"""PyTorch port: alignbykmer (ops/alignbykmer.py, cli/tools_misc.py), the
k-mer-chained alignment of prefilter pairs, held against the JAX package
on the same seeded inputs byte for byte: the function on protein (spaced
seeds) and nucleotide DBs at both gap settings, the command through both
packages' CLIs, and the reference's persistent-scratch quirk. Host code
on every device in both packages."""
import os

import numpy as np
import pytest

from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu.ops import alignbykmer as ref_abk
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import alignbykmer as port_abk

from test_torch_linsearch import nucl_records, run_both, write_fasta
from test_torch_prefilter import family_records
from test_torch_tools import ref_run


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(JAX package's CLI) `seq`, 10 seeded protein families, and `pref`,
    its self prefilter; `nseq`, seeded nucleotide families, and `npref`,
    their k-mer matches."""
    d = str(tmp_path_factory.mktemp("alignbykmer"))
    write_fasta(os.path.join(d, "seq.fasta"), family_records(10), "f")
    write_fasta(os.path.join(d, "nseq.fasta"), nucl_records(4, 5), "n")
    for argv in (["createdb", "seq.fasta", "seq"],
                 ["createdb", "nseq.fasta", "nseq"],
                 ["prefilter", "seq", "seq", "pref"],
                 ["kmermatcher", "nseq", "npref"]):
        assert ref_run([argv[0], *[os.path.join(d, a)
                                   for a in argv[1:]]]) == 0, argv[0]
    return d


def _open(d, names, seqdb_mod):
    return [seqdb_mod.SeqDB.open(os.path.join(d, n)) for n in names]


def _bytes(db):
    return db.data.tobytes(), db.keys.tolist(), db.lengths.tolist()


GAPS = {"default": {}, "gaps": {"gap_open": 13, "gap_extend": 2,
                                "gap_open_nucl": 7, "gap_extend_nucl": 3}}


@pytest.mark.parametrize("gaps", list(GAPS))
@pytest.mark.parametrize("kind", ["protein", "nucleotide"])
def test_run_alignbykmer_equals_the_jax_package(inputs, kind, gaps):
    names = ("seq", "seq", "pref") if kind == "protein" else (
        "nseq", "nseq", "npref")
    params = dict(GAPS[gaps], same_db=True, eval_thr=10.0)
    ref = ref_abk.run_alignbykmer(*_open(inputs, names, ref_seqdb), params)
    port = port_abk.run_alignbykmer(*_open(inputs, names, port_seqdb),
                                    params)
    assert _bytes(port) == _bytes(ref)
    assert ref.data.tobytes().count(b"\n") > 20


@pytest.mark.parametrize("argv", [
    ["{d}/seq", "{d}/seq", "{d}/pref"],
    ["{d}/seq", "{d}/seq", "{d}/pref", "--gap-open", "13", "--gap-extend",
     "2", "--spaced-kmer-mode", "0", "-e", "1"],
    ["{d}/nseq", "{d}/nseq", "{d}/npref"],
    ["{d}/nseq", "{d}/nseq", "{d}/npref", "--gap-open", "7", "--gap-extend",
     "3", "--min-seq-id", "0.8"]],
    ids=["protein", "protein-gaps-consecutive", "nucleotide",
         "nucleotide-gaps"])
def test_alignbykmer_command_writes_what_the_jax_package_writes(
        inputs, tmp_path, argv):
    ref, port = run_both(tmp_path, inputs, [], lambda out: [
        ["alignbykmer", *[a.format(d=inputs) for a in argv[:3]],
         f"{out}/aln", *argv[3:]]])
    assert port == ref
    assert ref["aln"].count(b"\n") > 10


def _shared_kmers(db, a, b, k=4):
    """Spaced 4-mers two records share (the protein path's seeds)."""
    from plass_tpu_torch import constants
    mat = constants.blosum62()
    idx = []
    for key in (a, b):
        num = mat.aa2num[db.get_seq(db.key_to_id(key))].astype(np.uint8)
        _, kmers = port_abk._kmer_indices(num, k, True, 21)
        idx.append(set(kmers.tolist()))
    return len(idx[0] & idx[1])


def test_a_pair_of_few_kmers_after_one_of_many_as_the_jax_package(
        inputs, tmp_path):
    """The reference's stretch and DP arrays persist across targets: a
    pair sharing fewer than 2 k-mers chains what the pair before it left
    behind (alignbykmer.cpp:177-179). Each query's record lists itself
    (many shared k-mers), then a record of another family that shares
    fewer than 2; at the largest -e both are written, the second with the
    coordinates of the first, past its target's end."""
    db = port_seqdb.SeqDB.open(os.path.join(inputs, "seq"))
    keys = sorted(int(k) for k in db.keys)
    w = port_seqdb.DBWriter(port_seqdb.PREFILTER_RES)
    pairs = 0
    for a in keys[:20]:
        lines = f"{a}\t0\t0\n"
        b = next((b for b in keys[::-1] if abs(b - a) > 8
                  and _shared_kmers(db, a, b) < 2), None)
        if b is not None:
            lines += f"{b}\t0\t0\n"
            pairs += 1
        w.write(a, lines.encode(), add_newline=False)
    w.finish().save(str(tmp_path / "pairs"))
    assert pairs >= 10
    ref, port = run_both(tmp_path / "run", str(tmp_path), [], lambda out: [
        ["alignbykmer", os.path.join(inputs, "seq"),
         os.path.join(inputs, "seq"), str(tmp_path / "pairs"),
         f"{out}/aln", "-e", "1.7976931348623157e+308"]])
    assert port == ref
    lines = [ln.split(b"\t") for ln in ref["aln"].replace(
        b"\0", b"").splitlines()]
    assert len(lines) == 20 + pairs
    assert sum(int(f[8]) >= int(f[9]) for f in lines) >= pairs // 2
