"""PyTorch port: the multi-hit tools (data/multihit.py, cli/tools.py):
multihitdb, multihitsearch (a `search`, whose candidate pairs B9 scores on
a card), besthitperset, combinepvalperset in its four aggregation modes,
mergeresultsbyset, result2stats and orftocontig, held against the JAX
package through both packages' CLIs on seeded coding genomes, byte for
byte. The port runs with --device cpu (kernel B9 as its plain
version)."""
import os

import numpy as np
import pytest

from test_torch_linsearch import run_both
from test_torch_tools import ref_run

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def coding_genomes(n, length, rng):
    """Seeded coding genomes: genes (ATG, 40-200 sense codons, a stop) on
    either strand between 20-150 nt of random sequence."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    codons = [bytes([a, b, c]) for a in b"ACGT" for b in b"ACGT"
              for c in b"ACGT"]
    sense = [c for c in codons if c not in (b"TAA", b"TAG", b"TGA")]
    out = []
    for _ in range(n):
        g = b""
        while len(g) < length:
            gene = b"ATG" + b"".join(
                sense[i] for i in rng.integers(0, len(sense),
                                               int(rng.integers(40, 200))))
            gene += (b"TAA", b"TAG", b"TGA")[int(rng.integers(3))]
            if rng.random() < 0.5:
                gene = gene[::-1].translate(COMP)
            g += gene + acgt[rng.integers(0, 4, int(
                rng.integers(20, 150)))].tobytes()
        out.append(g[:length])
    return out


def mutate(seq, rate, rng):
    s = np.frombuffer(seq, dtype=np.uint8).copy()
    mut = rng.random(len(s)) < rate
    s[mut] = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, int(mut.sum()))]
    return s.tobytes()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(JAX package's CLI) `tset`, the multihitdb of 3 FASTA files of 3
    coding genomes of 1,500 nt; `qset`, of 2 files of 2 of those genomes
    with 2% substitutions; `res`, a search of qset's ORF proteins against
    tset's; `mhs`, their multihitsearch."""
    d = str(tmp_path_factory.mktemp("multihit"))
    rng = np.random.default_rng(31)
    genomes = coding_genomes(9, 1500, rng)
    files = {"t0": genomes[0:3], "t1": genomes[3:6], "t2": genomes[6:9],
             "q0": [mutate(genomes[i], 0.02, rng) for i in (1, 4)],
             "q1": [mutate(genomes[i], 0.02, rng) for i in (7, 8)]}
    for name, recs in files.items():
        with open(os.path.join(d, name + ".fasta"), "w") as fh:
            for i, rec in enumerate(recs):
                fh.write(f">{name}_{i} genome\n{rec.decode()}\n")

    def p(name):
        return os.path.join(d, name)
    for argv in (["multihitdb", p("t0.fasta"), p("t1.fasta"), p("t2.fasta"),
                  p("tset"), p("ttmp")],
                 ["multihitdb", p("q0.fasta"), p("q1.fasta"), p("qset"),
                  p("qtmp")],
                 ["search", p("qset"), p("tset"), p("res"), p("stmp")],
                 ["multihitsearch", p("qset"), p("tset"), p("mhs"),
                  p("mtmp")]):
        assert ref_run(argv) == 0, argv[0]
    return d


CASES = {
    "multihitdb": ["multihitdb", "{d}/t0.fasta", "{d}/t1.fasta",
                   "{d}/t2.fasta", "OUT", "TMP"],
    "multihitsearch": ["multihitsearch", "{d}/qset", "{d}/tset", "OUT",
                       "TMP"],
    "multihitsearch-simple-best-hit": ["multihitsearch", "{d}/qset",
                                       "{d}/tset", "OUT", "TMP",
                                       "--simple-best-hit"],
    "besthitperset": ["besthitperset", "{d}/qset", "{d}/tset", "{d}/res",
                      "OUT"],
    "besthitperset-simple-best-hit": ["besthitperset", "{d}/qset",
                                      "{d}/tset", "{d}/res", "OUT",
                                      "--simple-best-hit"],
    **{f"combinepvalperset-mode-{m}": [
        "combinepvalperset", "{d}/qset", "{d}/tset", "{d}/mhs", "OUT",
        "--aggregation-mode", str(m), "--alpha", "0.5"] for m in range(4)},
    "mergeresultsbyset": ["mergeresultsbyset", "{d}/qset_set_to_member",
                          "{d}/res", "OUT"],
    "result2stats": ["result2stats", "{d}/qset", "{d}/tset", "{d}/res",
                     "OUT"],
    "orftocontig": ["orftocontig", "{d}/tset_nucl", "{d}/tset_nucl_orf",
                    "OUT"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_multihit_tool_writes_what_the_jax_package_writes(inputs, tmp_path,
                                                          case):
    ref, port = run_both(tmp_path, inputs, [], lambda out: [[
        a.format(d=inputs).replace("OUT", f"{out}/out").replace(
            "TMP", f"{out}/tmp") for a in CASES[case]]])
    assert port == ref
    assert ref["out"].count(b"\n") >= 3


def test_the_inputs_have_sets_and_hits(inputs):
    """The search behind the cases: every query set's ORFs hit members of
    each target set they were copied from."""
    from plass_tpu_torch.data import seqdb
    tset = seqdb.SeqDB.open(os.path.join(inputs, "tset"))
    res = seqdb.SeqDB.open(os.path.join(inputs, "res"))
    mhs = seqdb.SeqDB.open(os.path.join(inputs, "mhs"))
    assert tset.size > 30
    assert res.data.tobytes().count(b"\n") > 20
    assert sorted(int(k) for k in mhs.keys) == [0, 1]
