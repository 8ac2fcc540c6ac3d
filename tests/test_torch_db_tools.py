"""PyTorch port: the DB, misc, domain and `databases` tools of the `plass`
and `penguin` CLIs (cli/tools_db.py, cli/tools_misc.py, cli/tools_domain.py,
cli/tools_databases.py and nine commands of cli/tools.py), run through both
packages' CLIs on the same inputs: the files each run writes (data,
`.index`, `.dbtype`, `.lookup`, `.source`, `_h`, unpacked files), its
standard output, its exit code and, on the error paths, its message are
the same. These tools do no device work; the port runs with --device cpu
and would run them on the host with any device.

`databases` never downloads here: `urllib.request.urlretrieve` is replaced
by a function that raises, and the cases that build a DB place its file in
<tmpDir> under its URL's basename first."""
import gzip
import io
import os
import shutil
import struct
import sys
import tarfile
import types
import urllib.request

import numpy as np
import pytest

from plass_tpu.data import seqdb as ref_seqdb

from test_torch_prefilter import family_records
from test_torch_tools import port_run, ref_run


# the small DBs of the JAX package's tests/test_tools_misc.py: two identical
# proteins and two identical nucleotide records, which clusthash links
MISC_AA = [("s0", "MKLVAGTREWQPLHIDCNSFYMKLVAGTREWQPLHIDCNSFY"),
           ("s1", "MKLVAGTREWQPLHIDCNSFYMKLVAGTREWQPLHIDCNSFY"),
           ("s2", "MKLVAGTREWQPLHIDCNSFYMKLVAGTREWQALHIDCNSFY"),
           ("s3", "ACDEFGHIKLMNPQRSTVWYACDEFGHIKLMNPQRSTVWYACDEF"),
           ("s4", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
           ("s5", "GLNWSEVARDMGVKTAEHICRELIQGDRFTPEQAK")]

# the UniProtKB text of the JAX package's tests/test_profile_search.py,
# and a second entry
UNIPROT_KB = (
    "ID   TESTP_HUMAN             Reviewed;         120 AA.\n"
    "AC   P99999; Q88888;\n"
    "DT   01-JAN-2020, integrated into UniProtKB/Swiss-Prot.\n"
    "DE   RecName: Full=Test protein;\n"
    "GN   Name=TST1;\n"
    "OS   Homo sapiens (Human).\n"
    "OC   Eukaryota; Metazoa.\n"
    "OX   NCBI_TaxID=9606;\n"
    "CC   -!- FUNCTION: Does test things.\n"
    "DR   Pfam; PF00001; Tst; 1.\n"
    "PE   1: Evidence at protein level;\n"
    "KW   Test; Protein.\n"
    "FT   CHAIN           1..120\n"
    "SQ   SEQUENCE   12 AA;  1357 MW;  ABCDEF0123456789 CRC64;\n"
    "     MKTAYIAKQR QI\n"
    "//\n"
    "ID   OTHER_MOUSE             Unreviewed;        20 AA.\n"
    "AC   A0A000;\n"
    "DE   SubName: Full=Other protein;\n"
    "OS   Mus musculus (Mouse).\n"
    "RN   [1]\n"
    "RP   NUCLEOTIDE SEQUENCE.\n"
    "PE   4: Predicted;\n"
    "SQ   SEQUENCE   20 AA;  2000 MW;  0123456789ABCDEF CRC64;\n"
    "     MKLVAGTREW QPLHIDCNSF\n"
    "//\n")

# a DB entry of each input kind `databases` takes, with its file's name
DATABASES_FASTA = ("UniProtKB/Swiss-Prot", "uniprot_sprot.fasta.gz")
DATABASES_MSA = ("Pfam-A.seed", "Pfam-A.seed.gz")


def _write_db(path, dbtype, records):
    w = ref_seqdb.DBWriter(dbtype)
    for key, body in records:
        w.write(key, body, add_newline=False)
    w.finish().save(path)


def _nucl_records(rng):
    """Seeded nucleotide records: random sequences, one repeated, one as
    its reverse complement (clusthash's canonical strand), one with a
    low-complexity stretch (masksequence)."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [acgt[rng.integers(0, 4, int(n))].tobytes()
            for n in rng.integers(200, 600, 10)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    seqs.append(seqs[2])
    seqs.append(seqs[3].translate(comp)[::-1])
    seqs.append(seqs[4][:60] + b"CA" * 40 + seqs[4][60:200])
    return [(f"g{i}", s.decode()) for i, s in enumerate(seqs)]


def _write_ffindex(path, records):
    """An ffindex pair (.ffdata/.ffindex) of (key, bytes) records, each
    NUL-terminated."""
    offset = 0
    with open(path + ".ffdata", "wb") as data, \
            open(path + ".ffindex", "w") as index:
        for key, body in records:
            data.write(body + b"\0")
            index.write(f"{key}\t{offset}\t{len(body) + 1}\n")
            offset += len(body) + 1


def _write_ca3m(path):
    """A compressed-A3M triple (<path>_ca3m, _sequence, _header) over
    MISC_AA: MSAs of s0 and s3, each hit an entry index, its 1-based start
    and (matches, insertion > 0 or deletion < 0) blocks
    (CompressedA3M.cpp's layout)."""
    seqs = [s.encode() for _, s in MISC_AA]

    def hit(entry, start, blocks):
        return struct.pack("<IHH", entry, start, len(blocks)) + b"".join(
            struct.pack("<Bb", m, d) for m, d in blocks)

    _write_ffindex(path + "_sequence", [(i, s + b"\n")
                                        for i, s in enumerate(seqs)])
    _write_ffindex(path + "_header", [(i, f"{h} member {i}\n".encode())
                                      for i, (h, _) in enumerate(MISC_AA)])
    _write_ffindex(path + "_ca3m", [
        (0, b">s0\n" + seqs[0] + b"\n;" + hit(1, 1, [(42, 0)])
         + hit(2, 1, [(10, 2), (12, -3), (15, 0)])
         + hit(4, 3, [(8, -1), (20, 0)])),
        (3, b">s3\n" + seqs[3] + b"\n;" + hit(3, 1, [(45, 0)])
         + hit(5, 2, [(5, 1), (6, -2), (20, 0)]))])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case names, made with the JAX package's CLI."""
    d = str(tmp_path_factory.mktemp("db_tools"))
    p = {k: os.path.join(d, k) for k in (
        "fasta", "seq", "clu", "aln", "misc", "nfasta", "nucl", "gff",
        "gffkeys", "tar", "tsv", "kb", "tab", "lens", "dom", "msa",
        "ca3m", "cadom", "sprot")}
    rng = np.random.default_rng(23)
    with open(p["fasta"], "w") as fh:
        for i, rec in enumerate(family_records(12, seed=29)):
            kind = "sp" if i % 3 else "tr"
            fh.write(f">{kind}|P{i:05d}|FAM{i}_ORG Protein {i % 7} "
                     f"OS=Organism {i % 4} GN=g{i} PE={1 + i % 5} SV=1\n"
                     f"{rec.decode()}\n")
    assert ref_run(["createdb", p["fasta"], p["seq"]]) == 0
    assert ref_run(["cluster", p["seq"], p["clu"], os.path.join(d, "ctmp"),
                    "--min-seq-id", "0.5"]) == 0
    assert ref_run(["search", p["seq"], p["seq"], p["aln"],
                    os.path.join(d, "stmp"), "-a"]) == 0
    with open(p["misc"] + ".fasta", "w") as fh:
        fh.writelines(f">{h}\n{s}\n" for h, s in MISC_AA)
    assert ref_run(["createdb", p["misc"] + ".fasta", p["misc"]]) == 0
    nrecs = _nucl_records(rng)
    with open(p["nfasta"], "w") as fh:
        fh.writelines(f">{h} genome {h}\n{s}\n" for h, s in nrecs)
    assert ref_run(["createdb", p["nfasta"], p["nucl"]]) == 0
    # gff2db's GFF names records by their lookup name: features on both
    # strands and of two types, a comment, a short line and start == end
    with open(p["gff"], "w") as fh:
        fh.write("##gff-version 3\n")
        for i, (name, seq) in enumerate(nrecs[:8]):
            a = 1 + 7 * i
            fh.write(f"{name}\tsim\tCDS\t{a}\t{a + 89}\t.\t+\t0\tID=c{i}\n")
            fh.write(f"{name}\tsim\tgene\t{a + 10}\t{a + 150}\t.\t-\t.\t"
                     f"ID=g{i}\n")
        fh.write("g1\tsim\tCDS\n")
        fh.write("g2\tsim\tCDS\t40\t40\t.\t+\t0\tID=z\n")
    # maskbygff's GFF names records by their DB key
    with open(p["gffkeys"], "w") as fh:
        fh.write("# masked regions\n")
        for k in range(0, 12, 2):
            fh.write(f"{k}\tsim\tCDS\t{5 + k}\t{40 + 3 * k}\t.\t+\t0\t.\n")
        fh.write("3\tsim\trepeat\t10\t30\t.\t+\t0\t.\n")
        fh.write("5\tsim\tCDS\t30\t10\t.\t+\t0\t.\n")
    with tarfile.open(p["tar"], "w") as tf:
        for name, text in (("a/one.fasta", ">x\nMKV\n"), ("two.txt", "b\n"),
                           ("a/three.fasta", ">y\nACGT\n")):
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        tf.addfile(tarfile.TarInfo("a/empty_dir"))
    with open(p["tsv"], "w") as fh:
        fh.write("3\tc\t0.5\n1\ta\t1\n3\td\t2\n\n2\tb\t7\n")
    with open(p["kb"], "w") as fh:
        fh.write(UNIPROT_KB)
    # summarizetabs and extractdomains: the inputs of the JAX package's
    # tests/test_tools_misc.py
    _write_db(p["tab"], ref_seqdb.GENERIC_DB, [
        (10, b"q1\tP001\t99.0\t50\t0\t0\t5\t54\t1\t50\t1e-20\t100\n"
             b"q1\tP002\t80.0\t40\t5\t0\t10\t49\t3\t42\t1e-10\t60\n"
             b"q1\tP003\t70.0\t30\t8\t0\t60\t89\t1\t30\t1e-8\t50\n"),
        (20, b"q2\tP001\t95.0\t45\t2\t0\t2\t46\t4\t48\t5e-15\t80\n")])
    with open(p["lens"], "w") as fh:
        fh.write("10\t100\n20\t60\nP001\t55\nP002\t45\nP003\t35\n")
    _write_db(p["dom"], ref_seqdb.ALIGNMENT_RES, [
        (10, b"10\tP001\t4\t53\t100\t0\t49\t55\t1e-20\n"
             b"10\tP003\t59\t88\t100\t0\t29\t35\t1e-08\n")])
    core = "MKLVAGTREWQPLHIDCNSFY" * 4 + "MKLVAGTREWQPLHID"
    msa = (f">q1 first\n{core}\n"
           f">m1 Split=1 \n{core[:14]}-{core[15:]}\n"
           f">m2\n{core[:32]}{core[32:43].lower()}{core[43:93]}--"
           f"{core[95:]}\n"
           f">consensus_q1\n{core}\n")
    _write_db(p["msa"], ref_seqdb.MSA_DB, [(10, msa.encode())])
    _write_ca3m(p["ca3m"])
    _write_db(p["cadom"], ref_seqdb.ALIGNMENT_RES, [
        (0, b"0\tP001\t2\t35\t42\t0\t33\t40\t1e-20\n"
            b"0\tP003\t10\t40\t42\t0\t30\t35\t1e-08\n"),
        (3, b"3\tP009\t5\t40\t45\t2\t37\t44\t1e-12\n")])
    with gzip.open(p["sprot"], "wt") as fh:
        fh.write(open(p["fasta"]).read())
    return p


def _tree(d):
    """{path relative to d: bytes} of every file under d."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, d)] = open(path, "rb").read()
    return out


def _argv(argv, p, d):
    """A case's command line in the run's dir d: "{name}" is an input,
    a word starting with OUT or TMP a path in d."""
    return [os.path.join(d, a) if a.startswith(("OUT", "TMP"))
            else a.format(**p) for a in argv]


def _both(tmp_path, capsys, p, argvs, binary="plass", setup=None):
    """The command lines argvs run one after another through each CLI,
    each package in a dir of its own (setup(d) prepares it); returns per
    package (exit codes, stdout, stderr, files written), with the dir's
    path in the output written as DIR and the JAX package's "Time for
    processing" lines, which the port's shell does not print, left out."""
    got = []
    for tag, run in (("ref", ref_run), ("port", port_run)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        if setup is not None:
            setup(d)
        capsys.readouterr()
        rcs = [run(_argv(argv, p, d), binary) for argv in argvs]
        cap = capsys.readouterr()
        err = "".join(line for line in cap.err.replace(d, "DIR")
                      .splitlines(keepends=True)
                      if not line.startswith("Time for processing"))
        got.append((rcs, cap.out.replace(d, "DIR"), err, _tree(d)))
    return got


# the amino-acid program apply runs per record
APPLY_PROGRAM = ("import os, sys; data = sys.stdin.read(); "
                 "sys.stdout.write(os.environ['MMSEQS_ENTRY_NAME'] + ':' "
                 "+ str(len(data)) + '\\n' + data.upper()[::-1])")

# (command lines run one after another; {} names an input, OUT and TMP are
# paths in the run's dir); every case exits 0 in both packages
CASES = {
    "compress": [["compress", "{seq}", "OUT"]],
    "compress-decompress": [["compress", "{seq}", "OUTc"],
                            ["decompress", "OUTc", "OUT"]],
    "dbtype": [["dbtype", "{seq}"], ["dbtype", "{aln}"],
               ["dbtype", "{nucl}"], ["dbtype", "{clu}"]],
    "view": [["view", "{seq}", "--id-list", "0,3,17,999"]],
    "view-lookup": [["view", "{nucl}", "--id-mode", "1", "--id-list",
                     "g3,g1,nosuch"]],
    "suffixid": [["suffixid", "{aln}", "OUT"]],
    "suffixid-tsv": [["suffixid", "{clu}", "OUT", "--tsv", "--prefix",
                      "X"]],
    "unpackdb": [["unpackdb", "{nucl}", "OUT", "--unpack-suffix", ".fa"]],
    "unpackdb-keys": [["unpackdb", "{seq}", "OUT", "--unpack-name-mode",
                       "0"]],
    "countkmer-aa": [["countkmer", "{seq}", "-k", "3"]],
    "countkmer-nucl": [["countkmer", "{nucl}"]],
    "masksequence-aa": [["masksequence", "{seq}", "OUT"]],
    "masksequence-nucl": [["masksequence", "{nucl}", "OUT"]],
    "translateaa": [["translateaa", "{seq}", "OUT"]],
    "translateaa-table": [["translateaa", "{misc}", "OUT",
                           "--translation-table", "11"]],
    "summarizeresult": [["summarizeresult", "{aln}", "OUT"]],
    "summarizeresult-backtrace": [["summarizeresult", "{aln}", "OUT", "-a",
                                   "-c", "0.3", "--overlap", "0.2"]],
    "extractalignedregion": [["extractalignedregion", "{seq}", "{seq}",
                              "{aln}", "OUT"]],
    "extractalignedregion-query": [["extractalignedregion", "{seq}",
                                    "{seq}", "{aln}", "OUT",
                                    "--extract-mode", "1"]],
    "summarizeheaders": [["summarizeheaders", "{seq}_h", "{seq}_h", "{clu}",
                          "OUT"]],
    "summarizeheaders-metaclust": [["summarizeheaders", "{seq}_h",
                                    "{seq}_h", "{clu}", "OUT",
                                    "--header-type", "2",
                                    "--summary-prefix", "mc"]],
    "gff2db": [["gff2db", "{gff}", "{nucl}", "OUT"]],
    "gff2db-type": [["gff2db", "{gff}", "{gff}", "{nucl}", "OUT",
                     "--gff-type", "CDS"]],
    "maskbygff": [["maskbygff", "{gffkeys}", "{nucl}", "OUT"]],
    "maskbygff-type": [["maskbygff", "{gffkeys}", "{nucl}", "OUT",
                        "--gff-type", "repeat", "--id-offset", "100"]],
    "splitdb": [["splitdb", "{seq}", "OUT", "--split", "3"]],
    "extractframes": [["extractframes", "{nucl}", "OUT"]],
    "extractframes-single": [["extractframes", "{nucl}", "OUT",
                              "--forward-frames", "2",
                              "--reverse-frames", "1"]],
    "touchdb": [["touchdb", "{seq}"]],
    "diskspaceavail": [["diskspaceavail", "{seq}"]],
    "apply": [["apply", "{seq}", "OUT", sys.executable, "-c",
               APPLY_PROGRAM]],
    "tar2db": [["tar2db", "{tar}", "OUT"]],
    "tsv2db": [["tsv2db", "{tsv}", "OUT", "--output-dbtype", "5"]],
    "prefixid": [["prefixid", "{aln}", "OUT"]],
    "reverseseq-aa": [["reverseseq", "{seq}", "OUT"]],
    "reverseseq-nucl": [["reverseseq", "{nucl}", "OUT"]],
    "clusthash-aa": [["clusthash", "{misc}", "OUT"]],
    "clusthash-aa-families": [["clusthash", "{seq}", "OUT", "--alph-size",
                               "7", "--min-seq-id", "0.3"]],
    "clusthash-nucl": [["clusthash", "{nucl}", "OUT"]],
    "alignall": [["alignall", "{seq}", "{clu}", "OUT"]],
    "alignall-backtrace": [["alignall", "{seq}", "{clu}", "OUT", "-a"]],
    "transitivealign": [["transitivealign", "{seq}", "{aln}", "OUT"]],
    "convertkb": [["convertkb", "{kb}", "OUT"]],
    "convertkb-columns": [["convertkb", "{kb}", "OUT", "--kb-columns",
                           "AC,OS,REF,16"]],
    "summarizetabs": [["summarizetabs", "{tab}", "{lens}", "OUT", "-e",
                       "0.001"]],
    "extractdomains": [["extractdomains", "{dom}", "{msa}", "OUT", "-e",
                        "1000", "-c", "0.0"]],
    "extractdomains-ca3m": [["extractdomains", "{cadom}", "{ca3m}", "OUT",
                             "-e", "1000", "-c", "0.0", "--msa-type", "0"]],
    "databases-list": [["databases"]],
    "databases-fasta": [["databases", DATABASES_FASTA[0], "OUT", "TMP"]],
}

# the case's command line exits 1 in both packages with the same message
ERROR_CASES = {
    # C8: `--` is an unknown flag to the parser of both packages
    "apply-double-dash": ["apply", "{seq}", "OUT", "--", "cat"],
    "databases-unknown": ["databases", "NoSuchDB", "OUT", "TMP"],
    "databases-msa": ["databases", DATABASES_MSA[0], "OUT", "TMP"],
    "databases-download": ["databases", "UniRef50", "OUT", "TMP"],
    "alignall-nucl": ["alignall", "{nucl}", "{clu}", "OUT"],
    "extractalignedregion-usage": ["extractalignedregion", "{seq}", "OUT"],
}


def _no_download(url, dst):
    raise OSError(f"no network for {url}")


def _place(name, src):
    def setup(d):
        os.makedirs(os.path.join(d, "TMP"))
        shutil.copyfile(src, os.path.join(d, "TMP", name))
    return setup


def _setup(case, p):
    if case == "databases-fasta":
        return _place(DATABASES_FASTA[1], p["sprot"])
    if case == "databases-msa":
        return _place(DATABASES_MSA[1], p["sprot"])
    return None


@pytest.fixture
def guarded(monkeypatch):
    """No download, and diskspaceavail's statvfs the same for both."""
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_download)
    monkeypatch.setattr(os, "statvfs", lambda path: types.SimpleNamespace(
        f_bavail=123457, f_frsize=4096))


@pytest.mark.parametrize("case", list(CASES))
def test_tool_writes_as_the_jax_package(tmp_path, capsys, inputs, guarded,
                                        case):
    (want_rc, want_out, want_err, want_files), got = _both(
        tmp_path, capsys, inputs, CASES[case], setup=_setup(case, inputs))
    assert want_rc == [0] * len(CASES[case]), want_err
    assert got[0] == want_rc
    assert got[1] == want_out
    assert got[2] == want_err
    assert got[3].keys() == want_files.keys()
    for name, data in want_files.items():
        assert got[3][name] == data, name
    if case != "touchdb":
        assert want_files or want_out, "the case wrote and printed nothing"


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_tool_fails_as_the_jax_package(tmp_path, capsys, inputs, guarded,
                                       case):
    want, got = _both(tmp_path, capsys, inputs, [ERROR_CASES[case]],
                      setup=_setup(case, inputs))
    assert want[0] == [1]
    assert got[:3] == want[:3]
    assert want[2], "the case gave no message"


def test_a_penguin_tool_writes_as_the_jax_package(tmp_path, capsys, inputs,
                                                  guarded):
    """The tools are base tools of both CLIs: penguin's clusthash."""
    want, got = _both(tmp_path, capsys, inputs,
                      [["clusthash", "{nucl}", "OUT"]], binary="penguin")
    assert want[0] == [0]
    assert got == want


def _tree_of(prefix):
    """{extension: bytes} of a DB's data, index and dbtype files."""
    return {ext: open(prefix + ext, "rb").read()
            for ext in ("", ".index", ".dbtype")}


def test_compressed_records_of_many_blocks_as_the_jax_package(tmp_path,
                                                             capsys):
    """compress and decompress on records of 150,000 nt (two ZSTD blocks):
    the port's ZSTD is the system's libzstd (utils/zstd.py), the JAX
    package's the `zstandard` package, and two ZSTD versions may write
    different frames for such records, and so different offsets. So the
    dbtype files and the keys and lengths of the index are equal, each
    package inflates the other's frames to the input's bytes, and each
    decompressed DB equals the input DB byte for byte."""
    rng = np.random.default_rng(31)
    fasta, seq = str(tmp_path / "long.fasta"), str(tmp_path / "long")
    with open(fasta, "w") as fh:
        for i in range(3):
            fh.write(f">long{i}\n"
                     + "".join("ACGT"[c] for c in rng.integers(0, 4, 150000))
                     + "\n")
    assert ref_run(["createdb", fasta, seq]) == 0
    want = _tree_of(seq)
    zipped = {}
    for tag, run in (("ref", ref_run), ("port", port_run)):
        zipped[tag] = str(tmp_path / f"{tag}_z")
        assert run(["compress", seq, zipped[tag]]) == 0
    assert open(zipped["ref"] + ".dbtype", "rb").read() \
        == open(zipped["port"] + ".dbtype", "rb").read()
    keys_lengths = [[(f[0], f[2]) for f in (line.split("\t") for line in
                                            open(zipped[tag] + ".index"))]
                    for tag in ("ref", "port")]
    assert keys_lengths[0] == keys_lengths[1]
    for tag, run in (("ref", ref_run), ("port", port_run)):
        for src in ("ref", "port"):
            out = str(tmp_path / f"{tag}_from_{src}")
            assert run(["decompress", zipped[src], out]) == 0
            assert _tree_of(out) == want, (tag, src)
    capsys.readouterr()


@pytest.mark.parametrize("framing", ["one-shot", "streamed"])
def test_zstd_frames_as_the_zstandard_package(framing):
    """utils/zstd.py against the `zstandard` package the JAX package uses:
    the same frame for a record of one block, and every frame inflated to
    its content, streamed frames (no content size in the header, as the
    reference's DBWriter writes them) too; a truncated frame and a frame
    larger than max_output_size raise."""
    import zstandard
    from plass_tpu_torch.utils import zstd
    rng = np.random.default_rng(37)
    for n in (60, 1000, 20000, 400000):
        data = rng.integers(65, 91, n, dtype=np.uint8).tobytes()
        if framing == "one-shot":
            frame = zstandard.ZstdCompressor(level=3).compress(data)
            if n <= 1000:
                assert zstd.ZstdCompressor(level=3).compress(data) == frame
        else:
            co = zstandard.ZstdCompressor(level=3).compressobj()
            frame = co.compress(data) + co.flush()
        assert zstd.ZstdDecompressor().decompress(
            frame, max_output_size=1 << 31) == data
        with pytest.raises(ValueError):
            zstd.ZstdDecompressor().decompress(frame[:-4])
        with pytest.raises(ValueError):
            zstd.ZstdDecompressor().decompress(frame, max_output_size=n - 1)
