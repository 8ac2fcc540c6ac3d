"""PyTorch port: the profile and MSA tools (cli/tools_profile.py, 17
commands) and subtractdbs through both packages' CLIs, byte for byte, on
the inputs the JAX package's profile tests use: a protein family's self
alignments with backtraces, the profile, MSA, Stockholm and compressed A3M
DBs made from them, an HH-suite HHM DB and a nucleotide family's
alignments. The inputs are made with the JAX package's CLI; the port runs
with --device cpu."""
import os
import shutil

import numpy as np
import pytest

from test_torch_profile_ops import ALPHABET, family_rows
from test_torch_tools import _both, ref_run


def _hhm_record(rng, name, seq):
    """One HH-suite .hhm text record with seeded emission and transition
    values, some '*' (probability 0) and some 0 (probability 1)."""
    lines = ["HHsearch 1.5", f"NAME  {name} test protein family", "FAM   ",
             ">Consensus", seq.lower(), f">{name} query header", seq, "#",
             "NULL   3706 5728 4211 4064 4839 3729 4763 4308 4069 3323 "
             "5509 4640 4464 4937 4285 4423 3815 3783 6325 4665",
             "HMM    A\tC\tD\tE\tF\tG\tH\tI\tK\tL\tM\tN\tP\tQ\tR\tS\tT\tV\tW\tY",
             "       M->M\tM->I\tM->D\tI->M\tI->I\tD->M\tD->D\tNeff\tNeff_I"
             "\tNeff_D",
             "       0\t*\t*\t0\t*\t0\t*\t*\t*\t*"]
    for pos, aa in enumerate(seq, 1):
        vals = []
        for _ in range(20):
            r = rng.random()
            vals.append("*" if r < 0.1 else "0" if r < 0.15
                        else str(int(rng.integers(1, 12001))))
        lines.append(f"{aa} {pos}\t" + "\t".join(vals) + f"\t{pos}")
        lines.append("       0\t*\t*\t*\t*\t*\t*\t"
                     + str(int(rng.integers(1000, 9001))) + "\t0\t0")
        lines.append("")
    lines.append("//")
    return "\n".join(lines) + "\n"


def _write_ca3m(prefix, seq_path, aln_path):
    """A compressed A3M triple of an alignment DB (CompressedA3M.cpp's
    layout: per query a '#' name line, the query as consensus and ';',
    then the query's entry and each hit's, its start and match/indel
    blocks encoded by the JAX package's hit_to_buffer), with the sequence
    DB's data and headers as its _sequence and _header parts."""
    from plass_tpu.data import ca3m, seqdb
    from plass_tpu.ops.msa import expand_cigar
    seq, aln = seqdb.SeqDB.open(seq_path), seqdb.SeqDB.open(aln_path)
    data, index = b"", []
    for i in range(aln.size):
        key = int(aln.keys[i])
        qid = seq.key_to_id(key)
        qseq = seq.get_seq(qid).tobytes()
        rec = (f"#{key}\n>consensus\n".encode() + qseq + b"\n;"
               + ca3m.hit_to_buffer(qid, 0, 0, "M" * len(qseq)))
        for line in aln.get_data(i).tobytes().decode().split("\n"):
            f = line.split("\t")
            if len(f) > 10 and int(f[0]) != key:
                rec += ca3m.hit_to_buffer(seq.key_to_id(int(f[0])),
                                          int(f[4]), int(f[7]),
                                          expand_cigar(f[10]))
        rec += b"\n\0"
        index.append(f"{key}\t{len(data)}\t{len(rec)}\n")
        data += rec
    with open(prefix + "_ca3m.ffdata", "wb") as fh:
        fh.write(data)
    with open(prefix + "_ca3m.ffindex", "w") as fh:
        fh.writelines(index)
    for part, src in (("_sequence", seq_path), ("_header", seq_path + "_h")):
        shutil.copyfile(src, prefix + part + ".ffdata")
        shutil.copyfile(src + ".index", prefix + part + ".ffindex")
    seqdb.write_dbtype(prefix, seqdb.CA3M_DB)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("profile_tools"))
    p = {k: os.path.join(d, k) for k in (
        "seq", "pref", "aln", "prof", "msa", "ca3m", "hhm", "nseq", "npref",
        "naln")}
    p["sto"] = os.path.join(d, "flat.sto")
    rng = np.random.RandomState(11)
    base = "".join(rng.choice(ALPHABET, 120))
    with open(p["seq"] + ".fasta", "w") as fh:
        fh.writelines(f">p{i}\n{s}\n"
                      for i, s in enumerate(family_rows(rng, base, 8)))
    rng = np.random.RandomState(3)
    nbase = "".join(rng.choice(list("ACGT"), 150))
    with open(p["nseq"] + ".fasta", "w") as fh:
        for i in range(6):
            mut = list(nbase)
            for j in rng.choice(len(nbase), 10, replace=False):
                mut[j] = rng.choice(list("ACGT"))
            if i % 2:
                del mut[50:53]
            fh.write(f">n{i}\n{''.join(mut)}\n")
    for argv in (
            ["createdb", p["seq"] + ".fasta", p["seq"]],
            ["prefilter", p["seq"], p["seq"], p["pref"], "-s", "4"],
            ["align", p["seq"], p["seq"], p["pref"], p["aln"], "-a", "-e",
             "10000"],
            ["result2profile", p["seq"], p["seq"], p["aln"], p["prof"]],
            ["result2msa", p["seq"], p["seq"], p["aln"], p["msa"]],
            ["result2msa", p["seq"], p["seq"], p["aln"], p["sto"],
             "--msa-format-mode", "4"],
            ["createdb", p["nseq"] + ".fasta", p["nseq"]],
            ["kmermatcher", p["nseq"], p["npref"], "-k", "15",
             "--kmer-per-seq", "60", "--include-only-extendable", "0"],
            ["align", p["nseq"], p["nseq"], p["npref"], p["naln"], "-a",
             "-e", "10000", "--min-seq-id", "0"]):
        assert ref_run(argv) == 0, argv[:2]
    _write_ca3m(p["ca3m"], p["seq"], p["aln"])
    rng = np.random.default_rng(7)
    data, index = b"", []
    for name, seq in (("prot1", "ACDEFGHIKLMNPQRSTVWY"),
                      ("prot2", "MKVLAWYTTGH"), ("prot3", "GGSSLLKKRRE")):
        blob = _hhm_record(rng, name, seq).encode() + b"\x00"
        index.append(f"{name}.hhm\t{len(data)}\t{len(blob)}\n")
        data += blob
    with open(p["hhm"] + ".ffdata", "wb") as fh:
        fh.write(data)
    with open(p["hhm"] + ".ffindex", "w") as fh:
        fh.writelines(index)
    for name in ("aln", "naln", "prof", "msa"):
        assert os.path.getsize(p[name]) > 800, name
    return p


# (command line; {} names an input, OUT the output in the run's dir)
CASES = {
    "result2profile": ["result2profile", "{seq}", "{seq}", "{aln}", "OUT"],
    "result2profile-filtered": ["result2profile", "{seq}", "{seq}", "{aln}",
                                "OUT", "--cov", "0.5", "--qid", "0.1,0.3",
                                "--diff", "3", "--pca", "1.0"],
    "result2profile-profile-targets": ["result2profile", "{seq}", "{prof}",
                                       "{aln}", "OUT"],
    "filterresult": ["filterresult", "{seq}", "{seq}", "{aln}", "OUT"],
    "result2msa": ["result2msa", "{seq}", "{seq}", "{aln}", "OUT"],
    "result2msa-filtered": ["result2msa", "{seq}", "{seq}", "{aln}", "OUT",
                            "--filter-msa", "1"],
    "result2msa-stockholm": ["result2msa", "{seq}", "{seq}", "{aln}",
                             "OUT.sto", "--msa-format-mode", "4"],
    "result2msa-fasta-summary": ["result2msa", "{seq}", "{seq}", "{aln}",
                                 "OUT", "--msa-format-mode", "1"],
    "msa2profile": ["msa2profile", "{msa}", "OUT"],
    "msa2profile-match-mode-1": ["msa2profile", "{msa}", "OUT",
                                 "--match-mode", "1"],
    "profile2pssm": ["profile2pssm", "{prof}", "OUT.tsv"],
    "profile2pssm-db": ["profile2pssm", "{prof}", "OUT", "--db-output"],
    "profile2consensus": ["profile2consensus", "{prof}", "OUT"],
    "profile2repseq": ["profile2repseq", "{prof}", "OUT"],
    "expandaln": ["expandaln", "{seq}", "{seq}", "{aln}", "{aln}", "OUT"],
    "expandaln-profile": ["expandaln", "{prof}", "{seq}", "{aln}", "{aln}",
                          "OUT"],
    "expand2profile": ["expand2profile", "{seq}", "{seq}", "{aln}", "{aln}",
                       "OUT"],
    "summarizealis": ["summarizealis", "{aln}", "OUT"],
    "result2dnamsa": ["result2dnamsa", "{nseq}", "{nseq}", "{naln}", "OUT"],
    "convertmsa": ["convertmsa", "{sto}", "OUT"],
    "result2pp": ["result2pp", "{prof}", "{prof}", "{aln}", "OUT"],
    "profile2cs": ["profile2cs", "{prof}", "OUT"],
    "convertprofiledb": ["convertprofiledb", "{hhm}", "OUT"],
    "convertca3m": ["convertca3m", "{ca3m}", "OUT"],
    "msa2result": ["msa2result", "{msa}", "OUT", "OUT_res"],
    "msa2result-match-mode-1": ["msa2result", "{msa}", "OUT", "OUT_res",
                                "--match-mode", "1"],
    "msa2result-skip-query": ["msa2result", "{msa}", "OUT", "OUT_res",
                              "--skip-query"],
    "msa2result-ca3m": ["msa2result", "{ca3m}", "OUT", "OUT_res",
                        "--msa-type", "0"],
    "subtractdbs": ["subtractdbs", "{pref}", "{aln}", "OUT"],
    "subtractdbs-evalue": ["subtractdbs", "{aln}", "{aln}", "OUT", "-e",
                           "1e-60", "--e-profile", "1e-40"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_profile_tool_writes_what_the_jax_package_writes(inputs, tmp_path,
                                                         case):
    def argv(d):
        return [a.format(**inputs).replace("OUT", os.path.join(d, "out"))
                for a in CASES[case]]
    ref, port = _both(tmp_path, argv)
    assert port == ref
    assert any(name.startswith("out") and data for name, data in ref.items())
