"""Misc base tools: alignbykmer and easy-rbh (reference:
lib/mmseqs/src/util/alignbykmer.cpp, lib/mmseqs/src/workflow/EasyRbh.cpp
+ data/workflow/easyrbh.sh).

A copy of two of the JAX package's cli/tools_misc.py commands; each takes
the port's (positional, space, stats) and the flag list of its JAX
counterpart plus --device, which reaches easy-rbh's two searches (kernel
B9 scores their candidate pairs on a card). alignbykmer is host code on
every device, as in the JAX package. The file's other commands are not
ported yet (ROADMAP items 23.4-23.6).
"""
import os

from ..data import seqdb
from . import params as P
from .app import Command, port_space


def _easy_rbh(positional, space, stats):
    """easy-rbh: createdb both inputs -> rbh -> convertalis
    (reference: lib/mmseqs/data/workflow/easyrbh.sh)."""
    from ..data.createdb import create_db
    from .tools import _convertalis, _rbh
    if len(positional) != 4:
        raise ValueError(
            "usage: easy-rbh <i:queryFasta> <i:targetFasta> <o:tsv> <tmpDir>")
    # EasyRbh.cpp:36-45: -s 5.7 and SCORE_COV_SEQID staged as wasSet
    if "sensitivity" not in space.was_set:
        space.values["sensitivity"] = 5.7
        space.was_set.add("sensitivity")
    if "alignment_mode" not in space.was_set:
        space.values["alignment_mode"] = 3
        space.was_set.add("alignment_mode")
    tmp = positional[3]
    os.makedirs(tmp, exist_ok=True)
    qpath = os.path.join(tmp, "query")
    tpath = os.path.join(tmp, "target")
    # EasyRbh.cpp:40,101: query DB zero-copy/soft, target DB hard mode
    for fasta, path, soft in ((positional[0], qpath, True),
                              (positional[1], tpath, False)):
        if not os.path.exists(path + ".dbtype"):
            sdb, hdb = create_db([fasta], raw_headers=soft)
            sdb.save(path)
            hdb.save(path + "_h")
    _rbh([qpath, tpath, os.path.join(tmp, "result"),
          os.path.join(tmp, "rbh_tmp")], space, stats)
    return _convertalis([qpath, tpath, os.path.join(tmp, "result"),
                         positional[2]], space, stats)


def _alignbykmer(positional, space, stats):
    """alignbykmer (util/alignbykmer.cpp:21-510)."""
    from ..ops.alignbykmer import run_alignbykmer
    if len(positional) != 4:
        raise ValueError(
            "usage: alignbykmer <i:qDB> <i:tDB> <i:resDB> <o:alnDB>")
    v = space.values
    was = space.was_set
    qdb = seqdb.SeqDB.open(positional[0])
    same = positional[0] == positional[1]
    tdb = qdb if same else seqdb.SeqDB.open(positional[1])
    rdb = seqdb.SeqDB.open(positional[2])

    def _aa(x):
        return x.aminoacids if isinstance(x, P.MultiParam) else x

    def _nucl(x):
        return x.nucleotides if isinstance(x, P.MultiParam) else x

    params = {
        "same_db": same,
        "k": _aa(v["k"]) if "k" in was else None,
        "spaced_kmer": v["spaced_kmer_mode"] if "spaced_kmer_mode" in was
        else None,
        "eval_thr": v["eval_thr"] if "eval_thr" in was else 0.001,
        "min_seq_id": _aa(v["min_seq_id"]) if "min_seq_id" in was else 0.0,
        "cov_thr": v.get("cov_thr", 0.0),
        "cov_mode": v.get("cov_mode", 0),
        "include_identity": bool(v.get("include_identity", False)),
        "gap_open": v["gap_open"] if "gap_open" in was else 11,
        "gap_extend": v["gap_extend"] if "gap_extend" in was else 1,
        "gap_open_nucl": _nucl(v["gap_open"]) if "gap_open" in was else 5,
        "gap_extend_nucl": _nucl(v["gap_extend"]) if "gap_extend" in was
        else 2,
    }
    run_alignbykmer(qdb, tdb, rdb, params).save(positional[3])
    return 0


COMMANDS = [
    Command("easy-rbh", _easy_rbh, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:qFasta> <i:tFasta> <o:tsv> <tmpDir>",
            "Reciprocal best hit search (FASTA in, BLAST-tab out)",
            hidden=True),
    Command("alignbykmer", _alignbykmer, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--spaced-kmer-mode", "spaced_kmer_mode", int, 1,
                   "0: consecutive, 1: spaced", r"[0-1]")]),
            "<i:qDB> <i:tDB> <i:resDB> <o:alnDB>",
            "Heuristic gapped alignment from shared k-mer chains",
            hidden=True),
]
