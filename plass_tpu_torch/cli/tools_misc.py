"""Misc base tools: version, ungappedprefilter, easy-rbh, easy-taxonomy
and alignbykmer (reference: lib/mmseqs/src/util/{versionstring,
alignbykmer}.cpp, lib/mmseqs/src/prefiltering/ungappedprefilter.cpp,
lib/mmseqs/src/workflow/{EasyRbh,EasyTaxonomy}.cpp + data/workflow/
{easyrbh,easytaxonomy}.sh).

A copy of five of the JAX package's cli/tools_misc.py commands; each takes
the port's (positional, space, stats) and the flag list of its JAX
counterpart plus --device, which reaches the searches of easy-rbh and
easy-taxonomy (kernel B9 scores their candidate pairs on a card).
ungappedprefilter and alignbykmer are host code on every device, as in
the JAX package. The file's other commands are not ported yet (ROADMAP
item 23.5).
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


def _version(positional, space, stats):
    """versionstring.cpp: print the version string."""
    from .. import __version__
    print(__version__)
    return 0


def _ungappedprefilter(positional, space, stats):
    """ungappedprefilter.cpp: optimal ungapped-diagonal all-vs-all search."""
    from ..ops.prefilter import prefilter_to_db, ungapped_prefilter
    if len(positional) != 3:
        raise ValueError(
            "usage: ungappedprefilter <i:qDB> <i:tDB> <o:prefDB>")
    qdb = seqdb.SeqDB.open(positional[0])
    same = (os.path.realpath(positional[0])
            == os.path.realpath(positional[1]))
    tdb = None if same else seqdb.SeqDB.open(positional[1])
    v = space.values
    hits = ungapped_prefilter(
        qdb, tdb,
        eval_thr=v["eval_thr"] if "eval_thr" in space.was_set else 1e-3,
        cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
        min_diag_score=v["min_ungapped_score"], max_seqs=v["max_seqs"],
        comp_bias_corr=bool(v["comp_bias_corr"]),
        include_identity=v["add_self_matches"])
    prefilter_to_db(hits, qkeys=[int(k) for k in qdb.keys]) \
        .save(positional[2])
    return 0


def _easy_taxonomy(positional, space, stats):
    """easy-taxonomy (EasyTaxonomy.cpp:19-80 + easytaxonomy.sh): createdb
    -> taxonomy (output mode BOTH) -> <out>_lca.tsv, <out>_report,
    <out>_tophit_report (swap/summarize/addtaxonomy) and
    <out>_tophit_aln."""
    from ..data.createdb import create_db
    from .tools import (_addtaxonomy, _convertalis, _createtsv,
                        _swapresults, _taxonomy, _taxonomyreport)
    from .tools_profile import _summarizealis
    if len(positional) != 4:
        raise ValueError("usage: easy-taxonomy <i:queryFasta> "
                         "<i:taxSeqDB> <o:out> <tmpDir>")
    fasta, target, results, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    query = os.path.join(tmp, "query")
    if not os.path.exists(query + ".dbtype"):
        # createdbMode = SEQUENCE_SPLIT_MODE_SOFT (EasyTaxonomy.cpp:10)
        sdb, hdb = create_db([fasta], raw_headers=True)
        sdb.save(query)
        hdb.save(query + "_h")
    result = os.path.join(tmp, "result")
    v = space.values
    sv_out = v.get("tax_output_mode", 0)
    v["tax_output_mode"] = 2  # TAXONOMY_OUTPUT_BOTH (EasyTaxonomy.cpp:62)
    if not os.path.exists(result + ".dbtype"):
        _taxonomy([query, target, result,
                   os.path.join(tmp, "taxonomy_tmp")], space, stats)
    v["tax_output_mode"] = sv_out
    _createtsv([query, result, results + "_lca.tsv"], space, stats)
    _taxonomyreport([target, result, results + "_report"], space, stats)
    aln = result + "_aln"
    swapped = os.path.join(tmp, "result_aln_swapped")
    sv = "eval_thr" in space.was_set
    if not sv:
        # par.evalThr = FLT_MAX for swapresults (EasyTaxonomy.cpp:70)
        v["eval_thr"] = 3.4028234663852886e38
        space.was_set.add("eval_thr")
    _swapresults([query, target, aln, swapped], space, stats)
    if not sv:
        space.was_set.discard("eval_thr")
    summ = swapped + "_sum"
    _summarizealis([swapped, summ], space, stats)
    summ_tax = summ + "_tax"
    sv_pick = v.get("pick_id_from", 2)
    v["pick_id_from"] = 1  # EXTRACT_QUERY (EasyTaxonomy.cpp:72)
    _addtaxonomy([target, summ, summ_tax], space, stats)
    v["pick_id_from"] = sv_pick
    _createtsv([target, summ_tax, results + "_tophit_report"], space, stats)
    _convertalis([query, target, aln, results + "_tophit_aln"], space, stats)
    return 0


COMMANDS = [
    Command("version", _version, lambda: port_space([]),
            "", "Print version", hidden=True),
    Command("ungappedprefilter", _ungappedprefilter, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <o:prefDB>", "Optimal diagonal score search",
            hidden=True),
    Command("easy-rbh", _easy_rbh, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:qFasta> <i:tFasta> <o:tsv> <tmpDir>",
            "Reciprocal best hit search (FASTA in, BLAST-tab out)",
            hidden=True),
    Command("easy-taxonomy", _easy_taxonomy, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()
        + P.tax_flags() + [
            P.Flag("--alignment-mode", "alignment_mode", int, 0,
                   "0 auto, 1 score+end, 2 +start+cov, 3 +seq.id",
                   r"[0-5]"),
            P.Flag("--max-accept", "max_accept", int, 2**31 - 1,
                   "Maximum accepted alignments per query"),
            P.Flag("--max-rejected", "max_rejected", int, 2**31 - 1,
                   "Maximum rejected alignments before give-up"),
            P.Flag("--pick-id-from", "pick_id_from", int, 2,
                   "Extract mode: 1 query, 2 target", r"[1-2]")]),
            "<i:queryFasta> <i:taxSeqDB> <o:out> <tmpDir>",
            "Taxonomy assignment from FASTA input", hidden=True),
    Command("alignbykmer", _alignbykmer, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--spaced-kmer-mode", "spaced_kmer_mode", int, 1,
                   "0: consecutive, 1: spaced", r"[0-1]")]),
            "<i:qDB> <i:tDB> <i:resDB> <o:alnDB>",
            "Heuristic gapped alignment from shared k-mer chains",
            hidden=True),
]
