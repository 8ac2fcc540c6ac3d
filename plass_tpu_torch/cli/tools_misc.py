"""Misc base tools: version, clusthash, ungappedprefilter, alignall,
easy-rbh, easy-taxonomy, transitivealign, alignbykmer and convertkb
(reference: lib/mmseqs/src/util/{versionstring,clusthash,alignall,
transitivealign,alignbykmer,convertkb}.cpp,
lib/mmseqs/src/prefiltering/ungappedprefilter.cpp,
lib/mmseqs/src/workflow/{EasyRbh,EasyTaxonomy}.cpp + data/workflow/
{easyrbh,easytaxonomy}.sh).

A copy of the JAX package's cli/tools_misc.py; each command takes the
port's (positional, space, stats) and the flag list of its JAX counterpart
plus --device, which reaches the searches of easy-rbh and easy-taxonomy
(kernel B9 scores their candidate pairs on a card). The other commands are
host code on every device, as in the JAX package: alignall and
transitivealign align and rescore each pair on the host.
"""
import os

import numpy as np

from ..data import seqdb
from ..utils.log import logger
from . import params as P
from .app import Command, port_space

CLUST_HASH_DEFAULT_ALPH_SIZE = 3    # Parameters.h:239
CLUST_HASH_DEFAULT_MIN_SEQ_ID = 99  # Parameters.h:240


def _version(positional, space, stats):
    """versionstring.cpp: print the version string."""
    from .. import __version__
    print(__version__)
    return 0


def _horner_hash(codes, pows):
    """Util::hash (Util.h:337-345): h = h*31 + x with 64-bit wraparound,
    vectorized as a dot product against precomputed powers of 31."""
    n = len(codes)
    if n == 0:
        return 0
    with np.errstate(over="ignore"):
        return int((codes.astype(np.uint64) * pows[n - 1::-1]).sum())


def _pow31(max_len):
    pows = np.empty(max(max_len, 1), dtype=np.uint64)
    pows[0] = 1
    with np.errstate(over="ignore"):
        for i in range(1, len(pows)):
            pows[i] = pows[i - 1] * np.uint64(31)
    return pows


def _clusthash(positional, space, stats):
    """clusthash.cpp: group sequences by a reduced-alphabet (or canonical
    strand) hash, then link same-length members at >= --min-seq-id Hamming
    identity into an alignment-format DB."""
    from .. import constants
    from ..data.createdb import IUPAC_COMPLEMENT
    from ..ops.rescore import format_seq_id
    if len(positional) != 2:
        raise ValueError("usage: clusthash <i:seqDB> <o:alnDB>")
    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    alph = (v["alphabet_size"].aminoacids if "alphabet_size" in space.was_set
            else CLUST_HASH_DEFAULT_ALPH_SIZE)
    seq_id_thr = (v["min_seq_id"].aminoacids if "min_seq_id" in space.was_set
                  else CLUST_HASH_DEFAULT_MIN_SEQ_ID / 100.0)
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    n = db.size
    max_len = int(db.seq_lens().max()) if n else 1
    pows = _pow31(max_len)
    hashes = np.empty(n, dtype=np.uint64)
    if is_nucl:
        # canonical strand hash: min(h(seq), h(complement(reverse(seq))))
        for i in range(n):
            s = np.asarray(db.get_seq(i))
            h1 = _horner_hash(s, pows)
            h2 = _horner_hash(IUPAC_COMPLEMENT[s[::-1]], pows)
            hashes[i] = min(h1, h2)
    else:
        red = constants.reduced(alph)
        for i in range(n):
            codes = red.aa2num[np.asarray(db.get_seq(i))]
            hashes[i] = _horner_hash(codes, pows)
    # sort by (hash, id) — SORT_PARALLEL over std::pair
    order = np.lexsort((np.arange(n), hashes))
    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    pos = 0
    while pos < n:
        end = pos
        while end < n and hashes[order[end]] == hashes[order[pos]]:
            end += 1
        members = order[pos:end]
        found = [False] * len(members)
        seqs = [np.asarray(db.get_seq(i)) for i in members]
        for i_idx, sid in enumerate(members):
            qkey = int(db.keys[sid])
            qlen = len(seqs[i_idx])
            lines = [f"{qkey}\t255\t1.00\t0\t0\t{qlen - 1}\t{qlen}\t0\t"
                     f"{qlen - 1}\t{qlen}\n"]
            if not found[i_idx]:
                for j_idx in range(len(members)):
                    if found[j_idx] or j_idx == i_idx:
                        continue
                    if len(seqs[j_idx]) != qlen:
                        continue
                    ident = int(np.count_nonzero(seqs[i_idx] == seqs[j_idx]))
                    seq_id = float(np.float32(ident) / np.float32(qlen))
                    if seq_id >= seq_id_thr:
                        tkey = int(db.keys[members[j_idx]])
                        # raw fastSeqIdToBuffer output: identity is the
                        # full "1.000" (no separator overwrite here,
                        # clusthash.cpp:158-160)
                        sid = ("1.000" if seq_id == 1.0
                               else format_seq_id(seq_id))
                        lines.append(
                            f"{tkey}\t255\t{sid}\t0\t0\t"
                            f"{qlen - 1}\t{qlen}\t0\t{qlen - 1}\t{qlen}\n")
                        found[j_idx] = True
            writer.write(qkey, "".join(lines).encode(), add_newline=False)
        pos = end
    writer.finish().save(positional[1])
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


def _alignall(positional, space, stats):
    """alignall.cpp: within each result-DB entry's key set, align all
    members against all members; lines are prefixed with the query key and
    written under the entry's key (GENERIC_DB)."""
    from .. import constants
    from ..ops.evalue import EvalueComputer
    from ..ops.nucl_align import _can_be_covered, _has_cov
    from ..ops.protein_align import (ProteinAligner, compress_cigar,
                                     init_sw_mode, sw_pair)
    from ..ops.rescore import format_result_line
    if len(positional) != 3:
        raise ValueError("usage: alignall <i:tDB> <i:resDB> <o:alnDB>")
    db = seqdb.SeqDB.open(positional[0])
    if db.dbtype == seqdb.NUCLEOTIDES:
        logger.error("Nucleotide alignall needs diagonal information.")
        return 1
    res = seqdb.SeqDB.open(positional[1])
    v = space.values
    add_backtrace = v["add_backtrace"]
    alignment_mode = v.get("alignment_mode", 0)
    if add_backtrace:
        alignment_mode = 3
    cov_thr, cov_mode = v["cov_thr"], v["cov_mode"]
    seq_id_thr = (v["min_seq_id"].aminoacids
                  if "min_seq_id" in space.was_set else 0.0)
    eval_thr = v["eval_thr"] if "eval_thr" in space.was_set else 1e-3
    aln_len_thr = (v["min_aln_len"].aminoacids
                   if "min_aln_len" in space.was_set else 0)
    gap_open = v["gap_open"] if "gap_open" in space.was_set else 11
    gap_extend = v["gap_extend"] if "gap_extend" in space.was_set else 1
    include_identity = v["add_self_matches"]
    seq_id_mode = v["seq_id_mode"]
    sw_mode = init_sw_mode(alignment_mode, cov_thr, seq_id_thr)
    mat = constants.blosum62()
    evaluer = EvalueComputer.for_matrix("blosum62_11_1",
                                        db.total_residues())
    aligner = ProteinAligner(mat, bool(v["comp_bias_corr"]))
    writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    for ei in seqdb.data_order(res):
        entry_key = int(res.keys[ei])
        body = res.get_data(ei).tobytes().decode()
        keys = [int(ln.split("\t", 1)[0].split(" ", 1)[0])
                for ln in body.splitlines() if ln]
        out_lines = []
        for qkey in keys:
            qid = db.key_to_id(qkey)
            qnum = mat.aa2num[np.asarray(db.get_seq(qid))]
            aligner.init_query(qnum)
            L = aligner.L
            for tkey in keys:
                tid = db.key_to_id(tkey)
                tnum = mat.aa2num[np.asarray(db.get_seq(tid))]
                if not _can_be_covered(cov_thr, cov_mode, L, len(tnum)):
                    continue
                is_identity = (qid == tid) and include_identity
                r = sw_pair(aligner, evaluer, tnum, tkey, is_identity,
                            sw_mode, seq_id_mode, gap_open, gap_extend,
                            eval_thr, cov_mode, cov_thr, L // 2,
                            add_backtrace=add_backtrace)
                ok = is_identity or (
                    (r["eval"] <= eval_thr) and (r["seqId"] >= seq_id_thr)
                    and _has_cov(cov_thr, cov_mode, r["qcov"], r["tcov"])
                    and r["alnLength"] >= aln_len_thr)
                if ok:
                    bt = (compress_cigar(r.get("backtrace", ""))
                          if add_backtrace else None)
                    out_lines.append(f"{qkey}\t"
                                     + format_result_line(r, bt))
        writer.write(entry_key, "".join(out_lines).encode(),
                     add_newline=False)
    writer.finish().save(positional[2])
    return 0


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
    Command("clusthash", _clusthash, lambda: port_space(
        P.common_flags() + P.kmermatcher_flags() + P.align_flags()),
            "<i:seqDB> <o:alnDB>", "Hash-based redundancy grouping",
            hidden=True),
    Command("ungappedprefilter", _ungappedprefilter, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <o:prefDB>", "Optimal diagonal score search",
            hidden=True),
    Command("alignall", _alignall, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:tDB> <i:resDB> <o:alnDB>", "All-vs-all within result sets",
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
]


def _parse_aln_full(line):
    """Matcher::parseAlignmentRecord (Matcher.cpp:248-300): parse one
    alignment line incl. qcov/dbcov/alnLength derivation and backtrace
    expansion."""
    from ..ops.msa import expand_cigar
    f = line.split("\t")
    q_start, q_end, q_len = int(f[4]), int(f[5]), int(f[6])
    db_start, db_end, db_len = int(f[7]), int(f[8]), int(f[9])
    aqs = 0 if q_start == -1 else q_start
    ads = 0 if db_start == -1 else db_start
    qcov = np.float32((min(q_len, max(aqs, q_end)) - min(aqs, q_end) + 1)
                      / np.float32(q_len))
    dbcov = np.float32((min(db_len, max(ads, db_end)) - min(ads, db_end) + 1)
                       / np.float32(db_len))
    return {
        "dbKey": int(f[0]), "score": int(f[1]), "seqId": float(f[2]),
        "eval": float(f[3]), "qStartPos": q_start, "qEndPos": q_end,
        "qLen": q_len, "dbStartPos": db_start, "dbEndPos": db_end,
        "dbLen": db_len, "qcov": qcov, "dbcov": dbcov,
        "alnLength": max(abs(q_end - aqs), abs(db_end - ads)) + 1,
        "backtrace": expand_cigar(f[10]) if len(f) > 10 else "",
    }


def _check_criteria(res, is_identity, eval_thr, seq_id_thr, aln_len_thr,
                    cov_mode, cov_thr):
    """Alignment::checkCriteria (Alignment.cpp:555-574)."""
    from ..ops.nucl_align import _has_cov
    return is_identity or (
        res["eval"] <= eval_thr and res["seqId"] >= seq_id_thr
        and _has_cov(cov_thr, cov_mode, res.get("qcov", 0.0),
                     res.get("dbcov", 0.0))
        and res["alnLength"] >= aln_len_thr)


def _serialize_aln(res):
    from ..ops.rescore import format_seq_id
    from ..ops.protein_align import compress_cigar
    return (f"{res['dbKey']}\t{res['score']}\t"
            f"{format_seq_id(res['seqId'])}\t{res['eval']:.3E}\t"
            f"{res['qStartPos']}\t{res['qEndPos']}\t{res['qLen']}\t"
            f"{res['dbStartPos']}\t{res['dbEndPos']}\t{res['dbLen']}\t"
            f"{compress_cigar(res['backtrace'])}\n")


def _transitivealign(positional, space, stats):
    """transitivealign (util/transitivealign.cpp:20-334): from a center-star
    alignment DB (center B -> members A_i, with backtraces) infer member-
    vs-member alignments A_i -> A_j: swap B->A_i, compose with B->A_j via
    BacktraceTranslator, rescore the composed backtrace, filter by
    checkCriteria, sort by compareHits, then regroup the emitted
    "<A_i> <line>" rows by A_i into the output DB (records in center scan
    order).

    Identity deviation: the reference's identity-pair branch leaves
    qcov/dbcov uninitialized stack floats (transitivealign.cpp:115-134);
    here they are 1.0 (only observable with --cov-thr > 0)."""
    from .. import constants
    from ..ops.evalue import EvalueComputer
    from ..ops.protein_align import update_result_by_rescoring_backtrace
    from .tools_profile import translate_backtrace
    if len(positional) != 3:
        raise ValueError("usage: transitivealign <i:seqDB> <i:alnDB> <o:alnDB>")
    v = space.values
    sdb = seqdb.SeqDB.open(positional[0])
    adb = seqdb.SeqDB.open(positional[1])
    is_nucl = sdb.dbtype == seqdb.NUCLEOTIDES
    mat = constants.nucleotide() if is_nucl else constants.blosum62()
    ascii_mat = mat.ascii_mat
    evaluer = EvalueComputer.for_matrix(
        "nucleotide_gapped_5_2" if is_nucl else "blosum62_11_1",
        sdb.total_residues())
    # base-tool defaults (Parameters.cpp): -e 0.001, --min-seq-id 0.0,
    # --gap-open 11 / --gap-extend 1 (always the aa component,
    # transitivealign.cpp:50,64,137)
    was = space.was_set

    def _aa(x):
        return x.aminoacids if isinstance(x, P.MultiParam) else x

    eval_thr = v["eval_thr"] if "eval_thr" in was else 0.001
    seq_id_thr = _aa(v["min_seq_id"]) if "min_seq_id" in was else 0.0
    aln_len_thr = _aa(v["min_aln_len"]) if "min_aln_len" in was else 0
    cov_mode = v.get("cov_mode", 0)
    cov_thr = v.get("cov_thr", 0.0)
    include_identity = bool(v.get("include_identity", False))
    gap_open = v["gap_open"] if "gap_open" in was else 11
    gap_extend = v["gap_extend"] if "gap_extend" in was else 1

    key2id = {int(sdb.keys[i]): i for i in range(sdb.size)}
    seqs = {}

    def get_seq(key):
        if key not in seqs:
            seqs[key] = sdb.get_data(key2id[key]).tobytes().rstrip(b"\n")
        return seqs[key]

    out = {}
    out_order = []
    for i in seqdb.data_order(adb):
        i = int(i)
        aln_key = int(adb.keys[i])
        lines = [ln for ln in adb.get_data(i).tobytes().decode().split("\n")
                 if ln]
        results = [_parse_aln_full(ln) for ln in lines]
        for ri in results:
            query_key = ri["dbKey"]
            query_seq = get_seq(query_key)
            swapped = dict(ri)
            raw = evaluer.raw_score_from_bit(float(int(swapped["score"])))
            swapped["eval"] = float(evaluer.evalue(raw, swapped["dbLen"]))
            for a, b in (("qStartPos", "dbStartPos"), ("qEndPos", "dbEndPos"),
                         ("qLen", "dbLen")):
                swapped[a], swapped[b] = swapped[b], swapped[a]
            swapped["backtrace"] = swapped["backtrace"].translate(
                str.maketrans("ID", "DI"))
            if query_key not in out:
                out[query_key] = []
                out_order.append(query_key)
            if query_key == aln_key:
                out[query_key].extend(_serialize_aln(r) for r in results)
                continue
            passing = []
            for rj in results:
                target_seq = get_seq(rj["dbKey"])
                from ..ops.nucl_align import _can_be_covered
                if not _can_be_covered(cov_thr, cov_mode, swapped["qLen"],
                                       rj["dbLen"]):
                    continue
                is_identity = (query_key == rj["dbKey"] and include_identity)
                if ri["dbKey"] == rj["dbKey"]:
                    L = ri["dbLen"]
                    score = 0
                    best = 0
                    for pos in range(L):
                        score += int(ascii_mat[query_seq[pos],
                                               target_seq[pos]])
                        score = 0 if score < 0 else score
                        best = score if score > best else best
                    res = {
                        "dbKey": rj["dbKey"], "dbLen": rj["dbLen"],
                        "score": int(evaluer.bit_score(best)),
                        "qLen": rj["dbLen"],
                        "dbEndPos": rj["dbLen"] - 1,
                        "qEndPos": rj["dbLen"] - 1,
                        "dbStartPos": 0, "qStartPos": 0,
                        "eval": float(evaluer.evalue(best, rj["dbLen"])),
                        "seqId": 1.0, "alnLength": rj["dbLen"],
                        "backtrace": "M" * rj["dbLen"],
                        "qcov": 1.0, "dbcov": 1.0,
                    }
                else:
                    res = translate_backtrace(swapped, rj)
                    res["qcov"] = rj["qcov"]
                    res["dbcov"] = rj["dbcov"]
                    res["alnLength"] = rj["alnLength"]
                    update_result_by_rescoring_backtrace(
                        query_seq, target_seq, ascii_mat, evaluer,
                        gap_open, gap_extend, res)
                if _check_criteria(res, is_identity, eval_thr, seq_id_thr,
                                   aln_len_thr, cov_mode, cov_thr):
                    passing.append(res)
            passing.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                        r["dbKey"]))
            out[query_key].extend(_serialize_aln(r) for r in passing)

    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for key in sorted(out):
        body = "".join(out[key])
        if body:
            writer.write(key, body.encode(), add_newline=False)
    writer.finish().save(positional[2])
    return 0


COMMANDS.append(
    Command("transitivealign", _transitivealign, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:seqDB> <i:alnDB> <o:alnDB>",
            "Transfer alignments via a shared center sequence", hidden=True))


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


COMMANDS.append(
    Command("alignbykmer", _alignbykmer, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--spaced-kmer-mode", "spaced_kmer_mode", int, 1,
                   "0: consecutive, 1: spaced", r"[0-1]")]),
            "<i:qDB> <i:tDB> <i:resDB> <o:alnDB>",
            "Heuristic gapped alignment from shared k-mer chains",
            hidden=True))


# UniprotKB flat-file column definitions (commons/UniprotKB.cpp:11-104):
# (prefix, dbColumn, lines-mode, transform)
_KB_COLUMN_NAMES = ["ID", "AC", "DT", "DE", "GN", "OS", "OG", "OC", "OX",
                    "OH", "REF", "CC", "DR", "PE", "KW", "FT", "SEQ"]
_KB_PREFIXES = [
    ("ID", 0, "single", "first_space"),
    ("AC", 1, "concat", "no_ws"),
    ("DT", 2, "multi", None),
    ("DE", 3, "multi", None),
    ("GN", 4, "fold", None),
    ("OS", 5, "multi", None),
    ("OG", 6, "multi", None),
    ("OC", 7, "fold", None),
    ("OX", 8, "single", None),
    ("OH", 9, "multi", None),
    ("RN", 10, "multi", None),
    ("RP", 10, "multi", None),
    ("RC", 10, "multi", None),
    ("RX", 10, "multi", None),
    ("RG", 10, "multi", None),
    ("RA", 10, "multi", None),
    ("RT", 10, "multi", None),
    ("RL", 10, "multi", None),
    ("CC", 11, "multi", None),
    ("DR", 12, "multi", None),
    ("PE", 13, "single", "first_colon"),
    ("KW", 14, "fold", None),
    ("FT", 15, "multi", None),
    ("SQ", -1, "single", None),
    ("  ", 16, "concat", "no_ws"),
]
# only these columns are written (includeInDB, UniprotKB.cpp:77-104);
# RP/RC/RX/RG/RA/RT/RL share column 10 but only RN's flag counts per line
_KB_INCLUDE = {("ID", 0), ("DT", 2), ("DE", 3), ("GN", 4), ("OS", 5),
               ("OG", 6), ("OC", 7), ("OX", 8), ("OH", 9), ("RN", 10),
               ("CC", 11), ("DR", 12), ("PE", 13), ("KW", 14), ("FT", 15),
               ("  ", 16)}


def _convertkb(positional, space, stats):
    """convertkb (util/convertkb.cpp:65-176): UniProtKB flat files ->
    per-column generic DBs (<out>_<COLUMN>) + an accession .lookup.
    NOTE: every matching prefix accumulates into its column regardless of
    includeInDB (UniprotKB::readLine matches all prefixes,
    UniprotKB.cpp:116-142) — so RP/RC/... feed the REF column too."""
    import gzip
    if len(positional) < 2:
        raise ValueError("usage: convertkb <i:kbFile[.gz]> ... <o:kbDB>")
    v = space.values
    out_base = positional[-1]
    inputs = positional[:-1]
    cols_arg = v.get("kb_columns", "") or ",".join(
        str(i) for i in range(len(_KB_COLUMN_NAMES)))
    enabled = set()
    for tok in cols_arg.split(","):
        tok = tok.strip()
        if tok.isdigit():
            enabled.add(int(tok))
        else:
            for i, n in enumerate(_KB_COLUMN_NAMES):
                if n == tok:
                    enabled.add(i)
                    break
    enabled = sorted(enabled)

    mapping = None
    mf = v.get("mapping_file", "")
    if mf and os.path.exists(mf):
        mapping = {}
        with open(mf + ".lookup" if os.path.exists(mf + ".lookup") else mf) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and parts[1] not in mapping:
                    mapping[parts[1]] = int(parts[0])

    writers = {c: seqdb.DBWriter(seqdb.GENERIC_DB) for c in enabled}
    lookup_lines = []
    idx = 0
    for path in inputs:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            cols = [""] * len(_KB_COLUMN_NAMES)
            in_entry = False
            for line in fh:
                line = line.rstrip("\n")
                if len(line) < 2:
                    logger.warning("Invalid entry")
                    continue
                if line[:2] == "ID":
                    cols = [""] * len(_KB_COLUMN_NAMES)
                    in_entry = True
                if in_entry:
                    for prefix, col, mode, transform in _KB_PREFIXES:
                        if line[:2] == prefix and col >= 0:
                            start = line[5:]
                            if transform == "first_space":
                                start = start.split(" ", 1)[0]
                            elif transform == "no_ws":
                                start = "".join(start.split())
                            elif transform == "first_colon":
                                start = start.split(":", 1)[0]
                            cols[col] += start
                            if mode == "multi":
                                cols[col] += "\n"
                            elif mode == "fold":
                                cols[col] += " "
                if line[:2] == "//":
                    in_entry = False
                    accession = cols[1].split(";", 1)[0]
                    key = idx
                    skip = False
                    if mapping is not None:
                        if accession not in mapping:
                            logger.warning(
                                f"Could not find accession {accession} "
                                f"in lookup")
                            skip = True
                        else:
                            key = mapping[accession]
                    if not skip:
                        for c in enabled:
                            writers[c].write(key, cols[c].encode(),
                                             add_newline=False)
                    if mapping is None:
                        lookup_lines.append(f"{idx}\t{accession}\n")
                    idx += 1
    for c in enabled:
        writers[c].finish().save(f"{out_base}_{_KB_COLUMN_NAMES[c]}")
    if mapping is None:
        with open(out_base + ".lookup", "w") as fh:
            fh.writelines(lookup_lines)
    return 0


COMMANDS.append(
    Command("convertkb", _convertkb, lambda: port_space(P.common_flags() + [
        P.Flag("--kb-columns", "kb_columns", str, "",
               "UniProtKB columns to extract (names or indices)"),
        P.Flag("--mapping-file", "mapping_file", str, "",
               "Map accessions to the keys of this DB's .lookup")]),
            "<i:kbFile[.gz]> ... <o:kbDB>",
            "Convert UniProtKB flat files to column DBs", hidden=True))
