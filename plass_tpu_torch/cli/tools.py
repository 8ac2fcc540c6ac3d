"""Base tools of the port's `plass` and `penguin` CLIs: the DB plumbing,
the sensitive prefilter, `align`, `search` (against sequences, against
profiles, exhaustive and iterative) and cascaded `cluster` with their
easy-* forms, the profile and MSA tools (cli/tools_profile.py), and the
alignment-DB readers the product CLIs' hidden tools share.

A copy of the JAX package's cli/tools.py, cut to these commands; each
keeps its flag list there (cli/params.py) plus --device, which sets where
the aligner scores its candidate pairs (kernel B9, ops/protein_align.py).
Everything else runs on the host, as in the JAX package. The base tools
of the JAX package not listed in BASE_COMMANDS are not registered
(ROADMAP item 23). A command's `stats` dict receives the stage seconds of
its workflow under "seconds" and the aligner's pair counts under "pairs"
(see align_protein).
"""
import os
import re

import numpy as np

from ..data import seqdb
from ..ops.rescore import RESULT_DTYPE
from ..utils.log import logger
from . import params as P
from .app import Command, port_flags


def _space(flags):
    """A command's ParamSpace: its JAX flag list, plus --device."""
    return P.ParamSpace(port_flags(flags))


def _record_line_counts(db, ids):
    """Lines per record over the flat data file (one cumsum, no per-record
    Python) — records are newline-terminated lines plus a NUL."""
    nl = np.concatenate([[0], np.cumsum(db.data == 10)])
    off = db.offsets[ids].astype(np.int64)
    ln = db.lengths[ids].astype(np.int64)
    return (nl[np.minimum(off + ln, len(nl) - 1)] - nl[off]).astype(np.int64)


def load_alignments(path):
    """Parse an alignment DB into {query_key: RESULT_DTYPE array}.

    The whole data file goes through numpy's C text parser at once
    (np.loadtxt handles the optional trailing backtrace column via
    usecols); per-record slices come from a newline cumsum. Falls back to
    the per-line parser for non-tabular records."""
    import io

    db = seqdb.SeqDB.open(path)
    # the flat body is in PHYSICAL record order; slice in that order, then
    # emit the dict in id order (the original iteration order)
    order = np.asarray(seqdb.data_order(db))
    counts = _record_line_counts(db, order)
    body = db.data.tobytes().replace(b"\x00", b"")
    try:
        arr = np.loadtxt(io.BytesIO(body), delimiter="\t",
                         usecols=range(10), ndmin=2) if body.strip() \
            else np.zeros((0, 10))
        if arr.shape[0] != int(counts.sum()):
            raise ValueError("line count mismatch")
    except Exception:
        return _load_alignments_slow(db)
    rec = np.zeros(arr.shape[0], dtype=RESULT_DTYPE)
    rec["dbKey"] = arr[:, 0]
    rec["score"] = arr[:, 1]
    rec["seqId"] = arr[:, 2]
    rec["eval"] = arr[:, 3]
    rec["alnLength"] = arr[:, 5] - arr[:, 4] + 1
    rec["qStartPos"] = arr[:, 4]
    rec["qEndPos"] = arr[:, 5]
    rec["qLen"] = arr[:, 6]
    rec["dbStartPos"] = arr[:, 7]
    rec["dbEndPos"] = arr[:, 8]
    rec["dbLen"] = arr[:, 9]
    parts = np.split(rec, np.cumsum(counts)[:-1])
    by_id = {int(i): part for i, part in zip(order, parts)}
    return {int(db.keys[i]): by_id[i] for i in range(db.size)}


def _load_alignments_slow(db):
    out = {}
    for i in range(db.size):
        key = int(db.keys[i])
        rows = []
        for line in db.get_data(i).tobytes().decode().strip().split("\n"):
            if not line:
                continue
            f = line.split("\t")
            rows.append((int(f[0]), int(f[1]), 0.0, 0.0, float(f[2]), float(f[3]),
                         int(f[5]) - int(f[4]) + 1, int(f[4]), int(f[5]), int(f[6]),
                         int(f[7]), int(f[8]), int(f[9])))
        out[key] = np.array(rows, dtype=RESULT_DTYPE)
    return out


def load_prefilter(path):
    """Parse a prefilter DB into {query_key: [(target, score, diag), ...]};
    diagonals are short-cast on disk and recovered by the rescorer's
    +-65536 scan. Dict insertion order is the prefilter DB's DATA order
    (Alignment opens it LINEAR_ACCCESS, Alignment.cpp:93) — writers that
    must match the reference's physical record order iterate this dict."""
    import io

    db = seqdb.SeqDB.open(path)
    order = np.asarray(seqdb.data_order(db))
    counts = _record_line_counts(db, order)
    body = db.data.tobytes().replace(b"\x00", b"")
    try:
        arr = np.loadtxt(io.BytesIO(body), delimiter="\t",
                         usecols=range(3), dtype=np.int64,
                         ndmin=2) if body.strip() else np.zeros((0, 3),
                                                               dtype=np.int64)
        if arr.shape[0] != int(counts.sum()):
            raise ValueError("line count mismatch")
        trip = list(zip(arr[:, 0].tolist(), arr[:, 1].tolist(),
                        arr[:, 2].tolist()))
        bounds = np.concatenate([[0], np.cumsum(counts)])
        return {int(db.keys[i]): trip[bounds[j]: bounds[j + 1]]
                for j, i in enumerate(order)}
    except Exception:
        pass
    out = {}
    for i in order:
        i = int(i)
        key = int(db.keys[i])
        hits = []
        for line in db.get_data(i).tobytes().decode().strip().split("\n"):
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) >= 3:
                hits.append((int(cols[0]), int(cols[1]), int(cols[2])))
            else:
                # cluster-format / key-only result lines (Alignment only
                # reads the first column, Alignment.cpp parseKey)
                hits.append((int(cols[0].split(" ")[0]), 0, 0))
        out[key] = hits
    return out


def load_alignments_with_backtrace(path):
    """Parse an alignment DB (with backtrace column) into
    {query_key: [record dict]}."""
    db = seqdb.SeqDB.open(path)
    out = {}
    for i in range(db.size):
        key = int(db.keys[i])
        rows = []
        for line in db.get_data(i).tobytes().decode().strip().split("\n"):
            if not line:
                continue
            f = line.split("\t")
            rows.append({"dbKey": int(f[0]), "score": int(f[1]),
                         "seqId": float(f[2]), "eval": float(f[3]),
                         "qStartPos": int(f[4]), "qEndPos": int(f[5]),
                         "qLen": int(f[6]), "dbStartPos": int(f[7]),
                         "dbEndPos": int(f[8]), "dbLen": int(f[9]),
                         "backtrace": f[10] if len(f) > 10 else ""})
        out[key] = rows
    return out


def _createdb(positional, space, stats):
    from ..data.createdb import create_db, write_lookup, write_source
    if len(positional) < 2:
        raise ValueError("usage: createdb <i:fastaFile1> ... <o:seqDB>")
    sdb, hdb = create_db(positional[:-1])
    sdb.save(positional[-1])
    hdb.save(positional[-1] + "_h")
    write_lookup(positional[-1], sdb.lookup_entries)
    write_source(positional[-1], sdb.source_names)
    return 0


def _kmermatcher(positional, space, stats):
    from ..ops.kmermatch import kmermatcher, hits_to_db
    if len(positional) != 2:
        raise ValueError("usage: kmermatcher <i:seqDB> <o:prefDB>")
    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    k = v["kmer_size"].nucleotides if is_nucl else v["kmer_size"].aminoacids
    scale = (v["kmers_per_sequence_scale"].nucleotides if is_nucl
             else v["kmers_per_sequence_scale"].aminoacids)
    hits = kmermatcher(db, k, kmers_per_sequence=v["kmers_per_sequence"],
                       kmers_per_sequence_scale=scale, hash_shift=v["hash_shift"],
                       ignore_multi_kmer=v["ignore_multi_kmer"],
                       include_only_extendable=v["include_only_extendable"],
                       cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
                       split_memory_limit=v.get("split_memory_limit", "0"))
    hits_to_db(hits, is_nucl).save(positional[1])
    return 0


def _rescorediagonal(positional, space, stats):
    from ..ops.rescore import (RESCORE_HAMMING, RescoreParams,
                               rescore_diagonal, results_to_db)
    if len(positional) != 4:
        raise ValueError("usage: rescorediagonal <i:qDB> <i:tDB> <i:prefDB> <o:alnDB>")
    db = seqdb.SeqDB.open(positional[0])
    pref = seqdb.SeqDB.open(positional[2])
    hits = load_prefilter(positional[2])
    v = space.values
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    rp = RescoreParams(
        rescore_mode=v["rescore_mode"],
        seq_id_thr=(v["min_seq_id"].nucleotides if is_nucl else v["min_seq_id"].aminoacids),
        cov_thr=v["cov_thr"], cov_mode=v["cov_mode"], eval_thr=v["eval_thr"],
        aln_len_thr=(v["min_aln_len"].nucleotides if is_nucl else v["min_aln_len"].aminoacids),
        seq_id_mode=v["seq_id_mode"], add_backtrace=v["add_backtrace"],
        sort_results=v["sort_results"],
        wrapped_scoring=v.get("wrapped_scoring", False))
    alns = rescore_diagonal(db, hits, rp)
    if rp.rescore_mode == RESCORE_HAMMING:
        # short prefilter-format output, dbtype follows input prefilter
        w = seqdb.DBWriter(pref.dbtype)
        for k in sorted(alns):
            lines = "".join(f"{t}\t{s}\t{((d & 0xFFFF) ^ 0x8000) - 0x8000}\n"
                            for (t, s, d) in alns[k])
            w.write(k, lines.encode(), add_newline=False)
        w.finish().save(positional[3])
    else:
        results_to_db(alns, add_backtrace=rp.add_backtrace).save(positional[3])
    return 0


def _align(positional, space, stats):
    from ..ops.nucl_align import align_nucl, align_results_to_db
    if len(positional) != 4:
        raise ValueError("usage: align <i:qDB> <i:tDB> <i:prefDB> <o:alnDB>")
    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    if db.dbtype != seqdb.NUCLEOTIDES:
        from ..ops.protein_align import (align_protein,
                                         protein_align_results_to_db)
        same = (os.path.realpath(positional[0])
                == os.path.realpath(positional[1]))
        tdb = None if same else seqdb.SeqDB.open(positional[1])
        hits = load_prefilter(positional[2])
        res = align_protein(
            db, hits, seq_id_thr=(v["min_seq_id"].aminoacids
                                  if space_was_set(space, "min_seq_id") else 0.0),
            cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
            eval_thr=v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3,
            aln_len_thr=(v["min_aln_len"].aminoacids
                         if space_was_set(space, "min_aln_len") else 0),
            gap_open=v["gap_open"] if space_was_set(space, "gap_open") else 11,
            gap_extend=v["gap_extend"] if space_was_set(space, "gap_extend") else 1,
            tdb=tdb, alignment_mode=v.get("alignment_mode", 0),
            add_backtrace=v["add_backtrace"],
            seq_id_mode=v["seq_id_mode"],
            realign=bool(v.get("realign", False)),
            comp_bias_corr=bool(v.get("comp_bias_corr", 1)),
            max_accept=v.get("max_accept", 2**31 - 1),
            max_reject=v.get("max_rejected", 2**31 - 1),
            device=v["device"], counts=stats.setdefault("pairs", {}))
        if v.get("alignment_output_mode", 0) == 1:
            # ALIGNMENT_OUTPUT_CLUSTER (Alignment.cpp:255-259,506-511):
            # target keys only, CLUSTER_RES dbtype
            w = seqdb.DBWriter(seqdb.CLUSTER_RES)
            for key in hits:
                body = "".join(f"{r['dbKey']}\n" for r in res[key])
                w.write(key, body.encode(), add_newline=False)
            w.finish().save(positional[3])
            return 0
        protein_align_results_to_db(
            res, add_backtrace=v["add_backtrace"]
            or bool(v.get("realign", False)),
            key_order=list(hits)).save(positional[3])
        return 0
    hits = load_prefilter(positional[2])
    res = align_nucl(db, hits, seq_id_thr=v["min_seq_id"].nucleotides,
                     cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
                     eval_thr=v["eval_thr"],
                     aln_len_thr=v["min_aln_len"].nucleotides,
                     seq_id_mode=v["seq_id_mode"], gapo=v.get("gap_open", 5),
                     gape=v.get("gap_extend", 2), zdrop=v.get("zdrop", 200),
                     wrapped_scoring=v.get("wrapped_scoring", False))
    align_results_to_db(res).save(positional[3])
    return 0


def space_was_set(space, attr):
    return attr in space.was_set


def _lcaalign(positional, space, stats):
    """lcaalign (alignment/Main.cpp:34-52): approximate-2bLCA alignment;
    protein DBs only (the taxonomy workflow falls back to top-hit for
    nucl-nucl searches, Taxonomy.cpp:78-82)."""
    from ..ops.protein_align import (lca_align_protein,
                                     protein_align_results_to_db)
    if len(positional) != 4:
        raise ValueError("usage: lcaalign <i:qDB> <i:tDB> <i:prefDB> <o:alnDB>")
    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    same = (os.path.realpath(positional[0])
            == os.path.realpath(positional[1]))
    tdb = None if same else seqdb.SeqDB.open(positional[1])
    hits = load_prefilter(positional[2])
    res = lca_align_protein(
        db, hits, tdb=tdb,
        alignment_mode=v.get("alignment_mode", 0),
        cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
        seq_id_thr=(v["min_seq_id"].aminoacids
                    if space_was_set(space, "min_seq_id") else 0.0),
        eval_thr=v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3,
        aln_len_thr=(v["min_aln_len"].aminoacids
                     if space_was_set(space, "min_aln_len") else 0),
        gap_open=v["gap_open"] if space_was_set(space, "gap_open") else 11,
        gap_extend=v["gap_extend"] if space_was_set(space, "gap_extend") else 1,
        max_accept=v["max_accept"], max_reject=v["max_rejected"],
        seq_id_mode=v["seq_id_mode"])
    protein_align_results_to_db(res, key_order=list(hits)).save(positional[3])
    return 0


def _prefilter(positional, space, stats):
    from ..ops import prefilter as pf
    if len(positional) != 3:
        raise ValueError("usage: prefilter <i:qDB> <i:tDB> <o:prefDB>")
    qdb = seqdb.SeqDB.open(positional[0])
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    tdb = qdb if same else seqdb.SeqDB.open(positional[1])
    v = space.values
    p = pf.PrefilterParams(
        sensitivity=v["sensitivity"], kmer_size=v["search_kmer_size"],
        max_seqs=v["max_seqs"], min_ungapped_score=v["min_ungapped_score"],
        comp_bias_corr=bool(v["comp_bias_corr"]), mask=v["search_mask"],
        spaced_kmer=bool(v["search_spaced_kmer"]),
        exact_kmer_matching=bool(v["exact_kmer_matching"]),
        add_self_matches=v["add_self_matches"],
        cov_thr=v.get("cov_thr", 0.0), cov_mode=v.get("cov_mode", 0))
    hits = pf.prefilter(qdb, tdb, p, same_db=same)
    qorder = [int(qdb.keys[i]) for i in
              np.argsort(qdb.offsets, kind="stable")]
    pf.prefilter_to_db(hits, qorder).save(positional[2])
    return 0


def _search(positional, space, stats):
    from ..workflow.search import SearchParams, run_search
    if len(positional) != 4:
        raise ValueError("usage: search <i:qDB> <i:tDB> <o:alnDB> <tmpDir>")
    v = space.values
    if seqdb.read_dbtype(positional[1]) == seqdb.HMM_PROFILE:
        if v.get("exhaustive_search", False):
            return _search_sliced_profile(positional, space, stats)
        return _search_targetprofile(positional, space, stats)
    if space_was_set(space, "num_iterations"):
        it = v["num_iterations"]
        it = it.aminoacids if isinstance(it, P.MultiParam) else it
        if it > 1:
            return _search_iterative(positional, space, stats, it)
    sens = v["sensitivity"] if space_was_set(space, "sensitivity") else 5.7
    p = SearchParams(
        sensitivity=sens, kmer_size=v["search_kmer_size"],
        max_seqs=v["max_seqs"], min_ungapped_score=v["min_ungapped_score"],
        comp_bias_corr=bool(v["comp_bias_corr"]), mask=v["search_mask"],
        spaced_kmer=bool(v["search_spaced_kmer"]),
        exact_kmer_matching=bool(v["exact_kmer_matching"]),
        start_sens=v["start_sens"], sens_steps=v["sens_steps"],
        # setSearchDefaults (Search.cpp:22): SCORE_COV unless the user
        # set a mode (-a still upgrades to SCORE_COV_SEQID in align)
        alignment_mode=(v["alignment_mode"]
                        if space_was_set(space, "alignment_mode") else 2),
        add_backtrace=v["add_backtrace"],
        eval_thr=v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3,
        seq_id_thr=(v["min_seq_id"].aminoacids
                    if space_was_set(space, "min_seq_id") else 0.0),
        cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
        aln_len_thr=(v["min_aln_len"].aminoacids
                     if space_was_set(space, "min_aln_len") else 0),
        seq_id_mode=v["seq_id_mode"],
        gap_open=v["gap_open"] if space_was_set(space, "gap_open") else 11,
        gap_extend=v["gap_extend"] if space_was_set(space, "gap_extend") else 1,
        max_accept=v["max_accept"], max_reject=v["max_rejected"],
        remove_tmp=v["remove_tmp_files"],
        lca_search=bool(v.get("lca_search", False)))
    qdb = positional[0]
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    q = seqdb.SeqDB.open(qdb)
    t = q if same else seqdb.SeqDB.open(positional[1])
    run_search(q, t, positional[2], positional[3], p,
               tdb_path=positional[1], device=v["device"],
               seconds=stats.setdefault("seconds", {}),
               counts=stats.setdefault("pairs", {}))
    return 0


def _invoke(name, args, device, stats, step=None):
    """Run another registered command in-process on `device` (the
    reference shells back into the same binary via $MMSEQS,
    CommandCaller.cpp:69-89). Its wall seconds are added to
    stats["seconds"] under its name, and the aligner's pair counts it
    reports to stats["pairs"] under theirs; with a `step`, each name ends
    in "_<step>"."""
    from ..utils.device import pick_device, stage_timer
    from .plass import commands
    cmd = next(c for c in commands() if c.name == name)
    space = cmd.params_fn()
    positional = space.parse_args([str(a) for a in args]
                                  + ["--device", str(device)])
    suffix = "" if step is None else f"_{step}"
    timed = stage_timer(pick_device(device), stats.setdefault("seconds", {}))
    sub = {}
    with timed(name + suffix):
        rc = cmd.fn(positional, space, sub)
    pairs = stats.setdefault("pairs", {})
    for key, n in sub.get("pairs", {}).items():
        pairs[key + suffix] = pairs.get(key + suffix, 0) + n
    if rc not in (0, None):
        raise ValueError(f"{name} step failed")


def _swap_cov_mode(cov_mode):
    """Util::swapCoverageMode (Util.cpp:569-585)."""
    return {0: 0, 1: 2, 2: 1, 3: 4, 4: 3, 5: 5}.get(cov_mode, cov_mode)


def _search_targetprofile(positional, space, stats):
    """Default search against target profiles (Search.cpp:352-363 +
    data/workflow/searchtargetprofile.sh): profile-target prefilter
    (k-mer 5 unless set, Search.cpp:250-252), swap, profile-query
    alignment with the swapped coverage mode, swap back."""
    v = space.values
    query, target, out, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    if os.path.exists(out + ".dbtype"):
        raise ValueError(f"{out}.dbtype exists already!")
    eval_thr = v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3
    cov_mode = _swap_cov_mode(v.get("cov_mode", 0))
    sens = v["sensitivity"] if space_was_set(space, "sensitivity") else 5.7
    kmer = v["search_kmer_size"] \
        if space_was_set(space, "search_kmer_size") else 5

    def t(name):
        return os.path.join(tmp, name)

    def run(name, args):
        _invoke(name, args, v["device"], stats)

    if not os.path.exists(t("pref") + ".dbtype"):
        run("prefilter", [query, target, t("pref"), "-s", sens,
                          "-k", kmer, "--max-seqs", v["max_seqs"],
                          "--cov-mode", v.get("cov_mode", 0),
                          "-c", v.get("cov_thr", 0.0)])
    if not os.path.exists(t("pref_swapped") + ".dbtype"):
        run("swapresults", [query, target, t("pref"),
                            t("pref_swapped"), "-e", eval_thr])
    aln_mode = v["alignment_mode"] if space_was_set(space,
                                                    "alignment_mode") else 2
    if not os.path.exists(t("aln_swapped") + ".dbtype"):
        aln_args = [target, query, t("pref_swapped"), t("aln_swapped"),
                    "-e", eval_thr, "--cov-mode", cov_mode,
                    "-c", v.get("cov_thr", 0.0),
                    "--alignment-mode", aln_mode]
        if v.get("add_backtrace"):
            aln_args += ["-a"]
        run("align", aln_args)
    run("swapresults", [target, query, t("aln_swapped"), out,
                        "-e", eval_thr])
    if v.get("remove_tmp_files"):
        for name in ("pref", "pref_swapped", "aln_swapped"):
            run("rmdb", [t(name)])
    return 0


def _search_sliced_profile(positional, space, stats):
    """Exhaustive search against target profiles (Search.cpp:317-352 +
    data/workflow/searchslicedtargetprofile.sh, single slice): the
    PROFILES run as queries against the sequence DB, then results are
    swapped back. E-values are corrected for the inverted search by
    |queries| / |targets|."""
    v = space.values
    query, target, out, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    if os.path.exists(out + ".dbtype"):
        raise ValueError(f"{out}.dbtype exists already!")
    qsize = sum(1 for _ in open(query + ".index"))
    tsize = sum(1 for _ in open(target + ".index"))
    eval_thr = v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3
    eval_corr = eval_thr * (np.float32(qsize) / np.float32(tsize))
    cov_mode = _swap_cov_mode(v.get("cov_mode", 0))
    sens = v["sensitivity"] if space_was_set(space, "sensitivity") else 5.7

    def t(name):
        return os.path.join(tmp, name)

    def run(name, args):
        _invoke(name, args, v["device"], stats)

    if not os.path.exists(t("pref") + ".dbtype"):
        run("prefilter", [target, query, t("pref"), "-s", sens,
                          "--max-seqs", max(300, qsize),
                          "--cov-mode", cov_mode,
                          "-c", v.get("cov_thr", 0.0)])
    aln_mode = v["alignment_mode"] if space_was_set(space,
                                                    "alignment_mode") else 2
    if not os.path.exists(t("aln_merged") + ".dbtype"):
        run("align", [target, query, t("pref"), t("aln_merged"),
                      "-e", eval_corr, "--cov-mode", cov_mode,
                      "-c", v.get("cov_thr", 0.0),
                      "--alignment-mode", aln_mode,
                      "--alignment-output-mode", 1])
    if v.get("exhaustive_search_filter", 0) == 1 and \
            not os.path.exists(t("aln_filt") + ".dbtype"):
        run("filterresult", [target, query, t("aln_merged"), t("aln_filt")])
        run("rmdb", [t("aln_merged")])
        run("mvdb", [t("aln_filt"), t("aln_merged")])
    if not os.path.exists(t("aln") + ".dbtype"):
        aln_args = [target, query, t("aln_merged"), t("aln"),
                    "-e", eval_corr, "--cov-mode", cov_mode,
                    "-c", v.get("cov_thr", 0.0),
                    "--alignment-mode", aln_mode]
        if v.get("add_backtrace"):
            aln_args += ["-a"]
        run("align", aln_args)
    run("swapresults", [target, query, t("aln"), out,
                        "-e", 1.7976931348623157e+308])
    return 0


def _search_iterative(positional, space, stats, num_it):
    """Iterative profile search (Search.cpp:371-410 +
    data/workflow/blastpgp.sh): prefilter -> [subtract prev aln] -> align
    (realign on iteration 0) -> merge -> result2profile -> repeat with the
    profile DB as query. Each step's seconds go to stats["seconds"] and
    its pair counts to stats["pairs"] under the stage's name and the
    step's number ("align_0", "candidate_pairs_0", ...)."""
    v = space.values
    query, target, out, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    if os.path.exists(out + ".dbtype"):
        raise ValueError(f"{out}.dbtype exists already!")
    eval_real = v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3
    eval_profile = min(eval_real, v.get("eval_profile", 0.1))
    sens = v["sensitivity"] if space_was_set(space, "sensitivity") else 5.7

    def t(name):
        return os.path.join(tmp, name)

    qdb = query
    for step in range(num_it):
        def run(name, args):
            _invoke(name, args, v["device"], stats, step)

        ev = eval_real if step == num_it - 1 else eval_profile
        pref = t(f"pref_{step}")
        raw_pref = pref if step == 0 else t(f"pref_tmp_{step}")
        if not os.path.exists(raw_pref + ".dbtype"):
            run("prefilter", [qdb, target, raw_pref, "-s", sens])
        if step >= 1 and not os.path.exists(pref + ".dbtype"):
            run("subtractdbs", [raw_pref, t(f"aln_{step - 1}"), pref,
                                "--e-profile", eval_profile,
                                "-e", eval_profile])
        aln = t(f"aln_{step}")
        raw_aln = aln if step == 0 else t(f"aln_tmp_{step}")
        if not os.path.exists(raw_aln + ".dbtype"):
            # iterative search always adds backtraces (Search.cpp:275)
            aln_args = [qdb, target, pref, raw_aln, "-e", ev, "-a",
                        "--alignment-mode",
                        v["alignment_mode"]
                        if space_was_set(space, "alignment_mode") else 2]
            if step == 0:
                aln_args += ["--realign"]
            run("align", aln_args)
        if step > 0:
            dst = out if step == num_it - 1 else aln
            if not os.path.exists(dst + ".dbtype"):
                run("mergedbs", [qdb, dst, t(f"aln_{step - 1}"), raw_aln])
        if step != num_it - 1:
            profdb = t(f"profile_{step}")
            if not os.path.exists(profdb + ".dbtype"):
                run("result2profile", [qdb, target, aln, profdb,
                                       "-e", eval_profile])
            qdb = profdb
    return 0


def _parse_cigar(bt):
    """Expand a compressed cigar; returns (aln_len, match_count, gap_opens)
    (convertalignments.cpp:410-446)."""
    aln_len = 0
    match_count = 0
    gap_opens = 0
    i = 0
    while i < len(bt):
        cnt = 0
        while i < len(bt) and bt[i].isdigit():
            cnt = cnt * 10 + int(bt[i])
            i += 1
        cnt = max(cnt, 1)
        op = bt[i]
        i += 1
        aln_len += cnt
        if op == "M":
            match_count += cnt
        else:
            gap_opens += 1
    return aln_len, match_count, gap_opens


def _convertalis(positional, space, stats):
    """BLAST-tab output (convertalignments.cpp FORMAT_ALIGNMENT_BLAST_TAB
    default column set)."""
    from ..data.headers import parse_fasta_header
    if len(positional) != 4:
        raise ValueError(
            "usage: convertalis <i:qDB> <i:tDB> <i:alnDB> <o:tsv>")
    qh = seqdb.SeqDB.open(positional[0] + "_h")
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    th = qh if same else seqdb.SeqDB.open(positional[1] + "_h")
    aln = seqdb.SeqDB.open(positional[2])
    qnames = {int(qh.keys[i]): parse_fasta_header(
        qh.get_data(i).tobytes().decode().strip()) for i in range(qh.size)}
    tnames = {int(th.keys[i]): parse_fasta_header(
        th.get_data(i).tobytes().decode().strip()) for i in range(th.size)}
    with open(positional[3], "w") as out:
        for i in sorted(range(aln.size), key=lambda j: int(aln.offsets[j])):
            qkey = int(aln.keys[i])
            for line in aln.get_data(i).tobytes().decode().splitlines():
                if not line:
                    continue
                f = line.split("\t")
                tkey, score, seq_id, evalue = (int(f[0]), int(f[1]),
                                               float(f[2]), float(f[3]))
                qs, qe, ql, ts, te, tl = (int(f[4]), int(f[5]), int(f[6]),
                                          int(f[7]), int(f[8]), int(f[9]))
                if len(f) > 10 and f[10]:
                    aln_len, match_count, gap_opens = _parse_cigar(f[10])
                    identical = int(seq_id * aln_len + 0.5)
                    mismatch = match_count - identical
                else:
                    # parseAlignmentRecord adjusts -1 (score-only) starts
                    # to 0 before computing the length (Matcher.cpp:257-261)
                    aqs, ats = max(qs, 0), max(ts, 0)
                    aln_len = max(abs(qe - aqs), abs(te - ats)) + 1
                    gap_opens = 0
                    best = float(min(abs(qe - aqs), abs(te - ats)))
                    mismatch = int(best * (1.0 - seq_id) + 0.5)
                out.write(
                    f"{qnames[qkey]}\t{tnames[tkey]}\t{seq_id:1.3f}\t"
                    f"{aln_len}\t{mismatch}\t{gap_opens}\t{qs + 1}\t"
                    f"{qe + 1}\t{ts + 1}\t{te + 1}\t{evalue:.3E}\t"
                    f"{score}\n")
    return 0


def _easy_search(positional, space, stats):
    """easy-search: createdb both inputs -> search -> convertalis
    (reference: lib/mmseqs/data/workflow/easysearch.sh)."""
    from ..data.createdb import create_db
    if len(positional) != 4:
        raise ValueError(
            "usage: easy-search <i:queryFasta> <i:targetFasta> <o:tsv> <tmpDir>")
    # setEasySearchDefaults (EasySearch.cpp:18,27): SCORE_COV_SEQID
    if "alignment_mode" not in space.was_set:
        space.values["alignment_mode"] = 3
        space.was_set.add("alignment_mode")
    tmp = positional[3]
    os.makedirs(tmp, exist_ok=True)
    qpath = os.path.join(tmp, "query")
    tpath = os.path.join(tmp, "target")
    for fasta, path in ((positional[0], qpath), (positional[1], tpath)):
        if not os.path.exists(path + ".dbtype"):
            sdb, hdb = create_db([fasta])
            sdb.save(path)
            hdb.save(path + "_h")
    _search([qpath, tpath, os.path.join(tmp, "result"),
             os.path.join(tmp, "search_tmp")], space, stats)
    return _convertalis([qpath, tpath, os.path.join(tmp, "result"),
                         positional[2]], space, stats)


def _clust(positional, space, stats):
    from ..assembler.cluster import greedy_incremental_cluster, clusters_to_db
    if len(positional) != 3:
        raise ValueError("usage: clust <i:seqDB> <i:alnDB> <o:cluDB>")
    db = seqdb.SeqDB.open(positional[0])
    aln = seqdb.SeqDB.open(positional[1])
    targets = {}
    for i in range(aln.size):
        key = int(aln.keys[i])
        body = aln.get_data(i).tobytes().decode()
        targets[key] = [int(ln.split("\t", 1)[0].split(" ", 1)[0])
                        for ln in body.splitlines() if ln]
    clusters_to_db(greedy_incremental_cluster(db, targets)).save(positional[2])
    return 0


def _mergeclusters(positional, space, stats):
    from ..assembler.cluster import (db_to_clusters, merge_clusters,
                                     merged_clusters_to_db)
    if len(positional) < 3:
        raise ValueError("usage: mergeclusters <i:seqDB> <o:cluDB> <i:clu1> ...")
    db = seqdb.SeqDB.open(positional[0])
    steps = [db_to_clusters(seqdb.SeqDB.open(p)) for p in positional[2:]]
    merged_clusters_to_db(merge_clusters(db, steps)).save(positional[1])
    return 0


def _result2repseq(positional, space, stats):
    from ..assembler.cluster import result2repseq
    if len(positional) != 3:
        raise ValueError("usage: result2repseq <i:seqDB> <i:resultDB> <o:seqDB>")
    db = seqdb.SeqDB.open(positional[0])
    res = seqdb.SeqDB.open(positional[1])
    result2repseq(db, res).save(positional[2])
    return 0


_STRTOD_RE = re.compile(
    r"^[ \t]*[+-]?(?:inf(?:inity)?|nan|0[xX][0-9a-fA-F]+"
    r"|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)", re.IGNORECASE)


def _strtod(tok):
    """C strtod: parse the longest numeric prefix; None when nothing parses.

    Hex literals are tried before decimals so '0x1A' binds 26.0, not the
    '0' prefix; a finite-looking literal that overflows to inf is treated
    as unparseable, matching the ERANGE path (filterdb.cpp:330 keeps the
    stale variable value in that case)."""
    m = _STRTOD_RE.match(tok)
    if not m:
        return None
    s = m.group(0).strip()
    try:
        val = float.fromhex(s) if "x" in s.lower() else float(s)
    except ValueError:
        return None
    if val in (float("inf"), float("-inf")) and "inf" not in s.lower():
        return None
    return val


def _filterdb(positional, space, stats):
    """filterdb.cpp: per-record line filtering — by key file, by numeric
    comparison on a column, sorting entries, extracting the first N
    lines, or keeping lines that tie the first line (--beats-first)."""
    if len(positional) != 2:
        raise ValueError("usage: filterdb <i:db> <o:db> [mode flags]")
    v = space.values
    path = v.get("filter_file", "")
    db = seqdb.SeqDB.open(positional[0])
    # mode precedence mirrors filterdb.cpp:117-215: sort-entries wins over
    # everything, then file filtering, then the elif chain below
    if path and not v.get("sort_entries", 0):
        # FILE_FILTERING (filterdb.cpp:120-176,389-406): the filter set is
        # the first column of every line in the file (or a DB's data file,
        # NUL bytes skipped); string membership on the filter column;
        # --positive-filter 0 drops matching lines instead
        positive = v.get("positive_filter", True)
        fcol = v.get("filter_column", 1) - 1
        filt = set()
        with open(path, "rb") as fh:
            for raw_line in fh.read().split(b"\n"):
                raw_line = raw_line.replace(b"\x00", b"")
                if not raw_line:
                    continue
                tok = raw_line.split(b"\t")[0].split(b" ")[0]
                if tok:
                    filt.add(tok.decode())
        w = seqdb.DBWriter(db.dbtype)
        for i in seqdb.data_order(db):
            body = db.get_data(i).tobytes().decode()
            kept = []
            for ln in body.split("\n"):
                if not ln:
                    continue
                cols = ln.split("\t")
                val = cols[fcol] if fcol < len(cols) else ""
                found = val in filt
                if found == bool(positive):
                    kept.append(ln)
            w.write(int(db.keys[i]),
                    ("\n".join(kept) + "\n").encode() if kept else b"",
                    add_newline=False)
        w.finish().save(positional[1])
        return 0
    col = v.get("filter_column", 1) - 1
    op = v.get("comparison_operator", "")
    comp_value = v.get("comparison_value", 0.0)
    sort_entries = v.get("sort_entries", 0)
    extract_lines = v.get("extract_lines", 0)
    beats_first = v.get("beats_first", False)
    regex = v.get("filter_regex", "")
    mapping_file = v.get("mapping_file", "")
    trim = v.get("trim_to_one_column", False)
    expr_text = v.get("filter_expression", "")
    expression = None
    if expr_text:
        # EXPRESSION_FILTERING (filterdb.cpp:207-208,247-255,326-341)
        from ..utils.expr import Expression, ExprError
        try:
            expression = Expression(expr_text)
        except ExprError:
            logger.info(f"Error in expression {expr_text}")
            raise
    mapping = {}
    if mapping_file:
        for line in open(mapping_file):
            parts = line.split()
            if len(parts) >= 2:
                mapping.setdefault(parts[0], []).append(parts[1])
    w = seqdb.DBWriter(db.dbtype)
    for i in seqdb.data_order(db):
        lines = [l for l in db.get_data(i).tobytes().decode().splitlines()
                 if l]
        out = []
        if sort_entries:
            vals = [float(l.split("\t")[col]) for l in lines]
            order = sorted(range(len(lines)), key=lambda j: vals[j],
                           reverse=(sort_entries == 2))
            out = [lines[j] for j in order]
        elif mapping_file:
            # FILE_MAPPING (filterdb.cpp:407-452): replace the filter
            # column with each mapped value; unmapped lines are dropped
            for l in lines:
                cols = l.split("\t")
                for val in mapping.get(cols[0 if col < 0 else col].split()[0],
                                       ()):
                    out.append("\t".join(cols[:col] + [val]
                                          + cols[col + 1:]))
        elif extract_lines > 0:
            out = lines[:extract_lines]
        elif beats_first:
            ref = None
            for n, l in enumerate(lines):
                val = float(l.split("\t")[col])
                if n == 0:
                    ref = val
                    out.append(l)
                elif ((op == "ge" and val >= ref)
                      or (op == "le" and val <= ref)
                      or (op == "e" and val == ref)):
                    out.append(l)
        elif op:
            for l in lines:
                val = float(l.split("\t")[col])
                if ((op == "ge" and val >= comp_value)
                        or (op == "le" and val <= comp_value)
                        or (op == "e" and val == comp_value)):
                    out.append(l)
        elif expression is not None:
            # bind each referenced column ($N = 0-based word N-1) via
            # strtod-prefix parsing; unparseable columns keep the stale
            # variable value, exactly like filterdb.cpp:328-336
            for l in lines:
                words = l.split()
                for ci in expression.bindable:
                    if ci < len(words):
                        val = _strtod(words[ci])
                        if val is None:
                            logger.warning(f"Can not parse column {ci}!")
                            continue
                        expression.bind(ci, val)
                    else:
                        logger.warning(f"Can not parse column {ci}!")
                if expression.evaluate() != 0:
                    out.append(l)
        elif regex:
            # REGEX_FILTERING is the reference's fallback mode, ranked
            # below expression filtering (filterdb.cpp:207-215)
            import re as _re
            pat = _re.compile(regex)
            for l in lines:
                cols = l.split("\t")
                if pat.search(cols[col]):
                    out.append(cols[col] if trim else l)
        else:
            out = lines
        if trim and not regex and not mapping_file:
            # --trim-to-one-column applies to every mode's kept lines
            # (filterdb.cpp:282-294,467-470)
            out = [l.split("\t")[col].split(" ")[0] for l in out]
        w.write(int(db.keys[i]),
                "".join(l + "\n" for l in out).encode(),
                add_newline=False)
    w.finish().save(positional[1])
    return 0


def _concatdbs(positional, space, stats):
    if len(positional) != 3:
        raise ValueError("usage: concatdbs <i:db1> <i:db2> <o:db>")
    v = space.values
    a = seqdb.SeqDB.open(positional[0])
    b = seqdb.SeqDB.open(positional[1])
    take_larger = v.get("take_larger_entry", False)
    if v.get("preserve_keys", False):
        if take_larger:
            # DBConcat take-larger (DBConcat.cpp:81-132): A's record wins
            # ties; record sizes compared incl. terminators
            bkey2id = {int(b.keys[j]): j for j in range(b.size)}
            akey2id = {int(a.keys[j]): j for j in range(a.size)}
            w = seqdb.DBWriter(a.dbtype)
            for i in range(a.size):
                key = int(a.keys[i])
                lb = int(b.lengths[bkey2id[key]]) if key in bkey2id else 0
                if int(a.lengths[i]) >= lb:
                    w.write(key, a.get_data(i).tobytes(), add_newline=False)
            for j in range(b.size):
                key = int(b.keys[j])
                la = int(a.lengths[akey2id[key]]) if key in akey2id else 0
                if int(b.lengths[j]) > la:
                    w.write(key, b.get_data(j).tobytes(), add_newline=False)
            w.finish().save(positional[2])
        else:
            seqdb.concat_preserve_keys(a, b).save(positional[2])
    else:
        seqdb.concat(a, b).save(positional[2])
    return 0


def _createsubdb(positional, space, stats):
    if len(positional) != 3:
        raise ValueError("usage: createsubdb <i:subsetFile> <i:db> <o:db>")
    keys = [int(line.split()[0]) for line in open(positional[0]) if line.strip()]
    db = seqdb.SeqDB.open(positional[1])
    seqdb.subdb(db, keys).save(positional[2])
    return 0


def _convert2fasta(positional, space, stats):
    if len(positional) != 2:
        raise ValueError("usage: convert2fasta <i:seqDB> <o:fasta>")
    db = seqdb.SeqDB.open(positional[0])
    hdr_path = positional[0] + "_h"
    headers = None
    if os.path.exists(hdr_path + ".dbtype"):
        headers = seqdb.SeqDB.open(hdr_path)
    with open(positional[1], "w") as f:
        for i in range(db.size):
            if headers is not None:
                h = headers.get_seq_bytes(headers.key_to_id(int(db.keys[i]))).decode()
            else:
                h = str(int(db.keys[i]))
            f.write(f">{h}\n{db.get_seq_bytes(i).decode()}\n")
    return 0


def _rmdb(positional, space, stats):
    for name in positional:
        for suffix in ("", ".index", ".dbtype"):
            if os.path.exists(name + suffix):
                os.unlink(name + suffix)
    return 0


def _mvdb(positional, space, stats):
    from ..data.dbtools import mvdb
    mvdb(positional[0], positional[1])
    return 0


def _cpdb(positional, space, stats):
    from ..data.dbtools import cpdb
    cpdb(positional[0], positional[1])
    return 0


def _lndb(positional, space, stats):
    from ..data.dbtools import lndb
    lndb(positional[0], positional[1])
    return 0


def _sortresult(positional, space, stats):
    from ..data.dbtools import sort_result_db
    sort_result_db(seqdb.SeqDB.open(positional[0])).save(positional[1])
    return 0


def _swapresults(positional, space, stats):
    from ..data.dbtools import swap_results
    if len(positional) != 4:
        raise ValueError("usage: swapresults <i:qDB> <i:tDB> <i:resDB> <o:resDB>")
    q = seqdb.SeqDB.open(positional[0])
    t = seqdb.SeqDB.open(positional[1])
    r = seqdb.SeqDB.open(positional[2])
    # the base-tool default is 0.001, not the assembler's 1e-5
    thr = space.values["eval_thr"] if "eval_thr" in space.was_set else 0.001
    swap_results(q, t, r, eval_thr=thr).save(positional[3])
    return 0


def _mergedbs(positional, space, stats):
    from ..data.dbtools import merge_dbs
    if len(positional) < 3:
        raise ValueError("usage: mergedbs <i:qDB> <o:db> <i:db1> ...")
    dbs = [seqdb.SeqDB.open(p) for p in positional[2:]]
    merge_dbs(dbs).save(positional[1])
    return 0


RESULT_DBTYPES = (seqdb.ALIGNMENT_RES, seqdb.CLUSTER_RES,
                  seqdb.PREFILTER_RES)


def _createtsv4(positional, space, stats):
    """4-arg createtsv: map record keys and per-line first columns to
    header accessions (createtsv.cpp:84-160, default --target-column 1)."""
    from ..data.headers import parse_fasta_header
    qh = seqdb.SeqDB.open(positional[0] + "_h")
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    th = qh if same else seqdb.SeqDB.open(positional[1] + "_h")
    res = seqdb.SeqDB.open(positional[2])
    qnames = {int(qh.keys[i]): parse_fasta_header(
        qh.get_data(i).tobytes().decode().rstrip("\n"))
        for i in range(qh.size)}
    tnames = qnames if same else {int(th.keys[i]): parse_fasta_header(
        th.get_data(i).tobytes().decode().rstrip("\n"))
        for i in range(th.size)}
    with open(positional[3], "w") as out:
        for i in sorted(range(res.size), key=lambda j: int(res.offsets[j])):
            qname = qnames[int(res.keys[i])]
            for line in res.get_data(i).tobytes().decode().splitlines():
                if not line:
                    continue
                first, _, rest = line.partition("\t")
                tname = tnames[int(first)]
                out.write(f"{qname}\t{tname}" +
                          (f"\t{rest}" if rest else "") + "\n")
    return 0


def _result2flat(positional, space, stats):
    """result2flat.cpp: flatten a result/sequence DB into FASTA, headers
    from the query header DB; with --use-fasta-header result-DB lines get
    their first column replaced by the target accession."""
    from ..data.headers import parse_fasta_header
    if len(positional) != 4:
        raise ValueError(
            "usage: result2flat <i:qDB> <i:tDB> <i:resDB> <o:fasta>")
    use_header = bool(space.values.get("use_fasta_header", False)) \
        if space is not None else False
    qh = seqdb.SeqDB.open(positional[0] + "_h")
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    th = qh if same else seqdb.SeqDB.open(positional[1] + "_h")
    res = seqdb.SeqDB.open(positional[2])
    thdr = {int(th.keys[i]): th.get_data(i).tobytes().decode()
            for i in range(th.size)}
    qhdr = {int(qh.keys[i]): qh.get_data(i).tobytes().decode()
            for i in range(qh.size)}
    is_result = res.dbtype in RESULT_DBTYPES
    # reference iterates in data-file (write) order
    order = sorted(range(res.size), key=lambda i: int(res.offsets[i]))
    with open(positional[3], "w") as out:
        for i in order:
            key = int(res.keys[i])
            hd = qhdr[key]
            if use_header:
                hd = hd.split("\n", 1)[0] + " "
            else:
                hd = parse_fasta_header(hd)
            out.write(">" + hd + "\n")
            for line in res.get_data(i).tobytes().decode().splitlines():
                if use_header and is_result and line:
                    first = line.split("\t", 1)[0].split()[0]
                    acc = parse_fasta_header(
                        thdr[int(first)].rstrip("\n"))
                    line = acc + line[len(first):]
                out.write(line + "\n")
    return 0


def _createseqfiledb(positional, space, stats):
    """createseqfiledb.cpp: per cluster record, concatenated FASTA of all
    member sequences (full headers)."""
    if len(positional) != 3:
        raise ValueError(
            "usage: createseqfiledb <i:seqDB> <i:cluDB> <o:db>")
    db = seqdb.SeqDB.open(positional[0])
    hdb = seqdb.SeqDB.open(positional[0] + "_h")
    clu = seqdb.SeqDB.open(positional[1])
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in range(clu.size):
        parts = []
        for tok in clu.get_data(i).tobytes().split():
            member = int(tok)
            hid = hdb.key_to_id(member)
            sid = db.key_to_id(member)
            parts.append(b">" + hdb.get_data(hid).tobytes()
                         + db.get_data(sid).tobytes())
        w.write(int(clu.keys[i]), b"".join(parts), add_newline=False)
    w.finish().save(positional[2])
    return 0


def _cluster(positional, space, stats):
    from ..workflow.cluster import ClusterParams, run_cluster
    if len(positional) != 3:
        raise ValueError("usage: cluster <i:seqDB> <o:cluDB> <tmpDir>")
    v = space.values
    p = ClusterParams(
        seq_id_thr=(v["min_seq_id"].aminoacids
                    if space_was_set(space, "min_seq_id") else 0.0),
        cov_thr=v["cov_thr"] if space_was_set(space, "cov_thr") else 0.8,
        cov_mode=v["cov_mode"],
        eval_thr=v["eval_thr"] if space_was_set(space, "eval_thr") else 1e-3,
        sensitivity=(v["sensitivity"]
                     if space_was_set(space, "sensitivity") else None),
        max_seqs=v["max_seqs"] if space_was_set(space, "max_seqs") else 20,
        mask=v["search_mask"],
        remove_tmp=v["remove_tmp_files"])
    run_cluster(positional[0], positional[1], positional[2], p,
                device=v["device"], seconds=stats.setdefault("seconds", {}),
                counts=stats.setdefault("pairs", {}))
    return 0


def _easy_cluster(positional, space, stats, linear=False):
    """easy-cluster / easy-linclust (easycluster.sh): createdb ->
    cluster -> cluster.tsv + rep_seq.fasta + all_seqs.fasta."""
    from ..data.createdb import create_db
    if len(positional) != 3:
        raise ValueError(
            "usage: easy-cluster <i:fasta> <o:prefix> <tmpDir>")
    fasta, prefix, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    inp = os.path.join(tmp, "input")
    if not os.path.exists(inp + ".dbtype"):
        sdb, hdb = create_db([fasta], raw_headers=True)
        sdb.save(inp)
        hdb.save(inp + "_h")
    clu = os.path.join(tmp, "clu")
    if not os.path.exists(clu + ".dbtype"):
        if linear:
            from ..assembler.cluster import merged_clusters_to_db
            from ..workflow.linclust import LinclustParams, run_linclust
            db = seqdb.SeqDB.open(inp)
            v = space.values
            lp = LinclustParams(
                kmer_size=0, alphabet_size=13, kmers_per_sequence=21,
                kmers_per_sequence_scale=0.0,
                seq_id_thr=(v["min_seq_id"].aminoacids
                            if space_was_set(space, "min_seq_id") else 0.9),
                cov_thr=(v["cov_thr"]
                         if space_was_set(space, "cov_thr") else 0.8),
                cov_mode=v["cov_mode"], gap_open=11, gap_extend=1,
                max_seq_len=65535, wrapped_scoring=False, cluster_mode=-1)
            merged_clusters_to_db(run_linclust(
                db, lp, seconds=stats.setdefault("seconds", {}),
                device=v["device"],
                counts=stats.setdefault("pairs", {}))).save(clu)
        else:
            _cluster([inp, clu, os.path.join(tmp, "clu_tmp")], space, stats)
    _createtsv4([inp, inp, clu, prefix + "_cluster.tsv"], space, stats)
    from ..assembler.cluster import result2repseq
    db = seqdb.SeqDB.open(inp)
    rep = os.path.join(tmp, "clu_rep")
    result2repseq(db, seqdb.SeqDB.open(clu)).save(rep)
    space.values["use_fasta_header"] = True
    _result2flat([inp, inp, rep, prefix + "_rep_seq.fasta"], space, stats)
    space.values["use_fasta_header"] = False
    seqs = os.path.join(tmp, "clu_seqs")
    _createseqfiledb([inp, clu, seqs], space, stats)
    _result2flat([inp, inp, seqs, prefix + "_all_seqs.fasta"], space, stats)
    return 0


def _easy_linclust(positional, space, stats):
    return _easy_cluster(positional, space, stats, linear=True)


def _subtractdbs(positional, space, stats):
    """subtractdbs.cpp: remove from each left record the lines whose key
    appears in the right DB's record for the same query (both sides
    filtered by the e-value threshold when lines are alignment-format)."""
    if len(positional) != 3:
        raise ValueError(
            "usage: subtractdbs <i:leftDB> <i:rightDB> <o:db>")
    left = seqdb.SeqDB.open(positional[0])
    right = seqdb.SeqDB.open(positional[1])
    v = space.values
    eval_thr = min(v.get("eval_thr", 0.001), v.get("eval_profile", 0.001))

    def passing_keys(data):
        out = []
        for line in data.decode().splitlines():
            if not line:
                continue
            f = line.split("\t")
            evalue = float(f[3]) if len(f) >= 10 else 0.0
            out.append((int(f[0].split()[0]), evalue <= eval_thr, line))
        return out

    w = seqdb.DBWriter(left.dbtype)
    for i in seqdb.data_order(left):
        key = int(left.keys[i])
        lines = passing_keys(left.get_data(i).tobytes())
        drop = set()
        j = right.key_to_id(key)
        if j is not None:
            for (k, ok, _line) in passing_keys(right.get_data(j).tobytes()):
                if ok:
                    drop.add(k)
        body = "".join(line + "\n" for (k, ok, line) in lines
                       if ok and k not in drop)
        w.write(key, body.encode(), add_newline=False)
    w.finish().save(positional[2])
    return 0


def _createtsv(positional, space, stats):
    from ..data.dbtools import create_tsv
    if len(positional) == 4:
        return _createtsv4(positional, space, stats)
    if len(positional) < 2:
        raise ValueError("usage: createtsv <i:queryDB> [<i:resDB>] <o:tsv>")
    hdb = None
    if len(positional) == 3:
        # createtsv.cpp 3-name form: db1 = query seq DB (headers via _h),
        # db2 = result DB; each line gets the query accession prefixed
        db = seqdb.SeqDB.open(positional[1])
        hdb = seqdb.SeqDB.open(positional[0] + "_h")
    else:
        db = seqdb.SeqDB.open(positional[0])
    with open(positional[-1], "w") as f:
        f.write(create_tsv(db, hdb))
    return 0


BASE_COMMANDS = [
    Command("createdb", _createdb, lambda: _space(P.common_flags() + P.orf_flags()),
            "<i:fastaFile1[.gz]> ... <o:seqDB>", "Convert FASTA/Q to sequence DB", hidden=True),
    Command("concatdbs", _concatdbs, lambda: _space(P.common_flags() + [
        P.Flag("--preserve-keys", "preserve_keys", bool, False,
               "Keep the keys of both DBs (must be disjoint or "
               "--take-larger-entry)"),
        P.Flag("--take-larger-entry", "take_larger_entry", bool, False,
               "For duplicate keys keep the larger record")]),
            "<i:db1> <i:db2> <o:db>", "Concatenate DBs", hidden=True),
    Command("createsubdb", _createsubdb, lambda: _space(P.common_flags() + [
        P.Flag("--subdb-mode", "subdb_mode", int, 0,
               "0: copy data, 1: soft link data and write index", r"[0-1]"),
        P.Flag("--id-mode", "id_mode", int, 0,
               "0: database keys, 1: line numbers", r"[0-1]")]),
            "<i:subsetFile> <i:db> <o:db>", "Create subset DB", hidden=True),
    Command("convert2fasta", _convert2fasta, lambda: _space(P.common_flags()),
            "<i:seqDB> <o:fasta>", "Convert DB to FASTA", hidden=True),
    Command("rmdb", _rmdb, lambda: _space(P.common_flags()),
            "<i:db>", "Remove a DB file family", hidden=True),
    Command("mvdb", _mvdb, lambda: _space(P.common_flags()),
            "<i:db> <o:db>", "Move a DB file family", hidden=True),
    Command("cpdb", _cpdb, lambda: _space(P.common_flags()),
            "<i:db> <o:db>", "Copy a DB file family", hidden=True),
    Command("lndb", _lndb, lambda: _space(P.common_flags()),
            "<i:db> <o:db>", "Symlink a DB file family", hidden=True),
    Command("filterdb", _filterdb, lambda: _space(P.common_flags() + [
        P.Flag("--filter-file", "filter_file", str, "", "Keep lines whose first column is in file"),
        P.Flag("--positive-filter", "positive_filter", bool, True,
               "1: keep matching lines, 0: drop matching lines", r"[0-1]"),
        P.Flag("--filter-column", "filter_column", int, 1, "Column to filter on (1-based)"),
        P.Flag("--comparison-operator", "comparison_operator", str, "", "le, ge or e"),
        P.Flag("--comparison-value", "comparison_value", float, 0.0, "Comparison value"),
        P.Flag("--sort-entries", "sort_entries", int, 0, "1 increasing, 2 decreasing"),
        P.Flag("--extract-lines", "extract_lines", int, 0, "Keep first N lines"),
        P.Flag("--beats-first", "beats_first", bool, False, "Keep lines matching the first line's column"),
        P.Flag("--filter-regex", "filter_regex", str, "", "Keep lines whose column matches the regex"),
        P.Flag("--mapping-file", "mapping_file", str, "", "Map the filter column through a TSV"),
        P.Flag("--filter-expression", "filter_expression", str, "",
               "Keep lines where the expression over $1..$128 columns is nonzero"),
        P.Flag("--trim-to-one-column", "trim_to_one_column", bool, False, "Output only the filter column")]),
            "<i:db> <o:db>", "Filter result DB lines", hidden=True),
    Command("result2repseq", _result2repseq, lambda: _space(P.common_flags()),
            "<i:seqDB> <i:resultDB> <o:seqDB>", "Extract representative sequences", hidden=True),
    Command("createtsv", _createtsv, lambda: _space(P.common_flags()),
            "<i:db> [<i:hdb>] <o:tsv>", "Convert DB to TSV", hidden=True),
    Command("mergedbs", _mergedbs, lambda: _space(P.common_flags()),
            "<i:qDB> <o:db> <i:db1> ...", "Concatenate records per key", hidden=True),
    Command("sortresult", _sortresult, lambda: _space(P.common_flags()),
            "<i:resDB> <o:resDB>", "Sort result records by E-value/score", hidden=True),
    Command("swapresults", _swapresults, lambda: _space(P.common_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <i:resDB> <o:resDB>", "Transpose query/target results", hidden=True),
    Command("kmermatcher", _kmermatcher, lambda: _space(P.common_flags() + P.kmermatcher_flags() + P.align_flags()),
            "<i:seqDB> <o:prefDB>", "Find overlapping k-mers", hidden=True),
    Command("rescorediagonal", _rescorediagonal, lambda: _space(P.common_flags() + P.kmermatcher_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <i:prefDB> <o:alnDB>", "Ungapped diagonal rescoring", hidden=True),
    Command("prefilter", _prefilter, lambda: _space(P.common_flags() + P.search_flags() + [
        P.Flag("-c", "cov_thr", float, 0.0, "Coverage threshold"),
        P.Flag("--cov-mode", "cov_mode", int, 0, "Coverage mode", r"[0-5]")]),
            "<i:qDB> <i:tDB> <o:prefDB>", "Sensitive double-k-mer-match prefilter", hidden=True),
    Command("align", _align, lambda: _space(P.common_flags() + P.kmermatcher_flags() + P.align_flags() + [
        P.Flag("--alignment-mode", "alignment_mode", int, 0,
               "0 auto, 1 score+end, 2 +start+cov, 3 +seq.id", r"[0-5]"),
        P.Flag("--max-accept", "max_accept", int, 2**31 - 1, "Maximum accepted alignments per query"),
        P.Flag("--max-rejected", "max_rejected", int, 2**31 - 1, "Maximum rejected alignments before give-up")]),
            "<i:qDB> <i:tDB> <i:prefDB> <o:alnDB>", "Gapped banded alignment", hidden=True),
    Command("lcaalign", _lcaalign, lambda: _space(P.common_flags() + P.kmermatcher_flags() + P.align_flags() + [
        P.Flag("--alignment-mode", "alignment_mode", int, 0,
               "0 auto, 1 score+end, 2 +start+cov, 3 +seq.id", r"[0-5]"),
        P.Flag("--max-accept", "max_accept", int, 2**31 - 1, "Maximum accepted alignments per query"),
        P.Flag("--max-rejected", "max_rejected", int, 2**31 - 1, "Maximum rejected alignments before give-up")]),
            "<i:qDB> <i:tDB> <i:prefDB> <o:alnDB>", "Efficient gapped alignment for lca computation", hidden=True),
    Command("search", _search, lambda: _space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--num-iterations", "num_iterations", int, 1,
               "Number of iterative profile search iterations"),
        P.Flag("--e-profile", "eval_profile", float, 0.1,
               "E-value threshold for intermediate profiles")]),
            "<i:qDB> <i:tDB> <o:alnDB> <tmpDir>", "Sensitive homology search (prefilter + align)", hidden=True),
    Command("easy-search", _easy_search, lambda: _space(P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:queryFasta> <i:targetFasta> <o:tsv> <tmpDir>", "Sensitive homology search (FASTA in, BLAST-tab out)", hidden=True),
    Command("convertalis", _convertalis, lambda: _space(P.common_flags()),
            "<i:qDB> <i:tDB> <i:alnDB> <o:tsv>", "Convert alignment DB to BLAST-tab TSV", hidden=True),
    Command("clust", _clust, lambda: _space(P.common_flags()),
            "<i:seqDB> <i:alnDB> <o:cluDB>", "Greedy incremental clustering", hidden=True),
    Command("mergeclusters", _mergeclusters, lambda: _space(P.common_flags()),
            "<i:seqDB> <o:cluDB> <i:clu1> ...", "Merge clustering steps", hidden=True),
    Command("cluster", _cluster, lambda: _space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--cluster-mode", "cluster_mode", int, 0, "0 set-cover, 1 connected component, 2 greedy", r"[0-3]"),
        P.Flag("--cluster-steps", "cluster_steps", int, 3, "Cascaded clustering steps")]),
            "<i:seqDB> <o:cluDB> <tmpDir>", "Cascaded clustering", hidden=True),
    Command("easy-cluster", _easy_cluster, lambda: _space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--cluster-mode", "cluster_mode", int, 0, "0 set-cover, 1 connected component, 2 greedy", r"[0-3]"),
        P.Flag("--use-fasta-header", "use_fasta_header", bool, False, "Use full fasta header")]),
            "<i:fasta> <o:prefix> <tmpDir>", "Cascaded clustering (FASTA in, FASTA/TSV out)", hidden=True),
    Command("easy-linclust", _easy_linclust, lambda: _space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--use-fasta-header", "use_fasta_header", bool, False, "Use full fasta header")]),
            "<i:fasta> <o:prefix> <tmpDir>", "Linear-time clustering (FASTA in, FASTA/TSV out)", hidden=True),
    Command("result2flat", _result2flat, lambda: _space(P.common_flags() + [
        P.Flag("--use-fasta-header", "use_fasta_header", bool, False, "Use full fasta header")]),
            "<i:qDB> <i:tDB> <i:resDB> <o:fasta>", "Flatten result DB to FASTA", hidden=True),
    Command("createseqfiledb", _createseqfiledb, lambda: _space(P.common_flags()),
            "<i:seqDB> <i:cluDB> <o:db>", "Per-cluster FASTA records", hidden=True),
    Command("subtractdbs", _subtractdbs, lambda: _space(P.common_flags() + [
        P.Flag("-e", "eval_thr", float, 0.001, "E-value threshold"),
        P.Flag("--e-profile", "eval_profile", float, 0.001, "Profile E-value threshold")]),
            "<i:leftDB> <i:rightDB> <o:db>", "Remove right-side hits from left result DB", hidden=True),
]

from .tools_profile import COMMANDS as _PROFILE_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_PROFILE_COMMANDS)
