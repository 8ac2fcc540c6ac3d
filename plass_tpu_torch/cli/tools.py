"""Base tools of the port's `plass` and `penguin` CLIs: the DB plumbing,
the sensitive prefilter, `align`, `search` (against sequences, against
profiles, exhaustive and iterative) and cascaded `cluster` with their
easy-* forms, `rbh`, `map`, the multi-hit tools, the taxonomy tools and
the `taxonomy` workflow (data/taxonomy.py), `proteinaln2nucl`, the
profile and MSA tools (cli/tools_profile.py), the DB utilities
(cli/tools_db.py), linsearch and its relatives (cli/tools_linsearch.py),
the misc and domain tools (cli/tools_misc.py, cli/tools_domain.py),
`databases` (cli/tools_databases.py), and the alignment-DB readers the
product CLIs' hidden tools share.

A copy of the JAX package's cli/tools.py: BASE_COMMANDS registers every
base tool of the JAX package, in its order. Each keeps its flag list there
(cli/params.py) plus --device, which sets where the aligner scores its
candidate pairs (kernel B9, ops/protein_align.py). Everything else runs on
the host, as in the JAX package (`taxonomy`'s default --lca-mode 3 aligns
with the host's lcaalign; --lca-mode 4 and 1 align through `search`). One
command departs from it: `rescorediagonal` looks its hits' target keys up
in its <i:tDB>, as the reference does (ROADMAP C4). A command's `stats`
dict receives the stage seconds of its workflow under "seconds" and the
aligner's pair counts under "pairs" (see align_protein).
"""
import os
import re

import numpy as np

from ..data import seqdb
from ..ops.rescore import RESULT_DTYPE
from ..utils.log import logger
from . import params as P
from .app import Command, port_space


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


def _extractorfs(positional, space, stats):
    from ..ops import orf as orf_mod
    from ..ops import translate as tr
    if len(positional) != 2:
        raise ValueError("usage: extractorfs <i:seqDB> <o:seqDB>")
    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    odb, ohdb = orf_mod.extract_orfs(
        db, min_length=v["orf_min_length"], max_length=v["orf_max_length"],
        max_gaps=v["orf_max_gaps"], start_mode=v["orf_start_mode"],
        contig_start_mode=v["contig_start_mode"], contig_end_mode=v["contig_end_mode"],
        forward_frames=_frames(v["forward_frames"]),
        reverse_frames=_frames(v["reverse_frames"]),
        stop_codons=tr.stop_codons(v["translation_table"]),
        start_codons=tr.start_codons(v["translation_table"], v["use_all_table_starts"]))
    odb.save(positional[1])
    ohdb.save(positional[1] + "_h")
    return 0


def _frames(spec):
    mask = 0
    for f in str(spec).split(","):
        if f.strip():
            mask |= 1 << (int(f) - 1)
    return mask


def _translatenucs(positional, space, stats):
    from ..ops.translate import translate_nucs
    if len(positional) != 2:
        raise ValueError("usage: translatenucs <i:seqDB> <o:seqDB>")
    db = seqdb.SeqDB.open(positional[0])
    hdr = None
    add_stop = os.path.exists(positional[0] + "_h.dbtype")
    if add_stop:
        hdr = seqdb.SeqDB.open(positional[0] + "_h")
    out = translate_nucs(db, hdr, space.values["translation_table"],
                         add_orf_stop=add_stop,
                         max_seq_len=space.values["max_seq_len"])
    out.save(positional[1])
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
    # the hits' target keys belong to <i:tDB> (rescorediagonal.cpp opens
    # par.db2); the JAX package looks them up in <i:qDB> (ROADMAP C4)
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    tdb = None if same else seqdb.SeqDB.open(positional[1])
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
    alns = rescore_diagonal(db, hits, rp, tdb=tdb)
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


def _add_stats(stats, sub, suffix):
    """Add a step's stage seconds and pair counts (sub, a command's stats)
    to stats, each name ending in suffix."""
    for kind in ("seconds", "pairs"):
        acc = stats.setdefault(kind, {})
        for key, n in sub.get(kind, {}).items():
            acc[key + suffix] = acc.get(key + suffix, 0) + n


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
    # the step's seconds are its wall, timed above
    _add_stats(stats, {"pairs": sub.get("pairs", {})}, suffix)
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


def _result2rbh(positional, space, stats):
    """result2rbh.cpp: from bitscore-sorted merged A->B + swapped B->A
    results, keep the B->A lines tying A's best bitscore."""
    if len(positional) != 2:
        raise ValueError("usage: result2rbh <i:resDB> <o:resDB>")
    db = seqdb.SeqDB.open(positional[0])
    w = seqdb.DBWriter(db.dbtype)
    for i in seqdb.data_order(db):
        lines = [l for l in db.get_data(i).tobytes().decode().splitlines()
                 if l]
        best = 0
        out = []
        for n, l in enumerate(lines):
            score = int(l.split("\t")[1])
            if best == 0:
                best = score
            else:
                if score < best:
                    break
                out.append(l)
        w.write(int(db.keys[i]),
                "".join(l + "\n" for l in out).encode(),
                add_newline=False)
    w.finish().save(positional[1])
    return 0


def _map(positional, space, stats):
    """map workflow (Map.cpp:11-19 + map.sh): prefilter at sensitivity 2
    with a length-ratio coverage gate, then ungapped rescoring
    (rescorediagonal --rescore-mode 2) at -c 0.95 --cov-mode 2
    --min-seq-id 0.9 --sort-results 1; no composition bias, no masking.
    Host code on every device, as in the JAX package."""
    from ..ops import prefilter as pf
    from ..ops.rescore import (RESCORE_ALIGNMENT, RescoreParams,
                               rescore_diagonal, results_to_db)
    if len(positional) != 4:
        raise ValueError("usage: map <i:qDB> <i:tDB> <o:alnDB> <tmpDir>")
    v = space.values
    os.makedirs(positional[3], exist_ok=True)
    qdb = seqdb.SeqDB.open(positional[0])
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    tdb = qdb if same else seqdb.SeqDB.open(positional[1])
    sens = v["sensitivity"] if "sensitivity" in space.was_set else 2.0
    cov = v["cov_thr"] if "cov_thr" in space.was_set else 0.95
    cov_mode = v["cov_mode"] if "cov_mode" in space.was_set else 2
    seq_id = (v["min_seq_id"].aminoacids
              if "min_seq_id" in space.was_set else 0.9)
    pr = pf.PrefilterParams(
        sensitivity=sens, max_seqs=v["max_seqs"],
        comp_bias_corr=bool(v["comp_bias_corr"]
                            if "comp_bias_corr" in space.was_set else 0),
        mask=v["search_mask"] if "search_mask" in space.was_set else 0,
        cov_thr=cov, cov_mode=cov_mode)
    hits = pf.prefilter(qdb, tdb, pr, same_db=same)
    rp = RescoreParams(
        rescore_mode=RESCORE_ALIGNMENT, seq_id_thr=seq_id, cov_thr=cov,
        cov_mode=cov_mode,
        eval_thr=v["eval_thr"] if "eval_thr" in space.was_set else 0.001,
        sort_results=1)
    res = rescore_diagonal(qdb, hits, rp, tdb=None if same else tdb)
    qorder = [int(qdb.keys[i]) for i in
              np.argsort(qdb.offsets, kind="stable")]
    db = results_to_db({k: res.get(k, []) for k in qorder})
    db.save(positional[2])
    return 0


def _rbh(positional, space, stats):
    """rbh workflow (rbh.sh): search A vs B and B vs A, keep reciprocal
    best hits by bitscore. Each search's stage seconds and pair counts go
    to stats under their names ending in _AB and _BA."""
    if len(positional) != 4:
        raise ValueError("usage: rbh <i:aDB> <i:bDB> <o:resDB> <tmpDir>")
    a, b, out, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    # Rbh.cpp:11-13 defaults: no composition bias, no masking, SCORE_COV_SEQID
    if "comp_bias_corr" not in space.was_set:
        space.values["comp_bias_corr"] = 0
    if "search_mask" not in space.was_set:
        space.values["search_mask"] = 0
    if "alignment_mode" not in space.was_set:
        space.values["alignment_mode"] = 3
        space.was_set.add("alignment_mode")
    # the rbh workflow serializes its own -s 4.0 default into the searches,
    # overriding search's 5.7 (createParameterString of searchworkflow)
    if "sensitivity" not in space.was_set:
        space.values["sensitivity"] = 4.0
        space.was_set.add("sensitivity")
    for tag, query, target in (("AB", a, b), ("BA", b, a)):
        res = os.path.join(tmp, "res" + tag)
        if not os.path.exists(res + ".dbtype"):
            sub = {}
            _search([query, target, res, os.path.join(tmp, "temp" + tag)],
                    space, sub)
            _add_stats(stats, sub, "_" + tag)
    res_ab = os.path.join(tmp, "resAB")
    res_ba = os.path.join(tmp, "resBA")
    v = dict(space.values)

    def filterdb(inp, outp, **kw):
        space.values.update({"filter_file": "", "sort_entries": 0,
                             "extract_lines": 0, "beats_first": False,
                             "comparison_operator": "",
                             "comparison_value": 0.0, "filter_column": 1})
        space.values.update(kw)
        _filterdb([inp, outp], space, stats)
    filterdb(res_ab, os.path.join(tmp, "resAB_sorted"),
             sort_entries=2, filter_column=2)
    filterdb(os.path.join(tmp, "resAB_sorted"),
             os.path.join(tmp, "resA_best_B"), extract_lines=1)
    filterdb(res_ba, os.path.join(tmp, "resB_best_A"),
             beats_first=True, filter_column=2, comparison_operator="e")
    space.values.update(v)
    space.values["eval_thr"] = 1e8
    space.was_set.add("eval_thr")
    _swapresults([b, a, os.path.join(tmp, "resB_best_A"),
                  os.path.join(tmp, "resB_best_A_swap")], space, stats)
    _mergedbs([os.path.join(tmp, "resA_best_B"),
               os.path.join(tmp, "res_best_merged"),
               os.path.join(tmp, "resA_best_B"),
               os.path.join(tmp, "resB_best_A_swap")], space, stats)
    filterdb(os.path.join(tmp, "res_best_merged"),
             os.path.join(tmp, "res_best_merged_sorted"),
             sort_entries=2, filter_column=2)
    return _result2rbh([os.path.join(tmp, "res_best_merged_sorted"), out],
                       space, stats)


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


def _splitdb(positional, space, stats):
    from ..data.dbtools import split_db
    if len(positional) != 2:
        raise ValueError("usage: splitdb <i:db> <o:dbPrefix> --split N")
    n = int(space.values.get("split", 2))
    shards = split_db(seqdb.SeqDB.open(positional[0]), n)
    for i, s in enumerate(shards):
        s.save(f"{positional[1]}_{i}_{n}")
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


def _splitsequence(positional, space, stats):
    """splitsequence.cpp (hard mode): chop sequences into overlapping
    windows of --max-seq-len with --sequence-overlap, ORF-style headers,
    renumbered keys."""
    from ..ops.orf import _orf_header
    if len(positional) != 2:
        raise ValueError("usage: splitsequence <i:seqDB> <o:seqDB>")
    import math

    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    max_len = v.get("split_seq_len", 10000)
    overlap = v.get("sequence_overlap", 300)
    soft = v.get("sequence_split_mode", 1) == 1
    hw = seqdb.DBWriter(seqdb.GENERIC_DB)
    sw = None if soft else seqdb.DBWriter(db.dbtype)
    keys, offs, lens = [], [], []
    new_key = 0
    # records iterated in data order (decomposeDomain walks offsets)
    order = sorted(range(db.size), key=lambda j: int(db.offsets[j]))
    for i in order:
        key = int(db.keys[i])
        seq = db.get_seq(i)
        L = len(seq)
        split_cnt = max(int(math.ceil(L / float(max_len - overlap))), 1)
        for s in range(split_cnt):
            start = s * max_len - s * overlap
            ln = min(max_len, L - start)
            if soft:
                # soft mode: the output index points into the original
                # data file (+2 emulating the record terminators,
                # splitsequence.cpp:100-103); data is shared
                keys.append(new_key)
                offs.append(int(db.offsets[i]) + start)
                lens.append(ln + 2)
            else:
                sw.write(new_key, bytes(seq[start:start + ln]))
            hw.write(new_key,
                     _orf_header(key, start, start + ln - 1, 0, 0))
            new_key += 1
    if soft:
        out = seqdb.SeqDB(db.data, np.asarray(keys, dtype=np.uint32),
                          np.asarray(offs, dtype=np.int64),
                          np.asarray(lens, dtype=np.int64), db.dbtype)
        out.save(positional[1])
    else:
        sw.finish(sort_by_key=False).save(positional[1])
    hw.finish(sort_by_key=False).save(positional[1] + "_h")
    return 0


def _extractframes(positional, space, stats):
    """extractframes.cpp: emit the chosen reading frame(s) per strand with
    ORF headers, renumbered keys."""
    from ..data.createdb import iupac_revcomp
    from ..ops.orf import _orf_header
    if len(positional) != 2:
        raise ValueError("usage: extractframes <i:seqDB> <o:seqDB>")
    db = seqdb.SeqDB.open(positional[0])
    v = space.values
    fwd = _frames(v.get("forward_frames", "1,2,3"))
    rev = _frames(v.get("reverse_frames", "1,2,3"))
    sw = seqdb.DBWriter(db.dbtype)
    hw = seqdb.DBWriter(seqdb.GENERIC_DB)
    new_key = 0
    # the reference's switch handles only exact single-frame masks;
    # combined masks (like the "1,2,3" default) emit NOTHING
    # (extractframes.cpp:58-110 — quirk kept for parity)
    fwd_frame = {1: 0, 2: 1, 4: 2}.get(fwd)
    rev_frame = {1: 0, 2: 1, 4: 2}.get(rev)
    order = sorted(range(db.size), key=lambda j: int(db.offsets[j]))
    for i in order:
        key = int(db.keys[i])
        seq = bytes(db.get_seq(i))
        L = len(seq)
        if fwd_frame is not None and L > fwd_frame:
            f = fwd_frame
            sw.write(new_key, seq[f:])
            # writeOrfHeader(key, f, L-1-f): the frame offset shifts
            # both coordinate ends (extractframes.cpp:59-76)
            hw.write(new_key, _orf_header(key, f, L - 1 - f, 0, 0))
            new_key += 1
        if rev_frame is not None and L > rev_frame:
            f = rev_frame
            rc = bytes(iupac_revcomp(np.frombuffer(seq, dtype=np.uint8)))
            sw.write(new_key, rc[f:])
            hw.write(new_key, _orf_header(key, L - 1 - f, f, 0, 0))
            new_key += 1
    sw.finish(sort_by_key=False).save(positional[1])
    hw.finish(sort_by_key=False).save(positional[1] + "_h")
    return 0


def _touchdb(positional, space, stats):
    """touchdb.cpp: page the DB into memory (posix_madvise WILLNEED)."""
    db = seqdb.SeqDB.open(positional[0])
    _ = int(np.asarray(db.data[:: max(len(db.data) // 4096, 1)]).sum())
    return 0


def _diskspaceavail(positional, space, stats):
    """diskspaceavail.cpp: print available disk space of the path."""
    st = os.statvfs(positional[0] if positional else ".")
    print((st.f_bavail * st.f_frsize) / 1024)
    return 0


def _apply(positional, space, stats):
    """apply.cpp: run a program per DB entry (record on stdin, new record
    from stdout)."""
    import subprocess
    if len(positional) < 3:
        raise ValueError("usage: apply <i:db> <o:db> -- <program> [args]")
    db = seqdb.SeqDB.open(positional[0])
    prog = positional[2:]
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in range(db.size):
        data = db.get_data(i).tobytes()
        env = dict(os.environ,
                   MMSEQS_ENTRY_NAME=str(int(db.keys[i])))
        r = subprocess.run(prog, input=data, stdout=subprocess.PIPE,
                           env=env, check=True)
        w.write(int(db.keys[i]), r.stdout, add_newline=False)
    w.finish().save(positional[1])
    return 0


def _tar2db(positional, space, stats):
    """tar2db.cpp: one record per tar member + .lookup/.source files."""
    import tarfile
    if len(positional) != 2:
        raise ValueError("usage: tar2db <i:tar> <o:db>")
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    lookup = []
    key = 0
    with tarfile.open(positional[0]) as tf:
        for m in tf:
            if not m.isfile():
                continue
            w.write(key, tf.extractfile(m).read(), add_newline=False)
            lookup.append((key, m.name))
            key += 1
    w.finish(sort_by_key=False).save(positional[1])
    with open(positional[1] + ".lookup", "w") as f:
        for k, name in lookup:
            f.write(f"{k}\t{name}\t0\n")
    with open(positional[1] + ".source", "w") as f:
        f.write(f"0\t{os.path.basename(positional[0])}\n")
    return 0


def _swapdb(positional, space, stats):
    """swapdb.cpp: transpose a result DB (target keys become records
    listing the queries that hit them, lines otherwise unchanged except
    the first column)."""
    if len(positional) != 2:
        raise ValueError("usage: swapdb <i:resultDB> <o:resultDB>")
    db = seqdb.SeqDB.open(positional[0])
    swapped = {}
    for i in range(db.size):
        qkey = int(db.keys[i])
        for line in db.get_data(i).tobytes().decode().splitlines():
            if not line:
                continue
            first, _, rest = line.partition("\t")
            tkey = int(first.split()[0])
            swapped.setdefault(tkey, []).append(
                f"{qkey}" + (f"\t{rest}" if rest else ""))
    w = seqdb.DBWriter(db.dbtype)
    for tkey in sorted(swapped):
        w.write(tkey, ("\n".join(swapped[tkey]) + "\n").encode(),
                add_newline=False)
    w.finish().save(positional[1])
    return 0


def _orftocontig(positional, space, stats):
    from ..data.multihit import orftocontig
    if len(positional) != 3:
        raise ValueError(
            "usage: orftocontig <i:contigDB> <i:orfDB> <o:alnDB>")
    contigs = seqdb.SeqDB.open(positional[0])
    orf_h = seqdb.SeqDB.open(positional[1] + "_h")
    orftocontig(contigs, orf_h).save(positional[2])
    return 0


def _result2stats(positional, space, stats):
    from ..data.multihit import result2stats_linecount
    if len(positional) != 4:
        raise ValueError(
            "usage: result2stats <i:qDB> <i:tDB> <i:resultDB> <o:statsDB>")
    if space.values.get("stat", "linecount") != "linecount":
        raise ValueError("result2stats: only --stat linecount implemented")
    result2stats_linecount(seqdb.SeqDB.open(positional[2])).save(
        positional[3])
    return 0


def _besthitperset(positional, space, stats):
    from ..data.multihit import besthitperset
    if len(positional) != 4:
        raise ValueError(
            "usage: besthitperset <i:qDB> <i:tDB> <i:resultDB> <o:db>")
    out = besthitperset(positional[1], seqdb.SeqDB.open(positional[2]),
                        simple_best_hit=space.values.get("simple_best_hit",
                                                         False))
    out.save(positional[3])
    return 0


def _combinepvalperset(positional, space, stats):
    from ..data.multihit import combinepvalperset
    if len(positional) != 4:
        raise ValueError(
            "usage: combinepvalperset <i:qDB> <i:tDB> <i:resultDB> <o:db>")
    out = combinepvalperset(
        positional[0], positional[1], seqdb.SeqDB.open(positional[2]),
        alpha=space.values.get("alpha", 1.0),
        mode=space.values.get("aggregation_mode", 0))
    out.save(positional[3])
    return 0


def _mergeresultsbyset(positional, space, stats):
    from ..data.multihit import mergeresultsbyset
    if len(positional) != 3:
        raise ValueError(
            "usage: mergeresultsbyset <i:setDB> <i:resultDB> <o:db>")
    out = mergeresultsbyset(seqdb.SeqDB.open(positional[0]),
                            seqdb.SeqDB.open(positional[1]))
    out.save(positional[2])
    return 0


def _multihitdb(positional, space, stats):
    """multihitdb workflow (multihitdb.sh): per-input-file sets, ORF
    extraction/translation, member/set mapping DBs and set sizes."""
    from ..data.createdb import create_db
    from ..data.fastx import iter_fastx_raw
    from ..data.multihit import result2stats_linecount
    from ..ops import orf as orf_mod
    from ..ops import translate as tr
    from ..ops.orf import parse_orf_header
    if len(positional) < 3:
        raise ValueError(
            "usage: multihitdb <i:fasta1> ... <o:setDB> <tmpDir>")
    fastas, outdb, tmp = positional[:-2], positional[-2], positional[-1]
    os.makedirs(tmp, exist_ok=True)
    sdb, hdb = create_db(fastas)
    if sdb.dbtype != seqdb.NUCLEOTIDES:
        raise ValueError("multihitdb: protein mode not implemented "
                         "(multihitdb.sh:83)")
    sdb.save(outdb + "_nucl")
    hdb.save(outdb + "_nucl_h")
    # contig -> set (file index) via the lookup file numbers
    key = 0
    contig_to_set = {}
    for fi, fasta in enumerate(fastas):
        for _ in iter_fastx_raw(fasta):
            contig_to_set[key] = fi
            key += 1
    with open(outdb + "_nucl_contig_to_set.tsv", "w") as f:
        for k in sorted(contig_to_set):
            f.write(f"{k}\t{contig_to_set[k]}\n")
    # ORFs + translation (EXTRACTORFS_PAR: orf-min-length 30)
    odb, ohdb = orf_mod.extract_orfs(sdb, min_length=30)
    odb.save(outdb + "_nucl_orf")
    ohdb.save(outdb + "_nucl_orf_h")
    aa = tr.translate_nucs(odb, ohdb, 1)
    aa.save(outdb)
    seqdb.copy_db_files(outdb + "_nucl_orf_h", outdb + "_h")
    # member (orf) -> set via its contig
    m2s = seqdb.DBWriter(seqdb.GENERIC_DB)
    s2m = {}
    for i in range(ohdb.size):
        okey = int(ohdb.keys[i])
        loc = parse_orf_header(ohdb.get_data(i).tobytes().decode())
        set_key = contig_to_set[loc["id"]]
        m2s.write(okey, f"{set_key}\n".encode(), add_newline=False)
        s2m.setdefault(set_key, []).append(okey)
    m2s.finish().save(outdb + "_member_to_set")
    s2m_w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for set_key in sorted(s2m):
        s2m_w.write(set_key,
                    "".join(f"{m}\n" for m in s2m[set_key]).encode(),
                    add_newline=False)
    s2m_db = s2m_w.finish()
    s2m_db.save(outdb + "_set_to_member")
    result2stats_linecount(s2m_db).save(outdb + "_set_size")
    return 0


def _multihitsearch(positional, space, stats):
    """multihitsearch workflow (multihitsearch.sh): search the ORF
    proteins (B9 scores the candidate pairs on a card), aggregate best
    hits per target set, merge per query set."""
    from ..data.multihit import besthitperset, mergeresultsbyset
    if len(positional) != 4:
        raise ValueError(
            "usage: multihitsearch <i:qSetDB> <i:tSetDB> <o:db> <tmpDir>")
    q, t, out, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    result = os.path.join(tmp, "result")
    if not os.path.exists(result + ".dbtype"):
        _search([q, t, result, os.path.join(tmp, "search")], space, stats)
    agg = besthitperset(t, seqdb.SeqDB.open(result),
                        simple_best_hit=space.values.get("simple_best_hit",
                                                         False))
    agg_path = os.path.join(tmp, "aggregate")
    agg.save(agg_path)
    mergeresultsbyset(seqdb.SeqDB.open(q + "_set_to_member"),
                      seqdb.SeqDB.open(agg_path)).save(out)
    return 0


def _createtaxdb(positional, space, stats):
    """createtaxdb offline path (createtaxdb.sh:57-101): copy the provided
    NCBI dump files next to the sequence DB and derive <db>_mapping by
    joining <db>.lookup accessions with the accession->taxid file."""
    import shutil

    from ..data import taxonomy as taxmod
    if len(positional) != 2:
        raise ValueError("usage: createtaxdb <i:seqDB> <tmpDir> "
                         "--ncbi-tax-dump <dir> --tax-mapping-file <file>")
    v = space.values
    dump = v.get("ncbi_tax_dump", "")
    mapping_file = v.get("tax_mapping_file", "")
    if not dump or not mapping_file:
        raise ValueError("createtaxdb: downloads are unavailable; pass "
                         "--ncbi-tax-dump and --tax-mapping-file")
    db = positional[0]
    if v.get("tax_db_mode", 1) == 1:
        # createtaxdb.sh:69-72 — binary dump (default, taxDbMode=1)
        data = taxmod.serialize_taxonomy(os.path.join(dump, "names.dmp"),
                                         os.path.join(dump, "nodes.dmp"),
                                         os.path.join(dump, "merged.dmp"))
        with open(f"{db}_taxonomy", "wb") as f:
            f.write(data)
    else:
        for name in ("names.dmp", "nodes.dmp", "merged.dmp"):
            shutil.copyfile(os.path.join(dump, name),
                            f"{db}_{name[:-4]}.dmp")
        deln = os.path.join(dump, "delnodes.dmp")
        if os.path.exists(deln):
            shutil.copyfile(deln, f"{db}_delnodes.dmp")
    acc2tax = {}
    for line in open(mapping_file):
        parts = line.split()
        if len(parts) >= 2:
            acc2tax[parts[0]] = int(parts[1])
    mapping = {}
    for line in open(db + ".lookup"):
        parts = line.split("\t")
        if len(parts) >= 2 and parts[1] in acc2tax:
            mapping[int(parts[0])] = acc2tax[parts[1]]
    taxmod.write_mapping(db + "_mapping", mapping)
    return 0


def _nrtotaxmapping(positional, space, stats):
    """nrtotaxmapping (util/nrtotaxmapping.cpp:51-283): derive a
    <db>_mapping from NR-style headers — accession lookup in the given
    accession2taxid files, falling back to the species name in the last
    space-preceded [bracket]; per-record LCA over all header entries."""
    import gzip

    from ..data import taxonomy as taxmod
    if len(positional) < 3:
        raise ValueError("usage: nrtotaxmapping <i:acc2taxid...> "
                         "<i:seqDB> <o:mappingFile>")
    acc_files = positional[:-2]
    seq_db = positional[-2]
    out_path = positional[-1]
    acc2tax = {}
    for path in acc_files:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            for line in f:
                cols = line.split()
                if len(cols) < 4:
                    raise ValueError(f"Invalid accession2taxid file {path}")
                # fast_atoi: header rows ("taxid") parse to 0
                m = re.match(r"\d+", cols[2])
                acc2tax[cols[0].encode()] = int(m.group()) if m else 0
    tax = taxmod.Taxonomy.open(seq_db)
    # names that identify exactly one taxon (the reference additionally
    # drops the lexicographically-last name when only two nodes exist,
    # nrtotaxmapping.cpp:110-120)
    name_count = {}
    name_tax = {}
    for node in tax.nodes.values():
        name = node.name.encode()
        name_count[name] = name_count.get(name, 0) + 1
        name_tax[name] = node.tax_id
    n_nodes = len(tax.nodes)
    uniq_names = {n: t for n, t in name_tax.items()
                  if name_count[n] == 1}
    if n_nodes == 2 and len(uniq_names) == 2:
        del uniq_names[max(uniq_names)]
    elif n_nodes == 1:
        uniq_names = {}
    hdb = seqdb.SeqDB.open(seq_db + "_h")
    mapping = []
    for i in seqdb.data_order(hdb):
        key = int(hdb.keys[i])
        rec = hdb.get_data(i).tobytes()
        taxa = []
        n = len(rec)
        idx = 0
        start = 0
        is_in_acc = True
        start_name = end_name = 0
        in_species = need_species = False
        done = False
        while not done:
            c = rec[idx] if idx < n else 0
            if c in (10, 0):
                done = True
                c = 1  # FALLTHROUGH to the entry-separator case
            if c == 1:
                if need_species and in_species:
                    t = uniq_names.get(rec[start_name:end_name], 0)
                    if t:
                        taxa.append(t)
                idx += 1
                start = idx
                is_in_acc = True
                need_species = False
                in_species = False
            elif c == 0x5B:  # '[' — only counts with a space before it
                if idx > 0 and rec[idx - 1] == 0x20:
                    idx += 1
                    start_name = idx
                    end_name = idx
                    in_species = True
            elif c == 0x5D:  # ']'
                end_name = idx
            elif c in (0x2E, 0x20):  # '.' / ' ' end the accession
                if is_in_acc:
                    t = acc2tax.get(rec[start:idx], 0)
                    if t:
                        taxa.append(t)
                    else:
                        need_species = True
                    is_in_acc = False
            idx += 1
        node = tax.lca(taxa) if taxa else None
        if node is not None:
            mapping.append((key, node.tax_id))
    mapping.sort(key=lambda kv: kv[0])
    with open(out_path, "w") as f:
        for key, taxid in mapping:
            f.write(f"{key}\t{taxid}\n")
    return 0


def _createbintaxonomy(positional, space, stats):
    """createbintaxonomy (taxonomy/createbintaxonomy.cpp:6-20): serialize
    names/nodes/merged dmp files to the version-2 binary taxonomy dump."""
    from ..data import taxonomy as taxmod
    if len(positional) != 4:
        raise ValueError("usage: createbintaxonomy <i:names.dmp> "
                         "<i:nodes.dmp> <i:merged.dmp> <o:taxonomyFile>")
    data = taxmod.serialize_taxonomy(positional[0], positional[1],
                                     positional[2])
    with open(positional[3], "wb") as f:
        f.write(data)
    return 0


def _tax_result_suffix(tax, node, ranks, show_lineage):
    parts = [str(node.tax_id), node.rank, node.name]
    if ranks:
        parts.append(";".join(tax.at_ranks(node, ranks)))
    if show_lineage == 1:
        parts.append(tax.tax_lineage(node, True))
    elif show_lineage == 2:
        parts.append(tax.tax_lineage(node, False))
    return "\t".join(parts)


def _lca(positional, space, stats, majority=False):
    """lca / majoritylca (lca.cpp): LCA of each record's target taxa,
    with the default unclassified-sequences blacklist."""
    from ..data import taxonomy as taxmod
    if len(positional) != 3:
        raise ValueError("usage: lca <i:taxSeqDB> <i:resultDB> <o:taxDB>")
    v = space.values
    tax = taxmod.Taxonomy.open(positional[0])
    mapping = taxmod.read_mapping(positional[0] + "_mapping")
    db = seqdb.SeqDB.open(positional[1])
    ranks = [r for r in v.get("lca_ranks", "").split(",") if r]
    show_lineage = v.get("tax_lineage", 0)
    blacklist = taxmod.parse_blacklist(tax, v.get("blacklist",
                                                  taxmod.DEFAULT_BLACKLIST))
    no_tax = "0\tno rank\tunclassified"
    if ranks:
        no_tax += "\t"
    if show_lineage > 0:
        no_tax += "\t"
    w = seqdb.DBWriter(seqdb.TAX_RES)
    order = sorted(range(db.size), key=lambda j: int(db.offsets[j]))
    for i in order:
        key = int(db.keys[i])
        data = db.get_data(i).tobytes()
        taxa = []
        for line in data.decode().splitlines():
            if not line:
                continue
            tkey = int(line.split("\t")[0].split()[0])
            taxon = mapping.get(tkey)
            if taxon is None:
                continue
            if any(tax.is_ancestor(b, taxon) for b in blacklist):
                continue
            if majority:
                taxa.append((taxon, 1.0))
            else:
                taxa.append(taxon)
        if len(data) <= 1:
            w.write(key, (no_tax + "\n").encode(), add_newline=False)
            continue
        if majority:
            sel = taxmod.weighted_majority_lca(
                tax, taxa, v.get("majority", 0.5))
            node = tax.node(sel) if sel else None
        else:
            node = tax.lca(taxa)
        if node is None:
            w.write(key, (no_tax + "\n").encode(), add_newline=False)
            continue
        w.write(key, (_tax_result_suffix(tax, node, ranks, show_lineage)
                      + "\n").encode(), add_newline=False)
    w.finish().save(positional[2])
    return 0


def _majoritylca(positional, space, stats):
    return _lca(positional, space, stats, majority=True)


def _addtaxonomy(positional, space, stats):
    """addtaxonomy.cpp: append taxid/rank/name columns to result lines."""
    from ..data import taxonomy as taxmod
    if len(positional) != 3:
        raise ValueError(
            "usage: addtaxonomy <i:taxSeqDB> <i:resultDB> <o:resultDB>")
    v = space.values
    tax = taxmod.Taxonomy.open(positional[0])
    mapping = taxmod.read_mapping(positional[0] + "_mapping")
    db = seqdb.SeqDB.open(positional[1])
    ranks = [r for r in v.get("lca_ranks", "").split(",") if r]
    show_lineage = v.get("tax_lineage", 0)
    # --pick-id-from: 1 = record key (query), 2 = first column (target)
    pick_query = v.get("pick_id_from", 2) == 1
    w = seqdb.DBWriter(db.dbtype)
    for i in seqdb.data_order(db):
        data = db.get_data(i).tobytes()
        if len(data) <= 1:
            continue  # empty input records are skipped (addtaxonomy.cpp:64)
        if pick_query:
            taxon = mapping.get(int(db.keys[i]))
            if taxon is None or tax.node(taxon) is None:
                continue
        out = []
        for line in data.decode().splitlines():
            if not line:
                continue
            if pick_query:
                taxon = mapping.get(int(db.keys[i]))
            else:
                tkey = int(line.split("\t")[0].split()[0])
                taxon = mapping.get(tkey)
            node = tax.node(taxon) if taxon else None
            if node is None:
                continue
            out.append(line + "\t"
                       + _tax_result_suffix(tax, node, ranks, show_lineage))
        w.write(int(db.keys[i]),
                "".join(l + "\n" for l in out).encode(),
                add_newline=False)
    w.finish().save(positional[2])
    return 0


def _taxonomyreport(positional, space, stats):
    """taxonomyreport.cpp: Kraken-style clade report from a taxonomy
    result DB (children sorted by descending clade count)."""
    from ..data import taxonomy as taxmod
    if len(positional) != 3:
        raise ValueError(
            "usage: taxonomyreport <i:taxSeqDB> <i:taxResultDB> <o:tsv>")
    tax = taxmod.Taxonomy.open(positional[0])
    db = seqdb.SeqDB.open(positional[1])
    per_taxon = {}
    total = db.size
    for i in range(db.size):
        data = db.get_data(i).tobytes().decode()
        taxon = 0
        first = data.split("\n", 1)[0]
        if first:
            taxon = int(first.split("\t")[0])
        per_taxon[taxon] = per_taxon.get(taxon, 0) + 1
    # clade counts + children
    clade = {}
    children = {}
    for taxon, cnt in per_taxon.items():
        if taxon == 0:
            clade[0] = clade.get(0, 0) + cnt
            continue
        lineage = tax._lineage_ids(taxon)
        for t in lineage:
            clade[t] = clade.get(t, 0) + cnt
        for child, parent in zip(lineage[:-1], lineage[1:]):
            children.setdefault(parent, set()).add(child)
    out = open(positional[2], "w")

    def emit(taxon, depth):
        cnt = clade.get(taxon, 0)
        if cnt == 0:
            return
        node = tax.node(taxon)
        out.write(f"{100 * cnt / float(total):.4f}\t{cnt}\t"
                  f"{per_taxon.get(taxon, 0)}\t{node.rank}\t{taxon}\t"
                  f"{'  ' * depth}{node.name}\n")
        for c in sorted(children.get(taxon, ()),
                        key=lambda t: -clade.get(t, 0)):
            emit(c, depth + 1)
    if clade.get(0, 0) > 0:
        out.write(f"{100 * clade[0] / float(total):.4f}\t{clade[0]}\t"
                  f"{per_taxon.get(0, 0)}\tno rank\t0\tunclassified\n")
    emit(1, 0)
    out.close()
    return 0


def _filtertaxdb(positional, space, stats):
    """filtertaxdb.cpp: keep result lines whose taxon matches the
    taxonomy expression (--taxon-list, '!' negates)."""
    from ..data import taxonomy as taxmod
    if len(positional) != 3:
        raise ValueError(
            "usage: filtertaxdb <i:taxSeqDB> <i:taxResultDB> <o:taxResultDB>")
    tax = taxmod.Taxonomy.open(positional[0])
    expr = taxmod.TaxonomyExpression(
        space.values.get("taxon_list", ""), tax)
    db = seqdb.SeqDB.open(positional[1])
    w = seqdb.DBWriter(db.dbtype)
    for i in seqdb.data_order(db):
        out = []
        for line in db.get_data(i).tobytes().decode().splitlines():
            if not line:
                continue
            taxon = int(line.split("\t")[0])
            if expr.matches(taxon):
                out.append(line)
        w.write(int(db.keys[i]),
                "".join(l + "\n" for l in out).encode(),
                add_newline=False)
    w.finish().save(positional[2])
    return 0


def _aggregate_tax(positional, space, stats, use_aln):
    """aggregatetax / aggregatetaxweights (taxonomy/aggregatetax.cpp:15-188):
    weighted-majority-LCA over the taxa of each set's member sequences;
    weights from the member's alignment E-value or score when use_aln."""
    import math

    import numpy as np

    from ..data import taxonomy as taxmod
    n_pos = 5 if use_aln else 4
    if len(positional) != n_pos:
        raise ValueError("aggregatetax needs %d positional args" % n_pos)
    v = space.values
    tax = taxmod.Taxonomy.open(positional[0])
    set_db = seqdb.SeqDB.open(positional[1])
    tax_db = seqdb.SeqDB.open(positional[2])
    aln_db = seqdb.SeqDB.open(positional[3]) if use_aln else None
    out_path = positional[4] if use_aln else positional[3]
    ranks = [r for r in v.get("lca_ranks", "").split(",") if r]
    vote_mode = v.get("vote_mode", taxmod.AGG_TAX_MINUS_LOG_EVAL)
    majority = v.get("majority", 0.5)
    show_lineage = v.get("tax_lineage", 0)
    writer = seqdb.DBWriter(seqdb.TAX_RES)
    flt_max = 3.4028234663852886e38
    for i in seqdb.data_order(set_db):
        set_key = int(set_db.keys[i])
        hits = []
        for line in set_db.get_data(i).tobytes().decode().split("\n"):
            if not line:
                continue
            seq_key = int(line.split()[0])
            tid = tax_db.key_to_id(seq_key)
            if tid is None:
                raise ValueError(f"Missing key {seq_key} in tax result")
            taxon = int(tax_db.get_data(tid).tobytes().decode().split()[0])
            if use_aln and taxon != 0:
                aid = aln_db.key_to_id(seq_key)
                if aid is None:
                    raise ValueError("Missing key in alignment result")
                cols = (aln_db.get_data(aid).tobytes().decode()
                        .split("\n")[0].split())
                weight = flt_max
                if vote_mode == taxmod.AGG_TAX_MINUS_LOG_EVAL:
                    weight = float(cols[3])
                elif vote_mode == taxmod.AGG_TAX_SCORE:
                    weight = float(cols[1])
                hits.append((taxon,
                             taxmod.weighted_tax_hit_weight(weight,
                                                            vote_mode)))
            else:
                hits.append((taxon, 1.0))
        (sel, assigned, unassigned, agree,
         percent) = taxmod.weighted_majority_lca_full(tax, hits, majority)
        node = tax.node(sel)
        total = assigned + unassigned
        # SSTR(roundf(p*100)/100): float round-half-away, then %.3f
        fv = float(np.float32(percent * 100))
        r = math.floor(fv) + (1 if fv - math.floor(fv) >= 0.5 else 0)
        pct_str = "%.3f" % float(np.float32(r) / np.float32(100))
        if sel == 0 or node is None:
            parts = ["0", "no rank", "unclassified", str(total),
                     str(assigned), str(agree), pct_str]
            line = "\t".join(parts)
            if ranks:
                line += "\t"
            if show_lineage > 0:
                line += "\t"
        else:
            parts = [str(node.tax_id), node.rank, node.name, str(total),
                     str(assigned), str(agree), pct_str]
            line = "\t".join(parts)
            if ranks:
                line += "\t" + ";".join(tax.at_ranks(node, ranks))
            if show_lineage == 1:
                line += "\t" + tax.tax_lineage(node, True)
            elif show_lineage == 2:
                line += "\t" + tax.tax_lineage(node, False)
        writer.write(set_key, (line + "\n").encode(), add_newline=False)
    writer.finish().save(out_path)
    return 0


def _aggregatetax(positional, space, stats):
    return _aggregate_tax(positional, space, stats, False)


def _aggregatetaxweights(positional, space, stats):
    return _aggregate_tax(positional, space, stats, True)


def _filtertaxseqdb(positional, space, stats):
    """filtertaxseqdb (taxonomy/filtertaxseqdb.cpp:19-115): keep sequence
    records whose _mapping taxon matches the taxonomy expression; hard
    mode rewrites data, soft mode (--subdb-mode 1) keeps only the index
    and links the data file; ancillary files are symlinked either way."""
    from ..data import taxonomy as taxmod
    from ..data.dbtools import softlink_ancillary
    if len(positional) != 2:
        raise ValueError("usage: filtertaxseqdb <i:taxSeqDB> <o:taxSeqDB>")
    src, dst = positional
    tax = taxmod.Taxonomy.open(src)
    mapping = taxmod.read_mapping(src + "_mapping")
    expr = taxmod.TaxonomyExpression(
        space.values.get("taxon_list", ""), tax)
    db = seqdb.SeqDB.open(src)
    soft = space.values.get("subdb_mode", 0) == 1
    keep = [i for i in seqdb.data_order(db)
            if expr.matches(mapping.get(int(db.keys[i]), 0))]
    if soft:
        # SUBDB_MODE_SOFT: index entries point into the original data
        order = sorted(keep, key=lambda i: int(db.keys[i]))
        seqdb._write_index(dst + ".index", db.keys[order],
                           db.offsets[order], db.lengths[order])
        # DBFiles::SEQUENCE_NO_DATA_INDEX — link data + dbtype too
        for s in ("", ".dbtype"):
            if os.path.lexists(dst + s):
                os.unlink(dst + s)
            os.symlink(os.path.abspath(src + s), dst + s)
    else:
        w = seqdb.DBWriter(db.dbtype)
        for i in keep:
            w.write(int(db.keys[i]), db.get_data(i).tobytes(),
                    add_newline=False)
        w.finish().save(dst)
    softlink_ancillary(src, dst)
    return 0


def _taxonomy(positional, space, stats):
    """taxonomy workflow (Taxonomy.cpp:40-160 + taxonomy.sh): search
    (approximate-2bLCA via lcaalign by default, --lca-mode 4 = top hit,
    1 = all hits) -> lca; --tax-output-mode 1/2 exports the alignments."""
    from ..data.dbtools import mvdb
    if len(positional) != 4:
        raise ValueError(
            "usage: taxonomy <i:qDB> <i:taxSeqDB> <o:taxDB> <tmpDir>")
    q, t, out, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    # setTaxonomyDefaults (Taxonomy.cpp:13-24): sensitivity 2, -e 1,
    # --max-accept 30 --max-rejected 5
    v = space.values
    if "sensitivity" not in space.was_set:
        v["sensitivity"] = 2.0
        space.was_set.add("sensitivity")
    if "eval_thr" not in space.was_set:
        v["eval_thr"] = 1.0
        space.was_set.add("eval_thr")
    if "max_accept" not in space.was_set:
        v["max_accept"] = 30
    if "max_rejected" not in space.was_set:
        v["max_rejected"] = 5
    if "alignment_mode" not in space.was_set:
        v["alignment_mode"] = 1  # ALIGNMENT_MODE_SCORE_ONLY
        space.was_set.add("alignment_mode")
    lca_mode = v.get("lca_mode", 3)
    if lca_mode == 2:  # 2bLCA was replaced by approximate 2bLCA
        lca_mode = 3
    v["lca_search"] = lca_mode == 3
    first = os.path.join(tmp, "first")
    if not os.path.exists(first + ".dbtype"):
        _search([q, t, first, os.path.join(tmp, "tmp_hsp1")], space, stats)
    lca_in = first
    if lca_mode == 4:  # TOPHIT_MODE: keep hits tied with the best e-value
        top1 = os.path.join(tmp, "top1")
        sv = dict(space.values)
        space.values.update({"filter_file": "", "sort_entries": 0,
                             "extract_lines": 0, "beats_first": True,
                             "comparison_operator": "le",
                             "comparison_value": 0.0, "filter_column": 4})
        _filterdb([first, top1], space, stats)
        space.values.update(sv)
        lca_in = top1
    tax_output = v.get("tax_output_mode", 0)
    if tax_output == 0:
        return _lca([t, lca_in, out], space, stats)
    if tax_output == 2:
        rc = _lca([t, lca_in, out], space, stats)
        mvdb(lca_in, out + "_aln")
        return rc
    mvdb(lca_in, out)
    return 0


def _proteinaln2nucl(positional, space, stats):
    """proteinaln2nucl (util/proteinaln2nucl.cpp): map an amino-acid
    alignment DB onto the nucleotide sequences the proteins were
    translated from. Query and target are read from the query nucleotide
    and amino-acid DBs, as in the JAX package."""
    from ..ops.proteinaln2nucl import (nucl_results_to_db,
                                       protein_aln_to_nucl_records)
    if len(positional) != 6:
        raise ValueError("usage: proteinaln2nucl <i:qNuclDB> <i:tNuclDB> "
                         "<i:qAaDB> <i:tAaDB> <i:alnDB> <o:alnDB>")
    nucl_db = seqdb.SeqDB.open(positional[0])
    aa_db = seqdb.SeqDB.open(positional[2])
    alns = load_alignments_with_backtrace(positional[4])
    v = space.values
    out = protein_aln_to_nucl_records(nucl_db, aa_db, alns,
                                      gap_open=v.get("gap_open", 5),
                                      gap_extend=v.get("gap_extend", 2))
    nucl_results_to_db(out).save(positional[5])
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


def _tsv2db(positional, space, stats):
    from ..data.dbtools import tsv_to_db
    tsv_to_db(open(positional[0]).read(),
              int(space.values.get("output_dbtype", seqdb.GENERIC_DB))).save(positional[1])
    return 0


def _prefixid(positional, space, stats):
    from ..data.dbtools import prefix_id
    prefix_id(seqdb.SeqDB.open(positional[0])).save(positional[1])
    return 0


def _reverseseq(positional, space, stats):
    from ..data.dbtools import reverse_seq_db
    reverse_seq_db(seqdb.SeqDB.open(positional[0])).save(positional[1])
    return 0


BASE_COMMANDS = [
    Command("createdb", _createdb, lambda: port_space(P.common_flags() + P.orf_flags()),
            "<i:fastaFile1[.gz]> ... <o:seqDB>", "Convert FASTA/Q to sequence DB", hidden=True),
    Command("extractorfs", _extractorfs, lambda: port_space(P.common_flags() + P.orf_flags()),
            "<i:seqDB> <o:seqDB>", "Six-frame ORF extraction", hidden=True),
    Command("translatenucs", _translatenucs, lambda: port_space(P.common_flags() + P.orf_flags()),
            "<i:seqDB> <o:seqDB>", "Translate nucleotides to proteins", hidden=True),
    Command("kmermatcher", _kmermatcher, lambda: port_space(P.common_flags() + P.kmermatcher_flags() + P.align_flags()),
            "<i:seqDB> <o:prefDB>", "Find overlapping k-mers", hidden=True),
    Command("rescorediagonal", _rescorediagonal, lambda: port_space(P.common_flags() + P.kmermatcher_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <i:prefDB> <o:alnDB>", "Ungapped diagonal rescoring", hidden=True),
    Command("concatdbs", _concatdbs, lambda: port_space(P.common_flags() + [
        P.Flag("--preserve-keys", "preserve_keys", bool, False,
               "Keep the keys of both DBs (must be disjoint or "
               "--take-larger-entry)"),
        P.Flag("--take-larger-entry", "take_larger_entry", bool, False,
               "For duplicate keys keep the larger record")]),
            "<i:db1> <i:db2> <o:db>", "Concatenate DBs", hidden=True),
    Command("createsubdb", _createsubdb, lambda: port_space(P.common_flags() + [
        P.Flag("--subdb-mode", "subdb_mode", int, 0,
               "0: copy data, 1: soft link data and write index", r"[0-1]"),
        P.Flag("--id-mode", "id_mode", int, 0,
               "0: database keys, 1: line numbers", r"[0-1]")]),
            "<i:subsetFile> <i:db> <o:db>", "Create subset DB", hidden=True),
    Command("convert2fasta", _convert2fasta, lambda: port_space(P.common_flags()),
            "<i:seqDB> <o:fasta>", "Convert DB to FASTA", hidden=True),
    Command("rmdb", _rmdb, lambda: port_space(P.common_flags()),
            "<i:db>", "Remove a DB file family", hidden=True),
    Command("align", _align, lambda: port_space(P.common_flags() + P.kmermatcher_flags() + P.align_flags() + [
        P.Flag("--alignment-mode", "alignment_mode", int, 0,
               "0 auto, 1 score+end, 2 +start+cov, 3 +seq.id", r"[0-5]"),
        P.Flag("--max-accept", "max_accept", int, 2**31 - 1, "Maximum accepted alignments per query"),
        P.Flag("--max-rejected", "max_rejected", int, 2**31 - 1, "Maximum rejected alignments before give-up")]),
            "<i:qDB> <i:tDB> <i:prefDB> <o:alnDB>", "Gapped banded alignment", hidden=True),
    Command("lcaalign", _lcaalign, lambda: port_space(P.common_flags() + P.kmermatcher_flags() + P.align_flags() + [
        P.Flag("--alignment-mode", "alignment_mode", int, 0,
               "0 auto, 1 score+end, 2 +start+cov, 3 +seq.id", r"[0-5]"),
        P.Flag("--max-accept", "max_accept", int, 2**31 - 1, "Maximum accepted alignments per query"),
        P.Flag("--max-rejected", "max_rejected", int, 2**31 - 1, "Maximum rejected alignments before give-up")]),
            "<i:qDB> <i:tDB> <i:prefDB> <o:alnDB>", "Efficient gapped alignment for lca computation", hidden=True),
    Command("prefilter", _prefilter, lambda: port_space(P.common_flags() + P.search_flags() + [
        P.Flag("-c", "cov_thr", float, 0.0, "Coverage threshold"),
        P.Flag("--cov-mode", "cov_mode", int, 0, "Coverage mode", r"[0-5]")]),
            "<i:qDB> <i:tDB> <o:prefDB>", "Sensitive double-k-mer-match prefilter", hidden=True),
    Command("orftocontig", _orftocontig, lambda: port_space(P.common_flags()),
            "<i:contigDB> <i:orfDB> <o:alnDB>", "Write ORF locations as alignment records", hidden=True),
    Command("result2stats", _result2stats, lambda: port_space(P.common_flags() + [
        P.Flag("--stat", "stat", str, "linecount", "Statistic to compute")]),
            "<i:qDB> <i:tDB> <i:resultDB> <o:statsDB>", "Per-record statistics", hidden=True),
    Command("besthitperset", _besthitperset, lambda: port_space(P.common_flags() + [
        P.Flag("--simple-best-hit", "simple_best_hit", bool, False, "Use E-value instead of corrected P")]),
            "<i:qDB> <i:tDB> <i:resultDB> <o:db>", "Best hit per target set", hidden=True),
    Command("combinepvalperset", _combinepvalperset, lambda: port_space(P.common_flags() + [
        P.Flag("--alpha", "alpha", float, 1.0, "Truncation threshold numerator"),
        P.Flag("--aggregation-mode", "aggregation_mode", int, 0,
               "0 multihit, 1 min, 2 product, 3 truncated product", r"[0-3]")]),
            "<i:qDB> <i:tDB> <i:resultDB> <o:db>", "Combine P-values per target set", hidden=True),
    Command("mergeresultsbyset", _mergeresultsbyset, lambda: port_space(P.common_flags()),
            "<i:setDB> <i:resultDB> <o:db>", "Concatenate member results per set", hidden=True),
    Command("multihitdb", _multihitdb, lambda: port_space(P.common_flags() + P.orf_flags()),
            "<i:fasta1> ... <o:setDB> <tmpDir>", "Build a multi-hit set database", hidden=True),
    Command("multihitsearch", _multihitsearch, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--simple-best-hit", "simple_best_hit", bool, False, "Use E-value instead of corrected P")]),
            "<i:qSetDB> <i:tSetDB> <o:db> <tmpDir>", "Search with per-set aggregation", hidden=True),
    Command("createtaxdb", _createtaxdb, lambda: port_space(P.common_flags() + [
        P.Flag("--ncbi-tax-dump", "ncbi_tax_dump", str, "", "Directory with NCBI nodes/names/merged dmp files"),
        P.Flag("--tax-mapping-file", "tax_mapping_file", str, "", "Accession to taxid TSV"),
        P.Flag("--tax-db-mode", "tax_db_mode", int, 1,
               "0: .dmp flat files, 1: binary dump", r"[0-1]")]),
            "<i:seqDB> <tmpDir>", "Attach an NCBI taxonomy to a sequence DB", hidden=True),
    Command("nrtotaxmapping", _nrtotaxmapping,
            lambda: port_space(P.common_flags()),
            "<i:acc2taxid...> <i:seqDB> <o:mappingFile>",
            "Create a taxonomy mapping for NR-style headers", hidden=True),
    Command("createbintaxonomy", _createbintaxonomy,
            lambda: port_space(P.common_flags()),
            "<i:names.dmp> <i:nodes.dmp> <i:merged.dmp> <o:taxonomyFile>",
            "Serialize an NCBI taxonomy dump to a binary file", hidden=True),
    Command("lca", _lca, lambda: port_space(P.common_flags() + P.tax_flags()),
            "<i:taxSeqDB> <i:resultDB> <o:taxDB>", "Lowest common ancestor per query", hidden=True),
    Command("majoritylca", _majoritylca, lambda: port_space(P.common_flags() + P.tax_flags()),
            "<i:taxSeqDB> <i:resultDB> <o:taxDB>", "Weighted majority LCA per query", hidden=True),
    Command("addtaxonomy", _addtaxonomy, lambda: port_space(P.common_flags() + P.tax_flags() + [
        P.Flag("--pick-id-from", "pick_id_from", int, 2,
               "Extract mode: 1 query, 2 target", r"[1-2]")]),
            "<i:taxSeqDB> <i:resultDB> <o:resultDB>", "Annotate result lines with taxonomy", hidden=True),
    Command("taxonomyreport", _taxonomyreport, lambda: port_space(P.common_flags() + P.tax_flags()),
            "<i:taxSeqDB> <i:taxResultDB> <o:tsv>", "Kraken-style taxonomy report", hidden=True),
    Command("aggregatetax", _aggregatetax, lambda: port_space(
        P.common_flags() + P.tax_flags()),
            "<i:taxSeqDB> <i:setToSeqMap> <i:taxResPerSeqDB> <o:taxResPerSetDB>",
            "Aggregate multiple taxon labels to a single label", hidden=True),
    Command("aggregatetaxweights", _aggregatetaxweights, lambda: port_space(
        P.common_flags() + P.tax_flags()),
            "<i:taxSeqDB> <i:setToSeqMap> <i:taxResPerSeqDB> <i:alnPerSeqDB> <o:taxResPerSetDB>",
            "Aggregate multiple taxon labels to a single label", hidden=True),
    Command("filtertaxseqdb", _filtertaxseqdb, lambda: port_space(
        P.common_flags() + P.tax_flags() + [
            P.Flag("--subdb-mode", "subdb_mode", int, 0,
                   "0: copy data, 1: soft link data and write index",
                   r"[0-1]")]),
            "<i:taxSeqDB> <o:taxSeqDB>",
            "Filter taxonomy sequence database", hidden=True),
    Command("filtertaxdb", _filtertaxdb, lambda: port_space(P.common_flags() + P.tax_flags()),
            "<i:taxSeqDB> <i:taxResultDB> <o:taxResultDB>", "Filter by taxonomy expression", hidden=True),
    Command("taxonomy", _taxonomy, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags() + P.tax_flags()),
            "<i:qDB> <i:taxSeqDB> <o:taxDB> <tmpDir>", "Taxonomic classification (search + LCA)", hidden=True),
    Command("subtractdbs", _subtractdbs, lambda: port_space(P.common_flags() + [
        P.Flag("-e", "eval_thr", float, 0.001, "E-value threshold"),
        P.Flag("--e-profile", "eval_profile", float, 0.001, "Profile E-value threshold")]),
            "<i:leftDB> <i:rightDB> <o:db>", "Remove right-side hits from left result DB", hidden=True),
    Command("splitsequence", _splitsequence, lambda: port_space(P.common_flags() + [
        P.Flag("--max-seq-len", "split_seq_len", int, 10000, "Window length"),
        P.Flag("--sequence-overlap", "sequence_overlap", int, 300, "Window overlap"),
        P.Flag("--sequence-split-mode", "sequence_split_mode", int, 1, "0 copy data, 1 soft link", r"[0-1]")]),
            "<i:seqDB> <o:seqDB>", "Split long sequences into overlapping windows", hidden=True),
    Command("extractframes", _extractframes, lambda: port_space(P.common_flags() + [
        P.Flag("--forward-frames", "forward_frames", str, "1,2,3", "Forward frames"),
        P.Flag("--reverse-frames", "reverse_frames", str, "1,2,3", "Reverse frames")]),
            "<i:seqDB> <o:seqDB>", "Extract reading frames", hidden=True),
    Command("touchdb", _touchdb, lambda: port_space(P.common_flags()),
            "<i:db>", "Page a DB into memory", hidden=True),
    Command("diskspaceavail", _diskspaceavail, lambda: port_space(P.common_flags()),
            "<i:path>", "Print available disk space (KB)", hidden=True),
    Command("apply", _apply, lambda: port_space(P.common_flags()),
            "<i:db> <o:db> -- <program> [args]", "Run a program on every DB entry", hidden=True),
    Command("tar2db", _tar2db, lambda: port_space(P.common_flags()),
            "<i:tar> <o:db>", "Convert tar archive members to DB records", hidden=True),
    Command("swapdb", _swapdb, lambda: port_space(P.common_flags()),
            "<i:resultDB> <o:resultDB>", "Transpose a result DB", hidden=True),
    Command("cluster", _cluster, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--cluster-mode", "cluster_mode", int, 0, "0 set-cover, 1 connected component, 2 greedy", r"[0-3]"),
        P.Flag("--cluster-steps", "cluster_steps", int, 3, "Cascaded clustering steps")]),
            "<i:seqDB> <o:cluDB> <tmpDir>", "Cascaded clustering", hidden=True),
    Command("easy-cluster", _easy_cluster, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--cluster-mode", "cluster_mode", int, 0, "0 set-cover, 1 connected component, 2 greedy", r"[0-3]"),
        P.Flag("--use-fasta-header", "use_fasta_header", bool, False, "Use full fasta header")]),
            "<i:fasta> <o:prefix> <tmpDir>", "Cascaded clustering (FASTA in, FASTA/TSV out)", hidden=True),
    Command("easy-linclust", _easy_linclust, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--use-fasta-header", "use_fasta_header", bool, False, "Use full fasta header")]),
            "<i:fasta> <o:prefix> <tmpDir>", "Linear-time clustering (FASTA in, FASTA/TSV out)", hidden=True),
    Command("result2flat", _result2flat, lambda: port_space(P.common_flags() + [
        P.Flag("--use-fasta-header", "use_fasta_header", bool, False, "Use full fasta header")]),
            "<i:qDB> <i:tDB> <i:resDB> <o:fasta>", "Flatten result DB to FASTA", hidden=True),
    Command("createseqfiledb", _createseqfiledb, lambda: port_space(P.common_flags()),
            "<i:seqDB> <i:cluDB> <o:db>", "Per-cluster FASTA records", hidden=True),
    Command("easy-search", _easy_search, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:queryFasta> <i:targetFasta> <o:tsv> <tmpDir>", "Sensitive homology search (FASTA in, BLAST-tab out)", hidden=True),
    Command("convertalis", _convertalis, lambda: port_space(P.common_flags()),
            "<i:qDB> <i:tDB> <i:alnDB> <o:tsv>", "Convert alignment DB to BLAST-tab TSV", hidden=True),
    Command("search", _search, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags() + [
        P.Flag("--num-iterations", "num_iterations", int, 1,
               "Number of iterative profile search iterations"),
        P.Flag("--e-profile", "eval_profile", float, 0.1,
               "E-value threshold for intermediate profiles")]),
            "<i:qDB> <i:tDB> <o:alnDB> <tmpDir>", "Sensitive homology search (prefilter + align)", hidden=True),
    Command("clust", _clust, lambda: port_space(P.common_flags()),
            "<i:seqDB> <i:alnDB> <o:cluDB>", "Greedy incremental clustering", hidden=True),
    Command("mergeclusters", _mergeclusters, lambda: port_space(P.common_flags()),
            "<i:seqDB> <o:cluDB> <i:clu1> ...", "Merge clustering steps", hidden=True),
    Command("result2repseq", _result2repseq, lambda: port_space(P.common_flags()),
            "<i:seqDB> <i:resultDB> <o:seqDB>", "Extract representative sequences", hidden=True),
    Command("filterdb", _filterdb, lambda: port_space(P.common_flags() + [
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
    Command("result2rbh", _result2rbh, lambda: port_space(P.common_flags()),
            "<i:resDB> <o:resDB>", "Extract reciprocal best hits", hidden=True),
    Command("rbh", _rbh, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:aDB> <i:bDB> <o:resDB> <tmpDir>", "Reciprocal best hit search", hidden=True),
    Command("map", _map, lambda: port_space(P.common_flags() + P.search_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <o:alnDB> <tmpDir>", "Fast exact mapping (high-identity search)", hidden=True),
    Command("proteinaln2nucl", _proteinaln2nucl, lambda: port_space(P.common_flags() + P.align_flags()),
            "<i:qNuclDB> <i:tNuclDB> <i:qAaDB> <i:tAaDB> <i:alnDB> <o:alnDB>",
            "Map protein alignments to nucleotide space", hidden=True),
    Command("mvdb", _mvdb, lambda: port_space(P.common_flags()),
            "<i:db> <o:db>", "Move a DB file family", hidden=True),
    Command("cpdb", _cpdb, lambda: port_space(P.common_flags()),
            "<i:db> <o:db>", "Copy a DB file family", hidden=True),
    Command("lndb", _lndb, lambda: port_space(P.common_flags()),
            "<i:db> <o:db>", "Symlink a DB file family", hidden=True),
    Command("sortresult", _sortresult, lambda: port_space(P.common_flags()),
            "<i:resDB> <o:resDB>", "Sort result records by E-value/score", hidden=True),
    Command("swapresults", _swapresults, lambda: port_space(P.common_flags() + P.align_flags()),
            "<i:qDB> <i:tDB> <i:resDB> <o:resDB>", "Transpose query/target results", hidden=True),
    Command("mergedbs", _mergedbs, lambda: port_space(P.common_flags()),
            "<i:qDB> <o:db> <i:db1> ...", "Concatenate records per key", hidden=True),
    Command("splitdb", _splitdb, lambda: port_space(P.common_flags() + [
        P.Flag("--split", "split", int, 2, "Number of shards")]),
            "<i:db> <o:dbPrefix>", "Split DB into shards", hidden=True),
    Command("createtsv", _createtsv, lambda: port_space(P.common_flags()),
            "<i:db> [<i:hdb>] <o:tsv>", "Convert DB to TSV", hidden=True),
    Command("tsv2db", _tsv2db, lambda: port_space(P.common_flags() + [
        P.Flag("--output-dbtype", "output_dbtype", int, 12, "Output DB type")]),
            "<i:tsv> <o:db>", "Convert TSV to DB", hidden=True),
    Command("prefixid", _prefixid, lambda: port_space(P.common_flags()),
            "<i:db> <o:db>", "Prefix each line with the record key", hidden=True),
    Command("reverseseq", _reverseseq, lambda: port_space(P.common_flags()),
            "<i:seqDB> <o:seqDB>", "Reverse sequences", hidden=True),
]

from .tools_db import COMMANDS as _DB_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_DB_COMMANDS)
from .tools_profile import COMMANDS as _PROFILE_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_PROFILE_COMMANDS)
from .tools_misc import COMMANDS as _MISC_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_MISC_COMMANDS)
from .tools_domain import COMMANDS as _DOMAIN_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_DOMAIN_COMMANDS)
from .tools_linsearch import COMMANDS as _LINSEARCH_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_LINSEARCH_COMMANDS)
from .tools_databases import COMMANDS as _DATABASES_COMMANDS  # noqa: E402
BASE_COMMANDS.extend(_DATABASES_COMMANDS)
