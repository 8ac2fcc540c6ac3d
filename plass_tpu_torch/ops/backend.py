"""Host <-> device glue of the assemble and nuclassemble slices: run the
device k-mer matcher (monolithic, or split into hash ranges when its table
would not fit) and the device rescore on a SeqDB (protein or
nucleotide) and return host-format results.

The hits stay on the device between the two steps: the matcher keeps
(rep, tgt, diag, reverse) as tensors, and the rescore addresses them by
index (the JAX package's _rescore_from_dev_pallas). The self rows join
the hits in the rescore's launch, as hits at diagonal 0. Only (qk, tk,
score, diag) go to the host, for the native finish.

Across ranks (kmermatcher_sharded_torch, parallel/mesh.py) each rank
rescores its own hits as part of the matcher, and the hits carry those
columns to rescore_diagonal_torch (KmerHits.pre).
"""
import ctypes
import warnings

import numpy as np
import torch

from .. import constants, native
from ..data import seqdb
from ..utils.trace import span
from . import device_kmer
from .device_kmer import KmerParams, ksel_capacity
from .kmermatch import ENTRY_BYTES, estimate_kmer_count, parse_memory_limit
from .rescore_kernel import (rescore_align, rescore_e2e, rescore_hamming,
                             uniform_pattern)

# The automatic split budget on the card (split_memory_limit 0). The
# monolithic matcher's peak device memory per table entry in its pair and
# merge stages, the table included: at most 124.9 bytes on the iteration-0
# and last-iteration tables of chip_smoke.py's split-main phase (H100 80GB
# HBM3; PERF.md §5), which fails if a table needs more
BYTES_PER_ENTRY = 128
# what stays resident per table entry on the split path: the table (k-mer
# 8, id 4, pos 4, length 4, range key 4 bytes), then the kept pairs (rep,
# tgt, diag << 1 | rev: 12 bytes)
RESIDENT_BYTES = 36
# the share of the card's free memory the matcher plans to use; the rest
# covers the selection stage's fixed block (device_kmer.SELECT_CELLS) and
# the allocator's fragmentation
AUTO_SHARE = 0.75

# the self rows rescore_diagonal_torch has handed to its rescore's launch,
# summed over calls: one a sequence a call
SELF_ROWS = 0


def _matrix(db, alphabet):
    """The DB's matrix for `alphabet`: the nucleotide matrix for both
    'kmer' and 'score' on a nucleotide DB; reduced-13 or blosum62 on a
    protein DB."""
    if db.dbtype == seqdb.NUCLEOTIDES:
        return constants.nucleotide()
    return constants.reduced(13) if alphabet == "kmer" else constants.blosum62()


def flat_rows(db, device, alphabet="score"):
    """The sequences of a SeqDB on `device` as the matcher and K2 read
    them: (rows uint8[T], offsets int64[N], lengths int32[N], code_lut
    uint8[256]). rows is the DB's data as it is, terminators included, so
    a call uploads the DB's own bytes and no padded [N, W] copy exists on
    either side; code_lut maps a byte to its code in `alphabet` ('kmer':
    reduced-13 or nucleotide, 'score': blosum62 or nucleotide)."""
    mat = _matrix(db, alphabet)
    with span("upload.rows"):
        with warnings.catch_warnings():
            # a DB opened from disk is a read-only map; it is only read here
            warnings.filterwarnings("ignore", message=".*not writable.*")
            rows = torch.from_numpy(np.asarray(db.data))
        return (rows.to(device),
                torch.from_numpy(np.ascontiguousarray(
                    db.offsets, dtype=np.int64)).to(device),
                torch.from_numpy(db.seq_lens().astype(np.int32)).to(device),
                torch.from_numpy(np.ascontiguousarray(
                    mat.aa2num.astype(np.uint8))).to(device))


def kmermatcher_torch(db, k, device, kmers_per_sequence=21,
                      kmers_per_sequence_scale=None, hash_shift=67,
                      ignore_multi_kmer=False, include_only_extendable=False,
                      cov_thr=0.0, cov_mode=0, split_memory_limit=0):
    """Device k-mer matcher on `device`, protein or nucleotide.

    split_memory_limit (bytes of k-mer table at ENTRY_BYTES per entry, or
    a string with a K/M/G/T suffix, as --split-memory-limit): when the
    table's estimate exceeds it, the table is split into hash ranges of at
    most limit / ENTRY_BYTES entries (device_kmer.kmermatch_device); 0
    means automatic on a card (split_budget) and monolithic on the CPU.

    Returns the flat KmerHits (the JAX package's return_arrays format),
    whose raw hits stay on the device for rescore_diagonal_torch."""
    params = matcher_params(
        db, k, kmers_per_sequence=kmers_per_sequence,
        kmers_per_sequence_scale=kmers_per_sequence_scale,
        ignore_multi_kmer=ignore_multi_kmer,
        include_only_extendable=include_only_extendable, cov_thr=cov_thr,
        cov_mode=cov_mode)
    rows = flat_rows(db, device, "kmer")
    with span("kmermatch.budget"):
        budget = split_budget(db, params, device, split_memory_limit)
    rep, tgt, score, diag, table_entries, ranges = \
        device_kmer.kmermatch_device(
            *rows, torch.from_numpy(db.keys.astype(np.int32)).to(device),
            hash_shift, params, budget)
    with span("kmermatch.fetch"):
        host = (rep.cpu().numpy().astype(np.uint32),
                tgt.cpu().numpy().astype(np.uint32),
                score.cpu().numpy(), diag.cpu().numpy())
    with span("kmermatch.self_hits"):
        out = _insert_self_hits(db, *host)
    out.dev = (rep, tgt, diag, score < 0)
    out.table_entries = table_entries
    out.ranges = ranges
    return out


def match_kmers(db, k, device, backend="single", split_memory_limit=0,
                stats=None, **kw):
    """The workflows' k-mer matcher: kmermatcher_torch, or with backend
    "sharded" (utils/device.resolve_backend) kmermatcher_sharded_torch,
    which, as the JAX package's sharded path, takes no
    split_memory_limit. With stats, the sharded matcher's exchange bytes
    and seconds are added to stats["exchange_bytes"] and
    stats["exchange_seconds"], by exchange."""
    if backend != "sharded":
        return kmermatcher_torch(db, k, device,
                                 split_memory_limit=split_memory_limit, **kw)
    hits = kmermatcher_sharded_torch(db, k, device, **kw)
    if stats is not None:
        for key, part in (("exchange_bytes", hits.exchange.bytes),
                          ("exchange_seconds", hits.exchange.seconds)):
            total = stats.setdefault(key, {})
            for name, v in part.items():
                total[name] = total.get(name, 0) + v
    return hits


# the JAX package's row padding of a DB (its backend._bucket with
# db_to_padded's 2,048-row step): the sharded path pads no rows, but its
# segment edges, and so its output, follow the padded row count
PAD_ROWS = 2048


def padded_rows(n):
    """The JAX package's padded row count of a DB of n rows: steps of
    PAD_ROWS below 8 steps, then steps of an eighth of the power of two."""
    n, step = max(n, 1), PAD_ROWS
    if n > 8 * step:
        step = max(step, 1 << (int(n - 1).bit_length() - 3))
    return ((n + step - 1) // step) * step


def kmermatcher_sharded_torch(db, k, device, kmers_per_sequence=21,
                              kmers_per_sequence_scale=None, hash_shift=67,
                              ignore_multi_kmer=False,
                              include_only_extendable=False, cov_thr=0.0,
                              cov_mode=0):
    """The k-mer matcher across the ranks of the process group
    (parallel/mesh.sharded_iteration), each rank on `device`: the JAX
    package's kmermatcher_sharded(return_arrays=True) with one rank per
    mesh device. Every rank calls it on the same DB and gets the same
    KmerHits: the ranks' hits gathered in rank order, stable-sorted by
    representative key, with K2's columns in `.pre` (rescore mode 3) and
    the raw hits on the device in `.dev` for the other modes.

    Rank r owns the representatives of rows [r * s, (r + 1) * s), s the
    JAX package's padded row count over the world (padded_rows), so the
    segment edges, where runs are cut, fall where the JAX package's fall.
    With one rank there is no edge and the hits equal kmermatcher_torch's
    monolithic ones. `.exchange` holds the bytes this rank sent and the
    seconds of the table and pair exchanges and of the gather."""
    from ..parallel import distributed, mesh

    params = matcher_params(
        db, k, kmers_per_sequence=kmers_per_sequence,
        kmers_per_sequence_scale=kmers_per_sequence_scale,
        ignore_multi_kmer=ignore_multi_kmer,
        include_only_extendable=include_only_extendable, cov_thr=cov_thr,
        cov_mode=cov_mode)
    kmer_rows = flat_rows(db, device, "kmer")
    mat = _matrix(db, "score")
    score_rows = (*kmer_rows[:3], torch.from_numpy(np.ascontiguousarray(
        mat.aa2num.astype(np.uint8))).to(device))
    sub = torch.from_numpy(mat.sub.astype(np.int32)).to(device)
    rescore_kw = {}
    if params.is_nucl:
        rescore_kw = dict(
            comp=torch.from_numpy(mat.reverse.astype(np.int32)).to(device),
            code2char=torch.from_numpy(mat.num2aa.astype(np.uint8)).to(device),
            uniform=uniform_pattern(mat.sub))
    stats = mesh.ExchangeStats()
    world = distributed.world()
    *cols, selected = mesh.sharded_iteration(
        kmer_rows, score_rows, sub, params, hash_shift,
        padded_rows(db.size) // world, rescore_kw, stats)
    local = torch.stack(cols, 1)
    counts = torch.tensor([[selected]], dtype=torch.int32, device=device)
    gathered, counts = mesh.timed(
        stats, "gather", device,
        lambda: (distributed.gather(local), distributed.gather(counts)),
        local.numel() * local.element_size() + 4)
    rep, tgt, score, diag, r_score, first, last, idents = gathered.unbind(1)
    with span("kmermatch.order"):
        keys = torch.from_numpy(db.keys.astype(np.int64)).to(device)
        rep_k = keys[rep.long()]
        order = torch.sort(rep_k, stable=True).indices
        rep_k, tgt_k = rep_k[order], keys[tgt.long()[order]]
        score, diag = score[order], diag[order].contiguous()
        host = [x.cpu().numpy() for x in (rep_k, tgt_k, score, diag)]
        pre = tuple(c[order].cpu().numpy().astype(t) for c, t in (
            (r_score, np.int64), (first, np.int32), (last, np.int32),
            (idents, np.float64)))
    with span("kmermatch.self_hits"):
        out = _insert_self_hits(db, host[0].astype(np.uint32),
                                host[1].astype(np.uint32), *host[2:])
    out.dev = (rep_k.to(torch.int32), tgt_k.to(torch.int32), diag, score < 0)
    out.pre = pre
    out.pre_mode = 3
    out.table_entries = int(counts.sum())
    out.ranges = ((0, device_kmer.RANGE_BINS - 1),)
    out.exchange = stats
    return out


def matcher_params(db, k, kmers_per_sequence=21,
                   kmers_per_sequence_scale=None, ignore_multi_kmer=False,
                   include_only_extendable=False, cov_thr=0.0, cov_mode=0):
    """The device matcher's KmerParams for `db` (kmermatcher_torch's
    arguments), after checking the DB's lengths and keys against what its
    packed sort keys hold."""
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    if kmers_per_sequence_scale is None:
        kmers_per_sequence_scale = 0.2 if is_nucl else 0.0
    longest = int(db.seq_lens().max()) if db.size else 0
    if longest >= device_kmer.MAX_LEN:
        raise ValueError(f"sequences of {device_kmer.MAX_LEN} residues or "
                         "more are not supported by the k-mer matcher")
    if db.size and int(db.keys.max()) >= device_kmer.MAX_KEY:
        raise ValueError("sequence keys must be below 2^31")
    return KmerParams(
        k=k, alphabet_size=_matrix(db, "kmer").alphabet_size,
        kmers_per_sequence=kmers_per_sequence,
        kmers_per_sequence_scale=kmers_per_sequence_scale, is_nucl=is_nucl,
        ignore_multi_kmer=ignore_multi_kmer,
        include_only_extendable=include_only_extendable, cov_thr=cov_thr,
        cov_mode=cov_mode,
        ksel=ksel_capacity(kmers_per_sequence, kmers_per_sequence_scale,
                           max(longest, k)))


def split_budget(db, params, device, split_memory_limit=0):
    """The split path's entries per hash range for kmermatch_device, or
    None for the monolithic path; decided before the table is built.

    The table's estimate is the JAX package's, db.size * (ksel + 1) +
    db.size entries (its backend.py:165). With a limit, the table splits
    when the estimate at ENTRY_BYTES per entry exceeds it, into ranges of
    limit / ENTRY_BYTES entries, as the JAX package's device path cuts them.
    With 0 on a card, it splits when the estimate at BYTES_PER_ENTRY
    exceeds AUTO_SHARE of the memory the process can still allocate (the
    card's free memory and the allocator's unused cache), into ranges whose
    work at BYTES_PER_ENTRY fits beside what stays resident (RESIDENT_BYTES
    for each entry of the reference's table bound, estimate_kmer_count).
    With 0 on the CPU, monolithic."""
    est = db.size * (params.ksel + 1) + db.size
    limit = parse_memory_limit(split_memory_limit)
    if limit:
        return limit // ENTRY_BYTES if est * ENTRY_BYTES > limit else None
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    usable = AUTO_SHARE * (free + torch.cuda.memory_reserved(device)
                           - torch.cuda.memory_allocated(device))
    if est * BYTES_PER_ENTRY <= usable:
        return None
    resident = RESIDENT_BYTES * estimate_kmer_count(
        db, params.k, params.kmers_per_sequence,
        params.kmers_per_sequence_scale)
    return max(int((usable - resident) // BYTES_PER_ENTRY), 1)


class KmerHits(tuple):
    """(qk, tk, score, diag) flat host arrays, self rows interleaved; also
    carries the device-resident raw hits (rep, tgt, diag, reverse flag) and
    the slots the raw hits occupy, so the rescore addresses hits by
    index; table_entries and the hash ranges the matcher ran (inclusive
    range-key pairs, one pair for the monolithic path). The sharded
    matcher's hits also carry their rescore columns (score, first, last,
    idents) in `pre`, computed at rescore mode `pre_mode`, and the
    exchanges' bytes and seconds in `exchange`."""
    dev = None
    hit_slots = None
    table_entries = 0
    ranges = ()
    pre = None
    pre_mode = None
    exchange = None


def _insert_self_hits(db, rep, tgt, score, diag):
    """Flat (q, t, score, diag) arrays with a (k, k, 0, 0) self row at each
    query-group start — the array equivalent of the hits dict (device hit
    arrays arrive grouped by ascending representative)."""
    keys = db.keys.astype(np.int64)
    n = len(keys)
    counts = np.zeros(n, dtype=np.int64)
    pos = np.searchsorted(keys, rep.astype(np.int64))
    np.add.at(counts, pos, 1)
    m = len(rep) + n
    group_starts = np.cumsum(counts + 1) - (counts + 1)
    qk = np.empty(m, dtype=np.int64)
    tk = np.empty(m, dtype=np.int64)
    sc = np.zeros(m, dtype=np.int64)
    dg = np.zeros(m, dtype=np.int32)
    qk[group_starts] = keys
    tk[group_starts] = keys
    mask = np.ones(m, dtype=bool)
    mask[group_starts] = False
    hit_slots = np.nonzero(mask)[0]
    qk[hit_slots] = rep
    tk[hit_slots] = tgt
    sc[hit_slots] = score
    dg[hit_slots] = diag
    out = KmerHits((qk, tk, sc, dg))
    out.hit_slots = hit_slots
    return out


def rescore_diagonal_torch(db, hits, params=None, evaluer=None,
                           return_flat=False):
    """END_TO_END (--rescore-mode 3), ALIGNMENT (2) or HAMMING (0)
    rescorediagonal of kmermatcher_torch's or kmermatcher_sharded_torch's
    KmerHits.

    Every hit is rescored on the device that holds the hits (kernel K2, or
    its HAMMING or ALIGNMENT form, B12), addressed by index into the
    matcher's device-resident arrays, or, where the hits carry the columns
    of this rescore mode (`pre`, the sharded matcher's), taken from them,
    as the JAX package's rescore_diagonal_jax takes its sharded hits'
    columns. The self rows, one a sequence, are hits at diagonal 0 of the
    same kernel, in the same launch as the hits (with the sharded
    matcher's columns, in a launch of their own). On a nucleotide DB a
    reverse-strand hit reads the query reverse-complemented, and the
    nucleotide matrix's uniform match/mismatch form selects the kernel's
    uniform variant. Modes 1 and 4 raise: the JAX package fails on both.
    Returns {key: RESULT_DTYPE records}, or with return_flat {"qk":
    int64[M], "rec": RESULT_DTYPE[M]} of the surviving records grouped by
    query — the native extenders' input."""
    from .evalue import EvalueComputer
    from .rescore import (RESCORE_ALIGNMENT, RESCORE_END_TO_END,
                          RESCORE_HAMMING, RESULT_DTYPE, RescoreParams)
    global SELF_ROWS

    params = params or RescoreParams()
    if params.rescore_mode not in (RESCORE_END_TO_END, RESCORE_HAMMING,
                                   RESCORE_ALIGNMENT):
        raise NotImplementedError(
            f"--rescore-mode {params.rescore_mode} is not ported: only the "
            f"HAMMING (0), ALIGNMENT (2) and END_TO_END (3) rescores are")
    hamming = params.rescore_mode == RESCORE_HAMMING
    align = params.rescore_mode == RESCORE_ALIGNMENT
    if not isinstance(hits, KmerHits) or hits.dev is None:
        raise TypeError("rescore_diagonal_torch takes the KmerHits of "
                        "kmermatcher_torch")
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    mat = _matrix(db, "score")
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix(
            "nucleotide_ungapped" if is_nucl else "blosum62_ungapped",
            db.total_residues())
    qk, tk, pref, dg = hits
    m = len(qk)
    if m == 0:
        return {int(k): np.zeros(0, dtype=RESULT_DTYPE) for k in db.keys}
    with span("rescore.index"):
        lut = db.id_lookup_array()
        lengths = db.seq_lens().astype(np.int32)
        qrow = lut[qk].astype(np.int32)
        trow = lut[tk].astype(np.int32)
        qrev = is_nucl & (pref < 0)

        dist = np.abs(dg).astype(np.int64)
        score = np.zeros(m, dtype=np.int64)
        first = np.zeros(m, dtype=np.int32)
        last = np.zeros(m, dtype=np.int32)
        idents = np.zeros(m, dtype=np.float64)

        self_mask = (qk == tk) & (dg == 0) & (pref == 0)
        idxs = np.nonzero(~self_mask)[0]
    dev_rep, dev_tgt, dev_diag, dev_rev = hits.dev
    device = dev_rep.device
    with span("rescore.self_rows"):
        # the inserted (k, k, diag 0) self rows, scored in the launch below
        self_idx = np.nonzero(self_mask)[0]
        srow = torch.from_numpy(qrow[self_idx]).to(device)

    if hits.pre is not None and params.rescore_mode == hits.pre_mode:
        # the sharded matcher's hits carry their rescore columns; only the
        # self rows are launched
        with span("rescore.pre"):
            didx = np.searchsorted(hits.hit_slots, idxs)
            score[idxs], first[idxs], last[idxs], idents[idxs] = (
                c[didx] for c in hits.pre)
        idxs = idxs[:0]
    if len(idxs) or len(self_idx):
        SELF_ROWS += len(self_idx)
        with span("rescore.launch"):
            rows = flat_rows(db, device)
            dlut = torch.from_numpy(lut.astype(np.int64)).to(device)
            sub = torch.from_numpy(mat.sub.astype(np.int32)).to(device)
            didx = torch.from_numpy(
                np.searchsorted(hits.hit_slots, idxs)).to(device)
            # the matcher's hits, then the self rows
            q = torch.cat([dlut[dev_rep[didx].long()].to(torch.int32), srow])
            t = torch.cat([dlut[dev_tgt[didx].long()].to(torch.int32), srow])
            d = torch.cat([dev_diag[didx], torch.zeros_like(srow)])
            rev_kw = {}
            if is_nucl:
                # reverse hits: the query is read back to front through the
                # complement (mat.reverse), its chars from the codes
                # (num2aa)
                rev_kw = dict(
                    qrev=torch.cat([dev_rev[didx],
                                    torch.zeros_like(srow, dtype=torch.bool)]),
                    comp=torch.from_numpy(
                        mat.reverse.astype(np.int32)).to(device),
                    code2char=torch.from_numpy(
                        mat.num2aa.astype(np.uint8)).to(device))
            won = ()
            if hamming:
                sc, f, la, idn = rescore_hamming(*rows, q, t, d, **rev_kw)
            else:
                if is_nucl:
                    rev_kw["uniform"] = uniform_pattern(mat.sub)
                rescore = rescore_align if align else rescore_e2e
                sc, f, la, idn, *won = rescore(*rows, q, t, d, sub, **rev_kw)
        with span("rescore.fetch"):
            at = np.concatenate([idxs, self_idx])
            if won:
                # ALIGNMENT reports the diagonal that won among the hit's
                # candidates 65,536 apart (rows over 32,768 only)
                dg = dg.copy()
                dg[at] = won[0].cpu().numpy()
                dist = np.abs(dg).astype(np.int64)
            score[at] = sc.cpu().numpy()
            first[at] = f.cpu().numpy()
            last[at] = la.cpu().numpy()
            idents[at] = idn.cpu().numpy()
    with span("rescore.finish"):
        # the overlap is host-derivable from the lengths and the diagonal
        qlen = lengths[qrow].astype(np.int64)
        tlen = lengths[trow].astype(np.int64)
        ov = np.maximum(np.where(dg >= 0, np.minimum(tlen, qlen - dist),
                                 np.minimum(tlen - dist, qlen)),
                        0).astype(np.int32)
        if align:
            # the host's ungapped_best keeps a diagonal only for a score
            # above 0 and skips the hit otherwise (its diagonal length
            # stays 0)
            ov[score == 0] = 0
        rec, keep = _rescore_finish(params, evaluer, tk, dg, m, lengths,
                                    qrow, trow, qrev, score, first, last, ov,
                                    dist, idents)
    with span("rescore.group"):
        return _rescore_group(db, qk, m, rec, keep, return_flat)


def _rescore_finish(params, evaluer, tk, dg, m, lengths, qrow, trow, qrev,
                    score, first, last, ov, dist, idents):
    """One OpenMP pass over all hit rows (native/finish.cpp): E-values,
    coordinates, filters and packed RESULT_DTYPE records."""
    from .rescore import RESULT_DTYPE

    lib = native.lib()
    e = evaluer
    dparams = np.array([
        e.lam, e.K, e.log_K, e.a_I, e.b_I, e.a_J, e.b_J,
        e.alpha_I, e.beta_I, e.alpha_J, e.beta_J, e.sigma, e.tau,
        e.vi_y_thr, e.vj_y_thr, e.c_y_thr, e.db_res_count,
        params.eval_thr, params.seq_id_thr, params.cov_thr],
        dtype=np.float64)
    rec = np.zeros(m, dtype=RESULT_DTYPE)
    keep = np.zeros(m, dtype=np.uint8)

    def p(a, ct):
        a = np.ascontiguousarray(a)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    tk_a, tk_p = p(tk.astype(np.int64), ctypes.c_int64)
    dg_a, dg_p = p(dg.astype(np.int32), ctypes.c_int32)
    qr_a, qr_p = p(qrow.astype(np.int32), ctypes.c_int32)
    tr_a, tr_p = p(trow.astype(np.int32), ctypes.c_int32)
    ln_a, ln_p = p(lengths.astype(np.int32), ctypes.c_int32)
    rv_a, rv_p = p(qrev.astype(np.uint8), ctypes.c_uint8)
    sc_a, sc_p = p(score.astype(np.int64), ctypes.c_int64)
    f_a, f_p = p(first.astype(np.int32), ctypes.c_int32)
    l_a, l_p = p(last.astype(np.int32), ctypes.c_int32)
    ov_a, ov_p = p(ov.astype(np.int32), ctypes.c_int32)
    di_a, di_p = p(dist.astype(np.int64), ctypes.c_int64)
    id_a, id_p = p(idents.astype(np.float64), ctypes.c_double)
    lib.rescore_finish(
        m, tk_p, dg_p, qr_p, tr_p, ln_p, rv_p, sc_p, f_p, l_p, ov_p,
        di_p, id_p,
        dparams.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.int32(params.seq_id_mode), np.int32(params.cov_mode),
        np.int64(params.aln_len_thr),
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return rec, keep.astype(bool)


def _rescore_group(db, qk, m, rec, keep, return_flat):
    """Flat format, or per-query dict preserving input order."""
    from .rescore import RESULT_DTYPE

    if return_flat:
        return {"qk": qk[keep], "rec": rec[keep]}
    out = {}
    boundaries = np.nonzero(np.diff(qk))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [m]])
    for s0, e0 in zip(starts, ends):
        out[int(qk[s0])] = rec[s0:e0][keep[s0:e0]]
    for k in db.keys:
        out.setdefault(int(k), np.zeros(0, dtype=RESULT_DTYPE))
    return out
