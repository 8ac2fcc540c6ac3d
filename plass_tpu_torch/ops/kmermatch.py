"""linclust-style k-mer matcher (reference: lib/mmseqs/src/linclust/
kmermatcher.cpp).

Pipeline (single hash-range split; splits/sharding in parallel/):
 1. per sequence, enumerate contiguous k-mers (skipping any containing X);
    nucleotide k-mers are canonicalized min(fwd, revcomp) with a strand bit
    and palindromes skipped (kmermatcher.cpp:144-220)
 2. select ~kmersPerSequence smallest-hash k-mers per sequence using the
    two-level histogram threshold with last-bin correction
    (kmermatcher.cpp:221-237,266-308); with ignore_multi_kmer, k-mers that
    occur more than once in the sequence are dropped entirely
 3. add one whole-sequence-hash entry per sequence (identical-sequence
    grouping, kmermatcher.cpp:240-264)
 4. sort the global (kmer, seqLen desc, id, pos) table, assign the longest
    member of each k-mer group as representative, emit (rep, target,
    diagonal) pairs filtered by extendable/coverable (kmermatcher.cpp:
    406-558); strand algebra per kmermatcher.cpp:480-519
 5. per (rep, target) run pick the most frequent diagonal; score = number of
    shared k-mers (kmermatcher.cpp:844-914)

This is the host (NumPy) matcher, which linclust runs whatever the device;
ops/device_kmer.py holds the torch matcher of the assembly loops.
"""
import numpy as np

from .. import constants
from ..data import seqdb
from .hashes import xxh64_u64_np

BIT63 = np.uint64(1) << np.uint64(63)
U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def map_sequences(db, seed_mat=None):
    """Map a SeqDB to numeric padded batch.

    Returns (padded uint8[N, Lmax], lengths int64[N], alphabet_size, is_nucl).
    AA sequences use the reduced-13 alphabet (kmermatcherInner,
    kmermatcher.cpp:598-607) — blosum62-based by default; kmerindexdb/
    kmersearch pass the VTML80-based one for the standalone default
    --seed-sub-mat (kmerindexdb.cpp:62-69). Nucleotides use ACTG(X).
    """
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    if seed_mat is None:
        mat = constants.nucleotide() if is_nucl else constants.reduced(13)
    else:
        mat = constants.nucleotide() if is_nucl else seed_mat
    lengths = db.seq_lens()
    n = db.size
    lmax = int(lengths.max()) if n else 0
    padded = np.full((n, lmax), mat.alphabet_size - 1, dtype=np.uint8)
    for i in range(n):
        s = db.get_seq(i)
        padded[i, : len(s)] = mat.aa2num[s]
    return padded, lengths, mat.alphabet_size, is_nucl


def revcomp_packed(kmer_idx, k):
    """Util::revComplement on 2-bit packed k-mers (A=0 C=1 T=2 G=3; A<->T is
    XOR 2, C<->G is XOR 2 as well in this encoding; order reversed)."""
    kmer_idx = np.asarray(kmer_idx, dtype=np.uint64)
    out = np.zeros_like(kmer_idx)
    v = kmer_idx.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | ((v ^ np.uint64(2)) & np.uint64(3))
        v = v >> np.uint64(2)
    return out


def _select_kmers_one(hashes16, kmer_vals, positions, kmer_considered,
                      ignore_multi, is_nucl):
    """Replicates the per-sequence selection loop exactly. All inputs are the
    valid k-mers of one sequence in position order. Returns selected indices
    (into the inputs) in reference emission order."""
    n = len(hashes16)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # histogram threshold (pre-dedup!)
    counts = np.bincount(hashes16, minlength=65536)
    hier = counts.reshape(128, 512).sum(axis=1)
    cum = np.cumsum(hier)
    # hierarchical loop: add bins until >= kmerConsidered, then back off one
    hi = int(np.searchsorted(cum, kmer_considered))  # first bin where cum >= kc
    if hi >= 128:
        hi = 127
    in_bins = int(cum[hi - 1]) if hi > 0 else 0
    # fine loop from hi*512
    threshold = hi * 512
    while threshold <= 65535 and in_bins < kmer_considered:
        in_bins += int(counts[threshold])
        threshold += 1
    too_much = in_bins - kmer_considered

    # the per-sequence (hash, kmer, pos) sort happens ONLY in ignore-multi
    # mode (kmermatcher.cpp:266-272); otherwise the selection scan walks the
    # k-mers in position order, which decides ties at the threshold hash
    masked = kmer_vals | BIT63 if is_nucl else kmer_vals
    if ignore_multi:
        order = np.lexsort((positions, masked, hashes16))
    else:
        order = np.arange(n, dtype=np.int64)
    h_s = hashes16[order]
    m_s = masked[order]

    if ignore_multi:
        # the reference's skip loop (kmermatcher.cpp:277-301) jumps over a
        # duplicate run and PROCESSES the first following entry without
        # re-checking it — so a run right after another run contributes its
        # first element(s). Replicated as a 3-state scan:
        #   TOP: entry starting a multi-run -> skip (SKIP); else process
        #   SKIP: inside the run; at its last element -> LAND
        #   LAND: process unconditionally -> TOP
        eq_next = np.zeros(n, dtype=bool)
        eq_next[:-1] = m_s[:-1] == m_s[1:]
        processed = np.zeros(n, dtype=bool)
        state = 0  # 0 TOP, 1 SKIP, 2 LAND
        for p in range(n):
            if state == 0:
                if eq_next[p]:
                    state = 1
                else:
                    processed[p] = True
            elif state == 1:
                if not eq_next[p]:
                    state = 2
            else:  # LAND
                processed[p] = True
                state = 0
        order = order[processed]
        h_s = h_s[processed]

    sel = []
    selected = 0
    thr = threshold
    tm = too_much
    for idx, h in zip(order, h_s):
        if selected >= kmer_considered:
            break
        if h < thr:
            if h == threshold - 1 and tm:
                tm -= 1
                if tm == 0:
                    thr -= 1
            sel.append(idx)
            selected += 1
    return np.asarray(sel, dtype=np.int64)


def build_kmer_table(db, k, kmers_per_sequence=21, kmers_per_sequence_scale=0.0,
                     hash_shift=67, ignore_multi_kmer=False,
                     hash_range=None, hash_whole_sequence=True,
                     seed_mat=None):
    """Steps 1-3: per-sequence selection + whole-sequence hash entries.

    Returns structured arrays (kmer u64, id u32, pos i32, seq_len i32).
    hash_range=(lo, hi) restricts to a 16-bit hash range (multi-split /
    multi-host mode); whole-sequence entries use their own hash's low 16 bits.
    """
    padded, lengths, alpha, is_nucl = map_sequences(db, seed_mat=seed_mat)
    n, lmax = padded.shape
    x_code = alpha - 1
    out_kmer, out_id, out_pos, out_len = [], [], [], []
    lo, hi = hash_range if hash_range is not None else (0, 0xFFFF)

    if n == 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.int32), np.zeros(0, np.int32), is_nucl)

    # k-mer indices over windows, vectorized across the batch
    p = lmax - k + 1
    if p > 0:
        contains_x = np.zeros((n, p), dtype=bool)
        kidx = np.zeros((n, p), dtype=np.uint64)
        if is_nucl:
            # big-endian 2-bit packing (Indexer::computeKmerIdx)
            for i in range(k):
                w = padded[:, i: i + p]
                contains_x |= w == x_code
                kidx = (kidx << np.uint64(2)) | w.astype(np.uint64)
        else:
            # little-endian base-(alpha-1) packing (Indexer::int2index)
            pw = np.uint64(1)
            for i in range(k):
                w = padded[:, i: i + p]
                contains_x |= w == x_code
                kidx += w.astype(np.uint64) * pw
                pw = pw * np.uint64(alpha - 1)
    else:
        contains_x = np.zeros((n, 0), dtype=bool)
        kidx = np.zeros((n, 0), dtype=np.uint64)

    for i in range(n):
        L = int(lengths[i])
        np_i = max(0, L - k + 1)
        valid = ~contains_x[i, :np_i]
        pos = np.nonzero(valid)[0].astype(np.int64)
        kv = kidx[i, pos]
        if is_nucl:
            rev = revcomp_packed(kv, k)
            not_palin = rev != kv
            pos = pos[not_palin]
            kv = kv[not_palin]
            rev = rev[not_palin]
            pick_rev = rev < kv
            canon = np.where(pick_rev, rev, kv)
            hashes = (xxh64_u64_np(canon, hash_shift) & np.uint64(0xFFFF)).astype(np.int64)
            store_pos = np.where(pick_rev, L - pos - k, pos).astype(np.int32)
            store_kmer = np.where(pick_rev, canon & ~BIT63, canon | BIT63)
        else:
            canon = kv
            hashes = (xxh64_u64_np(canon, hash_shift) & np.uint64(0xFFFF)).astype(np.int64)
            store_pos = pos.astype(np.int32)
            store_kmer = canon

        seq_kmer_count = len(canon)
        # float32 arithmetic exactly as the reference (kmermatcher.cpp:223)
        kc_f = np.float32(kmers_per_sequence - 1) + \
            np.float32(np.float32(kmers_per_sequence_scale) * np.float32(L))
        kc = min(int(kc_f), seq_kmer_count)

        # whole-sequence hash entry (added regardless of threshold).
        # With hashWholeSequence false (kmersearch/kmerindexdb,
        # kmersearch.cpp:30-38) seqHash stays SIZE_T_MAX and the entry is
        # STILL emitted — as a sentinel-valued k-mer whose 16-bit hash is
        # 0xFFFF (kmermatcher.cpp:133-141,240-264)
        from .hashes import seq_hash_np
        if hash_whole_sequence:
            sh = seq_hash_np(padded[i, :L])
            sh = xxh64_u64_np(np.array([sh], dtype=np.uint64),
                              hash_shift)[0]
        else:
            sh = U64MAX
        if lo <= int(sh & np.uint64(0xFFFF)) <= hi:
            out_kmer.append(np.array([sh], dtype=np.uint64))
            out_id.append(np.array([db.keys[i]], dtype=np.uint32))
            out_pos.append(np.array([0], dtype=np.int32))
            out_len.append(np.array([L], dtype=np.int32))

        if seq_kmer_count:
            sel = _select_kmers_one(hashes, store_kmer, store_pos, kc,
                                    ignore_multi_kmer, is_nucl)
            if len(sel):
                in_range = (hashes[sel] >= lo) & (hashes[sel] <= hi)
                sel = sel[in_range]
            if len(sel):
                out_kmer.append(store_kmer[sel])
                out_id.append(np.full(len(sel), db.keys[i], dtype=np.uint32))
                out_pos.append(store_pos[sel])
                out_len.append(np.full(len(sel), L, dtype=np.int32))

    if not out_kmer:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.int32), np.zeros(0, np.int32), is_nucl)
    return (np.concatenate(out_kmer), np.concatenate(out_id),
            np.concatenate(out_pos), np.concatenate(out_len), is_nucl)


def assign_groups(kmer, sid, pos, slen, is_nucl, include_only_extendable,
                  cov_thr=0.0, cov_mode=0):
    """Steps 4: sort table, pick group representative, emit (rep, target,
    diagonal, rev) pairs (kmermatcher.cpp:406-558)."""
    masked = (kmer | BIT63) if is_nucl else kmer
    order = np.lexsort((pos, sid, -slen.astype(np.int64), masked))
    kmer = kmer[order]
    sid = sid[order]
    pos = pos[order]
    slen = slen[order]
    masked = masked[order]

    n = len(kmer)
    if n == 0:
        z = np.zeros(0, np.uint32)
        return z, z.copy(), np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, bool)

    new_group = np.ones(n, dtype=bool)
    new_group[1:] = masked[1:] != masked[:-1]
    group_idx = np.cumsum(new_group) - 1
    first_of_group = np.nonzero(new_group)[0]
    group_sizes = np.diff(np.append(first_of_group, n))

    rep_row = first_of_group[group_idx]
    rep_id = sid[rep_row]
    rep_pos = pos[rep_row]
    rep_len = slen[rep_row]

    keep = group_sizes[group_idx] > 1  # drop singleton groups

    if is_nucl:
        rep_fwd = (kmer[rep_row] & BIT63) != 0
        tgt_fwd = (kmer & BIT63) != 0
        # strand algebra (kmermatcher.cpp:480-519): both coordinates flip to
        # the forward frame when the TARGET k-mer is on the reverse strand;
        # the query sequence must be reverse-complemented when strands differ
        rev = rep_fwd != tgt_fwd
        q_pos = np.where(tgt_fwd, rep_pos, rep_len - 1 - rep_pos)
        t_pos = np.where(tgt_fwd, pos, slen - 1 - pos)
        diagonal = (q_pos - t_pos).astype(np.int32)
    else:
        rev = np.zeros(n, dtype=bool)
        diagonal = (rep_pos - pos).astype(np.int32)

    can_extend = (diagonal < 0) | (diagonal > (rep_len - slen))
    if include_only_extendable:
        keep &= can_extend
    else:
        keep &= _can_be_covered(cov_thr, cov_mode, rep_len, slen)

    return (rep_id[keep], sid[keep], diagonal[keep], slen[keep], rev[keep])


def _can_be_covered(cov_thr, cov_mode, qlen, tlen):
    """Util::canBeCovered for the default COV_MODE_BIDIRECTIONAL."""
    if cov_thr <= 0.0:
        return np.ones(len(qlen), dtype=bool)
    big = np.maximum(qlen, tlen).astype(np.float32)
    small = np.minimum(qlen, tlen).astype(np.float32)
    if cov_mode == 0:  # bidirectional
        return small / big >= cov_thr
    if cov_mode == 1:  # target
        return np.ones(len(qlen), dtype=bool)
    if cov_mode == 2:  # query
        return big * cov_thr <= small
    return np.ones(len(qlen), dtype=bool)


def emit_hits(rep_id, tgt_id, diagonal, rev, db_keys):
    """Step 5: per (rep, target): best diagonal + shared-kmer count
    (kmermatcher.cpp:844-914). Returns dict rep_key -> list of
    (target, score_signed, diagonal); every sequence gets a self hit first.

    NOTE the faithful quirk: the run scan checks only the TARGET id
    (kmermatcher.cpp:880-882), so when the same target sits at a rep-group
    boundary, the earlier rep's hit absorbs the next rep's entries into its
    count and diagonal vote.
    """
    order = np.lexsort((diagonal, tgt_id, rep_id))
    r = rep_id[order]
    t = tgt_id[order]
    d = diagonal[order]
    v = rev[order]
    hits = {int(k): [(int(k), 0, 0)] for k in db_keys}
    n = len(r)
    last_target = None
    cur_rep = None
    for p in range(n):
        if cur_rep is None or r[p] != cur_rep:
            cur_rep = r[p]
            last_target = None
        target = t[p]
        if last_target == target:
            continue
        # scan consecutive same-target entries (REP NOT CHECKED)
        top_score = 0
        best_cnt = 0
        best_diag = int(d[p])
        best_rev = bool(v[p])
        cnt = 0
        prev_diag = int(d[p])
        j = p
        while j < n and t[j] == target:
            if prev_diag == int(d[j]) and j > p:
                cnt += 1
            else:
                cnt = 1
            if cnt >= best_cnt:
                best_cnt = cnt
                best_diag = int(d[j])
                best_rev = bool(v[j])
            prev_diag = int(d[j])
            top_score += 1
            j += 1
        if target != cur_rep:
            score = -top_score if best_rev else top_score
            hits[int(cur_rep)].append((int(target), int(score), best_diag))
        last_target = target
    return hits


def parse_memory_limit(s):
    """'--split-memory-limit' strings: plain bytes or K/M/G/T suffix
    (Parameters.cpp parseByteString). Returns bytes (0 = unlimited)."""
    if isinstance(s, (int, np.integer)):
        return int(s)
    s = str(s).strip()
    if not s:
        return 0
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    suffix = s[-1].upper()
    if suffix in mult:
        return int(float(s[:-1]) * mult[suffix])
    return int(float(s))


ENTRY_BYTES = 20  # kmer u64 + id u32 + pos i32 + len i32


def estimate_kmer_count(db, k, kmers_per_sequence, kmers_per_sequence_scale):
    """Arithmetic upper bound on the k-mer table size — the reference's
    computeKmerCount (kmermatcher.cpp:576-586): per sequence
    min(max(1, L-k+2), kmersPerSequence + scale*L), the +2 covering the
    whole-sequence hash entry. No extraction pass, just the lengths."""
    L = db.seq_lens().astype(np.int64)
    avail = np.maximum(1, L - k + 2)
    want = (kmers_per_sequence
            + (np.float32(kmers_per_sequence_scale) * L.astype(np.float32))
            ).astype(np.int64)
    return int(np.minimum(avail, want).sum())


def compute_hash_splits(db, k, kmers_per_sequence, kmers_per_sequence_scale,
                        hash_shift, ignore_multi_kmer, memory_limit_bytes,
                        seed_mat=None):
    """Exact-histogram split selection (kmermatcher.cpp:594-779): one
    counting pass over the per-sequence selections, then 16-bit hash-range
    boundaries chosen so every split's table fits the memory limit.

    Returns a list of (lo, hi) inclusive ranges covering 0..0xFFFF (one
    range = single-split mode)."""
    hist = np.zeros(65536, dtype=np.int64)
    kmer, _sid, _pos, _slen, is_nucl = build_kmer_table(
        db, k, kmers_per_sequence, kmers_per_sequence_scale, hash_shift,
        ignore_multi_kmer, seed_mat=seed_mat)
    # the ~1/(ksel+1) whole-sequence entries carry an already-hashed value
    # whose range key is its own low 16 bits; re-hashing them here only
    # skews the BALANCE estimate by that fraction (range membership is
    # enforced exactly inside build_kmer_table)
    h16 = (xxh64_u64_np(kmer & ~BIT63 if is_nucl else kmer, hash_shift)
           & np.uint64(0xFFFF)).astype(np.int64)
    np.add.at(hist, h16, 1)
    total = int(hist.sum())
    if memory_limit_bytes <= 0 or total * ENTRY_BYTES <= memory_limit_bytes:
        return [(0, 0xFFFF)]
    per_split = max(memory_limit_bytes // ENTRY_BYTES, 1)
    ranges = []
    lo = 0
    acc = 0
    for h in range(65536):
        if acc + hist[h] > per_split and acc > 0:
            ranges.append((lo, h - 1))
            lo = h
            acc = 0
        acc += int(hist[h])
    ranges.append((lo, 0xFFFF))
    return ranges


def kmermatcher(db, k, kmers_per_sequence=21, kmers_per_sequence_scale=None,
                hash_shift=67, ignore_multi_kmer=False,
                include_only_extendable=False, cov_thr=0.0, cov_mode=0,
                hash_range=None, split_memory_limit=0):
    """Full kmermatcher: SeqDB -> prefilter hits dict {query_key: [(target,
    score, diag), ...]} with the self hit first.

    split_memory_limit (bytes or 'NG' string, 0 = unlimited): when the
    k-mer table would exceed it, the hash space is split into ranges whose
    tables each fit (kmermatcher.cpp:594-779) and the per-split pair
    streams are merged before hit emission (the reference's k-way merge,
    kmermatcher.cpp:947-1020). Selection is per-sequence and split-
    independent, so the merged output is identical to a single-split run.
    """
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    if kmers_per_sequence_scale is None:
        kmers_per_sequence_scale = 0.2 if is_nucl else 0.0
    limit = parse_memory_limit(split_memory_limit)
    if limit <= 0:
        # no explicit limit: budget 90% of system memory minus what's
        # already resident, like Util::computeMemory (Util.cpp:640-653);
        # when residency already exceeds the budget the reference errors
        # out instead of degrading into thousands of micro-splits
        from ..utils.progress import current_rss, total_system_memory
        budget = int(total_system_memory() * 0.9)
        rss = current_rss()
        if rss > budget:
            raise MemoryError(
                f"current residency {rss / 1e9:.2f} GB already exceeds the "
                f"90%-of-RAM budget {budget / 1e9:.2f} GB; pass an explicit "
                f"--split-memory-limit")
        limit = budget - rss
    if hash_range is None and limit > 0:
        # arithmetic estimate first (computeKmerCount, kmermatcher.cpp:
        # 576-586): the exact-histogram pass only runs when the estimate
        # says the table cannot fit, so the common ample-memory call does
        # no extra k-mer extraction work
        est = estimate_kmer_count(db, k, kmers_per_sequence,
                                  kmers_per_sequence_scale)
        if est * ENTRY_BYTES <= limit:
            ranges = [(0, 0xFFFF)]
            # swap guard: an explicit limit above physical memory would let
            # a monolithic table thrash (the auto path can't get here —
            # its limit is already below residual RAM)
            from ..utils.progress import MemoryTracker
            MemoryTracker().check(est * ENTRY_BYTES, "k-mer table")
        else:
            ranges = compute_hash_splits(
                db, k, kmers_per_sequence, kmers_per_sequence_scale,
                hash_shift, ignore_multi_kmer, limit)
    else:
        ranges = [hash_range if hash_range is not None else (0, 0xFFFF)]
    parts = []
    for rng in ranges:
        kmer, sid, pos, slen, is_nucl = build_kmer_table(
            db, k, kmers_per_sequence, kmers_per_sequence_scale, hash_shift,
            ignore_multi_kmer, rng if len(ranges) > 1 or hash_range else None)
        parts.append(assign_groups(
            kmer, sid, pos, slen, is_nucl, include_only_extendable, cov_thr,
            cov_mode))
    if len(parts) == 1:
        rep, tgt, diag, _tlen, rev = parts[0]
    else:
        rep = np.concatenate([p[0] for p in parts])
        tgt = np.concatenate([p[1] for p in parts])
        diag = np.concatenate([p[2] for p in parts])
        rev = np.concatenate([p[4] for p in parts])
    return emit_hits(rep, tgt, diag, rev, db.keys)


def hits_to_db(hits, is_nucl=False):
    """Serialize prefilter hits to an MMseqs prefilter DB (hit_t text format:
    target\\tscore\\tdiagonal with diagonal cast to short —
    QueryMatcher.h:prefilterHitToBuffer)."""
    writer = seqdb.DBWriter(seqdb.PREFILTER_REV_RES if is_nucl else seqdb.PREFILTER_RES)
    for key in sorted(hits):
        lines = []
        for t, s, dg in hits[key]:
            short_diag = ((dg + 32768) & 0xFFFF) - 32768
            lines.append(f"{t}\t{s}\t{short_diag}\n")
        writer.write(key, "".join(lines).encode(), add_newline=False)
    return writer.finish()
