"""Center-star MSA construction, MSA filtering and PSSM/profile records.

References:
 - MSA: lib/mmseqs/src/alignment/MultipleAlignment.cpp (computeMSA,
   computeQueryGaps, updateGapsInCenterSequence, updateGapsInSequenceSet)
 - filter: lib/mmseqs/src/alignment/MsaFilter.cpp (HH-suite-derived
   redundancy filter; the AVX2 32-byte block diff counting is replicated
   block-exactly because the cov_kj corrections are observable)
 - PSSM: native pssm.cpp (the JAX package's native/, built by the port's
   native/) mirroring PSSMCalculator.cpp
 - profile records: PSSMCalculator::Profile::toBuffer (23 bytes/column:
   20 minifloat probs + query num + consensus num + Neff char)
"""
import ctypes

import numpy as np

from .. import constants
from ..native import lib

NAA = 20
ANY = 20
GAP = 21
ENDGAP = 22
PROFILE_AA_SIZE = 20
PROFILE_READIN_SIZE = 23
BLOCK = 32  # AVX2: VECSIZE_INT * 4 bytes


def expand_cigar(bt):
    """'2M1I3D' -> 'MMIDDD'; plain letter strings pass through."""
    if not bt or not bt[0].isdigit():
        return bt
    out = []
    num = ""
    for c in bt:
        if c.isdigit():
            num += c
        else:
            out.append(c * (int(num) if num else 1))
            num = ""
    return "".join(out)


def compute_msa(center_num, edge_seqs, alns, no_deletion=True):
    """MultipleAlignment::computeMSA.

    center_num: uint8[L] numeric center sequence; edge_seqs: list of uint8
    arrays; alns: list of dicts with qStartPos, dbStartPos, backtrace
    (expanded letters). Returns (msa uint8[setSize, padded], centerLength).
    Rows are GAP-padded to a 32-byte multiple past centerLength
    (MultipleAlignment::initX fills buffers with GAP).
    """
    L = len(center_num)
    if not edge_seqs:
        width = (L + BLOCK) // BLOCK * BLOCK
        msa = np.full((1, width), GAP, dtype=np.uint8)
        msa[0, :L] = center_num
        return msa, L

    # computeQueryGaps (MultipleAlignment.cpp:47-79)
    query_gaps = np.zeros(L + 1, dtype=np.int64)
    for aln in alns:
        bt = aln["backtrace"]
        query_pos = aln["qStartPos"]
        cur_gap = 0
        for c in bt:
            if c == "M":
                query_pos += 1
                cur_gap = 0
            elif c == "I":
                query_pos += 1
                cur_gap = 0
            else:  # D
                cur_gap += 1
                query_gaps[query_pos] = max(query_gaps[query_pos], cur_gap)

    # updateGapsInCenterSequence (MultipleAlignment.cpp:81-98)
    center_row = []
    for qpos in range(L):
        if not no_deletion:
            center_row.extend([GAP] * int(query_gaps[qpos]))
        center_row.append(int(center_num[qpos]))
    center_len = len(center_row)

    width = (center_len + BLOCK) // BLOCK * BLOCK
    msa = np.full((len(edge_seqs) + 1, width), GAP, dtype=np.uint8)
    msa[0, :center_len] = center_row

    # updateGapsInSequenceSet (MultipleAlignment.cpp:100-180)
    for k, (seq, aln) in enumerate(zip(edge_seqs, alns)):
        row = msa[k + 1]
        bt = aln["backtrace"]
        query_pos = aln["qStartPos"]
        target_pos = aln["dbStartPos"]
        buf = aln["qStartPos"]  # initial gap fill: row already GAP
        pos = 0
        nbt = len(bt)
        while pos < nbt:
            c = bt[pos]
            if c == "I":
                row[buf] = GAP
                buf += 1
                query_pos += 1
                pos += 1
            elif c == "D":
                while pos < nbt and bt[pos] == "D":
                    if not no_deletion:
                        row[buf] = seq[target_pos]
                        buf += 1
                    target_pos += 1
                    pos += 1
                if pos >= nbt:
                    break
                if bt[pos] == "I":
                    row[buf] = GAP
                    buf += 1
                    query_pos += 1
                    pos += 1
                elif bt[pos] == "M":
                    row[buf] = seq[target_pos]
                    buf += 1
                    query_pos += 1
                    target_pos += 1
                    pos += 1
            else:  # M
                if not no_deletion:
                    for _ in range(int(query_gaps[query_pos])):
                        row[buf] = GAP
                        buf += 1
                row[buf] = seq[target_pos]
                buf += 1
                query_pos += 1
                target_pos += 1
                pos += 1
    return msa, center_len


def compute_pssm(msa, center_len, wg=False, pca=1.0, pcb=1.5):
    """Native computePSSMFromMSA. Returns dict with pssm (int8[L,20]),
    prob (float32[L,20]), neff (float32[L]), consensus (uint8[L] nums)."""
    mat = constants.blosum62()
    d = constants._load("blosum62")
    pback = np.ascontiguousarray(mat.pback, dtype=np.float64)
    # R rows padded to 32 floats, 32-byte aligned rows (malloc_simd_float)
    r = np.zeros((21, 32), dtype=np.float32)
    r[:, :21] = d["pseudo_r"]
    set_size, width = msa.shape
    buf = np.ascontiguousarray(msa, dtype=np.uint8).copy()
    pssm = np.zeros(center_len * 20, dtype=np.int8)
    prob = np.zeros(center_len * 20, dtype=np.float32)
    neff = np.zeros(center_len, dtype=np.float32)
    consensus = np.zeros(center_len, dtype=np.uint8)
    nat = lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i8p = ctypes.POINTER(ctypes.c_int8)
    nat.pssm_compute(
        buf.ctypes.data_as(u8p), set_size, center_len, width,
        1 if wg else 0, ctypes.c_float(pca), ctypes.c_float(pcb),
        pback.ctypes.data_as(f64p), r.ctypes.data_as(f32p),
        pssm.ctypes.data_as(i8p), prob.ctypes.data_as(f32p),
        neff.ctypes.data_as(f32p), consensus.ctypes.data_as(u8p))
    return {
        "pssm": pssm.reshape(center_len, 20),
        "prob": prob.reshape(center_len, 20),
        "neff": neff,
        "consensus": consensus,
    }


def mask_profile(center_num, res):
    """PSSMMasker::mask (PSSMMasker.h:19-44): tantan-mask the query; masked
    columns get prob = pBack*0.5 and consensus X."""
    from .tantan import TantanMasker
    mat = constants.blosum62()
    masker = TantanMasker(mat, min_mask_prob=0.9)
    masked = masker.mask(np.asarray(center_num, dtype=np.uint8))
    idx = np.nonzero(masked == (mat.alphabet_size - 1))[0]
    res["prob"][idx, :] = (mat.pback[:20] * 0.5).astype(np.float32)
    res["consensus"][idx] = ANY
    return res


def profile_record(center_num, res):
    """PSSMCalculator::Profile::toBuffer: 23 bytes per column."""
    nat = lib()
    L = len(center_num)
    out = bytearray()
    for pos in range(L):
        for aa in range(PROFILE_AA_SIZE):
            out.append(nat.pssm_score_mask(ctypes.c_float(res["prob"][pos, aa])))
        out.append(int(center_num[pos]))
        out.append(int(res["consensus"][pos]))
        out.append(nat.pssm_neff_to_char(ctypes.c_float(res["neff"][pos])))
    return bytes(out)


def parse_profile_record(data):
    """Inverse of profile_record: -> (probs float32[L,20], query nums,
    consensus nums, neff floats)."""
    nat = lib()
    arr = np.frombuffer(data, dtype=np.uint8)
    L = len(arr) // PROFILE_READIN_SIZE
    arr = arr[:L * PROFILE_READIN_SIZE].reshape(L, PROFILE_READIN_SIZE)
    probs = np.zeros((L, 20), dtype=np.float32)
    for pos in range(L):
        for aa in range(20):
            probs[pos, aa] = nat.pssm_score_unmask(int(arr[pos, aa]))
    query = arr[:, 20].copy()
    consensus = arr[:, 21].copy()
    neff = np.array([nat.pssm_neff_to_float(int(c)) for c in arr[:, 22]],
                    dtype=np.float32)
    return probs, query, consensus, neff


# ---------------------------------------------------------------------------
# MsaFilter (lib/mmseqs/src/alignment/MsaFilter.cpp:85-560)
# ---------------------------------------------------------------------------

def msa_filter(msa, center_len, coverage=0, qid_vec=(0,), qsc=-20.0,
               max_seqid=90, ndiff=1000, filter_min_enable=0,
               gap_open=11, gap_extend=1):
    """Returns keep flags (uint8[setSize]; 2=query, 1=kept, 0=dropped).

    msa rows must be GAP-padded to a 32-byte multiple (compute_msa does
    this); the block-granular diff/coverage counting of the AVX2 loop is
    reproduced exactly.
    """
    mat = constants.blosum62()
    sub = mat.sub  # int16[21,21]
    X_in = msa
    N_in_total = msa.shape[0]
    L = center_len
    keep = np.zeros(N_in_total, dtype=np.uint8)
    N_keep_total = 0
    qid_vec = sorted(int(q) for q in qid_vec)
    # Ndiff is a (mutated) function parameter in the reference: the
    # `Ndiff = N_in` rewrite persists across qid buckets (MsaFilter.cpp:85,249)
    Ndiff_param = ndiff

    for qid_idx in range(len(qid_vec)):
        if len(qid_vec) == 1:
            if N_in_total < filter_min_enable:
                keep[:] = 1
                keep[0] = 2
                N_keep_total = N_in_total - 1
                break
            qid = qid_vec[0]
            bucket = list(range(N_in_total))
        else:
            if qid_idx == len(qid_vec) - 1:
                break
            qid = 0
            bucket = [0]
            query = X_in[0]
            for k in range(1, N_in_total):
                xk = X_in[k][:L]
                nr = int((xk < NAA).sum())
                nid = int(((xk == query[:L]) & (xk < NAA)).sum())
                seqid = int(np.float32(100.0) * (np.float32(nid) / np.float32(nr))) if nr else 0
                if qid_vec[qid_idx] < seqid <= qid_vec[qid_idx + 1]:
                    bucket.append(k)
            if len(bucket) < filter_min_enable:
                for k in bucket[1:]:
                    keep[k] = 1
                keep[bucket[0]] = 2
                N_keep_total += len(bucket) - 1
                continue

        N_in = len(bucket)
        X = [X_in[k] for k in bucket]
        keep_local = bucket  # indices into keep
        seqid1 = 20
        WFIL = 25
        diffNmax = Ndiff_param
        diffNmax_prev = 0
        seqid_step = 0
        kfirst = 0

        for idx, k in enumerate(keep_local):
            keep[k] = 2 if idx == 0 else 1
        in_ = np.zeros(N_in, dtype=np.uint8)
        n = 0
        for idx in range(N_in):
            if keep[keep_local[idx]] == 2:
                in_[idx] = 2
                n += 1

        first = np.zeros(N_in, dtype=np.int64)
        last = np.zeros(N_in, dtype=np.int64)
        nres = np.zeros(N_in, dtype=np.int64)
        for k in range(N_in):
            xk = X[k][:L]
            isaa = xk < NAA
            nz = np.nonzero(isaa)[0]
            # reference scans i down to 1 (not 0) for `last`
            first[k] = nz[0] if len(nz) else L
            last[k] = nz[-1] if len(nz) else (0 if L > 0 else 0)
            if len(nz) == 0:
                first[k] = L
                last[k] = 0
            nres[k] = int(isaa[first[k]:last[k] + 1].sum()) if first[k] <= last[k] else 0
            if nres[k] == 0:
                keep[keep_local[k]] = 0

        # stable sort of 1..N_in-1 by nres descending (query stays first)
        order = sorted(range(1, N_in), key=lambda k: -nres[k])
        ksort = [0] + order
        inkk = np.array([in_[ksort[kk]] for kk in range(N_in)], dtype=np.uint8)

        N = np.zeros(L, dtype=np.int64)
        N[first[kfirst]:last[kfirst] + 1] = 1
        Nmax = np.zeros(L, dtype=np.int64)
        idmaxwin = np.full(L, -1, dtype=np.int64)
        seqid_prev = np.full(N_in, -1, dtype=np.int64)
        if Ndiff_param <= 0 or Ndiff_param >= N_in:
            seqid1 = max_seqid
            Ndiff_param = N_in
            diffNmax = Ndiff_param
        Ndiff = Ndiff_param

        # coverage / qsc / qid prefilters (MsaFilter.cpp:240-310)
        qdiff_max_frac = np.float32(0.9999 - 0.01 * qid)
        for k in range(N_in):
            kl = keep_local[k]
            if keep[kl] == 0 or keep[kl] == 2:
                continue
            if 100 * nres[k] < coverage * L:
                keep[kl] = 0
                continue
            if qsc > -10:
                qsc_min = np.float32(qsc) * np.float32(nres[k])
                qsc_sum = np.float32(0.0)
                gapq = 0
                gapk = 0
                xq = X[kfirst]
                xk = X[k]
                for i in range(int(first[k]), int(last[k]) + 1):
                    ak = int(xk[i])
                    aq = int(xq[i])
                    if ak < 20:
                        gapk = 0
                        if aq < 20:
                            gapq = 0
                            qsc_sum += np.float32(sub[aq][ak])
                        elif aq == ANY:
                            continue
                        else:
                            if gapq:
                                qsc_sum -= np.float32(1.0)
                            else:
                                qsc_sum -= np.float32(6.0)
                            gapq += 1
                    elif ak == ANY:
                        continue
                    elif aq < 20:
                        gapq = 0
                        if gapk:
                            qsc_sum -= np.float32(1.0)
                        else:
                            qsc_sum -= np.float32(6.0)
                        gapk += 1
                if qsc_sum < qsc_min:
                    keep[kl] = 0
                    continue
            if qdiff_max_frac < np.float32(0.999):
                qdiff_max = int(qdiff_max_frac * np.float32(nres[k]) + np.float64(0.9999))
                diff = 0
                xk = X[k][first[k]:last[k] + 1]
                xq = X[kfirst][first[k]:last[k] + 1]
                d = np.cumsum((xk < NAA) & (xk != xq))
                diff = int(d[-1]) if len(d) else 0
                if diff >= qdiff_max:
                    keep[kl] = 0
                    continue

        nn = sum(1 for k in range(N_in) if keep[keep_local[k]] > 0)
        if nn == 0 and N_in > 0:
            keep[keep_local[0]] = 1

        if seqid1 > max_seqid:
            N_keep_total += nn
            continue

        seqid = seqid1
        while seqid <= max_seqid:
            stop = True
            diffNmax_prev = diffNmax
            diffNmax = 0
            for i in range(L):
                lo = max(0, min(L - 2 * WFIL + 1, i - WFIL))
                hi = min(L, max(2 * WFIL, i + WFIL))
                mx = int(N[lo:hi].max()) if hi > lo else 0
                if Nmax[i] < mx:
                    Nmax[i] = mx
                if Nmax[i] < Ndiff:
                    stop = False
                    idmaxwin[i] = seqid
                    if diffNmax < Ndiff - Nmax[i]:
                        diffNmax = Ndiff - Nmax[i]
            if stop:
                break

            for kk in range(N_in):
                if inkk[kk]:
                    continue
                k = ksort[kk]
                kl = keep_local[k]
                if not keep[kl]:
                    continue
                if keep[kl] == 2:
                    inkk[kk] = 2
                    continue
                if seqid >= 100:
                    in_[k] = inkk[kk] = 1
                    n += 1
                    continue
                seqidk = np.float32(seqid1)
                if first[k] <= last[k]:
                    w = idmaxwin[first[k]:last[k] + 1]
                    m = int(w.max()) if len(w) else -1
                    if m > seqidk:
                        seqidk = np.float32(m)
                if seqid == seqid_prev[k]:
                    continue
                seqid_prev[k] = seqid
                diff_min_frac = np.float32(0.9999 - 0.01 * float(seqidk))
                rejected = False
                for jj in range(kk):
                    if not inkk[jj]:
                        continue
                    j = ksort[jj]
                    first_kj = max(first[k], first[j])
                    last_kj = min(last[k], last[j])
                    cov_kj = int(last_kj - first_kj + 1)
                    diff_suff = int(diff_min_frac * np.float32(min(int(nres[k]), cov_kj)) + np.float64(0.999))
                    fb = int(first_kj // BLOCK)
                    lb = int(last_kj // BLOCK) + 1
                    cov_kj += abs(fb * BLOCK - int(first_kj)) + abs(lb * BLOCK - (int(last_kj) + 1))
                    xk = X[k][fb * BLOCK: lb * BLOCK]
                    xj = X[j][fb * BLOCK: lb * BLOCK]
                    noaa = (xk > NAA - 1) | (xj > NAA - 1)
                    cov_kj -= int(noaa.sum())
                    eq = xk == xj
                    diff = int((~(eq | noaa)).sum())
                    if diff < diff_suff and np.float32(diff) <= diff_min_frac * cov_kj and cov_kj > 0:
                        rejected = True
                        break
                if not rejected:
                    in_[k] = inkk[kk] = 1
                    n += 1
                    N[first[k]:last[k] + 1] += 1

            seqid_step = max(1, min(5, diffNmax // (diffNmax_prev - diffNmax + 1) * seqid_step // 2))
            seqid += seqid_step

        for k in range(N_in):
            keep[keep_local[k]] = in_[k]
        N_keep_total += n - 1

    return keep, N_keep_total + 1
