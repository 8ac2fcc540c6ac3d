"""Banded affine-gap extension alignment — exact port of ksw2's extz kernel
(reference: lib/mmseqs/lib/ksw2/ksw2_extz2_sse.cpp, the minimap2 difference
formulation) and the BandedNucleotideAligner wrapper
(lib/mmseqs/src/alignment/BandedNucleotideAligner.cpp).

The anti-diagonal rows are vectorized with NumPy (the recurrence only reads
the previous row, so each row is one set of array ops); the SSE version's
16-lane padding is reproduced because its stale out-of-band cells can leak
back into the band and change results. This row-parallel formulation is also
the blueprint for a Pallas wavefront kernel.
"""
import numpy as np

NEG_INF = -0x40000000

M_OP, I_OP, D_OP = 0, 1, 2


class ExtzResult:
    __slots__ = ("max", "max_q", "max_t", "zdropped", "cigar", "score",
                 "mqe", "mqe_t", "mte", "mte_q")

    def __init__(self):
        self.max = 0
        self.max_q = -1
        self.max_t = -1
        self.zdropped = False
        self.cigar = []  # list of (op, length)
        self.score = NEG_INF
        self.mqe = NEG_INF
        self.mqe_t = -1
        self.mte = NEG_INF
        self.mte_q = -1


def ksw_extz(query, target, mat, m, q, e, w=64, zdrop=200, score_only=False,
             extz_only=True):
    """Exact scalar equivalent of ksw_extz2_sse (left gap alignment).

    query/target: uint8 numeric sequences; mat: int[m*m] scores flattened;
    q/e gap open/extend. Returns ExtzResult.
    """
    qlen, tlen = len(query), len(target)
    ez = ExtzResult()
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    qe = q + e
    qe2 = 2 * qe
    sc_mch = int(mat[0])
    sc_mis = int(mat[1])
    max_sc_clamp = sc_mch + qe2
    mat = np.asarray(mat, dtype=np.int32).reshape(m, m)
    max_sc = int(mat.max())
    min_sc = int(mat.min())
    if -min_sc > 2 * qe:
        return ez

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    n_col = min(qlen, tlen)
    n_col = (min(n_col, w + 1) + 15) // 16 * 16 + 16  # padded band width

    tpad = (tlen + 15) // 16 * 16 + 16
    u = np.zeros(tpad, dtype=np.int32)
    v = np.zeros(tpad, dtype=np.int32)
    x = np.zeros(tpad, dtype=np.int32)
    y = np.zeros(tpad, dtype=np.int32)
    s = np.zeros(tpad, dtype=np.int32)
    H = np.full(tpad, NEG_INF, dtype=np.int64)
    sf = np.zeros(tpad, dtype=np.int64)
    sf[:tlen] = target
    qr = np.zeros(qlen, dtype=np.int64)
    qr[:] = query[::-1]

    generic = not (m == 5 and _is_simple_matrix(mat, sc_mch, sc_mis))

    p_rows = [] if not score_only else None
    offs = []

    last_st = last_en = -1
    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        if st > en:
            ez.zdropped = True
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1

        # boundary conditions
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, v1 = int(x[st - 1]), int(v[st - 1])
            else:
                x1, v1 = 0, 0
        else:
            x1 = 0
            v1 = q if r else 0
        if en >= r:
            y[r] = 0
            u[r] = q if r else 0

        # score prefill over [st0, en0] in 16-wide stores (stale cells persist)
        pre_st, pre_en = st0, min(((en0 - st0) // 16) * 16 + st0 + 15, tpad - 1)
        qpos = r - np.arange(pre_st, pre_en + 1)  # query index per t
        # qrr[t] = qr[qlen-1-r+t] = query[r - t]
        qq = np.where((qpos >= 0) & (qpos < qlen), query[np.clip(qpos, 0, qlen - 1)], -1)
        tt = sf[pre_st: pre_en + 1]
        if not generic:
            mask = (tt == m - 1) | (qq == m - 1)
            sc = np.where(tt == qq, sc_mch, sc_mis)
            sc = np.where(mask, 0, sc)
        else:
            sc = mat[np.clip(tt, 0, m - 1).astype(np.int64),
                     np.clip(qq, 0, m - 1).astype(np.int64)]
            sc = np.where((qpos >= 0) & (qpos < qlen), sc, 0)
        s[pre_st: pre_en + 1] = sc

        # core row (vectorized): t in [st, en]
        n = en - st + 1
        z = s[st: en + 1] + qe2
        xt1 = np.concatenate([[x1], x[st: en]])
        vt1 = np.concatenate([[v1], v[st: en]])
        a = xt1 + vt1
        b = y[st: en + 1] + u[st: en + 1]
        if not score_only:
            d = (a > z).astype(np.uint8)
        z = np.maximum(z, a)
        if not score_only:
            d = np.where(b > z, np.uint8(2), d)
        z = np.maximum(z, b)  # both non-negative
        z = np.minimum(z, max_sc_clamp)
        new_u = z - vt1
        new_v = z - u[st: en + 1]
        z2 = z - q
        a2 = a - z2
        b2 = b - z2
        if not score_only:
            d = d | ((a2 > 0).astype(np.uint8) << np.uint8(3))
            d = d | ((b2 > 0).astype(np.uint8) << np.uint8(4))
            p_rows.append(d)
        u[st: en + 1] = new_u
        v[st: en + 1] = new_v
        x[st: en + 1] = np.maximum(a2, 0)
        y[st: en + 1] = np.maximum(b2, 0)
        offs.append((st, en))

        # exact H tracking (approx_max off)
        u8 = u
        v8 = v
        if r > 0:
            if en0 > 0:
                H[en0] = H[en0 - 1] + u8[en0] - qe
            else:
                H[en0] = H[en0] + v8[en0] - qe
            if en0 > st0:
                H[st0: en0] += v8[st0: en0] - qe
            # row max with the reference's exact 4-lane SSE tie-breaking
            # (ksw2_extz2_sse.cpp:216-244): H[en0] seeds the max; lanes
            # i=0..3 each keep the EARLIEST strict-> max over positions
            # st0+i, st0+4+i, ...; lanes are combined in index order with
            # strict <, then the scalar tail st0+4k..en0-1 with strict >.
            max_H = int(H[en0])
            max_t = en0
            en1 = st0 + (en0 - st0) // 4 * 4
            if en1 > st0:
                lanes = H[st0: en1].reshape(-1, 4)
                for i in range(4):
                    col = lanes[:, i]
                    k = int(np.argmax(col))
                    if int(col[k]) > max_H:
                        max_H = int(col[k])
                        max_t = st0 + 4 * k + i
            for tcand in range(en1, en0):
                if H[tcand] > max_H:
                    max_H = int(H[tcand])
                    max_t = tcand
        else:
            H[0] = v8[0] - qe - qe
            max_H, max_t = int(H[0]), 0
        if en0 == tlen - 1 and H[en0] > ez.mte:
            ez.mte = int(H[en0])
            ez.mte_q = r - en
        if r - st0 == qlen - 1 and H[st0] > ez.mqe:
            ez.mqe = int(H[st0])
            ez.mqe_t = st0
        if _apply_zdrop(ez, max_H, r, max_t, zdrop, e):
            break
        if r == qlen + tlen - 2 and en0 == tlen - 1:
            ez.score = int(H[tlen - 1])
        last_st, last_en = st, en

    if not score_only:
        if (not ez.zdropped) and (not extz_only):
            ez.cigar = _backtrack(p_rows, offs, tlen - 1, qlen - 1)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, offs, ez.max_t, ez.max_q)
    return ez


def _is_simple_matrix(mat, mch, mis):
    """True if the matrix is match/mismatch with wildcard last row/col = 0...
    The reference uses the fast path unless KSW_EZ_GENERIC_SC is set — the
    caller never sets it, so the fast path formula applies unconditionally:
    score = 0 if either letter == m-1 else (mch if equal else mis)."""
    return True


def _apply_zdrop(ez, H, r, t, zdrop, e):
    """ksw_apply_zdrop (ksw2.h:186-203), is_rot variant."""
    if H > ez.max:
        ez.max = H
        ez.max_t = t
        ez.max_q = r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = tl - ql if tl > ql else ql - tl
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


def _backtrack(p_rows, offs, i0, j0):
    """ksw_backtrack (ksw2.h:145-177), is_rot=1, left-aligned gaps.

    i = target index, j = query index. Returns cigar [(op, len)] with ops
    0=M 1=I(query) 2=D(target).
    """
    cigar = []

    def push(op, length):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += length
        else:
            cigar.append([op, length])

    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        st, en = offs[r]
        if i < st:
            force_state = 2
        if i > en:
            force_state = 1
        tmp = int(p_rows[r][i - st]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            push(M_OP, 1)
            i -= 1
            j -= 1
        elif state == 1 or state == 3:
            push(D_OP, 1)
            i -= 1
        else:
            push(I_OP, 1)
            j -= 1
    if i >= 0:
        push(D_OP, i + 1)
    if j >= 0:
        push(I_OP, j + 1)
    cigar.reverse()
    return [(op, length) for op, length in cigar]
