"""Profile database reading (Sequence::mapProfile semantics) and
profile-derived outputs (profile2pssm / profile2consensus / profile2repseq).

Reference: lib/mmseqs/src/commons/Sequence.cpp:mapProfile (scoreUnmask per
column, >0.9 renormalization, optional substitution-matrix pseudocounts),
Sequence.h:480 probaToBitScore, SubstitutionMatrix::calcGlobalAaBiasCorrection
(SubstitutionMatrix.cpp).
"""
import ctypes

import numpy as np

from .. import constants
from ..native import lib
from .msa import PROFILE_AA_SIZE, PROFILE_READIN_SIZE


def read_profile(data, add_pc=False, pca=1.0, pcb=1.5):
    """Parse one profile record -> dict(prob float32[L,20], query uint8[L],
    consensus uint8[L], neff float32[L])."""
    nat = lib()
    arr = np.frombuffer(data, dtype=np.uint8)
    L = len(arr) // PROFILE_READIN_SIZE
    arr = arr[:L * PROFILE_READIN_SIZE].reshape(L, PROFILE_READIN_SIZE)
    prob = np.zeros((L, 20), dtype=np.float32)
    for pos in range(L):
        for aa in range(20):
            prob[pos, aa] = nat.pssm_score_unmask(int(arr[pos, aa]))
        s = np.float32(0.0)
        for aa in range(20):
            s += prob[pos, aa]
        if s > 0.9:
            # MathUtil::NormalizeTo1 float semantics
            fac = np.float32(np.float64(1.0) / np.float64(s))
            prob[pos] *= fac
    out = {
        "prob": prob,
        "query": arr[:, 20].copy(),
        "consensus": arr[:, 21].copy(),
        "neff": np.array([nat.pssm_neff_to_float(int(c)) for c in arr[:, 22]],
                         dtype=np.float32),
    }
    if add_pc and pca > 0.0:
        _add_pseudocounts(out, pca, pcb)
    return out


def _add_pseudocounts(profile, pca, pcb):
    """PSSMCalculator::preparePseudoCounts + computePseudoCounts applied to
    a read profile (Sequence.cpp:mapProfile shouldAddPC path)."""
    nat = lib()
    d = constants._load("blosum62")
    r = np.zeros((21, 32), dtype=np.float32)
    r[:, :21] = d["pseudo_r"]
    prob = profile["prob"]
    L = prob.shape[0]
    flat = np.ascontiguousarray(prob.reshape(-1), dtype=np.float32)
    # reuse the native ScalarProd20 via a tiny per-position loop in C would
    # be nicer; the call count is small enough to do it here
    pc = np.zeros_like(flat)
    f32p = ctypes.POINTER(ctypes.c_float)
    for pos in range(L):
        for aa in range(20):
            pc[pos * 20 + aa] = nat.pssm_scalar_prod20(
                r[aa].ctypes.data_as(f32p),
                flat[pos * 20:].ctypes.data_as(f32p))
    neff = profile["neff"]
    for pos in range(L):
        # tau = fmin(1.0, pca / (1.0 + Neff/pcb)) — Neff/pcb is a FLOAT
        # division before the double promotion (PSSMCalculator.cpp:256)
        neff_ratio = np.float32(neff[pos]) / np.float32(pcb)
        tau = np.float32(min(1.0, float(pca) / (1.0 + float(neff_ratio))))
        for aa in range(20):
            sig = np.float32((1.0 - float(tau)) * float(flat[pos * 20 + aa]))
            prob[pos, aa] = sig + np.float32(float(tau) * float(pc[pos * 20 + aa]))
    return profile


def flog2(x):
    """MathUtil::flog2 via the native replica (MathUtil.h:107-119)."""
    return np.float32(lib().pssm_flog2(ctypes.c_float(x)))


def profile_scores(profile):
    """profile_score of mapProfile (Sequence.cpp): short[L,20] =
    round(2*flog2(prob/pBack)) (X-state -128 clamp to -1), NOT yet bias
    corrected. Returns int16 array."""
    mat = constants.blosum62()
    prob = profile["prob"]
    L = prob.shape[0]
    scores = np.zeros((L, 20), dtype=np.int16)
    for pos in range(L):
        for aa in range(20):
            bit = flog2(np.float64(prob[pos, aa]) / mat.pback[aa])
            if bit <= -128:
                bit = np.float32(-1)
            b8 = np.float32(bit * np.float32(2.0))
            v = np.int16(b8 - np.float32(0.5)) if b8 < 0.0 else np.int16(b8 + np.float32(0.5))
            scores[pos, aa] = v
    return scores


def global_aa_bias_correction(scores):
    """SubstitutionMatrix::calcGlobalAaBiasCorrection applied to int16
    [L,20] scores (window 40)."""
    mat = constants.blosum62()
    L = scores.shape[0]
    pnull = np.zeros(L, dtype=np.float32)
    for pos in range(L):
        # pNullBuffer[pos] += pBack[aa] * float(score): double-precision
        # add narrowed to float EACH step (SubstitutionMatrix.cpp)
        s = np.float32(0.0)
        for aa in range(20):
            s = np.float32(np.float64(s)
                           + mat.pback[aa] * np.float64(np.float32(scores[pos, aa])))
        pnull[pos] = s
    # the correction overwrites profileScores in place, so rows j < i read
    # already-corrected values inside later windows (SubstitutionMatrix.cpp)
    out = scores.copy()
    W = 40
    for i in range(L):
        lo = max(0, i - W // 2)
        hi = min(L, i + W // 2)
        wlen = hi - lo
        aasum = np.zeros(20, dtype=np.float32)
        for j in range(lo, hi):
            if j == i:
                continue
            aasum += out[j].astype(np.float32) - pnull[j]
        for aa in range(20):
            out[i, aa] = int(np.float32(out[i, aa]) - aasum[aa] / np.float32(wlen))
    return out


def profile_to_pssm_lines(profile, comp_bias_correction=True):
    """profile2pssm body lines (profile2pssm.cpp:57-82): the *4 /4 score
    round-trip is an identity, so scores come straight from profile_scores
    (+ optional bias correction)."""
    mat = constants.blosum62()
    scores = profile_scores(profile)
    # mapProfile stores profile_score = round(...)*4, bias-corrects on that
    # x4 scale, then profile_for_alignment = profile_score/4 with C
    # truncation toward zero (Sequence.cpp mapProfile + mapSequence)
    if comp_bias_correction:
        scores4 = (scores.astype(np.int32) * 4).astype(np.int16)
        scores4 = global_aa_bias_correction(scores4).astype(np.int32)
        scores = (np.sign(scores4) * (np.abs(scores4) // 4)).astype(np.int16)
    lines = ["Pos\tCns\t" + "\t".join(mat.letters[a] for a in range(20))]
    cons = profile["consensus"]
    L = scores.shape[0]
    for j in range(L):
        lines.append(f"{j}\t{mat.letters[int(cons[j])]}\t"
                     + "\t".join(str(int(scores[j, aa])) for aa in range(20)))
    return "\n".join(lines) + "\n"
