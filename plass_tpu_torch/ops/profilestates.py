"""Context profile state libraries and discretization (ProfileStates).

Reference: lib/mmseqs/src/commons/ProfileStates.{h,cpp} — parses the
HH-suite "ContextLibrary" text format (commons/LibraryReader semantics),
converts the per-state scores back to probabilities with fpow2(-s/1000)
(ProfileStates.cpp:141-156), normalizes priors (ProfileStates.cpp:199-232,
with the background-projection fallback for libraries without priors), and
assigns the closest state per profile column (discretize,
ProfileStates.cpp:308-397 / discretizeCs219, :401-423). Column scoring and
the squared-difference reduction run in the native kernel
(native/profilestates.cpp) at exact reference float semantics.
"""
import ctypes
import os

import numpy as np

from .. import constants
from ..native import lib

# ProfileStates.h:108-111 — HH-suite AA order -> mmseqs AA order
HH2MMSEQS = [0, 14, 11, 2, 1, 13, 3, 5, 6, 7, 9, 8, 10, 4, 12, 15, 16, 18, 19, 17]

_LIB_FILES = {
    8: "libPolished_8.lib",
    32: "ExpOpt3_8_polished.cs32.lib",
    219: "cs219.lib",
    255: "Library255_may17.lib",
}

_F32P = ctypes.POINTER(ctypes.c_float)


def _strtod_prefix(tok):
    """std::strtod semantics on a token: parse the leading numeric prefix,
    0.0 when there is none (e.g. '*')."""
    for end in range(len(tok), 0, -1):
        try:
            return float(tok[:end])
        except ValueError:
            continue
    return 0.0


def _parse_library(text, nat):
    """Parse a ContextLibrary blob -> (profiles float32[K,20], prior
    float32[K]) with reference float semantics."""
    lines = [ln for ln in text.split("\n")]
    pos = 0

    def getline():
        nonlocal pos
        ln = lines[pos] if pos < len(lines) else ""
        pos += 1
        return ln

    ln = getline()
    while ln.strip() == "":
        ln = getline()
    assert ln.startswith("ContextLibrary"), "not a ContextLibrary"
    size = int(getline().split()[1])        # SIZE
    getline()                               # LENG
    profiles = np.zeros((size, 20), dtype=np.float32)
    prior = np.zeros(size, dtype=np.float32)
    for k in range(size):
        ln = getline()
        while ln.strip() == "":
            ln = getline()
        assert ln.startswith("ContextProfile"), ln
        ln = getline()
        if "NAME" in ln:
            ln = getline()
        prior[k] = np.float32(float(ln.split()[1]))   # PRIOR
        ln = getline()
        if "COLOR" in ln:
            ln = getline()
        # ISLOG already consumed in ln; LENG; ALPH
        getline()
        getline()
        ln = getline()
        assert "PROBS" in ln
        toks = getline().split()
        # first field is the position index (== 1); then 20 scores
        for a in range(20):
            score = np.float32(_strtod_prefix(toks[1 + a]))
            prob = np.float32(nat.ps_fpow2(
                ctypes.c_float(np.float32(-score) / np.float32(1000))))
            profiles[k, HH2MMSEQS[a]] = prob
        ln = getline()
        assert ln.startswith("//"), ln
    return profiles, prior


class ProfileStates:
    """State library for one alphabet size (8/32/219/255)."""

    def __init__(self, alph_size, pback=None):
        nat = lib()
        if pback is None:
            pback = constants.blosum62().pback
        self.background = np.asarray(pback[:20], dtype=np.float32)
        path = os.path.join(constants.DATA_DIR, _LIB_FILES[alph_size])
        with open(path) as fh:
            self.profiles, prior = _parse_library(fh.read(), nat)
        self.K = self.profiles.shape[0]
        # prior normalization with background-projection fallback
        # (ProfileStates.cpp:201-232) — sequential float accumulation
        z = np.float32(0.0)
        for k in range(self.K):
            z += prior[k]
        if z == np.float32(0.0):
            for k in range(self.K):
                for a in range(20):
                    prior[k] += self.profiles[k, a] * self.background[a]
                z += prior[k]
        for k in range(self.K):
            prior[k] /= z
        self.ceilK = ((self.K + 7) // 8) * 8
        self.prior = np.zeros(self.ceilK, dtype=np.float32)
        self.prior[:self.K] = prior
        self.disc = np.zeros((self.K, self.ceilK), dtype=np.float32)
        nat.ps_disc_scores(self.profiles.ctypes.data_as(_F32P),
                           self.background.ctypes.data_as(_F32P),
                           self.K, self.ceilK,
                           self.disc.ctypes.data_as(_F32P))
        self._nat = nat

    def discretize(self, prob):
        """Closest-state assignment (ProfileStates::discretize) for float32
        profile columns prob[L,20] -> uint8[L]."""
        prob = np.ascontiguousarray(prob, dtype=np.float32)
        L = prob.shape[0]
        out = np.zeros(L, dtype=np.uint8)
        self._nat.ps_discretize(
            prob.ctypes.data_as(_F32P), L,
            self.profiles.ctypes.data_as(_F32P),
            self.prior.ctypes.data_as(_F32P),
            self.disc.ctypes.data_as(_F32P),
            self.background.ctypes.data_as(_F32P),
            self.K, self.ceilK,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out

    def discretize_cs219(self, prob):
        """Posterior-argmax assignment (ProfileStates::discretizeCs219)."""
        prob = np.ascontiguousarray(prob, dtype=np.float32)
        L = prob.shape[0]
        out = np.zeros(L, dtype=np.uint8)
        self._nat.ps_discretize_cs219(
            prob.ctypes.data_as(_F32P), L,
            self.profiles.ctypes.data_as(_F32P),
            self.prior.ctypes.data_as(_F32P),
            self.background.ctypes.data_as(_F32P),
            self.K,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
