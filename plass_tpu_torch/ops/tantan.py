"""Tandem-repeat / low-complexity masking (tantan).

Reference: lib/mmseqs/src/commons/tantan.cpp, invoked by
IndexBuilder::fillDatabase with maxCycleLength=50, repeatProb=0.005,
repeatEndProb=0.05, repeatOffsetProbDecay=0.9, no gaps, minMaskProb=0.9
(IndexBuilder.cpp:139-149); masked residues become X (hardMaskTable,
BaseMatrix.h:85). The forward-backward HMM runs in the native library.
"""
import ctypes

import numpy as np

from ..native import lib


class TantanMasker:
    """Masks numeric sequences in place-copy, replacing repeat residues
    with the matrix's X index."""

    def __init__(self, matrix, max_cycle_length=50, repeat_prob=0.005,
                 repeat_end_prob=0.05, decay=0.9, min_mask_prob=0.9):
        if matrix.lratio is None:
            raise ValueError("matrix has no likelihood-ratio table")
        self.lratio = np.ascontiguousarray(matrix.lratio, dtype=np.float64)
        self.alpha = matrix.alphabet_size
        self.x_idx = matrix.alphabet_size - 1
        self.max_cycle_length = max_cycle_length
        self.repeat_prob = repeat_prob
        self.repeat_end_prob = repeat_end_prob
        self.decay = decay
        self.min_mask_prob = min_mask_prob
        self.nat = lib()

    def mask(self, num):
        """Return a masked copy of the numeric sequence."""
        out = np.ascontiguousarray(num, dtype=np.uint8).copy()
        n = self.nat.tantan_mask(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out),
            self.lratio.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.alpha, self.max_cycle_length, self.repeat_prob,
            self.repeat_end_prob, self.decay, self.min_mask_prob,
            self.x_idx)
        if n < 0:
            raise RuntimeError("tantan: zero forward total")
        return out
