"""Exact XXH64 of 8-byte little-endian inputs and the Util::hash sequence
hash, on int64 tensors (device matcher) and on numpy uint64 (host matcher).

The k-mer matcher selects k-mers by the low 16 bits of
XXH64(uint64 kmer_index, seed=hashShift) (reference:
lib/mmseqs/src/linclust/kmermatcher.cpp:33-38,161,205). torch has no
general uint64 arithmetic, so the uint64 lanes live in int64 with the same
bits: multiplication, addition and xor wrap identically in two's
complement, every right shift is made logical by masking off the sign
copies, and constants >= 2^63 are written as their signed equivalents.
"""
import numpy as np
import torch

_M64 = 0xFFFFFFFFFFFFFFFF


def _s64(x):
    """Python int holding the signed int64 with the bits of uint64 x."""
    x &= _M64
    return x - (1 << 64) if x >= (1 << 63) else x


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = 0x27D4EB2F165667C5


def _shr(x, s):
    """Logical right shift of int64 lanes (uint64 semantics)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl(x, r):
    return (x << r) | _shr(x, 64 - r)


def xxh64_u64_torch(values, seed):
    """XXH64 of each uint64 (as 8 LE bytes, held in int64) with `seed`."""
    v = values.to(torch.int64)
    acc = _s64(int(seed) + _P5 + 8)
    k1 = _rotl(v * _P2, 31) * _P1
    acc = k1 ^ acc
    acc = _rotl(acc, 27) * _P1 + _P4
    acc = acc ^ _shr(acc, 33)
    acc = acc * _P2
    acc = acc ^ _shr(acc, 29)
    acc = acc * _P3
    acc = acc ^ _shr(acc, 32)
    return acc


def seq_hash_torch(seqs, lengths):
    """Util::hash (Util.h:337-345) h = h*31 + x over the first lengths[i]
    codes of each row of seqs [N, L], as uint64 bits in int64.

    Written as the closed form sum_j x_j * 31^(len-1-j) (mod 2^64), so it
    is one gather and one row sum instead of a loop over the columns."""
    n, lmax = seqs.shape
    pw = [1]
    for _ in range(max(lmax - 1, 0)):
        pw.append((pw[-1] * 31) & _M64)
    pw = torch.tensor([_s64(p) for p in pw] or [1], dtype=torch.int64,
                      device=seqs.device)
    j = torch.arange(lmax, device=seqs.device)
    expo = lengths.to(torch.int64)[:, None] - 1 - j[None, :]
    active = expo >= 0
    terms = seqs.to(torch.int64) * pw[expo.clamp(min=0)]
    return torch.where(active, terms, 0).sum(dim=1)


def xxh64_u64_np(values, seed):
    """XXH64 of each uint64 (as 8 LE bytes) with the given seed. NumPy."""
    u = np.uint64
    p1, p2 = u(_P1 & _M64), u(_P2 & _M64)
    p3, p4 = u(_P3 & _M64), u(_P4 & _M64)
    v = np.asarray(values, dtype=np.uint64)
    with np.errstate(over="ignore"):
        acc = u((seed + _P5 + 8) & _M64)
        k1 = v * p2
        k1 = (k1 << u(31)) | (k1 >> u(33))
        k1 = k1 * p1
        acc = acc ^ k1
        acc = ((acc << u(27)) | (acc >> u(37))) * p1 + p4
        acc ^= acc >> u(33)
        acc = acc * p2
        acc ^= acc >> u(29)
        acc = acc * p3
        acc ^= acc >> u(32)
    return acc


def seq_hash_np(num_seq):
    """Util::hash (Util.h:337-345): h = h*31 + x[i] over numeric letters."""
    h = np.uint64(0)
    with np.errstate(over="ignore"):
        for x in num_seq:
            h = h * np.uint64(31) + np.uint64(x)
    return h
