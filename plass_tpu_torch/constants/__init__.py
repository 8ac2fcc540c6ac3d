"""Frozen numeric constants derived from the reference data files.

The tables under `data/` (substitution matrices, alphabets, genetic codes,
the coding filter's weights, E-value parameters, the context-state and
calibration libraries) are this package's own copies of the JAX package's,
byte for byte; scripts/gen_constants.py made them, and holds the
derivations and reference citations. Loaded lazily and cached.
"""
import functools
import os

import numpy as np

# the tables, read here, by ops/profilestates.py and by ops/rescore.py
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.lru_cache(maxsize=None)
def _load(name):
    return dict(np.load(os.path.join(DATA_DIR, name + ".npz"), allow_pickle=False))


class Matrix:
    """A substitution matrix + alphabet mapping.

    aa2num: uint8[256] ASCII char -> alphabet index (X = alphabetSize-1)
    sub:    int16[A, A] integer scores
    ascii_mat: int16[256, 256] char-indexed score LUT
      (reference: SubstitutionMatrix::createAsciiSubMat, SubstitutionMatrix.h:56)
    """

    def __init__(self, d):
        self.letters = bytes(d["letters"]).decode()
        self.alphabet_size = len(self.letters)
        self.sub = d["sub"]
        self.pback = d.get("pback")
        self.aa2num = d["aa2num"]
        self.ascii_mat = d.get("ascii_mat")
        self.reverse = d.get("reverse")  # nucleotide complement permutation
        self.lratio = d.get("lratio")  # P(a,b)/(pa*pb), tantan emissions
        self.num2aa = np.frombuffer(self.letters.encode(), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def blosum62():
    return Matrix(_load("blosum62"))


@functools.lru_cache(maxsize=None)
def vtml80_8():
    """Seed k-mer matrix for the sensitive prefilter (VTML80, bit factor 8;
    reference: Prefiltering.cpp:64, --seed-sub-mat default)."""
    return Matrix(_load("vtml80_8"))


@functools.lru_cache(maxsize=None)
def blosum62_pref():
    """blosum62 at bit factor 2 with the prefilter's -0.2 score bias
    (Prefiltering.cpp:965-973) — ungapped diagonal scoring in `prefilter`."""
    return Matrix(_load("blosum62_pref"))


@functools.lru_cache(maxsize=None)
def nucleotide():
    return Matrix(_load("nucleotide"))


@functools.lru_cache(maxsize=None)
def reduced(size):
    """Reduced amino-acid alphabet (13 for kmermatcher, 7 for coding filter)."""
    return Matrix(_load(f"reduced{size}"))


@functools.lru_cache(maxsize=None)
def genetic_codes():
    """NCBI translation tables as 17^3 IUPAC-class LUTs.

    Returns dict: table id -> (lut uint8[17,17,17] of residue chars,
    start bool[17,17,17]), plus 'nucl_class' uint8[256].
    """
    d = _load("genetic_codes")
    out = {}
    for i, cid in enumerate(d["code_ids"]):
        out[int(cid)] = (d["luts"][i], d["starts"][i])
    out["nucl_class"] = d["nucl_class"]
    return out


@functools.lru_cache(maxsize=None)
def coding_filter_weights():
    """Weights of the coding/non-coding MLP (57 -> 32 -> 64 -> 1)."""
    d = _load("coding_filter")
    layers = []
    i = 0
    acts = [a for a in d["activations"]]
    while f"w{i}" in d:
        layers.append((d[f"w{i}"], d[f"b{i}"], str(acts[i])))
        i += 1
    return layers


@functools.lru_cache(maxsize=None)
def evalue_params(name):
    """Gumbel parameter vector [lambda K aJ bJ aI bI alphaJ betaJ alphaI betaI sigma tau].

    Names: blosum62_ungapped, blosum62_11_1, nucleotide_7_1,
    nucleotide_ungapped, nucleotide_gapped_5_2.
    (reference: EvalueComputation.h:56-76 + ALP-extracted values)
    """
    txt = os.path.join(DATA_DIR, name + ".txt")
    if os.path.exists(txt):
        return np.array([float(x) for x in open(txt).read().split()])
    return _load("evalue_params")[name]
