"""Codon translation (reference: lib/mmseqs/src/commons/TranslateNucl.h:488-501,
lib/mmseqs/src/util/translatenucs.cpp:40-118).

Uses precomputed 17^3 IUPAC-class LUTs from the constants package (one per
NCBI genetic-code table). Lowercase codons translate to lowercase residues.
"""
import numpy as np

from .. import constants
from ..data.seqdb import DBWriter, AMINO_ACIDS
from .orf import parse_orf_header


def translate_array(seq_u8, table=1):
    """Translate uint8 nucleotides -> uint8 residues (len//3)."""
    codes = constants.genetic_codes()
    lut, _ = codes[table]
    cls = codes["nucl_class"]
    n = (len(seq_u8) // 3) * 3
    s = seq_u8[:n].reshape(-1, 3)
    c = cls[s]
    aa = lut[c[:, 0], c[:, 1], c[:, 2]]
    lower = ((s | np.uint8(0x20)) == s) & (s >= ord("a")) & (s <= ord("z"))
    is_lower = lower.any(axis=1)
    aa = np.where(is_lower, aa | np.uint8(0x20), aa)
    return aa.astype(np.uint8)


def stop_codons(table=1):
    """Exact stop codons of a table (unambiguous ACGT codons translating to *)."""
    codes = constants.genetic_codes()
    lut, _ = codes[table]
    out = []
    base_cls = {b: int(codes["nucl_class"][ord(b)]) for b in "ACGT"}
    for b1 in "ACGT":
        for b2 in "ACGT":
            for b3 in "ACGT":
                if lut[base_cls[b1], base_cls[b2], base_cls[b3]] == ord("*"):
                    out.append((b1 + b2 + b3).encode())
    return tuple(out)


def start_codons(table=1, use_all_table_starts=False):
    if not use_all_table_starts:
        return (b"ATG",)
    codes = constants.genetic_codes()
    _, start = codes[table]
    base_cls = {b: int(codes["nucl_class"][ord(b)]) for b in "ACGT"}
    out = []
    for b1 in "ACGT":
        for b2 in "ACGT":
            for b3 in "ACGT":
                if start[base_cls[b1], base_cls[b2], base_cls[b3]]:
                    out.append((b1 + b2 + b3).encode())
    return tuple(out)


def translate_nucs(orf_db, orf_hdr_db=None, table=1, add_orf_stop=False,
                   max_seq_len=65535):
    """translatenucs: ORF nucleotide DB -> amino-acid DB.

    With add_orf_stop, '*' brackets are added where the ORF had a complete
    start/end according to its header (translatenucs.cpp:57-101).
    """
    writer = DBWriter(AMINO_ACIDS)
    hdr_by_key = None
    if add_orf_stop:
        if orf_hdr_db is None:
            raise ValueError("add_orf_stop requires the ORF header DB")
        hdr_by_key = {int(k): i for i, k in enumerate(orf_hdr_db.keys)}

    for i in range(orf_db.size):
        key = int(orf_db.keys[i])
        raw = orf_db.get_data(i)  # payload incl. trailing '\n'
        if len(raw) == 0:
            continue
        add_start = add_end = False
        if add_orf_stop:
            loc = parse_orf_header(orf_hdr_db.get_data(hdr_by_key[key]).tobytes())
            if loc is not None:
                add_start = not loc["incomplete_start"]
                add_end = not loc["incomplete_end"]
        # reference operates on entryLen-1, i.e. sequence + '\n'
        # (translatenucs.cpp:69-73); ORF lengths are always %3==0 so the odd
        # branches only matter for non-ORF inputs
        length = len(raw)
        if length % 3 != 0 and (length - 1) % 3 != 0:
            length -= length % 3
        if length < 3:
            continue
        if length > 3 * max_seq_len:
            length = 3 * max_seq_len
        n_codons = length // 3
        aa = translate_array(np.asarray(raw[: n_codons * 3]), table)
        parts = []
        if add_start:
            parts.append(b"*")
        parts.append(aa.tobytes())
        if add_end and aa[-1] != ord("*"):
            parts.append(b"*")
        writer.write(key, b"".join(parts))
    return writer.finish(sort_by_key=True)
