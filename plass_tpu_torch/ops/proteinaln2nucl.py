"""Map protein-space ungapped alignments onto the underlying nucleotide ORF
coordinates (the `proteinaln2nucl` command).

Reference: src/util/proteinaln2nucl.cpp — coordinates scale by 3 with a -3
shift when the amino-acid sequence starts with '*' (an ORF-stop marker from
translatenucs --add-orf-stop); the score is recomputed by walking the
backtrace over nucleotide characters with the nucleotide matrix and gap
costs gapOpen + (cnt-1)*3*gapExtend; bit score is TRUNCATED (no +0.5);
E-value parameters are the gapped nucleotide ones.

A copy of the JAX package's plass_tpu.ops.proteinaln2nucl, in two entry
points: protein_aln_to_nucl takes the flat records of the END_TO_END
rescore (pure-M, their implicit backtrace "<alnLength>M", so no gap cost
enters), the guided workflow's input; protein_aln_to_nucl_records takes
per-query record dicts with a gapped backtrace, as the `proteinaln2nucl`
command reads them from an alignment DB.
"""
import ctypes

import numpy as np

from .. import constants, native
from ..assembler.extend import _flat_seqs
from ..data import seqdb
from .evalue import EvalueComputer
from .rescore import format_seq_id


def protein_aln_to_nucl(nucl_db, aa_db, alignments, evaluer=None):
    """alignments: rescore's flat format {"qk": int64[M], "rec":
    RESULT_DTYPE[M]} (rescore_diagonal_torch(return_flat=True)).

    Coordinate x3 mapping in numpy, window scoring + identity counting +
    parsed-seqId in one OpenMP pass (native/aln2nucl.cpp), bit scores in
    one vectorized evaluer call.  Requires the nucl/aa DBs row-aligned
    (the guided workflow's invariant).

    Returns {"qk": int64[M], "n_aln_raw": int32[n] (pre-filter record
    count per row, for WAS_IN_ALIGNMENT), "dbkey", "dbid", "score",
    "seqid" (text-round-trip parsed), "alnlen", "qs", "qe", "qlen",
    "ts", "te", "tlen"} in nucleotide coordinates, grouped by query in
    nucl_db row order — the input of guided_assemble."""
    if not (isinstance(alignments, dict) and "qk" in alignments
            and "rec" in alignments):
        raise TypeError("protein_aln_to_nucl takes the flat records of "
                        "rescore_diagonal_torch(return_flat=True)")
    if not np.array_equal(nucl_db.keys, aa_db.keys):
        raise ValueError("flat proteinaln2nucl needs row-aligned DBs")
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("nucleotide_gapped_5_2",
                                            nucl_db.total_residues())
    qk = np.asarray(alignments["qk"], dtype=np.int64)
    rec = alignments["rec"]
    m = len(qk)
    lut = nucl_db.id_lookup_array()
    n = nucl_db.size

    # per-row ORF-stop marker: aa payload starts with '*'
    aa_data, aa_off, aa_lens = _flat_seqs(aa_db)
    star = np.zeros(n, dtype=np.int32)
    nz = aa_lens > 0
    star[nz] = (aa_data[aa_off[:-1][nz]] == ord("*")).astype(np.int32)

    seq_data, seq_off, seq_lens = _flat_seqs(nucl_db)
    qid = lut[qk].astype(np.int32)
    tid = lut[rec["dbKey"].astype(np.int64)].astype(np.int32)
    q_start = rec["qStartPos"].astype(np.int32) * 3 - 3 * star[qid]
    q_end = rec["qEndPos"].astype(np.int32) * 3 + 2 - 3 * star[qid]
    db_start = rec["dbStartPos"].astype(np.int32) * 3 - 3 * star[tid]
    db_end = rec["dbEndPos"].astype(np.int32) * 3 + 2 - 3 * star[tid]
    nwin = rec["alnLength"].astype(np.int32) * 3

    raw_score = np.zeros(m, dtype=np.int32)
    parsed = np.zeros(m, dtype=np.float64)
    mat = constants.nucleotide()
    ascii16 = np.ascontiguousarray(mat.ascii_mat.astype(np.int16))

    def p(a, ct):
        a = np.ascontiguousarray(a)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    qs_a, qs_p = p(q_start, ctypes.c_int32)
    ts_a, ts_p = p(db_start, ctypes.c_int32)
    qid_a, qid_p = p(qid, ctypes.c_int32)
    tid_a, tid_p = p(tid, ctypes.c_int32)
    nw_a, nw_p = p(nwin, ctypes.c_int32)
    native.lib().aln2nucl_score(
        m, seq_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qid_p, tid_p, qs_p, ts_p, nw_p,
        ascii16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        raw_score.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        parsed.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    bit = evaluer.bit_score(raw_score).astype(np.int64)  # truncated
    qlen = seq_lens[qid].astype(np.int32)
    tlen = seq_lens[tid].astype(np.int32)
    # the extender's alnLen is max(qe-qs, te-ts)+1 in nucl coords
    # (Matcher::computeAlnLength); for these ungapped windows both spans
    # are equal
    alnlen = (q_end - q_start + 1).astype(np.int32)
    # raw record count per row BEFORE the extender's seqId filter
    lo = np.searchsorted(qk, nucl_db.keys.astype(np.int64), side="left")
    hi = np.searchsorted(qk, nucl_db.keys.astype(np.int64), side="right")
    counts = (hi - lo).astype(np.int32)
    return {
        "qk": qk, "n_aln_raw": counts,
        "dbkey": rec["dbKey"].astype(np.uint32),
        "dbid": tid, "score": bit.astype(np.int32), "seqid": parsed,
        "alnlen": alnlen, "qs": q_start, "qe": q_end, "qlen": qlen,
        "ts": db_start, "te": db_end, "tlen": tlen,
    }


def protein_aln_to_nucl_records(nucl_db, aa_db, alignments, gap_open=5,
                                gap_extend=2, evaluer=None):
    """alignments: {query_key: [record dict with backtrace, or RESULT_DTYPE
    row (backtrace "<alnLength>M")]}.

    Returns {query_key: [dict(dbKey score seqId eval alnLength qStartPos
    qEndPos qLen dbStartPos dbEndPos dbLen backtrace)]} in nucleotide
    coordinates; the nucleotide and amino-acid DBs are read by key."""
    mat = constants.nucleotide()
    ascii_mat = mat.ascii_mat
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("nucleotide_gapped_5_2",
                                            nucl_db.total_residues())
    out = {}
    for qkey in alignments:
        qid = nucl_db.key_to_id(qkey)
        nq = np.asarray(nucl_db.get_seq(qid))
        nqlen = len(nq)
        aa_q = aa_db.get_seq_bytes(aa_db.key_to_id(qkey))
        q_start_codon = aa_q[:1] == b"*"
        rows = []
        for r in _iter_records(alignments[qkey]):
            tid = nucl_db.key_to_id(r["dbKey"])
            nt = np.asarray(nucl_db.get_seq(tid))
            aa_t = aa_db.get_seq_bytes(aa_db.key_to_id(r["dbKey"]))
            t_start_codon = aa_t[:1] == b"*"
            db_start = r["dbStartPos"] * 3 + (-3 if t_start_codon else 0)
            db_end = r["dbEndPos"] * 3 + 2 + (-3 if t_start_codon else 0)
            q_start = r["qStartPos"] * 3 + (-3 if q_start_codon else 0)
            q_end = r["qEndPos"] * 3 + 2 + (-3 if q_start_codon else 0)
            id_cnt = 0
            aln_len = 0
            qpos, tpos = q_start, db_start
            score = 0
            new_bt = []
            for cnt, op in _parse_backtrace(r["backtrace"]):
                if op == "M":
                    n = cnt * 3
                    qw = nq[qpos: qpos + n]
                    tw = nt[tpos: tpos + n]
                    id_cnt += int((qw == tw).sum())
                    score += int(ascii_mat[qw, tw].astype(np.int64).sum())
                    qpos += n
                    tpos += n
                elif op == "D":
                    tpos += cnt * 3
                    score -= gap_open + ((cnt - 1) * 3) * gap_extend
                elif op == "I":
                    qpos += cnt * 3
                    score -= gap_open + ((cnt - 1) * 3) * gap_extend
                else:
                    continue
                aln_len += cnt * 3
                new_bt.append(f"{cnt * 3}{op}")
            rows.append({
                "dbKey": int(r["dbKey"]),
                "score": int(evaluer.bit_score(score)),  # truncated
                "seqId": float(np.float32(id_cnt) / np.float32(aln_len))
                         if aln_len else 0.0,
                "eval": float(evaluer.evalue(score, nqlen)),
                "alnLength": aln_len,
                "qStartPos": q_start, "qEndPos": q_end, "qLen": nqlen,
                "dbStartPos": db_start, "dbEndPos": db_end, "dbLen": len(nt),
                "backtrace": "".join(new_bt),
            })
        out[qkey] = rows
    return out


def _iter_records(records):
    """Yield dicts with a backtrace from either dict records or RESULT_DTYPE
    rows (whose implicit END_TO_END backtrace is '<alnLen>M')."""
    for r in records:
        if isinstance(r, dict):
            yield r
        else:
            yield {
                "dbKey": int(r["dbKey"]), "qStartPos": int(r["qStartPos"]),
                "qEndPos": int(r["qEndPos"]),
                "dbStartPos": int(r["dbStartPos"]),
                "dbEndPos": int(r["dbEndPos"]),
                "backtrace": f"{int(r['alnLength'])}M",
            }


def _parse_backtrace(bt):
    """Parse a compressed cigar string like '19M2I3M' to [(19,'M'),...]."""
    out = []
    num = 0
    has_num = False
    for ch in bt:
        if ch.isdigit():
            num = num * 10 + int(ch)
            has_num = True
        else:
            out.append((num if has_num else 0, ch))
            num = 0
            has_num = False
    return out


def format_nucl_result_line(r):
    return (f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
            f"{r['eval']:.3E}\t{r['qStartPos']}\t{r['qEndPos']}\t{r['qLen']}\t"
            f"{r['dbStartPos']}\t{r['dbEndPos']}\t{r['dbLen']}\t"
            f"{r['backtrace']}\n")


def nucl_results_to_db(results):
    w = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for key in sorted(results):
        lines = [format_nucl_result_line(r) for r in results[key]]
        w.write(key, "".join(lines).encode(), add_newline=False)
    return w.finish()
