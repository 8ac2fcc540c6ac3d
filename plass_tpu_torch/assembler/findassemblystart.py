"""Start-codon correction (reference: src/assembler/findassemblystart.cpp).

For each query: locate its first 'M'; project that column through every
alignment partner; count partners whose projected position holds '*M'.
If the '*M' frequency over the group is >= 0.2, record (max-reduce) the cut
position for every member; pass 2 rewrites affected sequences as
'*' + suffix-from-M.
"""
import numpy as np

from ..data import seqdb

THRESHOLD = 0.2


def find_assembly_start(db, alignments):
    """db: amino-acid SeqDB; alignments: {query_key: RESULT_DTYPE array}.
    Returns corrected SeqDB."""
    lut = db.id_lookup_array()
    add_stop_at = np.full(db.size, -1, dtype=np.int64)

    for qkey in sorted(alignments):
        recs = alignments[qkey]
        qid = int(lut[qkey])
        qseq = db.get_seq_bytes(qid)
        m_pos = qseq.find(b"M")
        if m_pos == -1:
            continue
        has_stop_m = m_pos > 0 and qseq[m_pos - 1: m_pos] == b"*"
        group = [(qid, m_pos, True, has_stop_m)]
        for r in recs:
            tid = int(lut[int(r["dbKey"])])
            if tid == qid:
                continue
            qs, qe = int(r["qStartPos"]), int(r["qEndPos"])
            ts = int(r["dbStartPos"])
            pos_of_m = -1
            has_m = False
            has_sm = False
            # (reference condition at findassemblystart.cpp:108 — note the
            # second comparison is queryPosOfM <= qEndPos)
            if qs >= m_pos and m_pos <= qe:
                offset = m_pos - qs
                db_m = ts + offset
                tseq = db.get_seq_bytes(tid)
                pos_of_m = db_m
                has_m = 0 <= db_m < len(tseq) and tseq[db_m: db_m + 1] == b"M"
                if db_m > 0 and has_m:
                    has_sm = tseq[db_m - 1: db_m] == b"*"
            group.append((tid, pos_of_m, has_m, has_sm))
        if len(group) > 1:
            stop_m = sum(1 for g in group if g[3])
            freq = stop_m / len(group)
            if freq >= THRESHOLD:
                for tid, mp, _, _ in group:
                    if mp > add_stop_at[tid]:
                        add_stop_at[tid] = mp

    writer = seqdb.DBWriter(seqdb.AMINO_ACIDS)
    for i in range(db.size):
        key = int(db.keys[i])
        s = db.get_seq_bytes(i)
        mp = int(add_stop_at[i])
        if mp == -1:
            writer.write(key, s)
        else:
            writer.write(key, b"*" + s[mp:])
    return writer.finish()
