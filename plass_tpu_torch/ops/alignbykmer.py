"""alignbykmer — fast k-mer-chained alignment (util/alignbykmer.cpp:21-510).

Per (query, target) prefilter pair: collect exact shared k-mers (spaced
pattern for amino acids, Sequence.h:19 spaced_seed_4; contiguous for
nucleotides k=9), group same-diagonal runs into stretches
(alignbykmer.cpp:240-298), chain stretches with a gap-cost DP
(:300-331), refine the transition points with a 1-D score DP (:341-390),
extend the outer ends (:393-416), and emit the chained backtrace with
substitution-matrix scoring (:424-479).

Reference quirks replicated exactly: the stretch/DP scratch arrays persist
across targets, so pairs with <2 shared k-mers chain whatever the previous
target left behind (stretcheVec/dpMatrixRow are only written up to the
current stretcheSize, alignbykmer.cpp:177-179); the query is mapped with
the RESULT-record ordinal's length (`qdbr->getSeqLen(id)`,
alignbykmer.cpp:198); the outer-end extension never updates its running
maximum (:393-416).
"""
import numpy as np

from .. import constants
from ..data import seqdb
from .evalue import EvalueComputer
from .nucl_align import _has_cov
from .protein_align import compress_cigar
from .rescore import format_seq_id

# Sequence.h:19/29 — spaced seed patterns (1 = sampled position)
SPACED_SEED = {
    4: [1, 1, 1, 0, 1],
    5: [1, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1],
    6: [1, 1, 0, 1, 0, 1, 0, 0, 1, 1],
    7: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1],
    8: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1],
    9: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1],
    10: [1, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1],
    11: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1],
}

USHRT_MAX = 0xFFFF


def _kmer_indices(num, k, spaced, alphabet_size):
    """All k-mer window (startPos, packedIndex) in iteration order
    (Sequence::nextKmer + Indexer::int2index)."""
    if spaced:
        pattern = SPACED_SEED[k]
        span = len(pattern)
        offs = [i for i, b in enumerate(pattern) if b]
    else:
        span = k
        offs = list(range(k))
    L = len(num)
    n = L - span + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    cols = np.stack([num[o:o + n].astype(np.int64) for o in offs], axis=1)
    # Indexer packs little-endian (powers[0] scales the FIRST residue,
    # Indexer.h:75-79) and alignbykmer stores the index in an unsigned
    # short (alignbykmer.cpp:203,227) — the lookup key is idx mod 65536
    powers = alphabet_size ** np.arange(len(offs), dtype=np.int64)
    idx = (cols @ powers) & 0xFFFF
    return np.arange(n, dtype=np.int64), idx


def run_alignbykmer(qdb, tdb, rdb, params):
    """Returns the output DBWriter (ALIGNMENT_RES)."""
    same_db = params.get("same_db", False)
    is_nucl = qdb.dbtype == seqdb.NUCLEOTIDES
    if is_nucl:
        mat = constants.nucleotide()
        k = params.get("k") or 9
        spaced = params.get("spaced_kmer", None) or False
        gap_open = params.get("gap_open_nucl", 5)
        gap_extend = params.get("gap_extend_nucl", 2)
        alph = 5
        ev_name = "nucleotide_gapped_5_2" if (gap_open, gap_extend) == (5, 2) \
            else "nucleotide_gapped_5_2"
    else:
        mat = constants.blosum62()
        k = params.get("k") or 4
        spaced = params.get("spaced_kmer")
        spaced = True if spaced is None else spaced
        gap_open = params.get("gap_open", 11)
        gap_extend = params.get("gap_extend", 1)
        alph = 21
        ev_name = "blosum62_11_1"
    evaluer = EvalueComputer.for_matrix(ev_name, int(tdb.total_residues()))
    sub = mat.sub.astype(np.int64)

    eval_thr = params.get("eval_thr", 0.001)
    seq_id_thr = params.get("min_seq_id", 0.0)
    cov_thr = params.get("cov_thr", 0.0)
    cov_mode = params.get("cov_mode", 0)
    include_identity = params.get("include_identity", False)

    lookup = np.full(1 << 16, USHRT_MAX, dtype=np.int64)

    # persistent scratch (reference: per-thread new[] reused across targets)
    max_len = int(max(qdb.seq_lens().max(), tdb.seq_lens().max())) + 8
    st_i_start = np.zeros(max_len, dtype=np.int64)
    st_i_end = np.zeros(max_len, dtype=np.int64)
    st_j_start = np.zeros(max_len, dtype=np.int64)
    st_j_end = np.zeros(max_len, dtype=np.int64)
    st_cnt = np.zeros(max_len, dtype=np.int64)
    dp_prev = np.zeros(max_len, dtype=np.int64)
    dp_score = np.zeros(max_len, dtype=np.int64)

    key2qid = {int(qdb.keys[i]): i for i in range(qdb.size)}
    key2tid = {int(tdb.keys[i]): i for i in range(tdb.size)}

    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    scan = [int(i) for i in seqdb.data_order(rdb)]
    for rid, i in enumerate(scan):
        qkey = int(rdb.keys[i])
        query_id = key2qid[qkey]
        # reference maps the query with getSeqLen(id) of the RESULT ordinal
        quirk_len = int(qdb.lengths[rid]) - 2 if rid < qdb.size \
            else qdb.seq_len(query_id)
        qoff = int(qdb.offsets[query_id])
        qbytes = qdb.data[qoff:qoff + max(0, quirk_len)]
        # Sequence::mapSequence stops at '\0'/'\n' (Sequence.cpp:483)
        stop = np.nonzero((qbytes == 0) | (qbytes == 10))[0]
        if len(stop):
            qbytes = qbytes[:stop[0]]
        qnum = mat.aa2num[qbytes].astype(np.uint8)
        qL = len(qnum)

        qpos, qidx = _kmer_indices(qnum, k, spaced, alph)
        if len(qidx):
            uniq, first = np.unique(qidx, return_index=True)
            lookup[uniq] = qpos[first]

        out = []
        body = rdb.get_data(i).tobytes().decode()
        for line in body.split("\n"):
            if not line:
                continue
            dbkey = int(line.split("\t")[0])
            target_id = key2tid[dbkey]
            tnum = mat.aa2num[tdb.get_data(target_id)].astype(np.uint8)
            tnum = tnum[:tdb.seq_len(target_id)]
            tL = len(tnum)
            is_identity = (query_id == target_id
                           and (include_identity or same_db))

            tpos, tidx = _kmer_indices(tnum, k, spaced, alph)
            hit = lookup[tidx] != USHRT_MAX
            pos_j = tpos[hit]
            pos_i = lookup[tidx[hit]]
            ij = (pos_i - pos_j) & USHRT_MAX
            order = np.lexsort((pos_j, pos_i, ij))
            ij, pos_i, pos_j = ij[order], pos_i[order], pos_j[order]
            n_kmer = len(ij)

            # stretch construction (alignbykmer.cpp:247-298)
            stretche_size = 0
            if n_kmer > 1:
                diag = (pos_i - pos_j).astype(np.int64) & 0xFFFFFFFF
                rmin_i, rmax_i = USHRT_MAX, 0
                rmin_j, rmax_j = USHRT_MAX, 0
                rcnt = 0
                prev_d = 0xFFFFFFFF
                prev_i = prev_j = 0
                for t in range(n_kmer):
                    curr_d = int(diag[t])
                    curr_i = int(pos_i[t])
                    curr_j = int(pos_j[t])
                    next_d = int(diag[t + 1]) if t < n_kmer - 1 \
                        else 0xFFFFFFFF
                    if curr_d != next_d and curr_d != prev_d:
                        continue
                    if (next_d == curr_d or prev_d == curr_d) \
                            and prev_i <= curr_i and prev_j <= curr_j:
                        rmin_i = min(rmin_i, curr_i)
                        rmax_i = max(rmax_i, curr_i)
                        rmin_j = min(rmin_j, curr_j)
                        rmax_j = max(rmax_j, curr_j)
                        rcnt += 1
                    prev_d, prev_i, prev_j = curr_d, curr_i, curr_j
                    if next_d != curr_d or t == n_kmer - 1:
                        st_i_start[stretche_size] = rmin_i
                        st_i_end[stretche_size] = rmax_i
                        st_j_start[stretche_size] = rmin_j
                        st_j_end[stretche_size] = rmax_j
                        st_cnt[stretche_size] = rcnt
                        stretche_size += 1
                        rmin_i, rmax_i = USHRT_MAX, 0
                        rmin_j, rmax_j = USHRT_MAX, 0
                        rcnt = 0
                        prev_i = prev_j = 0

            # sort stretches by (i_start asc, i_end desc)
            if stretche_size:
                so = sorted(range(stretche_size),
                            key=lambda x: (st_i_start[x], -st_i_end[x]))
                st_i_start[:stretche_size] = st_i_start[so]
                st_i_end[:stretche_size] = st_i_end[so]
                st_j_start[:stretche_size] = st_j_start[so]
                st_j_end[:stretche_size] = st_j_end[so]
                st_cnt[:stretche_size] = st_cnt[so]

            # chaining DP (alignbykmer.cpp:301-331)
            for s in range(stretche_size):
                dp_prev[s] = s
                dp_score[s] = st_cnt[s]
            best_score = 0
            best_last = 0
            for cur in range(stretche_size):
                for prev in range(cur):
                    if st_i_start[cur] > st_i_end[prev] and \
                            st_j_start[cur] > st_i_end[prev]:
                        dist = gap_open + \
                            (int(st_i_end[prev]) - int(st_i_start[cur])) \
                            * gap_extend
                        cand = int(dp_score[prev]) + dist + \
                            int(st_cnt[cur]) * k * 2
                        if cand > dp_score[cur]:
                            dp_prev[cur] = prev
                            dp_score[cur] = cand
                if dp_score[cur] > best_score:
                    best_last = cur
                    best_score = int(dp_score[cur])

            cur_id = best_last
            path = []  # list of [i_start, i_end, j_start, j_end]
            guard = 0
            while dp_prev[cur_id] != cur_id and guard <= max_len:
                path.append([int(st_i_start[cur_id]), int(st_i_end[cur_id]),
                             int(st_j_start[cur_id]), int(st_j_end[cur_id])])
                cur_id = int(dp_prev[cur_id])
                guard += 1
            path.append([int(st_i_start[cur_id]), int(st_i_end[cur_id]),
                         int(st_j_start[cur_id]), int(st_j_end[cur_id])])

            # 1-D transition refinement (alignbykmer.cpp:341-390)
            scores = {}
            for s in range(len(path) - 1, 0, -1):
                score = 0
                pos = 0
                i2, j2 = path[s][1], path[s][3]
                n_is, n_js = path[s - 1][0], path[s - 1][2]
                ii, jj = i2, j2
                while ii < n_is and jj < n_js:
                    if ii < qL and jj < tL:
                        score += int(sub[qnum[ii], tnum[jj]])
                    scores[pos] = score
                    pos += 1
                    ii += 1
                    jj += 1
                max_score = 0
                max_pos = 0
                max_rev = 0
                rev = 0
                scores[pos] = 0
                score = 0
                ii, jj = n_is, n_js
                while ii > path[s][1] and jj > path[s][3]:
                    if ii < qL and jj < tL:
                        score += int(sub[qnum[ii], tnum[jj]])
                    if scores.get(pos, 0) + score > max_score:
                        max_score = scores.get(pos, 0) + score
                        max_pos = pos
                        max_rev = rev
                    rev += 1
                    pos -= 1
                    ii -= 1
                    jj -= 1
                path[s - 1][0] -= max_rev
                path[s - 1][2] -= max_rev
                path[s][1] += max_pos
                path[s][3] += max_pos

            # outer end extension (alignbykmer.cpp:393-416);
            # maxScore is never updated inside these loops (reference)
            max_score = 0
            score = 0
            ii, jj = path[-1][0], path[-1][2]
            while ii > -1 and jj > -1:
                if ii < qL and jj < tL:
                    score += int(sub[qnum[ii], tnum[jj]])
                if score > max_score:
                    path[-1][0] = ii
                    path[-1][2] = jj
                ii -= 1
                jj -= 1
            score = 0
            ii, jj = path[0][1], path[0][3]
            while ii < qL and jj < tL:
                score += int(sub[qnum[ii], tnum[jj]])
                if score > max_score:
                    path[0][1] = ii
                    path[0][3] = jj
                ii += 1
                jj += 1

            # backtrace + scoring (alignbykmer.cpp:424-454)
            bt = []
            ids = 0
            score = 0
            for s in range(len(path) - 1, -1, -1):
                ii, jj = path[s][0], path[s][2]
                while ii < path[s][1]:
                    bt.append("M")
                    if ii < qL and jj < tL:
                        ids += int(qnum[ii] == tnum[jj])
                        score += int(sub[qnum[ii], tnum[jj]])
                    ii += 1
                    jj += 1
                if s > 0:
                    score -= gap_open
                    if path[s - 1][0] == path[s][1]:
                        for _ in range(path[s][3], path[s - 1][2]):
                            bt.append("I")
                            score -= gap_extend
                    else:
                        for _ in range(path[s][1], path[s - 1][0]):
                            bt.append("D")
                            score -= gap_extend
            q_start, q_end = path[-1][0], path[0][1]
            t_start, t_end = path[-1][2], path[0][3]
            qcov = np.float32(
                (min(qL, max(q_start, q_end)) - min(q_start, q_end) + 1)
                / np.float32(qL))
            tcov = np.float32(
                (min(tL, max(t_start, t_end)) - min(t_start, t_end) + 1)
                / np.float32(tL))
            aln_len = len(bt)
            seq_id = np.float32(ids) / np.float32(aln_len) if aln_len \
                else np.float32(0)
            bit_score = int(evaluer.bit_score(score) + 0.5)
            evalue = float(evaluer.evalue(score, qL))
            has_cov = _has_cov(cov_thr, cov_mode, float(qcov), float(tcov))
            has_seq_id = seq_id >= (seq_id_thr - np.finfo(np.float32).eps)
            if is_identity or (has_cov and has_seq_id
                               and evalue <= eval_thr):
                out.append(
                    f"{dbkey}\t{bit_score}\t{format_seq_id(seq_id)}\t"
                    f"{evalue:.3E}\t{q_start}\t{q_end}\t{qL}\t"
                    f"{t_start}\t{t_end}\t{tL}\t"
                    f"{compress_cigar(''.join(bt))}\n")
        writer.write(qkey, "".join(out).encode(), add_newline=False)
        if len(qidx):
            lookup[qidx] = USHRT_MAX
    return writer.finish()
