"""Linear-time search index (kmerindexdb) and k-mer search (kmersearch).

Reference: lib/mmseqs/src/linclust/kmerindexdb.cpp, kmersearch.cpp,
LinsearchIndexReader.cpp. The index stores one entry per distinct selected
k-mer — the first member after the (kmer, seqLen desc, id, pos) sort, i.e.
the longest sequence (LinsearchIndexReader::pickCenterKmer,
LinsearchIndexReader.cpp:20-63). kmersearch merge-joins the query's
selected k-mers against the index, emits (rep, member, diagonal) with
strand algebra for nucleotides (kmersearch.cpp:296-430), sorts by
(rep, id, diagonal) and writes prefilter records whose score is the
shared-k-mer count and whose diagonal is the last (largest) shared
diagonal (KmerSearch::writeResult, kmersearch.cpp:62-129).

The on-disk index is an npz payload (+ a .dbtype tagged DBTYPE_INDEX_DB
for detection), the same file the JAX package writes; the *search output*
is byte-identical to the reference. Cited quirk replicated: when the
largest-key query k-mer matches the index, the reference's in-place merge
loop re-emits that match until the write cursor overruns it
(kmersearch.cpp:363-418)."""
import math
import os

import numpy as np

from ..data import seqdb

BIT63 = np.uint64(1) << np.uint64(63)
INDEX_SUFFIX = ".linidx"


def index_name(base):
    """LinsearchIndexReader::indexName (LinsearchIndexReader.cpp:233-237)."""
    return base + INDEX_SUFFIX


def search_for_index(base):
    """LinsearchIndexReader::searchForIndex (:280-286)."""
    out = base + INDEX_SUFFIX
    return out if os.path.exists(out + ".dbtype") else ""


def set_kmer_length_and_alphabet(db, kmer_size, alphabet_size,
                                 kmers_per_sequence, seq_id_thr=0.0):
    """setKmerLengthAndAlphabet (kmermatcher.cpp:1200-1228)."""
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    aa_size = int(db.total_residues())
    if is_nucl:
        if kmer_size == 0:
            kmer_size = max(17, int(math.log(float(aa_size)) / math.log(4)))
            alphabet_size = 5
        if kmers_per_sequence == 0:
            kmers_per_sequence = 60
    else:
        if kmer_size == 0:
            if (seq_id_thr + 0.001) >= 0.99:
                kmer_size, alphabet_size = 14, 21
            elif (seq_id_thr + 0.001) >= 0.9:
                kmer_size, alphabet_size = 14, 13
            else:
                kmer_size = max(10, int(math.log(float(aa_size))
                                        / math.log(8.7)))
                alphabet_size = 13
        if kmers_per_sequence == 0:
            kmers_per_sequence = 20
    return kmer_size, alphabet_size, kmers_per_sequence


def _seed_matrix(name):
    """--seed-sub-mat resolution: reduced-13 alphabet over the named
    matrix's probabilities (kmerindexdb.cpp:60-70); VTML80 is the global
    default, blosum62 the createlinindex/linsearch override."""
    from .. import constants
    if name and "vtml" in name.lower():
        return constants.Matrix(constants._load("vtml80_reduced13"))
    return None  # blosum62 reduced-13 (map_sequences default)


def _sorted_kmer_entries(db, k, kmers_per_sequence, scale, hash_shift,
                         seed_mat=None):
    """extractKmerAndSort (kmersearch.cpp:23-59): selected k-mers sorted by
    compareRepSequenceAndIdAndPos(Reverse)."""
    from .kmermatch import build_kmer_table
    kmer, sid, pos, slen, is_nucl = build_kmer_table(
        db, k, kmers_per_sequence=kmers_per_sequence,
        kmers_per_sequence_scale=scale, hash_shift=hash_shift,
        hash_whole_sequence=False, seed_mat=seed_mat)
    pos16 = pos.astype(np.int16)
    len16 = slen.astype(np.int16)
    cmp_kmer = (kmer | BIT63) if is_nucl else kmer
    order = np.lexsort((pos16, sid, -len16.astype(np.int32), cmp_kmer))
    return (kmer[order], sid[order], pos16[order], len16[order], is_nucl)


def build_linindex(db, base_out, kmer_size=0, alphabet_size=0,
                   kmers_per_sequence=0, scale=None, hash_shift=67,
                   spaced_kmer=0, mask_mode=0, max_seq_len=65535,
                   seed_sub_mat="VTML80.out"):
    """kmerindexdb (kmerindexdb.cpp:18-330) with an npz payload."""
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    kmer_size, alphabet_size, kmers_per_sequence = \
        set_kmer_length_and_alphabet(db, kmer_size, alphabet_size,
                                     kmers_per_sequence)
    if scale is None:
        scale = 0.2 if is_nucl else 0.0
    kmer, sid, pos, slen, _ = _sorted_kmer_entries(
        db, kmer_size, kmers_per_sequence, scale, hash_shift,
        seed_mat=_seed_matrix(seed_sub_mat))
    # pickCenterKmer: first entry (longest member) per distinct k-mer;
    # SIZE_T_MAX placeholder groups are dropped
    # (LinsearchIndexReader.cpp:33-47)
    cmp_kmer = (kmer | BIT63) if is_nucl else kmer
    if len(cmp_kmer):
        first = np.ones(len(cmp_kmer), dtype=bool)
        first[1:] = cmp_kmer[1:] != cmp_kmer[:-1]
        first &= cmp_kmer != np.uint64(0xFFFFFFFFFFFFFFFF)
    else:
        first = np.zeros(0, dtype=bool)
    out = index_name(base_out)
    np.savez(out + ".npz",
             kmer=kmer[first], id=sid[first],
             pos=pos[first].astype(np.uint16),
             seq_len=slen[first].astype(np.uint16),
             meta=np.array([max_seq_len, kmer_size, kmer_size,
                            alphabet_size, int(mask_mode > 0),
                            int(spaced_kmer), 0, db.dbtype],
                           dtype=np.int64),
             seed_mat=np.frombuffer(seed_sub_mat.encode(), dtype=np.uint8))
    # detection stub: a DBTYPE_INDEX_DB record DB pointing at the payload
    w = seqdb.DBWriter(seqdb.INDEX_DB)
    w.write(0, b"plass_tpu-linidx-v1\n", add_newline=False)
    w.finish().save(out)
    return out


def load_linindex(base):
    d = np.load(index_name(base) + ".npz")
    meta = d["meta"]
    return {
        "kmer": d["kmer"], "id": d["id"], "pos": d["pos"],
        "seq_len": d["seq_len"],
        "max_seq_len": int(meta[0]), "kmer_size": int(meta[1]),
        "adjusted_kmer_size": int(meta[2]), "alphabet_size": int(meta[3]),
        "mask": int(meta[4]), "spaced_kmer": int(meta[5]),
        "seq_type": int(meta[7]),
        "seed_sub_mat": (bytes(d["seed_mat"]).decode()
                         if "seed_mat" in d else "VTML80.out"),
    }


def kmersearch(qdb, index, kmers_per_sequence=0, scale=None, hash_shift=67,
               result_direction_target=True, seed_sub_mat="VTML80.out"):
    """kmersearch (kmersearch.cpp:134-295) -> prefilter DBWriter."""
    is_nucl = qdb.dbtype == seqdb.NUCLEOTIDES
    k = index["kmer_size"]
    if kmers_per_sequence == 0:
        kmers_per_sequence = 60 if is_nucl else 20
    if scale is None:
        scale = 0.2 if is_nucl else 0.0
    qk, qid, qpos, qlen, _ = _sorted_kmer_entries(
        qdb, k, kmers_per_sequence, scale, hash_shift,
        seed_mat=_seed_matrix(seed_sub_mat))
    K = len(qk)

    tk = index["kmer"]
    tid = index["id"].astype(np.int64)
    tpos = index["pos"].astype(np.int64)       # unsigned short
    tlen = index["seq_len"].astype(np.int64)   # unsigned short

    key_q = (qk | BIT63) if is_nucl else qk
    key_t = (tk | BIT63) if is_nucl else tk

    if K and len(tk):
        j = np.searchsorted(key_t, key_q)
        jc = np.minimum(j, len(tk) - 1)
        match = key_t[jc] == key_q
    else:
        match = np.zeros(K, dtype=bool)
        jc = np.zeros(K, dtype=np.int64)

    qsel = np.nonzero(match)[0]
    tsel = jc[qsel]

    # the in-place merge re-emits a match on the final query entry
    # (kmersearch.cpp:363-418): duplicates until writePos reaches it
    if K and match[K - 1]:
        w0 = len(qsel) - 1
        extra = (K - 1) - w0
        if extra > 0:
            qsel = np.concatenate([qsel, np.full(extra, K - 1,
                                                 dtype=qsel.dtype)])
            tsel = np.concatenate([tsel, np.full(extra, jc[K - 1],
                                                 dtype=tsel.dtype)])

    q_pos = qpos[qsel].astype(np.int64)
    q_id = qid[qsel].astype(np.int64)
    q_len16 = qlen[qsel]
    t_id = tid[tsel]
    t_pos = tpos[tsel]
    t_len = tlen[tsel]

    if is_nucl:
        q_is_fwd = (qk[qsel] & BIT63) != 0      # bit set = forward
        t_is_fwd = (tk[tsel] & BIT63) != 0
        if result_direction_target:
            target_is_rev = ~q_is_fwd
            rep_is_rev = ~t_is_fwd
        else:
            target_is_rev = ~t_is_fwd
            rep_is_rev = ~q_is_fwd
        # short-typed position algebra (kmersearch.cpp:377-398)
        query_pos = t_pos.astype(np.int16)
        target_pos = q_pos.astype(np.int16)
        qp_f = ((t_len - 1) - t_pos).astype(np.int16)
        # targetPos flip uses the query entry's seqLen (short)
        tp_flip = ((q_len16.astype(np.int64) - 1) - q_pos).astype(np.int16)
        do_flip = (rep_is_rev & target_is_rev) | \
                  (~rep_is_rev & target_is_rev)
        query_pos = np.where(do_flip, qp_f, query_pos)
        target_pos = np.where(do_flip, tp_flip, target_pos)
        query_needs_rev = (rep_is_rev & ~target_is_rev) | \
                          (~rep_is_rev & target_is_rev)
        if result_direction_target:
            diag = (query_pos.astype(np.int32)
                    - target_pos.astype(np.int32)).astype(np.int16)
            rep = t_id
            member = q_id
        else:
            diag = (target_pos.astype(np.int32)
                    - query_pos.astype(np.int32)).astype(np.int16)
            rep = q_id
            member = t_id
        rep_field = np.where(query_needs_rev,
                             rep.astype(np.uint64) & ~BIT63,
                             rep.astype(np.uint64) | BIT63)
    else:
        if result_direction_target:
            rep, member = t_id, q_id
            diag = (t_pos.astype(np.int32)
                    - q_pos.astype(np.int32)).astype(np.int16)
        else:
            rep, member = q_id, t_id
            diag = (q_pos.astype(np.int32)
                    - t_pos.astype(np.int32)).astype(np.int16)
        rep_field = rep.astype(np.uint64)

    # sort by (rep [BIT_SET for nucl], member id, diagonal)
    cmp_rep = (rep_field | BIT63) if is_nucl else rep_field
    order = np.lexsort((diag, member, cmp_rep))
    rep_field = rep_field[order]
    member = member[order]
    diag = diag[order]

    # writeResult (kmersearch.cpp:62-129)
    out_type = seqdb.PREFILTER_REV_RES if is_nucl else seqdb.PREFILTER_RES
    writer = seqdb.DBWriter(out_type)
    n = len(rep_field)
    i = 0
    cur_rep = None
    lines = []
    while i < n:
        if is_nucl:
            rev_mask = (rep_field[i] & BIT63) == 0
            rep_id = int(rep_field[i] & ~BIT63)
        else:
            rev_mask = False
            rep_id = int(rep_field[i])
        if cur_rep is None or rep_id != cur_rep:
            if cur_rep is not None:
                writer.write(cur_rep, "".join(lines).encode(),
                             add_newline=False)
            cur_rep = rep_id
            lines = []
        run_start = i
        best_rev = rev_mask
        best_diag = int(diag[i])
        hit_id = int(member[i])
        while i < n and int(member[i]) == hit_id and \
                int(rep_field[i] & ~BIT63 if is_nucl
                    else rep_field[i]) == rep_id:
            best_diag = int(diag[i])
            best_rev = ((rep_field[i] & BIT63) == 0) if is_nucl else False
            i += 1
        top_score = i - run_start
        score = -top_score if best_rev else top_score
        lines.append(f"{hit_id}\t{score}\t{best_diag}\n")
    if cur_rep is not None and lines:
        writer.write(cur_rep, "".join(lines).encode(), add_newline=False)
    return writer.finish()
