"""Greedy incremental clustering + cluster-merging utilities (the `clust`,
`mergeclusters`, `result2repseq` commands used by linclust).

Reference semantics:
  - clust GREEDY/GREEDY_MEM: lib/mmseqs/src/clustering/Clustering.cpp:32-84
    (execute(4)) and ClusteringAlgorithms.cpp:271-333
    (greedyIncrementalLowMem): sequences are ordered by (length desc,
    key-sorted position asc) — SORT_BY_LENGTH, DBReader.h — and every
    element is assigned the minimum internal id among itself and all
    queries whose alignment list contains it; a serial fix-up pass then
    re-promotes any referenced non-representative to representative.
  - output format: Clustering::writeData (Clustering.cpp:85-115): per
    representative key (ascending), the rep key line first, then member
    keys (ascending) excluding the rep.
  - mergeclusters: lib/mmseqs/src/util/mergeclusters.cpp — chains
    clustering steps by splicing member lists.
  - result2repseq: lib/mmseqs/src/util/result2repseq.cpp — first key of
    each result record selects the representative sequence.
"""
import numpy as np

from ..data import seqdb

DBTYPE_CLUSTER = 6


def _length_order(db):
    """Internal ids: positions into key-sorted order, sorted by
    (entry length desc, key-sorted position asc). DBReader SORT_BY_LENGTH
    sorts by the index length field, which includes the \\n\\0 suffix —
    a constant shift, so sequence-length order is identical."""
    lens = db.lengths  # full record lengths — the reference index field
    return np.lexsort((np.arange(db.size), -lens.astype(np.int64)))


def greedy_incremental_cluster(db, alignments):
    """ClusteringAlgorithms::greedyIncrementalLowMem.

    db: SeqDB of the clustered input (keys ascending).
    alignments: {query_key: iterable of target keys} — the first column of
    each alignment record, in record line order (order is irrelevant here;
    only set membership feeds the min).

    Returns {rep_key: [member_keys ascending, rep first]} with reps
    ascending (dict preserves insertion order).
    """
    n = db.size
    order = _length_order(db)  # internal id -> key-sorted position
    keys = np.asarray(db.keys)
    internal_of_pos = np.empty(n, dtype=np.int64)
    internal_of_pos[order] = np.arange(n)
    key_to_internal = {int(keys[pos]): int(internal_of_pos[pos])
                       for pos in range(n)}

    # assigned[e] = min(e, min{q : key(e) in aln[key(q)]})
    assigned = np.arange(n, dtype=np.int64)
    for q_int in range(n):
        q_key = int(keys[order[q_int]])
        for t_key in alignments.get(q_key, ()):
            m = key_to_internal[int(t_key)]
            if q_int < assigned[m]:
                assigned[m] = q_int
    # fix-up: promote any referenced assignment target to representative
    # (ClusteringAlgorithms.cpp:323-331)
    for i in range(n):
        a = assigned[i]
        if assigned[a] != a:
            assigned[a] = a

    rep_keys = keys[order[assigned]]
    member_keys = keys[order]
    pairs = sorted(zip(rep_keys.tolist(), member_keys.tolist()))
    out = {}
    for rep, member in pairs:
        out.setdefault(rep, []).append(member)
    return out


UINT_MAX = 0xFFFFFFFF


def set_cover_cluster(db, adjacency):
    """ClusteringAlgorithms::setCover (execute(1), --cluster-mode 0).

    adjacency: {query_key: [(target_key, ushort_score), ...]} in record line
    order. An empty record must be passed as [(self_key, sentinel)] —
    1000 for alignment input, 65535 for prefilter/cluster input
    (AlignmentSymmetry::readInData, AlignmentSymmetry.cpp:44-63).

    Pipeline (ClusteringAlgorithms.cpp + AlignmentSymmetry.cpp): symmetrize
    the graph (missing back-links appended at the tail in setId-ascending
    discovery order, carrying the forward score), bucket-sort ids by degree,
    then greedily take the largest remaining set, assigning members by
    strict score improvement (the ushort score is read back as SIGNED short,
    so the 65535 sentinel compares as -1).
    """
    n = db.size
    order = _length_order(db)
    keys = np.asarray(db.keys)
    key_to_internal = {}
    internal_of_pos = np.empty(n, dtype=np.int64)
    internal_of_pos[order] = np.arange(n)
    for pos in range(n):
        key_to_internal[int(keys[pos])] = int(internal_of_pos[pos])

    lists = [[] for _ in range(n)]
    scores = [[] for _ in range(n)]
    for i in range(n):
        qkey = int(keys[order[i]])
        for (tkey, sc) in adjacency.get(qkey, ()):
            lists[i].append(key_to_internal[int(tkey)])
            scores[i].append(int(sc) & 0xFFFF)

    # symmetrize (findMissingLinks + addMissingLinks): membership tested
    # against the ORIGINAL lists; new links appended at the tail
    orig_sets = [set(l) for l in lists]
    appended = [[] for _ in range(n)]
    appended_sc = [[] for _ in range(n)]
    for set_id in range(n):
        for elm, sc in zip(lists[set_id], scores[set_id]):
            if set_id not in orig_sets[elm]:
                appended[elm].append(set_id)
                appended_sc[elm].append(sc)
    for i in range(n):
        lists[i].extend(appended[i])
        scores[i].extend(appended_sc[i])

    cluster_sizes = [len(l) for l in lists]
    max_size = max(cluster_sizes) if n else 0

    # initClustersizes: counting sort of ids by size, id-ascending per bucket
    abundance = [0] * (max_size + 1)
    for s in cluster_sizes:
        abundance[s] += 1
    borders = [0] * (max_size + 1)
    for s in range(1, max_size + 1):
        borders[s] = borders[s - 1] + abundance[s - 1]
    sorted_cs = [UINT_MAX] * (n + 1)
    pos_of = [UINT_MAX] * (n + 1)
    running = [0] * (max_size + 1)
    for i in range(n):
        p = borders[cluster_sizes[i]] + running[cluster_sizes[i]]
        sorted_cs[p] = i
        pos_of[i] = p
        running[cluster_sizes[i]] += 1

    assigned = [UINT_MAX] * n
    best = [-32768] * n  # SHRT_MIN

    def remove_clustersize(cid):
        cluster_sizes[cid] = 0
        sorted_cs[pos_of[cid]] = UINT_MAX
        pos_of[cid] = UINT_MAX

    def decrease_clustersize(cid):
        oldpos = pos_of[cid]
        newpos = borders[cluster_sizes[cid]]
        swapid = sorted_cs[newpos]
        if swapid != UINT_MAX:
            pos_of[swapid] = oldpos
        sorted_cs[oldpos] = swapid
        sorted_cs[newpos] = cid
        pos_of[cid] = newpos
        borders[cluster_sizes[cid]] += 1
        cluster_sizes[cid] -= 1

    for cl_size in range(n - 1, -1, -1):
        rep = sorted_cs[cl_size]
        if rep == UINT_MAX:
            continue
        remove_clustersize(rep)
        assigned[rep] = rep
        for elm, usc in zip(lists[rep], scores[rep]):
            sc = usc - 0x10000 if usc >= 0x8000 else usc  # ushort -> short
            if sc > best[elm]:
                assigned[elm] = rep
                best[elm] = sc
            if elm == rep:
                continue
            if cluster_sizes[elm] < 1:
                continue
            remove_clustersize(elm)
        for elm in lists[rep]:
            if elm == rep:
                cluster_sizes[elm] = -1
                continue
            if cluster_sizes[elm] < 0:
                continue
            cluster_sizes[elm] = -1
            for elm2 in lists[elm]:
                if cluster_sizes[elm2] == 1:
                    pass  # reference logs an error and leaves it
                elif cluster_sizes[elm2] > 0:
                    decrease_clustersize(elm2)

    rep_keys = keys[order[np.asarray(assigned, dtype=np.int64)]]
    member_keys = keys[order]
    pairs = sorted(zip(rep_keys.tolist(), member_keys.tolist()))
    out = {}
    for rep, member in pairs:
        out.setdefault(rep, []).append(member)
    return out


def alignment_adjacency(db, alignments):
    """Build set_cover_cluster adjacency from alignment results
    (similarity-type 2: ushort(atof(seqId text) * 1000.0f))."""
    from ..ops.rescore import format_seq_id
    out = {}
    for i in range(db.size):
        qkey = int(db.keys[i])
        rows = alignments.get(qkey, ())
        if len(rows) == 0:
            out[qkey] = [(qkey, 1000)]
            continue
        entries = []
        for r in rows:
            sc = int(float(format_seq_id(r["seqId"])) * np.float32(1000.0))
            entries.append((int(r["dbKey"]), sc))
        out[qkey] = entries
    return out


def prefilter_adjacency(db, hits):
    """set_cover_cluster adjacency from prefilter-format hits
    (|score| column)."""
    out = {}
    for i in range(db.size):
        qkey = int(db.keys[i])
        rows = hits.get(qkey, ())
        if len(rows) == 0:
            out[qkey] = [(qkey, 0xFFFF)]
            continue
        out[qkey] = [(int(t), abs(int(s))) for (t, s, _d) in rows]
    return out


def clusters_to_db(clusters):
    """Serialize clustering as a DBTYPE_CLUSTER record DB
    (Clustering::writeData layout: rep key line first, members minus rep)."""
    w = seqdb.DBWriter(dbtype=DBTYPE_CLUSTER)
    for rep in sorted(clusters):
        lines = [str(rep)]
        lines += [str(m) for m in clusters[rep] if m != rep]
        w.write(rep, ("\n".join(lines) + "\n").encode(), add_newline=False)
    return w.finish()


def db_to_clusters(cdb):
    """Parse a cluster DB back to {rep_key: [line keys in order]}."""
    out = {}
    for i in range(cdb.size):
        key = int(cdb.keys[i])
        txt = cdb.get_data(i).tobytes().decode()
        out[key] = [int(x) for x in txt.split()] if txt else []
    return out


def merge_clusters(seq_db, steps):
    """mergeclusters.cpp: chain clustering steps.

    steps: list of {rep_key: [line keys in record order]} — the first step's
    records start with the rep key itself (Clustering::writeData), so the
    spliced lists carry the rep as their first element.
    Returns {rep_key: [member keys in splice order]} iterated in seq_db key
    order (mergeclusters.cpp:112-147 writes per key-sorted position).
    """
    merged = {}
    first = steps[0]
    for rep in sorted(first):
        # record line order: the rep key line first, then members minus rep
        # (Clustering::writeData)
        merged[rep] = [rep] + [m for m in first[rep] if m != rep]
    for step in steps[1:]:
        for rep in sorted(step):
            acc = merged.setdefault(rep, [])
            for member in step[rep]:
                if member != rep:
                    acc.extend(merged.get(member, ()))
                    merged[member] = []
    out = {}
    for key in np.asarray(seq_db.keys).tolist():
        members = merged.get(int(key))
        if members:
            out[int(key)] = members
    return out


def merged_clusters_to_db(clusters):
    """mergeclusters output: one record per non-empty rep, member keys in
    list order (the rep is the first list element via the step-1 records)."""
    w = seqdb.DBWriter(dbtype=DBTYPE_CLUSTER)
    for rep, members in clusters.items():
        w.write(rep, ("\n".join(str(m) for m in members) + "\n").encode(),
                add_newline=False)
    return w.finish()


def result2repseq(seq_db, result_db):
    """result2repseq.cpp: write the sequence of each record's first key
    under the record's own key; output dbtype follows seq_db."""
    w = seqdb.DBWriter(dbtype=seq_db.dbtype)
    for i in range(result_db.size):
        body = result_db.get_data(i).tobytes()
        if not body:
            continue
        first = int(body.split(None, 1)[0].split(b"\t", 1)[0])
        sid = seq_db.key_to_id(first)
        w.write(int(result_db.keys[i]), seq_db.get_data(sid).tobytes(),
                add_newline=False)
    return w.finish()


def filter_lines_by_keys(result_db, keep_keys):
    """filterdb --filter-file (filterdb.cpp GET_FROM_FILE, positive
    filtering on column 1): keep lines whose first token is in the set."""
    keep = {str(int(k)) for k in keep_keys}
    w = seqdb.DBWriter(dbtype=result_db.dbtype)
    for i in range(result_db.size):
        body = result_db.get_data(i).tobytes().decode()
        kept = [ln for ln in body.splitlines()
                if ln and ln.split("\t", 1)[0].split(" ", 1)[0] in keep]
        w.write(int(result_db.keys[i]),
                ("\n".join(kept) + "\n").encode() if kept else b"",
                add_newline=False)
    return w.finish()
