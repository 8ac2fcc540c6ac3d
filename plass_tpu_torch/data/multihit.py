"""Multi-hit aggregation (`multihitdb`, `multihitsearch`, besthitperset,
combinepvalperset, mergeresultsbyset).

Reference: lib/mmseqs/src/multihit/ — Aggregation.{h,cpp} (group result
lines by target set via <target>_member_to_set), besthitperset.cpp
(best corrected log-P per set), combinepvalperset.cpp (truncated
Fisher / min / product P-value combination per set),
util/mergeresultsbyset.cpp, util/orftocontig.cpp, util/result2stats.cpp.
"""
import math

from . import seqdb


def _read_first_ints(db):
    """{key: int(first token of record)}."""
    out = {}
    for i in range(db.size):
        data = db.get_data(i).tobytes().split()
        if data:
            out[int(db.keys[i])] = int(data[0])
    return out


def aggregate(result_db, member_to_set, entry_fn, prepare_fn=None):
    """Aggregation::run (Aggregation.cpp:47-91): group each query
    record's lines by the target's set key; per set (ascending set key)
    emit entry_fn(lines, query_key, set_key) + newline."""
    w = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for i in seqdb.data_order(result_db):
        key = int(result_db.keys[i])
        groups = {}
        for line in result_db.get_data(i).tobytes().decode().splitlines():
            if not line:
                continue
            cols = line.split("\t")
            target_key = int(cols[0])
            set_key = member_to_set.get(target_key)
            if set_key is None:
                raise ValueError(f"invalid target database key {target_key}")
            groups.setdefault(set_key, []).append(cols)
        if prepare_fn is not None:
            prepare_fn(key)
        parts = []
        for set_key in sorted(groups):
            parts.append(entry_fn(groups[set_key], key, set_key) + "\n")
        w.write(key, "".join(parts).encode(), add_newline=False)
    return w.finish()


def _sstr(x):
    """SSTR(double): %.3E (Util.cpp:714-718)."""
    return f"{x:.3E}"


def besthitperset(target_prefix, result_db, simple_best_hit=False):
    """besthitperset.cpp: per target set keep the best-P line, replacing
    its score column with the corrected log P-value."""
    member_to_set = _read_first_ints(
        seqdb.SeqDB.open(target_prefix + "_member_to_set"))
    set_size = _read_first_ints(
        seqdb.SeqDB.open(target_prefix + "_set_size"))
    dbl_min = 2.2250738585072014e-308

    def entry(lines, query_key, set_key):
        nbr_genes = set_size[set_key]
        best_score = -float("inf")
        second_best = -float("inf")
        best_eval = float("inf")
        best = None
        simple = simple_best_hit or len(lines) < 2
        for cols in lines:
            evalue = float(cols[3])
            pval = evalue / nbr_genes
            if pval == 0:
                pval = dbl_min
            score = -math.log(pval)
            if simple:
                if best_eval > evalue:
                    best_eval = evalue
                    best = cols
            else:
                if score >= best_score:
                    second_best = best_score
                    best_score = score
                    best = cols
                elif score > second_best:
                    second_best = score
        if simple:
            if best_eval == 0:
                log_corrected = math.log(dbl_min)
            elif best_eval < 10e-4:
                log_corrected = math.log(best_eval)
            else:
                log_corrected = math.log(1 - math.exp(-best_eval))
        else:
            log_corrected = second_best - best_score
        if best is None:
            return ""
        out = list(best)
        out[1] = _sstr(log_corrected)
        return "\t".join(out)

    return aggregate(result_db, member_to_set, entry)


def _lbincoeff(m, k):
    return (math.lgamma(m + 1) - math.lgamma(k + 1)
            - math.lgamma(m - k + 1))


def _precompute_log_b(orf_count, pval_thr):
    """precomputeLogB (combinepvalperset.cpp:17-26)."""
    log_thr = math.log(pval_thr)
    log_one_minus = math.log(1 - pval_thr) if pval_thr < 1 else -math.inf
    log_b = [0.0] * orf_count
    log_b[orf_count - 1] = orf_count * log_thr
    for i in range(orf_count - 2, -1, -1):
        k = i + 1
        new_term = (_lbincoeff(orf_count, k) + k * log_thr
                    + (orf_count - k) * log_one_minus)
        log_b[i] = log_b[i + 1] + math.log1p(
            math.exp(new_term - log_b[i + 1]))
    return log_b


MODE_MULTIHIT = 0
MODE_MIN_PVAL = 1
MODE_PRODUCT = 2
MODE_TRUNCATED_PRODUCT = 3


def combinepvalperset(query_prefix, target_prefix, result_db, alpha=1.0,
                      mode=MODE_MULTIHIT):
    """combinepvalperset.cpp: combine the per-gene log P-values of each
    (query set, target set) pair into a set-level E-value."""
    member_to_set = _read_first_ints(
        seqdb.SeqDB.open(target_prefix + "_member_to_set"))
    q_set_size = _read_first_ints(
        seqdb.SeqDB.open(query_prefix + "_set_size"))
    num_target_sets = seqdb.SeqDB.open(target_prefix + "_set_size").size

    def entry(lines, query_set_key, target_set_key):
        prefix = f"{target_set_key}\t"
        orf_count = q_set_size[query_set_key]
        if mode == MODE_MULTIHIT:
            pval_thr = alpha / (orf_count + 1)
            if pval_thr == 0.0:
                return prefix + _sstr(num_target_sets)
            log_thr = math.log(pval_thr)
            r = 0.0
            for cols in lines:
                log_pval = float(cols[1])
                if log_pval < log_thr:
                    r -= log_pval - log_thr
            if r == 0:
                return prefix + _sstr(num_target_sets)
            if math.isinf(r):
                return prefix + "0"
            exp_minus_r = math.exp(-r)
            if pval_thr == 1.0:
                return prefix + _sstr(exp_minus_r * num_target_sets)
            log_b = _precompute_log_b(orf_count, pval_thr)
            log_r = math.log(r)
            fisher = 0.0
            for i in range(orf_count):
                fisher += math.exp(i * log_r - math.lgamma(i + 2)
                                   + log_b[i])
            updated_pval = exp_minus_r * fisher
        elif mode == MODE_MIN_PVAL:
            min_log = 0.0
            for cols in lines:
                min_log = min(min_log, float(cols[1]))
            updated_pval = 1 - math.exp(-math.exp(min_log) * orf_count)
        elif mode == MODE_PRODUCT:
            updated_pval = math.exp(sum(float(c[1]) for c in lines))
        elif mode == MODE_TRUNCATED_PRODUCT:
            log_thr = math.log(alpha / (orf_count + 1))
            min_log = 0.0
            sum_log = 0.0
            k = 0
            for cols in lines:
                log_pval = float(cols[1])
                if log_pval < min_log:
                    min_log = log_pval if log_pval == 0 else -log_pval
                if log_pval < log_thr:
                    sum_log -= log_pval - log_thr
                    k += 1
            if k == 0:
                return prefix + _sstr(min_log)
            return prefix + _sstr(sum_log - log_thr)
        else:
            raise ValueError("invalid aggregation mode")
        return prefix + _sstr(updated_pval * num_target_sets)

    return aggregate(result_db, member_to_set, entry)


def mergeresultsbyset(set_db, result_db):
    """mergeresultsbyset.cpp: concatenate the member records listed in
    each set record under the set key."""
    w = seqdb.DBWriter(result_db.dbtype)
    for i in seqdb.data_order(set_db):
        parts = []
        for tok in set_db.get_data(i).tobytes().split():
            member = int(tok)
            j = result_db.key_to_id(member)
            if j is None:
                raise ValueError(f"invalid key {member} in set record")
            parts.append(result_db.get_data(j).tobytes())
        w.write(int(set_db.keys[i]), b"".join(parts), add_newline=False)
    return w.finish()


def orftocontig(contigs_db, orf_header_db):
    """orftocontig.cpp: serialize each ORF's location on its contig as an
    alignment line (with an empty backtrace column)."""
    from ..ops.orf import parse_orf_header
    from ..ops.rescore import format_seq_id
    w = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for i in seqdb.data_order(orf_header_db):
        orf_key = int(orf_header_db.keys[i])
        header = orf_header_db.get_data(i).tobytes().decode()
        loc = parse_orf_header(header)
        contig_key = loc["id"]
        cid = contigs_db.key_to_id(contig_key)
        contig_len = contigs_db.seq_len(cid)
        orf_len = abs(loc["from"] - loc["to"]) + 1
        line = (f"{contig_key}\t1\t{format_seq_id(1.0)}\t0.000E+00\t0\t"
                f"{orf_len - 1}\t{orf_len}\t{loc['from']}\t{loc['to']}\t"
                f"{contig_len}\t0M\n")
        w.write(orf_key, line.encode(), add_newline=False)
    return w.finish()


def result2stats_linecount(result_db):
    """result2stats.cpp --stat linecount: per record the number of
    lines."""
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in seqdb.data_order(result_db):
        n = result_db.get_data(i).tobytes().count(b"\n")
        w.write(int(result_db.keys[i]), f"{n}\n".encode(),
                add_newline=False)
    return w.finish()
