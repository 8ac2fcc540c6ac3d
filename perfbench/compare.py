"""The comparison that decides `correct`: every step's hits and records,
as the window produced them, against the plain reference's.

Numbers compared (each with its limit from the configuration file's
"limits"):
  hit_mismatches     hits that differ in representative key, target key,
                     k-mer count with its strand sign, or diagonal, over
                     the longer of the two lists (exact: limit 0)
  record_mismatches  kept records that differ in the query key or any
                     field but the E-value, over the longer list (exact)
  eval_rel_gap       the widest relative gap of a kept record's E-value,
                     |port - reference| / max(|reference|, the smallest
                     normal double)
Each is the worst over the window's steps.
"""
import numpy as np

TINY = np.finfo(np.float64).tiny
EXACT_FIELDS = ("dbKey", "score", "qcov", "dbcov", "seqId", "alnLength",
                "qStartPos", "qEndPos", "qLen", "dbStartPos", "dbEndPos",
                "dbLen")
NAMES = ("hit_mismatches", "record_mismatches", "eval_rel_gap")


def _mismatches(cols_a, cols_b):
    na, nb = len(cols_a[0]), len(cols_b[0])
    n = min(na, nb)
    differ = np.zeros(n, dtype=bool)
    for a, b in zip(cols_a, cols_b):
        differ |= np.asarray(a[:n]) != np.asarray(b[:n])
    return int(differ.sum()) + abs(na - nb)


def step_numbers(hits, recs, ref_hits, ref_recs):
    """The three numbers for one step's output."""
    hits = tuple(np.asarray(x, dtype=np.int64) for x in hits)
    hm = _mismatches(hits, ref_hits)
    a, b = recs["rec"], ref_recs["rec"]
    rm = _mismatches([np.asarray(recs["qk"], np.int64)]
                     + [a[f] for f in EXACT_FIELDS],
                     [ref_recs["qk"]] + [b[f] for f in EXACT_FIELDS])
    n = min(len(a), len(b))
    ea, eb = a["eval"][:n], b["eval"][:n]
    gap = float(np.max(np.abs(ea - eb) / np.maximum(np.abs(eb), TINY),
                       initial=0.0))
    if not np.isfinite(gap):
        gap = float("inf")
    return {"hit_mismatches": hm, "record_mismatches": rm,
            "eval_rel_gap": gap}


def judge(outputs, ref, limits):
    """(checks, failed): the worst of each number over the steps' outputs,
    each {"value", "limit"}, and how many steps failed a limit."""
    worst = {k: 0 for k in NAMES}
    failed = 0
    for hits, recs in outputs:
        nums = step_numbers(hits, recs, *ref)
        if any(nums[k] > limits[k] for k in NAMES):
            failed += 1
        for k in NAMES:
            worst[k] = max(worst[k], nums[k])
    return {k: {"value": worst[k], "limit": limits[k]} for k in NAMES}, failed
