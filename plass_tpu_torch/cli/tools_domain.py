"""Domain-annotation tools: summarizetabs, extractdomains (reference:
lib/mmseqs/src/util/summarizetabs.cpp, extractdomains.cpp,
lib/mmseqs/src/commons/Domain.h).

A copy of the JAX package's cli/tools_domain.py, host code on every
device; each command takes the port's (positional, space, stats) and the
flag list of its JAX counterpart plus --device, which it accepts and does
not use.
"""
import bisect

import numpy as np

from ..data import seqdb
from ..utils.log import logger
from . import params as P
from .app import Command, port_space


def _fmt_domain(query, target, qs, qe, qlen, ts, te, tlen, evalue):
    """Domain::writeResult (Domain.h:31-35) with ostream precision 6."""
    return (f"{query}\t{target}\t{qs}\t{qe}\t{qlen}\t{ts}\t{te}\t{tlen}\t"
            f"{evalue:.6g}")


def _map_domains(entries, overlap, min_coverage, eval_thr):
    """mapDomains (summarizetabs.cpp:27-67): greedy accept by ascending
    E-value, rejecting candidates overlapping already covered query range."""
    result = []
    if not entries:
        return result
    covered = np.zeros(entries[0]["qLength"], dtype=bool)
    for d in entries:
        if d["qStart"] > d["qLength"] or d["qEnd"] > d["qLength"]:
            logger.warning("Query alignment start or end is greater than "
                           f"query length in set {d['query']}! Skipping line.")
            continue
        if d["qStart"] > d["qEnd"]:
            logger.warning("Query alignment end is greater than start in "
                           f"set {d['query']}! Skipping line.")
            continue
        cov_cnt = int(covered[d["qStart"]:d["qEnd"]].sum())
        pct_overlap = cov_cnt / float(d["qEnd"] - d["qStart"] + 1)
        if d["tStart"] > d["tEnd"]:
            logger.warning("Target alignment end is greater than start in "
                           f"set {d['query']}! Skipping line.")
            continue
        if d["tStart"] > d["tLength"] or d["tEnd"] > d["tLength"]:
            logger.warning("Target alignment start or end is greater than "
                           f"target length in set {d['query']}! Skipping line.")
            continue
        tcov = float(np.float32(d["tEnd"] - d["tStart"] + 1)
                     / np.float32(d["tLength"]))
        if pct_overlap <= overlap and tcov > min_coverage \
                and d["eValue"] < eval_thr:
            covered[d["qStart"]:d["qEnd"]] = True
            result.append(d)
    return result


def _summarizetabs(positional, space, stats):
    """summarizetabs.cpp: extract the highest-scoring non-overlapping
    domains per query from a BLAST-tab DB; lengths come from a
    name->length TSV consulted with map::lower_bound semantics."""
    if len(positional) != 3:
        raise ValueError(
            "usage: summarizetabs <i:tabDB> <i:lengthFile> <o:domainDB>")
    v = space.values
    overlap = v.get("overlap", 0.0)
    cov_thr = v["cov_thr"]
    eval_thr = v["eval_thr"] if "eval_thr" in space.was_set else 0.001
    # readLength: std::map keyed lexicographically, first insert wins
    lengths = {}
    with open(positional[1]) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts[0] not in lengths:
                lengths[parts[0]] = int(parts[1])
    lkeys = sorted(lengths)

    def lookup(name):
        # map::lower_bound — first key >= name (summarizetabs.cpp:99,111)
        i = bisect.bisect_left(lkeys, name)
        return lengths[lkeys[i]] if i < len(lkeys) else None

    tab = seqdb.SeqDB.open(positional[0])
    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for i in seqdb.data_order(tab):
        key = int(tab.keys[i])
        query = str(key)
        entries = []
        for line in tab.get_data(i).tobytes().decode().splitlines():
            if not line:
                continue
            f = line.split("\t")
            qlen = lookup(query)
            if qlen is None:
                logger.warning("Missing query length! Skipping line.")
                continue
            tlen = lookup(f[1])
            if tlen is None:
                logger.warning("Missing target length! Skipping line.")
                continue
            entries.append({
                "query": query, "target": f[1],
                "qStart": (int(f[6]) - 1) & 0xFFFFFFFF,
                "qEnd": (int(f[7]) - 1) & 0xFFFFFFFF, "qLength": qlen,
                "tStart": (int(f[8]) - 1) & 0xFFFFFFFF,
                "tEnd": (int(f[9]) - 1) & 0xFFFFFFFF, "tLength": tlen,
                "eValue": float(f[10]),
            })
        if not entries:
            logger.warning(f"Can not map any entries for entry {key}!")
            continue
        entries.sort(key=lambda d: d["eValue"])  # stable_sort by eValue
        result = _map_domains(entries, overlap, cov_thr, eval_thr)
        if not result:
            logger.warning(f"Can not map any domains for entry {key}!")
            continue
        body = "".join(
            _fmt_domain(d["query"], d["target"], d["qStart"], d["qEnd"],
                        d["qLength"], d["tStart"], d["tEnd"], d["tLength"],
                        d["eValue"]) + "\n" for d in result)
        writer.write(key, body.encode(), add_newline=False)
    writer.finish().save(positional[2])
    return 0


def _parse_fasta_entries(msa):
    """kseq-style FASTA split of an MSA blob: (name, comment, sequence)."""
    out = []
    name = comment = None
    seq_parts = []
    for line in msa.split("\n"):
        if line.startswith(">"):
            if name is not None:
                out.append((name, comment, "".join(seq_parts)))
            header = line[1:]
            sp = header.split(None, 1)
            name = sp[0] if sp else ""
            comment = sp[1] if len(sp) > 1 else ""
            seq_parts = []
        elif name is not None:
            seq_parts.append(line.strip())
    if name is not None:
        out.append((name, comment, "".join(seq_parts)))
    return out


def _score_sub_alignment(qnum, tnum, query, target, q_start, q_end,
                         t_start, t_end, sub):
    """scoreSubAlignment (extractdomains.cpp:52-114): gap-aware max-scoring
    subalignment along aligned MSA columns."""
    raw = 0
    best = 0
    tpos = t_start
    qpos = q_start
    for _ in range(q_end - q_start):
        if tpos >= t_end:
            break
        if qpos < len(query) and query[qpos] == "-":
            raw = max(0, raw - 10)
            while qpos < q_end and qpos < len(query) and query[qpos] == "-":
                raw = max(0, raw - 1)
                qpos += 1
                tpos += 1
        if tpos < len(target) and (target[tpos] == "-"
                                   or target[tpos].islower()):
            raw = max(0, raw - 10)
            while tpos < t_end and tpos < len(target) and target[tpos] == "-":
                raw = max(0, raw - 1)
                tpos += 1
                qpos += 1
            while tpos < t_end and tpos < len(target) \
                    and target[tpos].islower():
                raw = max(0, raw - 1)
                tpos += 1
        else:
            if qpos < len(qnum) and tpos < len(tnum):
                raw = max(0, raw + int(sub[qnum[qpos], tnum[tpos]]))
            qpos += 1
            tpos += 1
        best = max(best, raw)
    return best


def _extractdomains(positional, space, stats):
    """extractdomains.cpp: project domain annotations from summarizetabs
    through each member of the corresponding MSA."""
    from .. import constants
    from ..data.headers import parse_fasta_header
    if len(positional) != 3:
        raise ValueError(
            "usage: extractdomains <i:domainDB> <i:msaDB> <o:domainDB>")
    v = space.values
    msa_type = v.get("msa_type", 2)
    cov_thr = v["cov_thr"]
    eval_thr = v["eval_thr"] if "eval_thr" in space.was_set else 0.001
    mat = constants.blosum62()
    dom = seqdb.SeqDB.open(positional[0])
    if msa_type == 0:
        # ca3m input (extractdomains.cpp:219-233,273-277): the MSA DB is an
        # ffindex triple; records decode through CompressedA3M::extractA3M
        from ..data import ca3m
        msadb = ca3m.open_ffindex(positional[1] + "_ca3m.ffdata",
                                  positional[1] + "_ca3m.ffindex")
        ca3m_hdrs = ca3m.open_ffindex(positional[1] + "_header.ffdata",
                                      positional[1] + "_header.ffindex")
        ca3m_seqs = ca3m.open_ffindex(positional[1] + "_sequence.ffdata",
                                      positional[1] + "_sequence.ffindex")
    else:
        msadb = seqdb.SeqDB.open(positional[1])
    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    K, lambda_lin = 0.041, 0.267  # computeEvalue (extractdomains.cpp:46-50)
    for i in seqdb.data_order(dom):
        key = int(dom.keys[i])
        try:
            mi = msadb.key_to_id(key)
        except (KeyError, IndexError):
            logger.warning(f"Can not find MSA for key {key}!")
            continue
        domains = []
        for line in dom.get_data(i).tobytes().decode().splitlines():
            if not line:
                continue
            f = line.split("\t")
            domains.append({
                "query": f[0], "target": f[1],
                "qStart": int(f[2]), "qEnd": int(f[3]), "qLength": int(f[4]),
                "tStart": int(f[5]), "tEnd": int(f[6]), "tLength": int(f[7]),
                "eValue": float(f[8]),
            })
        if not domains:
            logger.warning(f"Can not map any entries for entry {key}!")
            continue
        if msa_type == 0:
            msa = ca3m.extract_a3m(msadb.get_data(mi).tobytes(),
                                   ca3m_seqs, ca3m_hdrs).decode()
        else:
            msa = msadb.get_data(mi).tobytes().decode()
        out = []
        query_seq = None
        qnum = None
        for full_name, comment, sequence in _parse_fasta_entries(msa):
            if not full_name or not sequence:
                logger.warning("Invalid fasta entry!")
                continue
            if full_name.startswith("consensus_") \
                    or full_name.endswith("_consensus"):
                continue
            name = parse_fasta_header(full_name)
            # Split= is only honored when terminated by a space
            # (find_first_of(" \n") must succeed, extractdomains.cpp:140-152)
            start = comment.find("Split=")
            if start != -1:
                rest = comment[start + 6:]
                end = rest.find(" ")
                if end != -1:
                    split = rest[:end]
                    if split != "0":
                        name = f"{name}_{split}"
            if query_seq is None:
                query_seq = sequence
                qnum = mat.aa2num[
                    np.frombuffer(sequence.encode("latin-1"), np.uint8)]
            tnum = mat.aa2num[
                np.frombuffer(sequence.encode("latin-1"), np.uint8)]
            length = sum(1 for c in sequence if c.isalpha())
            for d in domains:
                found_start = False
                domain_start = 0
                pos_wo_ins = 0
                q_dom_off = 0
                for aa_pos, c in enumerate(sequence):
                    if (c not in "-.") and not found_start \
                            and pos_wo_ins >= d["qStart"] \
                            and pos_wo_ins <= d["qEnd"]:
                        found_start = True
                        domain_start = aa_pos
                        q_dom_off = pos_wo_ins - d["qStart"]
                    if not c.islower():
                        pos_wo_ins += 1
                    if pos_wo_ins == d["qEnd"] and found_start:
                        found_start = False
                        domain_end = min(aa_pos, length - 1)
                        dom_cov = float(
                            np.float32(domain_end - domain_start + 1)
                            / np.float32(d["tLength"]))
                        score = _score_sub_alignment(
                            qnum, tnum, query_seq, sequence,
                            d["qStart"] + q_dom_off, d["qEnd"],
                            domain_start, domain_end, mat.sub)
                        dom_eval = d["eValue"] + K * length * np.exp(
                            -lambda_lin * score)
                        if dom_cov > cov_thr and dom_eval < eval_thr:
                            out.append(_fmt_domain(
                                name, d["target"], domain_start, domain_end,
                                length, d["tStart"], d["tEnd"], d["tLength"],
                                dom_eval) + "\n")
                            break
        writer.write(key, "".join(out).encode(), add_newline=False)
    writer.finish().save(positional[2])
    return 0


COMMANDS = [
    Command("summarizetabs", _summarizetabs, lambda: port_space(
        P.common_flags() + P.align_flags() + [
            P.Flag("--overlap", "overlap", float, 0.0,
                   "Maximum overlap of covered regions")]),
            "<i:tabDB> <i:lengthFile> <o:domainDB>",
            "Extract annotations from HHblits BLAST-tab-formatted results",
            hidden=True),
    Command("extractdomains", _extractdomains, lambda: port_space(
        P.common_flags() + P.align_flags() + [
            P.Flag("--msa-type", "msa_type", int, 2, "MSA type", r"[0-2]")]),
            "<i:domainDB> <i:msaDB> <o:domainDB>",
            "Extract highest scoring alignment regions per sequence",
            hidden=True),
]
