"""Framework-surface DB utility commands (reference: lib/mmseqs/src/util/):
mvdb/cpdb/lndb, sortresult, swapresults, mergedbs, splitdb, createtsv,
tsv2db, prefixid, reverseseq. Each mirrors the reference tool's record
semantics; they operate on the standard record-DB family
(data, .index, .dbtype and optional _h companions).
"""
import os
import shutil

import numpy as np

from . import seqdb

FAMILY_SUFFIXES = ["", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype",
                   ".lookup", ".source"]


def _family(path):
    return [(path + s, s) for s in FAMILY_SUFFIXES if os.path.exists(path + s)]


def mvdb(src, dst):
    for p, s in _family(src):
        os.replace(p, dst + s)


def cpdb(src, dst):
    for p, s in _family(src):
        shutil.copyfile(p, dst + s)


def lndb(src, dst):
    for p, s in _family(src):
        if os.path.lexists(dst + s):
            os.unlink(dst + s)
        os.symlink(os.path.abspath(p), dst + s)


ANCILLARY_SUFFIXES = ["_h", "_h.index", "_h.dbtype", ".lookup", ".source",
                      "_mapping", "_names.dmp", "_nodes.dmp", "_merged.dmp",
                      "_taxonomy"]


def softlink_ancillary(src, dst):
    """DBReader::softlinkDb(..., DBFiles::SEQUENCE_ANCILLARY)
    (DBReader.cpp:1123-1155): absolute symlinks for the header/lookup/
    taxonomy side files that exist next to src."""
    for s in ANCILLARY_SUFFIXES:
        if os.path.exists(src + s):
            if os.path.lexists(dst + s):
                os.unlink(dst + s)
            os.symlink(os.path.abspath(src + s), dst + s)


def data_order(db):
    """Record ids in data-file offset order (DBReader LINEAR_ACCCESS) —
    the write order the reference tools preserve."""
    return np.argsort(db.offsets, kind="stable")


def sort_result_db(db):
    """sortresult.cpp: sort alignment records by Matcher::compareHits,
    prefilter records by |score| desc then target key asc; physical record
    order follows the input data file."""
    w = seqdb.DBWriter(db.dbtype)
    for i in data_order(db):
        body = db.get_data(i).tobytes().decode()
        lines = [ln for ln in body.splitlines() if ln]
        if not lines:
            w.write(int(db.keys[i]), b"", add_newline=False)
            continue
        cols = lines[0].split("\t")
        if len(cols) >= 10:  # alignment format
            def key_aln(ln):
                f = ln.split("\t")
                return (float(f[3]), -int(f[1]), int(f[9]), int(f[0]))
            lines.sort(key=key_aln)
        elif len(cols) == 3:  # prefilter format
            def key_pref(ln):
                f = ln.split("\t")
                return (-abs(int(f[1])), int(f[0]))
            lines.sort(key=key_pref)
        w.write(int(db.keys[i]), ("\n".join(lines) + "\n").encode(),
                add_newline=False)
    return w.finish()


def swap_results(query_db, target_db, result_db, eval_thr=0.001,
                 evaluer=None):
    """swapresults.cpp: invert query/target, recompute E-values against the
    swapped query length, per-target compareHits sort; targets present in
    the target DB get (possibly empty) records."""
    from ..ops.evalue import EvalueComputer
    is_nucl = target_db.dbtype == seqdb.NUCLEOTIDES
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix(
            "nucleotide_gapped_5_2" if is_nucl else "blosum62_11_1",
            query_db.total_residues())
    per_target = {}
    eval_broke = set()
    is_aln = result_db.dbtype == seqdb.ALIGNMENT_RES
    for i in range(result_db.size):
        qkey = int(result_db.keys[i])
        body = result_db.get_data(i).tobytes().decode()
        for ln in body.splitlines():
            if not ln:
                continue
            f = ln.split("\t")
            tkey = int(f[0])
            if is_aln:
                raw = evaluer.raw_score_from_bit(float(int(f[1])))
                new_eval = float(evaluer.evalue(raw, int(f[9])))
                if new_eval > eval_thr:
                    eval_broke.add(tkey)
                    continue
                bt = f[10] if len(f) > 10 else None
                if bt:
                    bt = bt.translate(str.maketrans("ID", "DI"))
                rec = (new_eval, -int(f[1]), int(f[6]), qkey,
                       [str(qkey), f[1], f[2], f"{new_eval:.3E}", f[7], f[8],
                        f[9], f[4], f[5], f[6]] + ([bt] if bt else []))
            else:
                diag = -int(f[2])
                diag = ((diag + 0x8000) & 0xFFFF) - 0x8000
                score = int(f[1])
                rec = (-float(score), -score, 0, qkey,
                       [str(qkey), f[1], str(diag)])
            per_target.setdefault(tkey, []).append(rec)
    w = seqdb.DBWriter(result_db.dbtype)
    target_keys = set(int(k) for k in target_db.keys)
    max_target = max(target_keys) if target_keys else -1
    for t in range(max_target + 1):
        rows = per_target.get(t)
        if rows:
            rows.sort(key=lambda r: r[:4])
            w.write(t, ("".join("\t".join(r[4]) + "\n" for r in rows)).encode(),
                    add_newline=False)
        elif t in eval_broke or t in target_keys:
            w.write(t, b"", add_newline=False)
    return w.finish()


def merge_dbs(dbs):
    """mergedbs.cpp: per key of the FIRST db, concatenate all dbs' records."""
    first = dbs[0]
    w = seqdb.DBWriter(first.dbtype)
    for i in range(first.size):
        key = int(first.keys[i])
        parts = []
        for db in dbs:
            j = db.key_to_id(key)
            if j is not None:
                parts.append(db.get_data(j).tobytes())
        w.write(key, b"".join(parts), add_newline=False)
    return w.finish()


def split_db(db, n):
    """splitdb.cpp: size-balanced record split into n shards."""
    shards = []
    per = (db.size + n - 1) // n
    for s in range(n):
        w = seqdb.DBWriter(db.dbtype)
        for i in range(s * per, min((s + 1) * per, db.size)):
            w.write(int(db.keys[i]), db.get_data(i).tobytes(),
                    add_newline=False)
        shards.append(w.finish())
    return shards


def create_tsv(db, header_db=None):
    """createtsv.cpp (basic mode): one line per record line, prefixed by the
    query key (or its header accession)."""
    out = []
    for i in data_order(db):
        key = int(db.keys[i])
        if header_db is not None:
            from .headers import parse_fasta_header
            j = header_db.key_to_id(key)
            name = parse_fasta_header(header_db.get_seq_bytes(j).decode())
        else:
            name = str(key)
        body = db.get_data(i).tobytes().decode()
        for ln in body.splitlines():
            if ln:
                out.append(f"{name}\t{ln}")
    return "\n".join(out) + ("\n" if out else "")


def tsv_to_db(text, dbtype=seqdb.GENERIC_DB):
    """tsv2db.cpp: first column is the record key; rest is the line body."""
    records = {}
    order = []
    for ln in text.splitlines():
        if not ln:
            continue
        key_s, _, rest = ln.partition("\t")
        key = int(key_s)
        if key not in records:
            records[key] = []
            order.append(key)
        records[key].append(rest)
    w = seqdb.DBWriter(dbtype)
    for key in order:
        w.write(key, ("\n".join(records[key]) + "\n").encode(),
                add_newline=False)
    return w.finish()


def prefix_id(db, prefix=None, tsv=False, suffix=False, mapping=None):
    """prefixid/suffixid (prefixid.cpp addid): prepend (or append with
    suffix=True) the record key, a fixed string, or the record's lookup
    accession (mapping={key: name}) to every line of each record."""
    w = seqdb.DBWriter(db.dbtype)
    for i in data_order(db):
        key = int(db.keys[i])
        if prefix is not None:
            add = prefix
        elif mapping is not None:
            add = mapping[key]
        else:
            add = str(key)
        body = db.get_data(i).tobytes().decode()
        if suffix:
            lines = [f"{ln}\t{add}" for ln in body.splitlines() if ln]
        else:
            lines = [f"{add}\t{ln}" for ln in body.splitlines() if ln]
        w.write(key, ("\n".join(lines) + "\n").encode() if lines else b"",
                add_newline=False)
    return w.finish()


def reverse_seq_db(db):
    """reverseseq.cpp: plain character reversal (no complement)."""
    w = seqdb.DBWriter(db.dbtype)
    for i in data_order(db):
        w.write(int(db.keys[i]), db.get_seq_bytes(i)[::-1])
    return w.finish()
