"""Compressed-A3M (CA3M) databases.

Format and behavior mirror the reference:
 - lib/mmseqs/src/alignment/CompressedA3M.cpp (block encoding:
   per hit "u32 entryIndex, u16 startPos(1-based), u16 nBlocks,
   then nBlocks x (u8 matchCount, i8 inDelCount)")
 - lib/mmseqs/src/commons/DBConcat.cpp (the _sequence/_header ffdata
   companions with renumbered keys)
 - lib/mmseqs/src/commons/DBWriter.cpp sortIndex(lexicographicOrder)
   (the _ca3m.ffindex is sorted by key *string*)
"""
import struct

import numpy as np

from . import seqdb


def db_concat(a_path, b_path, out_path, trim_right=0,
              preserve_a=False, preserve_b=False):
    """DBConcat (DBConcat.cpp:14-180): write A's records then B's with
    renumbered keys (A: id, B: id + maxKeyA + 1); each record is the raw
    record bytes minus trim_right, re-terminated with NUL. Returns
    (a_map, b_map) key-mapping dicts (identity when a_path == b_path)."""
    same = a_path == b_path
    dba = seqdb.SeqDB.open(a_path)
    dbb = dba if same else seqdb.SeqDB.open(b_path)
    writer = seqdb.DBWriter(dba.dbtype)
    a_map, b_map = {}, {}
    max_key_a = 0
    for i in range(dba.size):
        new_key = int(dba.keys[i]) if preserve_a else i
        o = int(dba.offsets[i])
        size = max(int(dba.lengths[i]), trim_right) - trim_right
        writer.write(new_key, dba.data[o:o + size].tobytes(),
                     add_newline=False)
        a_map[int(dba.keys[i])] = new_key
        max_key_a = max(max_key_a, new_key)
    max_key_a += 1
    for i in range(dbb.size):
        new_key = int(dbb.keys[i]) if preserve_b else i + max_key_a
        o = int(dbb.offsets[i])
        size = max(int(dbb.lengths[i]), trim_right) - trim_right
        writer.write(new_key, dbb.data[o:o + size].tobytes(),
                     add_newline=False)
        b_map[int(dbb.keys[i])] = i + max_key_a
    writer.finish().save(out_path)
    if same:
        # dbAKeyMap/dbBKeyMap return the key unchanged (DBConcat.cpp:345-358)
        a_map = {k: k for k in a_map}
        b_map = {k: k for k in b_map}
    return a_map, b_map


def hit_to_buffer(target_id, q_start, db_start, backtrace):
    """CompressedA3M::hitToBuffer (CompressedA3M.cpp:272-361)."""
    out = bytearray()
    out += struct.pack("<I", target_id & 0xFFFFFFFF)
    out += struct.pack("<H", (db_start + 1) & 0xFFFF)
    n_blocks = 0
    count_pos = len(out)
    out += b"\0\0"
    first_gap = q_start
    while first_gap:
        gap = min(127, first_gap)
        out.append(0)
        out.append((-gap) & 0xFF)
        first_gap -= gap
        n_blocks += 1
    bt = backtrace
    i = 0
    n = len(bt)
    while i < n:
        match_len = 0
        while i < n and bt[i] == "M" and match_len < 255:
            i += 1
            match_len += 1
        out.append(match_len)
        indel = 0
        ch = None
        if i < n and bt[i] != "M":
            ch = bt[i]
        while i < n and ch is not None and bt[i] == ch and indel < 127:
            i += 1
            indel += 1
        if indel and ch == "I":
            indel = -indel
        out.append(indel & 0xFF)
        n_blocks += 1
    struct.pack_into("<H", out, count_pos, n_blocks)
    return bytes(out)


def extract_matcher_results(data, seq_db, skip_first=True):
    """CompressedA3M::extractMatcherResults (CompressedA3M.cpp:148-268):
    decode a ca3m record into (key, [result dict]) against the line-wise
    _sequence reader (entryIndex = line number in the ffindex)."""
    n = len(data)
    idx = 0
    last = 0
    if idx < n and data[idx] == 0x23:  # '#'
        while data[idx] != 0x0A:
            idx += 1
        last = 0x0A
        idx += 1
    in_consensus = 0
    while not (last == 0x0A and idx < n and data[idx] == 0x3B) and idx < n:
        if data[idx] == 0x0A:
            in_consensus += 1
        last = data[idx]
        idx += 1
    idx += 1  # ';'
    key = None
    q_len = 0
    results = []
    is_first = True
    while idx < n - 1:
        entry_index = struct.unpack_from("<I", data, idx)[0]
        idx += 4
        db_key = int(seq_db.keys[entry_index])
        db_len = seq_db.seq_len(entry_index)
        if is_first:
            key = db_key
            q_len = db_len
        start_pos = struct.unpack_from("<H", data, idx)[0]
        idx += 2
        n_blocks = struct.unpack_from("<H", data, idx)[0]
        idx += 2
        if skip_first and is_first:
            idx += 2 * n_blocks
            is_first = False
            continue
        q_start = 0
        q_aln = db_aln = 0
        first_block_m = False
        bt = []
        for _ in range(n_blocks):
            match_count = data[idx]
            idx += 1
            q_aln += match_count
            db_aln += match_count
            bt.append("M" * match_count)
            if match_count:
                first_block_m = True
            indel = data[idx]
            idx += 1
            if indel >= 128:
                indel -= 256
            if not first_block_m:
                q_start -= indel
            elif indel > 0:
                bt.append("D" * indel)
                q_aln += indel
            elif indel < 0:
                bt.append("I" * (-indel))
                db_aln -= indel
        backtrace = "".join(bt)
        results.append({
            "dbKey": db_key, "score": 0, "seqId": 0.0, "eval": 0.0,
            "qStartPos": q_start, "qEndPos": q_start + db_aln - 1,
            "qLen": q_len, "dbStartPos": start_pos - 1,
            "dbEndPos": (start_pos - 1) + q_aln - 1, "dbLen": db_len,
            "qcov": 0.0, "tcov": 0.0, "alnLength": len(backtrace),
            "backtrace": backtrace,
        })
        is_first = False
    return key, results


def extract_a3m(data, seq_db, hdr_db):
    """CompressedA3M::extractA3M (CompressedA3M.cpp:37-146): decode a
    ca3m record to flat A3M text using the line-wise _sequence/_header
    readers."""
    n = len(data)
    out = []
    idx = 0
    last = 0
    consensus_length = 0
    in_consensus = 0
    if idx < n and data[idx] == 0x23:  # '#'
        while data[idx] != 0x0A:
            out.append(data[idx])
            last = data[idx]
            idx += 1
        out.append(0x0A)
        last = 0x0A
        idx += 1
    while not (last == 0x0A and idx < n and data[idx] == 0x3B) and idx < n:
        if data[idx] == 0x0A:
            in_consensus += 1
        elif in_consensus == 1:
            consensus_length += 1
        out.append(data[idx])
        last = data[idx]
        idx += 1
    idx += 1  # ';'
    res = bytearray(out)
    while idx < n - 1:
        entry_index = struct.unpack_from("<I", data, idx)[0]
        idx += 4
        seq = seq_db.get_data(entry_index).tobytes()
        header = hdr_db.get_data(entry_index).tobytes()
        if not header.startswith(b">"):
            res += b">"
        res += header[:-1] if header else header
        res += b"\n"
        start_pos = struct.unpack_from("<H", data, idx)[0]
        idx += 2
        n_blocks = struct.unpack_from("<H", data, idx)[0]
        idx += 2
        actual = start_pos
        aln_len = 0
        for _ in range(n_blocks):
            matches = data[idx]
            idx += 1
            for _ in range(matches):
                res.append(seq[actual - 1])
                actual += 1
                aln_len += 1
            indel = data[idx]
            idx += 1
            if indel >= 128:
                indel -= 256
            if indel > 0:
                for _ in range(indel):
                    res.append(ord(chr(seq[actual - 1]).lower()))
                    actual += 1
            else:
                res += b"-" * (-indel)
                aln_len += -indel
        res += b"-" * max(0, consensus_length - aln_len)
        res += b"\n"
    return bytes(res)


def save_lexicographic(db, path):
    """Save with the _ca3m.ffindex convention: index lines sorted by key
    *string* (DBWriter WRITER_LEXICOGRAPHIC_MODE, DBWriter.cpp:606-607),
    data stays in write order."""
    db.data.tofile(path)
    order = sorted(range(db.size), key=lambda i: str(int(db.keys[i])))
    with open(path + ".index", "w") as f:
        for i in order:
            f.write(f"{int(db.keys[i])}\t{int(db.offsets[i])}\t"
                    f"{int(db.lengths[i])}\n")
    seqdb.write_dbtype(path, db.dbtype)


def open_ffindex(data_path, index_path):
    """Open an ffindex pair (.ffdata/.ffindex) in index-file line order
    (DBReader<std::string> NOSORT / SORT_BY_LINE addressing)."""
    data = np.fromfile(data_path, dtype=np.uint8)
    keys, offsets, lengths = [], [], []
    with open(index_path, "rb") as f:
        for line in f:
            parts = line.split(b"\t")
            if len(parts) < 3:
                continue
            try:
                keys.append(int(parts[0]))
            except ValueError:
                keys.append(len(keys))
            offsets.append(int(parts[1]))
            lengths.append(int(parts[2]))
    return seqdb.SeqDB(data, np.asarray(keys, dtype=np.uint32),
                       np.asarray(offsets, dtype=np.int64),
                       np.asarray(lengths, dtype=np.int64), seqdb.GENERIC_DB)


def open_linewise(path):
    """DBReader SORT_BY_LINE: ids = physical line order of the index
    file (ffindex line number addressing, DBReader.h:252)."""
    dbtype = seqdb.read_dbtype(path) if \
        __import__("os").path.exists(path + ".dbtype") else seqdb.GENERIC_DB
    data = np.fromfile(path, dtype=np.uint8)
    keys, offsets, lengths = [], [], []
    with open(path + ".index", "rb") as f:
        for line in f:
            parts = line.split(b"\t")
            keys.append(int(parts[0]))
            offsets.append(int(parts[1]))
            lengths.append(int(parts[2]))
    return seqdb.SeqDB(data, np.asarray(keys, dtype=np.uint32),
                       np.asarray(offsets, dtype=np.int64),
                       np.asarray(lengths, dtype=np.int64), dbtype)
