"""Base DB utility tools (reference: lib/mmseqs/src/util/): compress and
decompress, dbtype, view, renamedbkeys, suffixid, unpackdb, countkmer,
masksequence, translateaa, summarizeresult, extractalignedregion,
offsetalignment, summarizeheaders, diffseqdbs, gff2db and maskbygff.

A copy of the JAX package's cli/tools_db.py, host code on every device;
each command takes the port's (positional, space, stats) and the flag list
of its JAX counterpart plus --device, which it accepts and does not use.
"""
import os

import numpy as np

from ..data import seqdb
from ..utils.log import logger
from . import params as P
from .app import Command, port_space


def _compress(positional, space, stats):
    """compress (util/compress.cpp:50-52): re-store every record
    ZSTD-compressed; dbtype gets bit 31 set."""
    if len(positional) != 2:
        raise ValueError("usage: compress <i:db> <o:db>")
    if seqdb.is_compressed(positional[0]):
        logger.info("Database is already compressed.")
        return 0
    db = seqdb.SeqDB.open(positional[0])
    seqdb.save_compressed(db, positional[1])
    return 0


def _decompress(positional, space, stats):
    """decompress (util/compress.cpp:54-56)."""
    if len(positional) != 2:
        raise ValueError("usage: decompress <i:db> <o:db>")
    if not seqdb.is_compressed(positional[0]):
        logger.info("Database is already decompressed.")
        return 0
    db = seqdb.SeqDB.open(positional[0])  # open() inflates records
    db.save(positional[1])
    return 0


def _dbtype(positional, space, stats):
    """dbtype (util/dbtype.cpp): print the human-readable DB type."""
    if len(positional) != 1:
        raise ValueError("usage: dbtype <i:db>")
    print(seqdb.DBTYPE_NAMES.get(seqdb.read_dbtype(positional[0]), "Unknown"))
    return 0


def _view(positional, space, stats):
    """view (util/view.cpp): print selected records to stdout."""
    import sys
    if len(positional) < 1:
        raise ValueError("usage: view <i:db> --id-list k1,k2,...")
    v = space.values
    db = seqdb.SeqDB.open(positional[0])
    ids = [s for s in v.get("id_list", "").split(",") if s]
    if v.get("id_mode", 0) == 1:
        from ..data.createdb import read_lookup
        name2key = {name: key for key, name, _ in read_lookup(positional[0])}
        keys = []
        for ref in ids:
            if ref not in name2key:
                logger.warning("Could not find %s in lookup", ref)
                continue
            keys.append(name2key[ref])
    else:
        keys = [int(s) for s in ids]
    for key in keys:
        i = db.key_to_id(key)
        if i is None:
            logger.error("Key %s not found in database", key)
            continue
        sys.stdout.buffer.write(db.get_data(i).tobytes())
    sys.stdout.flush()
    return 0


def _renamedbkeys(positional, space, stats):
    """renamedbkeys (util/renamedbkeys.cpp): rewrite keys via an
    'oldKey newKey' mapping file; renames lookup/_mapping/header too."""
    if len(positional) != 3:
        raise ValueError("usage: renamedbkeys <i:mapFile> <i:db> <o:db>")
    map_file, src, dst = positional
    pairs = []
    with open(map_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                logger.warning("Not enough columns in mapping file")
                continue
            pairs.append((int(parts[0]), int(parts[1])))
    db = seqdb.SeqDB.open(src)
    writer = seqdb.DBWriter(db.dbtype)
    for old, new in pairs:
        i = db.key_to_id(old)
        if i is None:
            raise ValueError(f"Key {old} not found in database")
        writer.write(new, db.get_data(i).tobytes(), add_newline=False)
    writer.finish().save(dst)
    if os.path.exists(src + "_h.dbtype"):
        hdb = seqdb.SeqDB.open(src + "_h")
        hw = seqdb.DBWriter(hdb.dbtype)
        for old, new in pairs:
            i = hdb.key_to_id(old)
            if i is not None:
                hw.write(new, hdb.get_data(i).tobytes(), add_newline=False)
        hw.finish().save(dst + "_h")
    if os.path.exists(src + ".lookup"):
        from ..data.createdb import read_lookup, write_lookup
        remap = dict(pairs)
        entries = [(remap[k], name, fn)
                   for k, name, fn in read_lookup(src) if k in remap]
        entries.sort(key=lambda e: e[0])
        write_lookup(dst, entries)
    if os.path.exists(src + "_mapping"):
        remap = dict(pairs)
        out = []
        with open(src + "_mapping") as f:
            for line in f:
                a, b = line.split("\t")[:2]
                if int(a) in remap:
                    out.append((remap[int(a)], int(b)))
        out.sort(key=lambda e: e[0])
        with open(dst + "_mapping", "w") as f:
            for a, b in out:
                f.write(f"{a}\t{b}\n")
    return 0


def _suffixid(positional, space, stats):
    """suffixid (util/prefixid.cpp:96-99): append the key (or --prefix
    string / lookup accession) after a TAB to every record line."""
    from ..data.dbtools import prefix_id
    if len(positional) != 2:
        raise ValueError("usage: suffixid <i:db> <o:db>")
    v = space.values
    db = seqdb.SeqDB.open(positional[0])
    out = prefix_id(db, prefix=v.get("prefix") or None, tsv=v.get("tsv", False),
                    suffix=True)
    if v.get("tsv", False):
        with open(positional[1], "wb") as f:
            order = seqdb.data_order(out)
            for i in order:
                f.write(out.get_data(int(i)).tobytes())
    else:
        out.save(positional[1])
    return 0


def _unpackdb(positional, space, stats):
    """unpackdb (util/unpackdb.cpp): one file per record in an output dir."""
    if len(positional) != 2:
        raise ValueError("usage: unpackdb <i:db> <o:dir>")
    v = space.values
    db = seqdb.SeqDB.open(positional[0])
    os.makedirs(positional[1], exist_ok=True)
    names = {}
    if v.get("unpack_name_mode", 1) == 1 and os.path.exists(positional[0] + ".lookup"):
        from ..data.createdb import read_lookup
        names = {k: name for k, name, _ in read_lookup(positional[0])}
    suffix = v.get("unpack_suffix", "")
    for i in range(db.size):
        key = int(db.keys[i])
        base = names.get(key, str(key))
        # FileUtil::sanitizeFilename replaces path separators
        base = base.replace("/", "_").replace("\\", "_")
        with open(os.path.join(positional[1], base + suffix), "wb") as f:
            f.write(db.get_data(i).tobytes())
    return 0


def _countkmer(positional, space, stats):
    """countkmer (util/countkmer.cpp): global k-mer count table on stdout.
    Nucleotide k-mers print through the reference's quirky A,C,T,G code
    table (Indexer::printKmer)."""
    from .. import constants
    if len(positional) != 1:
        raise ValueError("usage: countkmer <i:seqDB>")
    v = space.values
    k = v.get("kmer_size", 5)  # countkmer's own default (countkmer.cpp:19)
    db = seqdb.SeqDB.open(positional[0])
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    mat = constants.nucleotide() if is_nucl else constants.blosum62()
    a = mat.alphabet_size - 1  # X excluded
    idx_size = a ** k
    counts = np.zeros(idx_size, dtype=np.uint64)
    powers = a ** np.arange(k, dtype=np.int64)
    for i in range(db.size):
        num = mat.aa2num[db.get_seq(i)].astype(np.int64)
        if len(num) < k:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(num, k)
        valid = ~(windows == a).any(axis=1)
        if is_nucl:
            # Indexer::computeKmerIdx: big-endian 2-bit packing
            idxs = np.zeros(len(windows), dtype=np.int64)
            for pos in range(k):
                idxs = (idxs << 2) | windows[:, pos]
        else:
            idxs = (windows * powers).sum(axis=1)
        np.add.at(counts, idxs[valid], 1)
    lines = []
    nucl_code = "ACTG"  # Indexer::printKmer quirk: T/G swapped
    for i in range(idx_size):
        if is_nucl:
            s = "".join(nucl_code[(i >> (2 * (k - 1 - j))) & 3] for j in range(k))
        else:
            digits = []
            rem = i
            for j in range(k):
                digits.append(rem % a)
                rem //= a
            s = "".join(mat.letters[d] for d in digits)
        lines.append(f"{i}\t{s}\t{counts[i]}")
    print("\n".join(lines))
    return 0


def _masksequence(positional, space, stats):
    """masksequence (util/masksequence.cpp): tantan-mask to lowercase
    (minMaskProb 0.5, maxCycleLength 50)."""
    from .. import constants
    from ..ops.tantan import TantanMasker
    if len(positional) != 2:
        raise ValueError("usage: masksequence <i:seqDB> <o:seqDB>")
    db = seqdb.SeqDB.open(positional[0])
    mat = constants.nucleotide() if db.dbtype == seqdb.NUCLEOTIDES \
        else constants.blosum62()
    masker = TantanMasker(mat, min_mask_prob=0.5)
    writer = seqdb.DBWriter(db.dbtype)
    x_idx = mat.alphabet_size - 1
    for i in range(db.size):
        raw = db.get_seq(i)
        num = mat.aa2num[raw]
        masked = masker.mask(num)
        is_masked = (masked == x_idx) & (num != x_idx)
        out = np.where(is_masked,
                       np.char.lower(raw.view("S1")).view(np.uint8),
                       np.char.upper(raw.view("S1")).view(np.uint8))
        writer.write(int(db.keys[i]), out.tobytes())
    writer.finish().save(positional[1])
    return 0


def _translateaa(positional, space, stats):
    """translateaa (util/translateaa.cpp): protein -> nucleotide by the
    first codon (A<C<G<T nested order) coding each residue; X -> NNN."""
    from .. import constants
    from ..ops.translate import translate_array
    if len(positional) != 2:
        raise ValueError("usage: translateaa <i:aaDB> <o:nuclDB>")
    v = space.values
    table = v.get("translation_table", 1)
    mat = constants.blosum62()
    codons = {}
    nucs = b"ACGT"
    for n1 in nucs:
        for n2 in nucs:
            for n3 in nucs:
                codon = bytes([n1, n2, n3])
                aa = translate_array(np.frombuffer(codon, dtype=np.uint8),
                                     table=table).tobytes()
                if aa not in codons:
                    codons[aa] = codon
    lut = {}
    for i in range(20):
        aa = mat.letters[i].encode()
        lut[i] = codons.get(aa, b"NNN")
    lut[20] = b"NNN"
    db = seqdb.SeqDB.open(positional[0])
    writer = seqdb.DBWriter(seqdb.NUCLEOTIDES)
    for i in range(db.size):
        num = mat.aa2num[db.get_seq(i)]
        out = b"".join(lut[int(c)] for c in num)
        writer.write(int(db.keys[i]), out)
    writer.finish().save(positional[1])
    return 0


def _summarizeresult(positional, space, stats):
    """summarizeresult (util/summarizeresult.cpp): greedy non-overlapping
    domain selection over each query's alignment list."""
    from ..ops.rescore import format_result_line
    if len(positional) != 2:
        raise ValueError("usage: summarizeresult <i:alnDB> <o:alnDB>")
    v = space.values
    cov_thr = v.get("cov_thr", 0.0)
    max_overlap = v.get("overlap", 0.0)
    add_bt = v.get("add_backtrace", False)
    db = seqdb.SeqDB.open(positional[0])
    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for i in seqdb.data_order(db):
        i = int(i)
        covered = None
        out = []
        for line in db.get_data(i).tobytes().decode().split("\n"):
            if not line:
                continue
            f = line.split("\t")
            (dbkey, score, seqid, evalue, qs, qe, qlen, ts, te, tlen) = f[:10]
            qs, qe, qlen, ts, te, tlen = map(int, (qs, qe, qlen, ts, te, tlen))
            if covered is None:
                covered = np.zeros(qlen, dtype=bool)
            if qs > qlen or qe > qlen:
                logger.warning("Query alignment start or end is greater than "
                               "query length! Skipping line.")
                continue
            dbcov = (abs(te - ts) + 1) / tlen
            if dbcov <= cov_thr:
                continue
            lo, hi = min(qs, qe), max(qs, qe)
            counter = int(covered[lo:hi].sum())
            pct = counter / (hi - lo + 1)
            if pct <= max_overlap:
                covered[lo:hi] = True
                if not add_bt and len(f) > 10:
                    line = "\t".join(f[:10])
                out.append(line + "\n")
        writer.write(int(db.keys[i]), "".join(out).encode(), add_newline=False)
    writer.finish().save(positional[1])
    return 0


def _extractalignedregion(positional, space, stats):
    """extractalignedregion (util/extractalignedregion.cpp): cut the aligned
    region out of the query (--extract-mode 1) or target (2, default)."""
    if len(positional) != 4:
        raise ValueError("usage: extractalignedregion <i:qDB> <i:tDB> "
                         "<i:alnDB> <o:seqDB>")
    v = space.values
    mode = v.get("extract_mode", 2)
    qdb = seqdb.SeqDB.open(positional[0])
    tdb = qdb if positional[1] == positional[0] else seqdb.SeqDB.open(positional[1])
    adb = seqdb.SeqDB.open(positional[2])
    writer = seqdb.DBWriter(tdb.dbtype)
    for i in seqdb.data_order(adb):
        i = int(i)
        qkey = int(adb.keys[i])
        for line in adb.get_data(i).tobytes().decode().split("\n"):
            if not line:
                continue
            f = line.split("\t")
            tkey, qs, qe, ts, te = int(f[0]), int(f[4]), int(f[5]), int(f[7]), int(f[8])
            if mode == 1:
                seq = qdb.get_seq(qdb.key_to_id(qkey)).tobytes()[qs:qe + 1]
            else:
                seq = tdb.get_seq(tdb.key_to_id(tkey)).tobytes()[ts:te + 1]
            writer.write(qkey, seq)
    writer.finish().save(positional[3])
    return 0


def _offsetalignment(positional, space, stats):
    """offsetalignment (util/offsetalignment.cpp): project ORF alignments
    back to source-contig coordinates."""
    from ..data.offsetaln import offset_alignment
    if len(positional) != 6:
        raise ValueError("usage: offsetalignment <i:qDB> <i:qOrfDB> "
                         "<i:tDB> <i:tOrfDB> <i:alnDB> <o:alnDB>")
    v = space.values
    aln = seqdb.SeqDB.open(positional[4])

    def _src(path):
        # a .linidx target resolves to the embedded SOURCE sequence DB
        # (IndexReader::SRC_SEQUENCES, offsetalignment.cpp:220-231)
        return path + "_src" if path.endswith(".linidx") else path

    q_hdr = seqdb.SeqDB.open(positional[1] + "_h")
    t_hdr = q_hdr if positional[3] == positional[1] \
        else seqdb.SeqDB.open(positional[3] + "_h")
    out = offset_alignment(_src(positional[0]), q_hdr, _src(positional[2]),
                           t_hdr, aln, search_type=v.get("search_type", 0))
    out.save(positional[5])
    return 0


def _summarizeheaders(positional, space, stats):
    """summarizeheaders (util/summarizeheaders.cpp): cluster headers ->
    one Uniclust/Metaclust-style summary line per cluster."""
    from ..data.summarize import summarize_metaclust, summarize_uniprot
    if len(positional) != 4:
        raise ValueError("usage: summarizeheaders <i:qHdrDB> <i:tHdrDB> "
                         "<i:cluDB> <o:db>")
    v = space.values
    fn = summarize_uniprot if v.get("header_type", 1) == 1 else summarize_metaclust
    prefix = v.get("summary_prefix", "cl")
    qdb = seqdb.SeqDB.open(positional[0])
    tdb = qdb if positional[1] == positional[0] else seqdb.SeqDB.open(positional[1])
    cdb = seqdb.SeqDB.open(positional[2])
    writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in seqdb.data_order(cdb):
        i = int(i)
        headers = []
        rep = ""
        for n, line in enumerate(cdb.get_data(i).tobytes().decode().splitlines()):
            if not line:
                continue
            src = qdb if n == 0 else tdb
            if n == 0:
                rep = line
            headers.append(src.get_data(src.key_to_id(int(line))).tobytes().decode())
        writer.write(int(cdb.keys[i]), fn(headers, prefix, rep).encode(),
                     add_newline=False)
    writer.finish().save(positional[3])
    return 0


def _diffseqdbs(positional, space, stats):
    """diffseqdbs (util/diffseqdbs.cpp): compare two sequence DBs by header
    and write removed / kept-mapping / new key files."""
    if len(positional) != 5:
        raise ValueError("usage: diffseqdbs <i:oldDB> <i:newDB> "
                         "<o:removedKeys> <o:keptKeys> <o:newKeys>")
    v = space.values
    use_seq_id = v.get("use_seq_id", False)

    def header_key(raw):
        text = raw.decode()
        if use_seq_id:  # Util::parseFastaHeader: first word, db|acc|... aware
            from ..data.headers import parse_fasta_header
            return parse_fasta_header(text)
        return "".join(text.split())

    old = seqdb.SeqDB.open(positional[0] + "_h")
    new = seqdb.SeqDB.open(positional[1] + "_h")
    keys_old = [(header_key(old.get_data(i).tobytes()), int(old.keys[i]))
                for i in range(old.size)]
    keys_new = [(header_key(new.get_data(i).tobytes()), int(new.keys[i]))
                for i in range(new.size)]
    keys_new_sorted = sorted(range(len(keys_new)),
                             key=lambda i: keys_new[i][0])
    sorted_headers = [keys_new[i][0] for i in keys_new_sorted]
    import bisect
    checked = [False] * len(keys_new)
    mapped = [0] * len(keys_new)
    removed = []
    for oid, (h, okey) in enumerate(keys_old):
        pos = bisect.bisect_left(sorted_headers, h)
        if pos < len(sorted_headers) and sorted_headers[pos] == h:
            nid = keys_new_sorted[pos]
            checked[nid] = True
            mapped[nid] = oid
        else:
            removed.append(okey)
    with open(positional[2], "w") as f:
        for k in removed:
            f.write(f"{k}\n")
    # reference iterates keysNew in SORTED order (the array was sorted
    # in place, diffseqdbs.cpp:103-143)
    with open(positional[3], "w") as fk, open(positional[4], "w") as fn:
        for pos in range(len(keys_new_sorted)):
            nid = keys_new_sorted[pos]
            if checked[nid]:
                fk.write(f"{keys_old[mapped[nid]][1]}\t{keys_new[nid][1]}\n")
            else:
                fn.write(f"{keys_new[nid][1]}\n")
    return 0


def _gff2db(positional, space, stats):
    """gff2db (util/gff2db.cpp): extract GFF features from a sequence DB
    into a new nucleotide DB with ORF-style headers."""
    from ..data.createdb import read_lookup, IUPAC_COMPLEMENT
    from ..ops.orf import _orf_header
    if len(positional) < 3:
        raise ValueError("usage: gff2db <i:gff1> ... <i:seqDB> <o:db>")
    v = space.values
    gffs = positional[:-2]
    seq_path, out = positional[-2], positional[-1]
    db = seqdb.SeqDB.open(seq_path)
    name2key = {name: key for key, name, _ in read_lookup(seq_path)}
    features = [s for s in v.get("gff_type", "").split(",") if s]
    writer = seqdb.DBWriter(seqdb.NUCLEOTIDES)
    hwriter = seqdb.DBWriter(seqdb.GENERIC_DB)
    lookup_lines = []
    key = 0
    with open(out + ".source", "w") as f:
        for i, g in enumerate(gffs):
            f.write(f"{i}\t{os.path.basename(g)}\n")
    for fi, gff in enumerate(gffs):
        idx = 0
        with open(gff) as f:
            for line in f:
                if line.startswith("#") or line == "\n":
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 9:
                    logger.warning("Not enough columns in GFF file")
                    continue
                if features and cols[2] not in features:
                    continue
                start, end = int(cols[3]), int(cols[4])
                if start == end:
                    logger.warning("Invalid sequence length in line %d", idx)
                    continue
                strand, name = cols[6], cols[0]
                if name not in name2key:
                    raise ValueError(
                        f"GFF entry not found in database lookup: {name}")
                lkey = name2key[name]
                sid = db.key_to_id(lkey)
                seq = db.get_seq(sid).tobytes()
                if strand == "+":
                    hwriter.write(key, _orf_header(lkey, start, end, 0, 0) + b"\n",
                                  add_newline=False)
                    lookup_lines.append(f"{key}\t{name}_{idx}_{start}_{end}\t{fi}\n")
                    frag = seq[start - 1: start - 1 + (end - start + 1)]
                else:
                    hwriter.write(key, _orf_header(lkey, end, start, 0, 0) + b"\n",
                                  add_newline=False)
                    lookup_lines.append(f"{key}\t{name}_{idx}_{end}_{start}\t{fi}\n")
                    window = np.frombuffer(seq[start - 1: end], dtype=np.uint8)
                    frag = IUPAC_COMPLEMENT[window][::-1].tobytes()
                writer.write(key, frag)
                key += 1
                idx += 1
    writer.finish().save(out)
    hwriter.finish().save(out + "_h")
    with open(out + ".lookup", "w") as f:
        f.writelines(lookup_lines)
    return 0


def _maskbygff(positional, space, stats):
    """maskbygff (util/maskbygff.cpp): X out GFF regions of a sequence DB;
    keys are renumbered from --id-offset."""
    if len(positional) != 3:
        raise ValueError("usage: maskbygff <i:gff> <i:seqDB> <o:seqDB>")
    v = space.values
    gff_type = v.get("gff_type", "")
    offset = v.get("id_offset", 0)
    db = seqdb.SeqDB.open(positional[1])
    seqs = {str(int(db.keys[i])): bytearray(db.get_seq(i).tobytes())
            for i in range(db.size)}
    n = 0
    with open(positional[0]) as f:
        for line in f:
            n += 1
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) != 9:
                logger.warning("Invalid GFF format in line %d!", n)
                continue
            name, ftype = cols[0], cols[2]
            if gff_type and ftype != gff_type:
                continue
            start, end = int(cols[3]), int(cols[4])
            if end <= start or end == 0 or start == 0:
                logger.warning("Invalid sequence length in line %d!", n)
                continue
            if name not in seqs:
                raise ValueError(f"GFF entry not found in input database: {name}")
            body = seqs[name]
            body[start - 1: end] = b"X" * (end - start + 1)
    writer = seqdb.DBWriter(db.dbtype)
    hdb = seqdb.SeqDB.open(positional[1] + "_h")
    hwriter = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in range(db.size):
        newkey = offset + i
        writer.write(newkey, bytes(seqs[str(int(db.keys[i]))]))
        hwriter.write(newkey, hdb.get_data(hdb.key_to_id(int(db.keys[i]))).tobytes(),
                      add_newline=False)
    writer.finish().save(positional[2])
    hwriter.finish().save(positional[2] + "_h")
    return 0


def _db_flags():
    return P.common_flags() + [
        P.Flag("--id-list", "id_list", str, "", "Entries to print, comma-separated"),
        P.Flag("--id-mode", "id_mode", int, 0, "0: DB keys, 1: FASTA ids (.lookup)", r"[0-1]"),
        P.Flag("--idx-entry-type", "idx_entry_type", int, 0, "0 seq, 1 src seq, 2 header, 3 src header", r"[0-3]"),
        P.Flag("--prefix", "prefix", str, "", "Prefix/suffix string"),
        P.Flag("--tsv", "tsv", bool, False, "Output TSV instead of a DB"),
        P.Flag("--mapping-file", "mapping_file", str, "", "Lookup mapping file"),
        P.Flag("--unpack-suffix", "unpack_suffix", str, "", "File suffix for unpacked files"),
        P.Flag("--unpack-name-mode", "unpack_name_mode", int, 1, "0: DB key, 1: accession", r"[0-1]"),
        P.Flag("-k", "kmer_size", int, 5, "k-mer size"),
        P.Flag("--translation-table", "translation_table", int, 1, "Genetic code table"),
        P.Flag("-c", "cov_thr", float, 0.0, "Coverage threshold"),
        P.Flag("--overlap", "overlap", float, 0.0, "Maximum overlap of covered regions"),
        P.Flag("-a", "add_backtrace", bool, False, "Keep backtraces"),
        P.Flag("--extract-mode", "extract_mode", int, 2, "Extract 1: query, 2: target", r"[1-2]"),
        P.Flag("--search-type", "search_type", int, 0, "0 auto, 1 aa, 2 translated, 3 nucl, 4 trans-nucl-aln", r"[0-4]"),
        P.Flag("--header-type", "header_type", int, 1, "1: Uniclust, 2: Metaclust", r"[1-2]"),
        P.Flag("--summary-prefix", "summary_prefix", str, "cl", "Summary prefix"),
        P.Flag("--use-seq-id", "use_seq_id", bool, False, "Match by sequence ID instead of full header"),
        P.Flag("--gff-type", "gff_type", str, "", "GFF feature type(s), comma-separated"),
        P.Flag("--id-offset", "id_offset", int, 0, "Numeric ids in index file are offset by this value"),
    ]


COMMANDS = [
    Command("compress", _compress, lambda: port_space(P.common_flags()),
            "<i:db> <o:db>", "Compress DB entries with ZSTD", hidden=True),
    Command("decompress", _decompress, lambda: port_space(P.common_flags()),
            "<i:db> <o:db>", "Decompress DB entries", hidden=True),
    Command("dbtype", _dbtype, lambda: port_space(P.common_flags()),
            "<i:db>", "Print the DB type", hidden=True),
    Command("view", _view, lambda: port_space(_db_flags()),
            "<i:db>", "Print DB entries to stdout", hidden=True),
    Command("renamedbkeys", _renamedbkeys, lambda: port_space(P.common_flags() + [
        P.Flag("--subdb-mode", "subdb_mode", int, 0,
               "0: copy data, 1: soft link data and write index", r"[0-1]")]),
            "<i:mapFile> <i:db> <o:db>", "Rename DB keys by a two-column mapping", hidden=True),
    Command("suffixid", _suffixid, lambda: port_space(_db_flags()),
            "<i:db> <o:db>", "Suffix each line with the record key", hidden=True),
    Command("unpackdb", _unpackdb, lambda: port_space(_db_flags()),
            "<i:db> <o:dir>", "Unpack a DB into separate files", hidden=True),
    Command("countkmer", _countkmer, lambda: port_space(_db_flags()),
            "<i:seqDB>", "Count k-mers over the whole DB", hidden=True),
    Command("masksequence", _masksequence, lambda: port_space(P.common_flags()),
            "<i:seqDB> <o:seqDB>", "Soft-mask low-complexity regions (tantan)", hidden=True),
    Command("translateaa", _translateaa, lambda: port_space(_db_flags()),
            "<i:aaDB> <o:nuclDB>", "Back-translate protein to nucleotide", hidden=True),
    Command("summarizeresult", _summarizeresult, lambda: port_space(_db_flags()),
            "<i:alnDB> <o:alnDB>", "Greedy non-overlapping domain selection", hidden=True),
    Command("extractalignedregion", _extractalignedregion, lambda: port_space(_db_flags()),
            "<i:qDB> <i:tDB> <i:alnDB> <o:seqDB>", "Extract aligned regions", hidden=True),
    Command("offsetalignment", _offsetalignment, lambda: port_space(_db_flags()),
            "<i:qDB> <i:qOrfDB> <i:tDB> <i:tOrfDB> <i:alnDB> <o:alnDB>",
            "Map ORF alignments back to contig coordinates", hidden=True),
    Command("summarizeheaders", _summarizeheaders, lambda: port_space(_db_flags()),
            "<i:qHdrDB> <i:tHdrDB> <i:cluDB> <o:db>",
            "Summarize cluster headers (Uniclust/Metaclust style)", hidden=True),
    Command("diffseqdbs", _diffseqdbs, lambda: port_space(_db_flags()),
            "<i:oldDB> <i:newDB> <o:removed> <o:kept> <o:new>",
            "Diff two sequence DBs by header", hidden=True),
    Command("gff2db", _gff2db, lambda: port_space(_db_flags()),
            "<i:gff1> ... <i:seqDB> <o:db>", "Extract GFF features into a DB", hidden=True),
    Command("maskbygff", _maskbygff, lambda: port_space(_db_flags()),
            "<i:gff> <i:seqDB> <o:seqDB>", "X out GFF regions", hidden=True),
]
