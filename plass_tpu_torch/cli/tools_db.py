"""DB utility tools: renamedbkeys, offsetalignment and diffseqdbs
(reference: lib/mmseqs/src/util/{renamedbkeys,offsetalignment,
diffseqdbs}.cpp), which `linsearch` on nucleotides and `clusterupdate`
run.

A copy of three of the JAX package's cli/tools_db.py commands, host code
on every device; each takes the port's (positional, space, stats) and the
flag list of its JAX counterpart plus --device. The file's other commands
are not ported yet (ROADMAP item 23.5).
"""
import os

from ..data import seqdb
from ..utils.log import logger
from . import params as P
from .app import Command, port_space


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
    Command("renamedbkeys", _renamedbkeys, lambda: port_space(P.common_flags() + [
        P.Flag("--subdb-mode", "subdb_mode", int, 0,
               "0: copy data, 1: soft link data and write index", r"[0-1]")]),
            "<i:mapFile> <i:db> <o:db>", "Rename DB keys by a two-column mapping", hidden=True),
    Command("offsetalignment", _offsetalignment, lambda: port_space(_db_flags()),
            "<i:qDB> <i:qOrfDB> <i:tDB> <i:tOrfDB> <i:alnDB> <o:alnDB>",
            "Map ORF alignments back to contig coordinates", hidden=True),
    Command("diffseqdbs", _diffseqdbs, lambda: port_space(_db_flags()),
            "<i:oldDB> <i:newDB> <o:removed> <o:kept> <o:new>",
            "Diff two sequence DBs by header", hidden=True),
]
