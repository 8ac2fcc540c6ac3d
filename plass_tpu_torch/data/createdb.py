"""Input ingestion: createdb and paired-end read merging (mergereads).

createdb (reference: lib/mmseqs/src/util/createdb.cpp): FASTA/FASTQ ->
sequence DB + header DB. Keys are assigned in read order; the reference's
--shuffle only changes on-disk byte layout, not logical key order, so it is
a no-op here.

mergereads (reference: src/assembler/mergereads.cpp:15-131 + lib/flash/
combine_reads.cpp): FLASH overlap-merging of read pairs with min_overlap=15,
max_overlap=65, max_mismatch_density=0.10; read 2 is reverse-complemented
first; combined pairs produce one record, uncombined pairs two records.
"""
import numpy as np

from . import seqdb
from .fastx import iter_fastx

# IUPAC complement table used by FLASH and Orf (lib/flash/read.cpp:4-8,
# commons/Orf.cpp:48-52): maps unknown chars to '.'
IUPAC_COMPLEMENT = np.full(256, ord("."), dtype=np.uint8)
for _src, _dst in zip(b"ABCDGHKMNRSTUVWY", b"TVGHCDMKNYSAABWR"):
    IUPAC_COMPLEMENT[_src] = _dst
    IUPAC_COMPLEMENT[_src + 32] = _dst + 32  # lowercase


def iupac_revcomp(arr):
    """Reverse-complement a uint8 sequence array (FLASH semantics)."""
    return IUPAC_COMPLEMENT[arr][::-1]


def write_lookup(path, entries):
    """Write `<db>.lookup`: ``key\\taccession\\tfileNumber`` per record
    (DBReader::lookupEntryToBuffer, DBReader.cpp:686-694)."""
    with open(path + ".lookup", "w") as f:
        for key, name, filenum in entries:
            f.write(f"{key}\t{name}\t{filenum}\n")


def read_lookup(path):
    """Parse `<db>.lookup` into [(key, accession, fileNumber)]."""
    out = []
    with open(path + ".lookup") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out.append((int(parts[0]), parts[1],
                            int(parts[2]) if len(parts) > 2 else 0))
    return out


def write_source(path, names):
    """Write `<db>.source`: ``fileNumber\\tbaseName`` (createdb.cpp:121)."""
    import os
    with open(path + ".source", "w") as f:
        for i, name in enumerate(names):
            f.write(f"{i}\t{os.path.basename(name)}\n")


def create_db(paths, dbtype=None, raw_headers=False):
    """Build (sequence SeqDB, header SeqDB) from FASTA/FASTQ files.

    dbtype None = auto-detect nucleotide vs amino acid from the first
    sequences (createdb.cpp dbType detection). raw_headers=True keeps the
    original header bytes (the zero-copy --createdb-mode 1 of the easy-*
    workflows, where the header DB points into the input FASTA,
    EasyCluster.cpp:17, createdb.cpp:134-160) instead of hard mode's
    name+' '+comment normalization (createdb.cpp:159-166).
    """
    from .fastx import iter_fastx_raw
    seq_writer = seqdb.DBWriter(seqdb.NUCLEOTIDES)
    hdr_writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    key = 0
    sample = []
    records = []
    lookup = []
    for filenum, path in enumerate(paths):
        for raw, name, comment, seq, qual in iter_fastx_raw(path):
            header = raw if raw_headers \
                else name + (b" " + comment if comment else b"")
            records.append((key, header, seq))
            lookup.append((key, name.decode(), filenum))
            if len(sample) < 100:
                sample.append(seq)
            key += 1
    # --shuffle (default on, off in zero-copy mode, createdb.cpp:48-51):
    # deterministic 32-way round-robin split interleave — record id goes
    # to shard id%32 and the shards are concatenated (createdb.cpp:60,219)
    if not raw_headers and len(records) > 1:
        records.sort(key=lambda r: (r[0] % 32, r[0]))
    for k, header, seq in records:
        seq_writer.write(k, seq)
        hdr_writer.write(k, header)
    sdb = seq_writer.finish()
    hdb = hdr_writer.finish()
    if dbtype is None:
        dbtype = _detect_dbtype(sample)
    sdb.dbtype = dbtype
    sdb.lookup_entries = lookup
    sdb.source_names = list(paths)
    return sdb, hdb


def _detect_dbtype(seqs):
    """Auto-detect: if >90% of letters are ACGTUN -> nucleotide."""
    nucl = 0
    total = 0
    for s in seqs:
        up = s.upper()
        total += len(up)
        nucl += sum(up.count(c) for c in b"ACGTUN")
    if total and nucl / total >= 0.9:
        return seqdb.NUCLEOTIDES
    return seqdb.AMINO_ACIDS


# ---------------------------------------------------------------------------
# FLASH pair merging
# ---------------------------------------------------------------------------

MIN_OVERLAP = 15
MAX_OVERLAP = 65
MAX_MISMATCH_DENSITY = 0.10


def flash_combine(seq1, qual1, seq2_rc, qual2_rc):
    """FLASH combine_reads with plass parameters; read 2 pre-revcomped.

    Returns combined sequence bytes or None (lib/flash/combine_reads.cpp:
    pair_align:267-335, generate_combined_read:338-446). Innie only
    (allow_outies=false).
    """
    s1 = np.frombuffer(seq1, dtype=np.uint8)
    s2 = np.frombuffer(seq2_rc, dtype=np.uint8)
    q1 = np.frombuffer(qual1, dtype=np.uint8).astype(np.int32)
    q2 = np.frombuffer(qual2_rc, dtype=np.uint8).astype(np.int32)
    len1, len2 = len(s1), len(s2)

    n1 = s1 == ord("N")
    n2 = s2 == ord("N")

    best_density = MAX_MISMATCH_DENSITY + 1.0
    best_qual = 0.0
    best_pos = None
    start = max(0, len1 - len2)
    end = len1 - MIN_OVERLAP + 1
    for i in range(start, end):
        ov = min(len1 - i, len2)
        a = s1[i: i + ov]
        b = s2[:ov]
        un = n1[i: i + ov] | n2[:ov]
        mm = (a != b) & ~un
        olen = ov - int(un.sum())
        if olen < MIN_OVERLAP:
            continue
        num_mm = int(mm.sum())
        qa = q1[i: i + ov]
        qb = q2[:ov]
        mm_qual = int(np.minimum(qa, qb)[mm].sum())
        score_len = float(min(olen, MAX_OVERLAP))
        density = num_mm / score_len
        qual_score = mm_qual / score_len
        if density <= best_density and (density < best_density or qual_score < best_qual):
            best_density = density
            best_qual = qual_score
            best_pos = i

    if best_pos is None or best_density > MAX_MISMATCH_DENSITY:
        return None

    i = best_pos
    ov = len1 - i
    rem = len2 - ov
    head = s1[:i]
    a = s1[i:]
    b = s2[:ov]
    qa = q1[i:]
    qb = q2[:ov]
    same = a == b
    # mismatch: take higher-quality base; tie -> read2 base unless it is N
    take_a = (qa > qb) | ((qa == qb) & (b == ord("N")))
    merged = np.where(same, a, np.where(take_a, a, b)).astype(np.uint8)
    tail = s2[ov:] if rem > 0 else np.zeros(0, dtype=np.uint8)
    return np.concatenate([head, merged, tail]).tobytes()


def merge_reads(paths):
    """mergereads: paired FASTQ files -> (sequence DB, header DB)."""
    from ..utils.progress import Progress
    if len(paths) % 2 != 0:
        raise ValueError("mergereads requires an even number of input files")
    seq_writer = seqdb.DBWriter(seqdb.NUCLEOTIDES)
    hdr_writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    key = 0
    n_combined = 0
    n_pairs = 0
    prog = Progress()  # unknown total, Debug::Progress's dot mode
    for fi in range(len(paths) // 2):
        it1 = iter_fastx(paths[fi * 2])
        it2 = iter_fastx(paths[fi * 2 + 1])
        for (n1, c1, s1, q1), (n2, c2, s2, q2) in zip(it1, it2):
            prog.update()
            if len(s1) == 0 or len(s2) == 0 or len(q1) == 0 or len(q2) == 0:
                raise ValueError("invalid read pair (empty sequence or quality)")
            n_pairs += 1
            s2rc = iupac_revcomp(np.frombuffer(s2, dtype=np.uint8)).tobytes()
            q2rc = q2[::-1]
            combined = flash_combine(s1, q1, s2rc, q2rc)
            if combined is not None:
                n_combined += 1
                seq_writer.write(key, combined)
                hdr_writer.write(key, n1)
                key += 1
            else:
                seq_writer.write(key, s1)
                hdr_writer.write(key, n1)
                key += 1
                # read 2 was reverse-complemented in place before combine_reads
                # and is written in that orientation (mergereads.cpp:78,103-105)
                seq_writer.write(key, s2rc)
                hdr_writer.write(key, n2)
                key += 1
    prog.finish()
    sdb = seq_writer.finish()
    hdb = hdr_writer.finish()
    return sdb, hdb
