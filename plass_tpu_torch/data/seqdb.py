"""MMseqs-compatible record database, NumPy-backed.

The on-disk contract matches the reference so that databases interoperate
bit-for-bit (reference: lib/mmseqs/src/commons/DBReader.{h,cpp},
DBWriter.{h,cpp}):

 - ``<name>``        data file; records are raw bytes each terminated by ``\\0``
                     (sequence records additionally end with ``\\n`` before it)
 - ``<name>.index``  text: ``key\\toffset\\tlength\\n`` sorted by key ascending;
                     length INCLUDES the trailing ``\\0``
 - ``<name>.dbtype`` 4-byte little-endian int (Parameters.h:63-82)

In memory a database is a flat uint8 array + (key, offset, length) arrays —
the padded-batch views handed to the device are built from these without
copies of the underlying data where possible.
"""
import os
import shutil

import numpy as np

# dbtype ids (Parameters.h:63-82)
AMINO_ACIDS = 0
NUCLEOTIDES = 1
HMM_PROFILE = 2
PROFILE_STATE_SEQ = 3
ALIGNMENT_RES = 5
CLUSTER_RES = 6
PREFILTER_RES = 7
TAX_RES = 8
INDEX_DB = 9
CA3M_DB = 10
MSA_DB = 11
GENERIC_DB = 12
PREFILTER_REV_RES = 14
OFFSETDB = 15

# Parameters::getDbTypeName (Parameters.h:1111-1134)
DBTYPE_NAMES = {
    0: "Aminoacid", 1: "Nucleotide", 2: "Profile", 3: "Profile state",
    4: "Profile profile", 5: "Alignment", 6: "Clustering", 7: "Prefilter",
    8: "Taxonomy", 9: "Index", 10: "CA3M", 11: "MSA", 12: "Generic",
    14: "Bi-directional prefilter", 15: "Offsetted headers",
    16: "Directory", 17: "Flatfile", 19: "stdin",
}


def read_dbtype(path):
    with open(path + ".dbtype", "rb") as f:
        raw = int.from_bytes(f.read(4), "little")
    return raw & 0x7FFFFFFF


def read_dbtype_raw(path):
    """Full 4-byte dbtype incl. the compressed flag in bit 31
    (DBReader::getExtendedDbtype / DBWriter::writeDbtypeFile)."""
    with open(path + ".dbtype", "rb") as f:
        return int.from_bytes(f.read(4), "little")


def is_compressed(path):
    return bool(read_dbtype_raw(path) & (1 << 31))


def write_dbtype(path, dbtype):
    with open(path + ".dbtype", "wb") as f:
        f.write(int(dbtype).to_bytes(4, "little"))


def is_sequence_type(dbtype):
    return dbtype in (AMINO_ACIDS, NUCLEOTIDES)


class SeqDB:
    """Read-only view of a record database.

    data:    uint8[total] raw bytes of the data file
    keys:    uint32[N]    record keys (sorted ascending)
    offsets: int64[N]
    lengths: int64[N]     full record length incl. trailing NUL
    """

    def __init__(self, data, keys, offsets, lengths, dbtype):
        self.data = data
        self.keys = keys
        self.offsets = offsets
        self.lengths = lengths
        self.dbtype = dbtype
        self._key2id = None

    # -- construction -------------------------------------------------------

    @classmethod
    def open(cls, path):
        # linsearch index resolution (IndexReader::SEQUENCES/HEADERS on a
        # .linidx, IndexReader.h:27-60): the indexed sequence DB and its
        # headers are materialized beside the index payload
        if path.endswith(".linidx"):
            path = path + "_seq"
        elif path.endswith(".linidx_h"):
            path = path[: -len("_h")] + "_seq_h"
        dbtype = read_dbtype(path)
        # mmap the data file instead of reading it into RAM (reference:
        # DBReader.cpp:402-425 mmaps with sequential madvise) — record
        # accessors and padded-batch construction read through the map, so
        # peak RSS stays bounded by what is actually touched, not DB size
        if os.path.getsize(path) == 0:
            data = np.zeros(0, dtype=np.uint8)
        else:
            data = np.memmap(path, dtype=np.uint8, mode="r")
            try:
                data._mmap.madvise(__import__("mmap").MADV_SEQUENTIAL)
            except (AttributeError, OSError):
                pass
        idx = _read_index(path + ".index")
        if read_dbtype_raw(path) & (1 << 31):
            return _decompress_db(data, idx[0], idx[1], idx[2], dbtype)
        return cls(data, idx[0], idx[1], idx[2], dbtype)

    @classmethod
    def from_records(cls, records, keys=None, dbtype=GENERIC_DB, add_newline=True):
        """Build from a list of bytes payloads (without \\n\\0 terminators)."""
        n = len(records)
        if keys is None:
            keys = np.arange(n, dtype=np.uint32)
        else:
            keys = np.asarray(keys, dtype=np.uint32)
        tail = b"\n\x00" if add_newline else b"\x00"
        lengths = np.array([len(r) + len(tail) for r in records], dtype=np.int64)
        offsets = np.zeros(n, dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:] if n > 1 else None)
        data = bytearray()
        for r in records:
            data += r
            data += tail
        return cls(np.frombuffer(bytes(data), dtype=np.uint8), keys, offsets, lengths, dbtype)

    # -- accessors ----------------------------------------------------------

    @property
    def size(self):
        return len(self.keys)

    def seq_len(self, i):
        """Sequence length: record length minus \\n\\0 (DBReader::getSeqLen)."""
        return int(self.lengths[i]) - 2

    def seq_lens(self):
        return self.lengths - 2

    def get_data(self, i):
        """Record payload without the trailing NUL byte."""
        o = int(self.offsets[i])
        return self.data[o: o + int(self.lengths[i]) - 1]

    def get_seq(self, i):
        """Sequence bytes without trailing \\n\\0."""
        o = int(self.offsets[i])
        return self.data[o: o + int(self.lengths[i]) - 2]

    def get_seq_bytes(self, i):
        return self.get_seq(i).tobytes()

    def get_record_str(self, i):
        return self.get_data(i).tobytes().decode()

    def key_to_id(self, key):
        if self._key2id is None:
            self._key2id = {int(k): i for i, k in enumerate(self.keys)}
        return self._key2id.get(int(key))

    def id_lookup_array(self):
        """uint32[maxKey+1] key -> id (UINT32_MAX where absent)."""
        maxk = int(self.keys.max()) if self.size else 0
        lut = np.full(maxk + 1, np.iinfo(np.uint32).max, dtype=np.uint32)
        lut[self.keys] = np.arange(self.size, dtype=np.uint32)
        return lut

    def total_residues(self):
        """Sum of sequence lengths (DBReader::getAminoAcidDBSize,
        DBReader.cpp:537-546); profile DBs count columns
        (dataSize / PROFILE_READIN_SIZE - size)."""
        if self.dbtype == HMM_PROFILE:
            # PROFILE_READIN_SIZE = 23 (Sequence.h)
            return int(self.lengths.sum()) // 23 - self.size
        return int(self.seq_lens().sum())

    # -- persistence --------------------------------------------------------

    def save(self, path):
        # writing over the very file the data is mmapped from would corrupt
        # the live view; the bytes are already on disk in that case
        if getattr(self.data, "filename", None) != os.path.abspath(path):
            self.data.tofile(path)
        _write_index(path + ".index", self.keys, self.offsets, self.lengths)
        write_dbtype(path, self.dbtype)

    def __repr__(self):
        return f"SeqDB(n={self.size}, dbtype={self.dbtype}, bytes={self.data.size})"


class DBWriter:
    """Streaming record writer mirroring the reference DBWriter contract."""

    def __init__(self, dbtype):
        self.dbtype = dbtype
        self._chunks = []
        self._keys = []
        self._lengths = []

    def write(self, key, payload, add_newline=True):
        """payload: bytes without terminators."""
        tail = b"\n\x00" if add_newline else b"\x00"
        rec = bytes(payload) + tail
        self._chunks.append(rec)
        self._keys.append(key)
        self._lengths.append(len(rec))

    def finish(self, sort_by_key=True):
        """Mirror the reference DBWriter: data stays in WRITE order, only the
        index is sorted by key (DBWriter::close). The physical record order
        is observable (e.g. the only-assembled selection keys off data-file
        line numbers, assemble.sh:176) so it must match."""
        keys = np.asarray(self._keys, dtype=np.uint32)
        lengths = np.asarray(self._lengths, dtype=np.int64)
        n = len(keys)
        offsets = np.zeros(n, dtype=np.int64)
        if n > 1:
            np.cumsum(lengths[:-1], out=offsets[1:])
        data = np.frombuffer(b"".join(self._chunks), dtype=np.uint8)
        if sort_by_key:
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            offsets = offsets[order]
            lengths = lengths[order]
        return SeqDB(data, keys, offsets, lengths, self.dbtype)


def _decompress_db(data, keys, offsets, lengths, dbtype):
    """Expand a per-record ZSTD-compressed DB into a plain SeqDB.

    On-disk compressed record framing (DBWriter::writeEnd,
    DBWriter.cpp:322-379; DBReader::getDataCompressed, DBReader.cpp:507-535):
    ``[uint32 cSize][payload cSize bytes][terminator]`` where the terminator
    is 0x00 for a ZSTD frame and 0xFF for a short (<60 byte) raw record; the
    index length keeps the UNCOMPRESSED record length (payload + NUL).
    """
    from ..utils import zstd as zstandard
    dctx = zstandard.ZstdDecompressor()
    writer = DBWriter(dbtype)
    for i in range(len(keys)):
        o = int(offsets[i])
        csize = int.from_bytes(data[o:o + 4].tobytes(), "little")
        payload = data[o + 4: o + 4 + csize].tobytes()
        term = int(data[o + 4 + csize])
        if term == 0:
            payload = dctx.decompress(payload, max_output_size=1 << 31)
        writer.write(int(keys[i]), payload, add_newline=False)
    return writer.finish(sort_by_key=False)


def save_compressed(db, path):
    """Write a DB in the reference's per-record ZSTD-compressed layout.

    Mirrors DBWriter with WRITER_COMPRESSED_MODE (DBWriter.cpp:274-384):
    records < 60 bytes stay raw with an 0xFF terminator; the index records
    the uncompressed length (+1 for the terminator); bit 31 of the dbtype
    marks the DB compressed.
    """
    from ..utils import zstd as zstandard
    order = data_order(db)
    keys, lengths, offsets = [], [], []
    pos = 0
    with open(path, "wb") as f:
        for i in order:
            payload = db.get_data(int(i)).tobytes()
            if len(payload) < 60:
                framed = (len(payload).to_bytes(4, "little") + payload + b"\xff")
            else:
                cctx = zstandard.ZstdCompressor(level=3)
                comp = cctx.compress(payload)
                framed = len(comp).to_bytes(4, "little") + comp + b"\x00"
            f.write(framed)
            keys.append(int(db.keys[int(i)]))
            offsets.append(pos)
            lengths.append(len(payload) + 1)
            pos += len(framed)
    order2 = np.argsort(np.asarray(keys, dtype=np.uint32), kind="stable")
    _write_index(path + ".index",
                 np.asarray(keys, dtype=np.uint32)[order2],
                 np.asarray(offsets, dtype=np.int64)[order2],
                 np.asarray(lengths, dtype=np.int64)[order2])
    with open(path + ".dbtype", "wb") as f:
        f.write(int(db.dbtype | (1 << 31)).to_bytes(4, "little"))


def _read_index(path):
    if os.path.getsize(path) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.uint32), z, z
    arr = np.loadtxt(path, dtype=np.int64, ndmin=2)
    return arr[:, 0].astype(np.uint32), arr[:, 1], arr[:, 2]


def _write_index(path, keys, offsets, lengths):
    with open(path, "w") as f:
        for k, o, l in zip(keys, offsets, lengths):
            f.write(f"{k}\t{o}\t{l}\n")


def data_order(db):
    """Record indices in data-file (write) order — the order the
    reference's LINEAR_ACCCESS readers iterate and writers preserve."""
    import numpy as np
    return np.argsort(db.offsets, kind="stable")


def renumber(db):
    """Reassign keys 0..N-1 in current record order (DBWriter::createRenumberedDB)."""
    return SeqDB(db.data, np.arange(db.size, dtype=np.uint32), db.offsets,
                 db.lengths, db.dbtype)


def concat(db1, db2):
    """concatdbs: renumbers keys sequentially across both inputs
    (reference: lib/mmseqs/src/util/concatdbs.cpp)."""
    data = np.concatenate([db1.data, db2.data])
    keys = np.arange(db1.size + db2.size, dtype=np.uint32)
    offsets = np.concatenate([db1.offsets, db2.offsets + db1.data.size])
    lengths = np.concatenate([db1.lengths, db2.lengths])
    return SeqDB(data, keys, offsets, lengths, db1.dbtype)


def concat_preserve_keys(db1, db2):
    """concatdbs --preserve-keys: keys kept as-is (must be disjoint)."""
    data = np.concatenate([db1.data, db2.data])
    keys = np.concatenate([db1.keys, db2.keys])
    offsets = np.concatenate([db1.offsets, db2.offsets + db1.data.size])
    lengths = np.concatenate([db1.lengths, db2.lengths])
    order = np.argsort(keys, kind="stable")
    return SeqDB(data, keys[order], offsets[order], lengths[order], db1.dbtype)


def subdb(db, keep_keys, order="numeric"):
    """createsubdb: keep only the given keys.

    order: 'numeric' (sorted key order) or 'lex' (lexicographic string order,
    matching `sort | uniq` over an index file as in assemble.sh:178) — the
    data layout follows the processing order, index stays key-sorted.
    """
    uniq = sorted(set(int(k) for k in keep_keys))
    if order == "lex":
        uniq = sorted(uniq, key=str)
    lut = db.id_lookup_array()
    writer = DBWriter(db.dbtype)
    for k in uniq:
        if k >= len(lut):
            continue
        i = int(lut[k])
        if i == np.iinfo(np.uint32).max:
            continue
        o = int(db.offsets[i])
        payload = db.data[o: o + int(db.lengths[i]) - 2].tobytes()
        writer.write(int(db.keys[i]), payload)
    return writer.finish(sort_by_key=True)


def copy_db_files(src, dst):
    """cpdb equivalent for the file family."""
    for suffix in ("", ".index", ".dbtype"):
        if os.path.exists(src + suffix):
            shutil.copyfile(src + suffix, dst + suffix)
