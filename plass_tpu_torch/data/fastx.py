"""Streaming FASTA/FASTQ input (kseq-equivalent).

Supports plain and gzip files (reference: lib/mmseqs/src/commons/KSeqWrapper.cpp).
Yields (name, comment, sequence, quality) tuples of bytes; quality is b"" for
FASTA. bz2 support comes free via the stdlib.
"""
import bz2
import gzip
import io


def _open_any(path):
    f = open(path, "rb")
    magic = f.read(3)
    f.seek(0)
    if magic[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    if magic == b"BZh":
        return io.BufferedReader(bz2.BZ2File(f))
    return f


def iter_fastx(path):
    """Yield (name, comment, seq, qual) from a FASTA/FASTQ file."""
    for _raw, name, comment, seq, qual in iter_fastx_raw(path):
        yield name, comment, seq, qual


def iter_fastx_raw(path):
    """Yield (raw_header, name, comment, seq, qual); raw_header keeps the
    original header bytes after the '>'/'@' marker."""
    with _open_any(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        line = f.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if not line:
                line = f.readline()
                continue
            if line.startswith(b">"):
                head = line[1:]
                name, _, comment = head.partition(b" ")
                if b"\t" in name:
                    name, _, rest = head.partition(b"\t")
                    comment = rest
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b">") and not line.startswith(b"@"):
                    seq_parts.append(line.strip())
                    line = f.readline()
                yield head, name, comment, b"".join(seq_parts), b""
            elif line.startswith(b"@"):
                head = line[1:]
                name, _, comment = head.partition(b" ")
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                qual = f.readline().rstrip(b"\r\n")
                # multi-line fastq is rare; handle the common 4-line records
                yield head, name, comment, seq, qual
                line = f.readline()
            else:
                raise ValueError(f"unrecognized record start in {path}: {line[:20]!r}")


_COMPLEMENT = bytes.maketrans(
    b"ACGTUacgtuNnRYSWKMBDHVryswkmbdhv",
    b"TGCAAtgcaaNnYRSWMKVHDByrswmkvhdb",
)


def revcomp_bytes(seq):
    return seq.translate(_COMPLEMENT)[::-1]
