"""FASTA header accession extraction.

Reference: Util::getFastaHeaderPosition / parseFastaHeader
(lib/mmseqs/src/commons/Util.cpp:173-256): recognizes the NCBI-style
database prefixes and extracts the accession between the vertical bars;
otherwise the first whitespace-delimited word.
"""

_DATABASES = [
    ("uc", 2, 0),      # Uniclust
    ("cl|", 3, 1),
    ("sp|", 3, 1),     # Swiss-Prot
    ("tr|", 3, 1),     # TrEMBL
    ("gb|", 3, 1),     # GenBank
    ("ref|", 4, 1),    # NCBI Reference Sequence
    ("pdb|", 4, 1),    # Protein Data Bank
    ("bbs|", 4, 1),    # GenInfo Backbone
    ("lcl|", 4, 1),    # Local identifier
    ("pir||", 5, 1),   # NBRF PIR
    ("prf||", 5, 1),   # Protein Research Foundation
    ("gnl|", 4, 2),    # General database identifier
    ("pat|", 4, 2),    # Patents
    ("gi|", 3, 3),     # NCBI GI
]


def parse_fasta_header(header):
    """Accession of a header line (first word, database-prefix aware)."""
    word = header.split(None, 1)[0] if header.split() else ""
    if not word:
        return ""
    offset = 0
    if word.startswith("consensus_"):
        offset = 10
    for prefix, length, bar_pos in _DATABASES:
        if word.startswith(prefix, offset):
            start = offset + length
            ok = True
            for _ in range(max(bar_pos - 1, 0)):
                end = word.find("|", start)
                if end == -1:
                    ok = False
                    break
                start = end + 1
            if not ok:
                return ""
            end = word.find("|", start)
            if end == -1:
                end = len(word)
            return word[start:end]
    return word[offset:]
