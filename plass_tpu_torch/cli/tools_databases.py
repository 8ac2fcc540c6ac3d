"""`databases` — list and download public reference databases
(reference: lib/mmseqs/src/workflow/Databases.cpp +
lib/mmseqs/data/workflow/databases.sh). The download table mirrors the
reference; post-processing uses the native createdb / convertmsa /
msa2profile / createtaxdb commands. Downloads use urllib (the reference
shells out to aria2c/wget) and fail with a clear message without network
access. A file already in <tmpDir> under its URL's basename is used as it
is, and nothing is downloaded.

A copy of the JAX package's cli/tools_databases.py, host code on every
device. Its createdb step runs the port's own command in-process
(cli/tools.py::_invoke) with the caller's --device and stats.
"""
import os

from ..utils.log import logger
from . import params as P
from .app import Command, port_space

# name, description, citation, url, hasTaxonomy, dbtype, downloads,
# input type (Databases.cpp:28-249 + databases.sh:66-260)
_FASTA = "FASTA"
_MSA = "FASTA_MSA"
DATABASES = [
    ("UniRef100", "The UniProt Reference Clusters provide clustered sets of sequences from the UniProt Knowledgebase.",
     "Suzek et al: UniRef: comprehensive and non-redundant UniProt reference clusters. Bioinformatics 23(10), 1282-1288 (2007)",
     "https://www.uniprot.org/help/uniref", True, "Aminoacid", _FASTA,
     ["ftp://ftp.uniprot.org/pub/databases/uniprot/uniref/uniref100/uniref100.fasta.gz"]),
    ("UniRef90", "The UniProt Reference Clusters provide clustered sets of sequences from the UniProt Knowledgebase.",
     "Suzek et al: UniRef: comprehensive and non-redundant UniProt reference clusters. Bioinformatics 23(10), 1282-1288 (2007)",
     "https://www.uniprot.org/help/uniref", True, "Aminoacid", _FASTA,
     ["ftp://ftp.uniprot.org/pub/databases/uniprot/uniref/uniref90/uniref90.fasta.gz"]),
    ("UniRef50", "The UniProt Reference Clusters provide clustered sets of sequences from the UniProt Knowledgebase.",
     "Suzek et al: UniRef: comprehensive and non-redundant UniProt reference clusters. Bioinformatics 23(10), 1282-1288 (2007)",
     "https://www.uniprot.org/help/uniref", True, "Aminoacid", _FASTA,
     ["ftp://ftp.uniprot.org/pub/databases/uniprot/uniref/uniref50/uniref50.fasta.gz"]),
    ("UniProtKB", "The UniProt Knowledgebase is the central hub for the collection of functional information on proteins, with accurate, consistent and rich annotation.",
     "The UniProt Consortium: UniProt: a worldwide hub of protein knowledge. Nucleic Acids Res 47(D1), D506-515 (2019)",
     "https://www.uniprot.org/help/uniprotkb", True, "Aminoacid", _FASTA,
     ["https://ftp.expasy.org/databases/uniprot/current_release/knowledgebase/complete/uniprot_sprot.fasta.gz",
      "https://ftp.expasy.org/databases/uniprot/current_release/knowledgebase/complete/uniprot_trembl.fasta.gz"]),
    ("UniProtKB/TrEMBL", "UniProtKB/TrEMBL (unreviewed) contains protein sequences associated with computationally generated annotation and large-scale functional characterization.",
     "The UniProt Consortium: UniProt: a worldwide hub of protein knowledge. Nucleic Acids Res 47(D1), D506-515 (2019)",
     "https://www.uniprot.org/help/uniprotkb", True, "Aminoacid", _FASTA,
     ["https://ftp.expasy.org/databases/uniprot/current_release/knowledgebase/complete/uniprot_trembl.fasta.gz"]),
    ("UniProtKB/Swiss-Prot", "UniProtKB/Swiss-Prot (reviewed) is a high quality manually annotated and non-redundant protein sequence database.",
     "The UniProt Consortium: UniProt: a worldwide hub of protein knowledge. Nucleic Acids Res 47(D1), D506-515 (2019)",
     "https://uniprot.org", True, "Aminoacid", _FASTA,
     ["https://ftp.expasy.org/databases/uniprot/current_release/knowledgebase/complete/uniprot_sprot.fasta.gz"]),
    ("NR", "Non-redundant protein sequences from GenPept, Swissprot, PIR, PDF, PDB, and NCBI RefSeq.",
     "NCBI Resource Coordinators: Database resources of the National Center for Biotechnology Information. Nucleic Acids Res 46(D1), D8-D13 (2018)",
     "https://ftp.ncbi.nlm.nih.gov/blast/db/FASTA", True, "Aminoacid", _FASTA,
     ["https://ftp.ncbi.nlm.nih.gov/blast/db/FASTA/nr.gz"]),
    ("NT", "Partially non-redundant nucleotide sequences from all traditional divisions of GenBank, EMBL, and DDBJ.",
     "NCBI Resource Coordinators: Database resources of the National Center for Biotechnology Information. Nucleic Acids Res 46(D1), D8-D13 (2018)",
     "https://ftp.ncbi.nlm.nih.gov/blast/db/FASTA", False, "Nucleotide", _FASTA,
     ["https://ftp.ncbi.nlm.nih.gov/blast/db/FASTA/nt.gz"]),
    ("GTDB", "Genome Taxonomy Database is a phylogenetically consistent, genome-based taxonomy.",
     "Parks et al: A complete domain-to-species taxonomy for Bacteria and Archaea. Nat Biotechnol 38(9), 1079-1086 (2020)",
     "https://gtdb.ecogenomic.org", True, "Aminoacid", _FASTA,
     ["https://data.ace.uq.edu.au/public/gtdb/data/releases/latest/genomic_files_reps/gtdb_proteins_aa_reps.tar.gz"]),
    ("PDB", "The Protein Data Bank is the single worldwide archive of structural data of biological macromolecules.",
     "Berman et al: The Protein Data Bank. Nucleic Acids Res 28(1), 235-242 (2000)",
     "https://www.rcsb.org", False, "Aminoacid", _FASTA,
     ["https://ftp.wwpdb.org/pub/pdb/derived_data/pdb_seqres.txt.gz"]),
    ("PDB70", "PDB clustered to 70% sequence identity and enriched using HHblits with Uniclust sequences.",
     "Steinegger et al: HH-suite3 for fast remote homology detection and deep protein annotation. BMC Bioinform 20(1), 473 (2019)",
     "https://github.com/soedinglab/hh-suite", False, "Profile", _MSA,
     ["http://wwwuser.gwdg.de/~compbiol/data/hhsuite/databases/hhsuite_dbs/pdb70_from_mmcif_latest.tar.gz"]),
    ("Pfam-A.full", "The Pfam database is a large collection of protein families, each represented by multiple sequence alignments and hidden Markov models.",
     "El-Gebali and Mistry et al: The Pfam protein families database in 2019. Nucleic Acids Res 47(D1), D427-D432 (2019)",
     "https://pfam.xfam.org", False, "Profile", _MSA,
     ["ftp://ftp.ebi.ac.uk/pub/databases/Pfam/current_release/Pfam-A.full.gz"]),
    ("Pfam-A.seed", "The Pfam database is a large collection of protein families, each represented by multiple sequence alignments and hidden Markov models.",
     "El-Gebali and Mistry et al: The Pfam protein families database in 2019. Nucleic Acids Res 47(D1), D427-D432 (2019)",
     "https://pfam.xfam.org", False, "Profile", _MSA,
     ["ftp://ftp.ebi.ac.uk/pub/databases/Pfam/current_release/Pfam-A.seed.gz"]),
    ("Pfam-B", "The Pfam database is a large collection of protein families, each represented by multiple sequence alignments and hidden Markov models.",
     "El-Gebali and Mistry et al: The Pfam protein families database in 2019. Nucleic Acids Res 47(D1), D427-D432 (2019)",
     "https://pfam.xfam.org", False, "Profile", _MSA,
     ["ftp://ftp.ebi.ac.uk/pub/databases/Pfam/current_release/Pfam-B.tgz"]),
    ("CDD", "Conserved Domain Database is a protein annotation resource of well-annotated MSA models.",
     "Lu et al: CDD/SPARCLE: the conserved domain database in 2020. Nucleic Acids Res 48(D1), D265-D268 (2020)",
     "https://www.ncbi.nlm.nih.gov/Structure/cdd/cdd.shtml", False, "Profile", _MSA,
     ["https://ftp.ncbi.nih.gov/pub/mmdb/cdd/fasta.tar.gz"]),
    ("eggNOG", "eggNOG is a hierarchical, functionally and phylogenetically annotated orthology resource.",
     "Huerta-Cepas et al: eggNOG 5.0: a hierarchical, functionally and phylogenetically annotated orthology resource. Nucleic Acids Res 47(D1), D309-D314 (2019)",
     "http://eggnog5.embl.de", False, "Profile", _MSA,
     ["http://eggnog5.embl.de/download/eggnog_5.0/per_tax_level/2/2_raw_algs.tar"]),
    ("VOGDB", "VOGDB is a continuously updated resource of Virus Orthologous Groups.",
     "Marz et al: Challenges in RNA virus bioinformatics. Bioinformatics 30, 1793-9 (2014)",
     "https://vogdb.org", False, "Profile", _MSA,
     ["http://fileshare.csb.univie.ac.at/vog/latest/vog.raw_algs.tar.gz"]),
    ("dbCAN2", "dbCAN2 is a database of carbohydrate-active enzymes.",
     "Zhang et al: dbCAN2: a meta server for automated carbohydrate-active enzyme annotation. Nucleic Acids Res 46(W1), W95-W101 (2018)",
     "http://bcb.unl.edu/dbCAN2", False, "Profile", _MSA,
     ["http://bcb.unl.edu/dbCAN2/download/dbCAN-fam-aln-V9.tar.gz"]),
    ("Resfinder", "ResFinder identifies acquired antimicrobial resistance genes in total or partial sequenced isolates of bacteria.",
     "Zankari et al: Identification of acquired antimicrobial resistance genes. J Antimicrob Chemother 67(11), 2640-2644 (2012)",
     "https://cge.cbs.dtu.dk/services/ResFinder", False, "Nucleotide", _FASTA,
     ["https://bitbucket.org/genomicepidemiology/resfinder_db/get/master.tar.gz"]),
    ("Kalamari", "Kalamari is a database of complete public assemblies, backed by trusted institutions.",
     "Katz et al: Kalamari: a representative set of genomes of public health concern. (2021)",
     "https://github.com/lskatz/Kalamari", True, "Nucleotide", _FASTA, []),
]


def _databases(positional, space, stats):
    """databases (workflow/Databases.cpp:250-301): list or download."""
    if len(positional) == 0:
        print("  %-22s %-12s %-9s %s" % ("Name", "Type", "Taxonomy", "Url"))
        for (name, _, _, url, tax, dbtype, _, _) in DATABASES:
            print("- %-22s %-12s %-9s %s" %
                  (name, dbtype, "yes" if tax else "-", url))
        return 0
    if len(positional) != 3:
        raise ValueError(
            "usage: databases <name> <o:sequenceDB> <tmpDir>")
    sel = positional[0]
    entry = next((d for d in DATABASES if d[0] == sel), None)
    if entry is None:
        raise ValueError(f"Selected database {sel} was not found")
    name, _, _, _, has_tax, dbtype, input_type, urls = entry
    out_db, tmp = positional[1], positional[2]
    os.makedirs(tmp, exist_ok=True)
    import urllib.request
    files = []
    for url in urls:
        dst = os.path.join(tmp, url.rstrip("/").rsplit("/", 1)[-1])
        if not os.path.exists(dst):
            logger.info("Downloading %s", url)
            try:
                urllib.request.urlretrieve(url, dst)
            except Exception as e:
                raise ValueError(
                    f"databases: download of {url} failed ({e}); "
                    f"download manually into {tmp} and rerun") from e
        files.append(dst)
    from .tools import _invoke
    if input_type == _FASTA:
        # tar archives (GTDB reps, Resfinder master.tar.gz) must be
        # unpacked first — the reference's databases.sh untars before
        # createdb (data/workflow/databases.sh); createdb can't parse tar
        fasta_files = []
        for f in files:
            if f.endswith((".tar.gz", ".tgz", ".tar")):
                import tarfile
                exdir = os.path.join(tmp, "extracted")
                os.makedirs(exdir, exist_ok=True)
                with tarfile.open(f) as tf:
                    for member in tf.getmembers():
                        base = os.path.basename(member.name)
                        if member.isfile() and any(
                                base.endswith(s) for s in
                                (".fa", ".fasta", ".faa", ".fna", ".fa.gz",
                                 ".fasta.gz", ".faa.gz", ".fna.gz")):
                            member.name = base
                            tf.extract(member, exdir)
                            fasta_files.append(os.path.join(exdir, base))
                if not fasta_files:
                    raise ValueError(
                        f"databases: no FASTA files found inside {f}; "
                        f"extract manually and run createdb")
            else:
                fasta_files.append(f)
        _invoke("createdb", [*fasta_files, out_db],
                space.values["device"], stats)
    else:
        raise ValueError(
            f"databases: post-processing for {name} (MSA/profile input) "
            f"requires convertmsa + msa2profile; run them manually on "
            f"{files}")
    if has_tax:
        logger.warning("createtaxdb for %s requires the NCBI taxdump; run "
                       "`createtaxdb %s tmp` after downloading it.",
                       name, out_db)
    return 0


COMMANDS = [
    Command("databases", _databases, lambda: port_space(P.common_flags()),
            "<name> <o:sequenceDB> <tmpDir>",
            "List and download databases", hidden=True),
]
