"""Linear-time search: kmerindexdb, kmersearch, createlinindex, linsearch,
easy-linsearch, indexdb, createindex, clusterupdate and enrich
(reference: lib/mmseqs/src/linclust/{kmerindexdb,kmersearch}.cpp,
workflow/{CreateIndex,Linsearch,EasySearch,ClusterUpdate,Enrich}.cpp,
data/workflow/{createindex,linsearch,easysearch,update_clustering,
enrich}.sh).

A copy of the JAX package's cli/tools_linsearch.py. Each command takes
the port's (positional, space, stats) and the flag list of its JAX
counterpart plus --device; the workflows run their steps through the
port's command table with that device, so kernel B9 scores the candidate
pairs of linsearch's `align` and of the searches of clusterupdate and
enrich on a card. Each step's wall seconds go to stats["seconds"] under
its command's name, the aligner's pair counts to stats["pairs"].
`rescorediagonal` reads its target DB from its second argument, so
linsearch's ungapped filter looks the query keys up in the query DB
(ROADMAP C4; the JAX package looks them up in the index's DB).
"""
import os

from ..data import seqdb
from ..utils.log import logger
from . import params as P
from .app import Command, port_space


def _runner(space, stats):
    """run(name, args): another registered command in-process on this
    command's --device (cli/tools.py::_invoke); its wall seconds and the
    aligner's pair counts go to stats under its name."""
    from .tools import _invoke
    return lambda name, args: _invoke(name, args, space.values["device"],
                                      stats)


def _kmerindexdb(positional, space, stats):
    """kmerindexdb (linclust/kmerindexdb.cpp:18-330)."""
    from ..ops import linsearch as LS
    if len(positional) != 2:
        raise ValueError("usage: kmerindexdb <i:seqDB> <o:indexBase>")
    v = space.values
    was = space.was_set
    db = seqdb.SeqDB.open(positional[0])
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES

    def _alph(x):
        if isinstance(x, P.MultiParam):
            return x.nucleotides if is_nucl else x.aminoacids
        return x

    LS.build_linindex(
        db, positional[1],
        kmer_size=_alph(v["kmer_size"]) if "kmer_size" in was else 0,
        kmers_per_sequence=v["kmers_per_sequence"] if "kmers_per_sequence" in was else 0,
        scale=(_alph(v["kmers_per_sequence_scale"])
               if "kmers_per_sequence_scale" in was else None),
        hash_shift=v.get("hash_shift", 67),
        spaced_kmer=0, mask_mode=0,
        seed_sub_mat=v.get("seed_sub_mat", "VTML80.out"))
    # materialize the embedded DBR1/HDR1/DBR2/HDR2 families
    # (kmerindexdb.cpp:229-310) as plain record DBs beside the payload
    import shutil
    out = LS.index_name(positional[1])

    def _copy(src, dst):
        if not os.path.exists(src + ".dbtype"):
            return
        if os.path.realpath(src) == os.path.realpath(dst):
            return
        for ext in ("", ".index", ".dbtype"):
            shutil.copy(src + ext, dst + ext)

    _copy(positional[0], out + "_seq")
    _copy(positional[0] + "_h", out + "_seq_h")
    if os.path.realpath(positional[0]) != os.path.realpath(positional[1]):
        _copy(positional[1], out + "_src")
        _copy(positional[1] + "_h", out + "_src_h")
    else:
        _copy(positional[0], out + "_src")
        _copy(positional[0] + "_h", out + "_src_h")
    return 0


def _kmersearch(positional, space, stats):
    """kmersearch (linclust/kmersearch.cpp:134-295)."""
    from ..ops import linsearch as LS
    if len(positional) != 3:
        raise ValueError("usage: kmersearch <i:queryDB> <i:indexDB> <o:prefDB>")
    v = space.values
    was = space.was_set
    base = positional[1]
    if base.endswith(LS.INDEX_SUFFIX):
        base = base[: -len(LS.INDEX_SUFFIX)]
    if not os.path.exists(LS.index_name(base) + ".npz"):
        raise ValueError(
            "Create index before calling kmersearch with createlinindex.")
    index = LS.load_linindex(base)
    qdb = seqdb.SeqDB.open(positional[0])
    if (qdb.dbtype == seqdb.NUCLEOTIDES) != \
            (index["seq_type"] == seqdb.NUCLEOTIDES):
        raise ValueError("Dbtype of query and target database do not match!")
    writer = LS.kmersearch(
        qdb, index,
        kmers_per_sequence=v["kmers_per_sequence"] if "kmers_per_sequence" in was else 0,
        hash_shift=v.get("hash_shift", 67),
        result_direction_target=v.get("result_direction", 1) == 1,
        seed_sub_mat=v.get("seed_sub_mat", "VTML80.out"))
    writer.save(positional[2])
    return 0


def _createlinindex(positional, space, stats):
    """createlinindex (workflow/CreateIndex.cpp:64-104 +
    data/workflow/createindex.sh)."""
    run = _runner(space, stats)
    if len(positional) != 2:
        raise ValueError("usage: createlinindex <i:seqDB> <tmpDir>")
    db_path = positional[0]
    tmp = positional[1]
    os.makedirs(tmp, exist_ok=True)
    dbtype = seqdb.read_dbtype(db_path)
    search_type = space.values.get("search_type", 0)
    # createlinindex serializes the kmerindexdb list with the GLOBAL
    # defaults (--kmer-per-seq 21), not setLinearFilterDefault's 0
    # (CreateIndex.cpp:48-52, Parameters.cpp:2332)
    extra = ["--seed-sub-mat", "blosum62.out", "--kmer-per-seq",
             space.values.get("kmers_per_sequence", 21)
             if "kmers_per_sequence" in space.was_set else 21]
    if "kmer_size" in space.was_set:
        extra += ["-k", space.values["kmer_size"].aminoacids
                  if isinstance(space.values["kmer_size"], P.MultiParam)
                  else space.values["kmer_size"]]
    if dbtype == seqdb.NUCLEOTIDES:
        if search_type == 0:
            logger.warning(
                "Database %s is a nucleotide database. Please provide the "
                "parameter --search-type 2 (translated) or 3 (nucleotide)",
                db_path)
            return 1
        if search_type in (2, 4):  # translated
            orfs = os.path.join(tmp, "orfs_aa")
            if not os.path.exists(orfs + ".dbtype"):
                run("extractorfs", [db_path, orfs, "--orf-start-mode", 1,
                                    "--min-length", 30,
                                    "--max-length", 32734])
                run("translatenucs", [orfs, orfs + "_trans"])
                orfs = orfs + "_trans"
            run("kmerindexdb", [orfs, db_path, *extra])
        else:  # nucleotide (search-type 3)
            split = os.path.join(tmp, "nucl_split_seq")
            if not os.path.exists(split + ".dbtype"):
                run("splitsequence", [db_path, split,
                                      "--max-seq-len", 10000,
                                      "--sequence-overlap", 0])
            run("kmerindexdb", [split, db_path, *extra])
    else:
        run("kmerindexdb", [db_path, db_path, *extra])
    return 0


def _linsearch(positional, space, stats):
    """linsearch (workflow/Linsearch.cpp:34-156 +
    data/workflow/linsearch.sh): kmersearch -> strict ungapped-coverage
    filter -> gapped alignment (target-centric) -> swap to query-centric;
    nucleotide pairs merge the ungapped alignments back in and offset
    coordinates."""
    run = _runner(space, stats)
    from ..ops import linsearch as LS
    if len(positional) != 4:
        raise ValueError(
            "usage: linsearch <i:queryDB> <i:targetDB> <o:alnDB> <tmpDir>")
    query, target, out, tmp = positional
    v = space.values
    was = space.was_set
    os.makedirs(tmp, exist_ok=True)
    if os.path.exists(out + ".dbtype"):
        raise ValueError(f"{out}.dbtype exists already!")
    if not LS.search_for_index(target):
        raise ValueError(f"{target} needs to be index. createlinindex "
                         f"{target}.")
    qtype = seqdb.read_dbtype(query)
    index = LS.load_linindex(target)
    is_nucl = (qtype == seqdb.NUCLEOTIDES
               and index["seq_type"] == seqdb.NUCLEOTIDES)
    if qtype == seqdb.NUCLEOTIDES and not is_nucl:
        raise ValueError("translated linsearch is not supported yet")

    eval_thr = v["eval_thr"] if "eval_thr" in was else 0.001
    cov_mode = v["cov_mode"] if "cov_mode" in was else 2  # COV_MODE_TARGET
    cov_thr = max(v.get("cov_thr", 0.0), 0.9)
    pref = os.path.join(tmp, "pref")
    if not os.path.exists(pref + ".dbtype"):
        run("kmersearch", [query, LS.index_name(target), pref,
                           "--seed-sub-mat", "blosum62.out",
                           "--kmer-per-seq", 21])

    # strict ungapped filter (Linsearch.cpp:115-126)
    def _aa(x):
        return x.aminoacids if isinstance(x, P.MultiParam) else x

    seq_id_thr = _aa(v["min_seq_id"]) if "min_seq_id" in was else 0.0
    tgt = LS.index_name(target)
    rev_ungap = os.path.join(tmp, "reverse_ungapaln")
    if not os.path.exists(rev_ungap + ".dbtype"):
        # RESCORE_FILTER_PAR serializes the full rescorediagonal list with
        # linsearch values (Linsearch.cpp:115-126): RESCORE_MODE_ALIGNMENT,
        # cov-mode target, cov >= 0.9, base defaults otherwise
        run("rescorediagonal",
            [tgt, query, pref, rev_ungap, "--rescore-mode", 2,
             "--cov-mode", cov_mode, "-c", cov_thr, "-e", eval_thr,
             "--min-seq-id", seq_id_thr, "--min-aln-len", 0])
    pref_filter = os.path.join(tmp, "pref_filter")
    if not os.path.exists(pref_filter + ".dbtype"):
        run("filterdb", [pref, pref_filter, "--filter-file", rev_ungap,
                         "--positive-filter", 0])
    # gapped alignment, target-centric, eval gate pushed to 100000
    # (Linsearch.cpp:130-133)
    rev_aln = os.path.join(tmp, "reverse_aln")
    if not os.path.exists(rev_aln + ".dbtype"):
        aln_args = [tgt, query, pref_filter, rev_aln, "-e", 100000, "-a",
                    "--min-seq-id", seq_id_thr, "--min-aln-len", 0]
        if "cov_thr" in was:
            aln_args += ["-c", v["cov_thr"]]
        if "cov_mode" in was:
            aln_args += ["--cov-mode", v["cov_mode"]]
        if "alignment_mode" in was:
            aln_args += ["--alignment-mode", v["alignment_mode"]]
        run("align", aln_args)
    if is_nucl:
        aln = os.path.join(tmp, "aln")
        if not os.path.exists(aln + ".dbtype"):
            run("swapresults", [tgt, query, rev_aln, aln,
                                "-e", eval_thr])
        ungap_aln = os.path.join(tmp, "ungap_aln")
        if not os.path.exists(ungap_aln + ".dbtype"):
            run("swapresults", [tgt, query, rev_ungap, ungap_aln])
        merged = os.path.join(tmp, "aln_merged")
        if not os.path.exists(merged + ".dbtype"):
            run("concatdbs", [ungap_aln, aln, merged, "--preserve-keys",
                              "--take-larger-entry"])
        run("offsetalignment", [query, query, tgt, tgt, merged,
                                out])
    else:
        run("swapresults", [tgt, query, rev_aln, out,
                            "-e", eval_thr])
    return 0


def _easy_linsearch(positional, space, stats):
    """easy-linsearch (workflow/EasySearch.cpp linsearch variant +
    data/workflow/easysearch.sh)."""
    run = _runner(space, stats)
    from ..data.createdb import create_db
    if len(positional) != 4:
        raise ValueError("usage: easy-linsearch <i:queryFasta> "
                         "<i:targetFasta> <o:tsv> <tmpDir>")
    if "alignment_mode" not in space.was_set:
        space.values["alignment_mode"] = 3
        space.was_set.add("alignment_mode")
    tmp = positional[3]
    os.makedirs(tmp, exist_ok=True)
    qpath = os.path.join(tmp, "query")
    tpath = os.path.join(tmp, "target")
    for fasta, path in ((positional[0], qpath), (positional[1], tpath)):
        if not os.path.exists(path + ".dbtype"):
            sdb, hdb = create_db([fasta])
            sdb.save(path)
            hdb.save(path + "_h")
    from ..ops import linsearch as LS
    if not LS.search_for_index(tpath):
        run("createlinindex", [tpath, os.path.join(tmp, "index_tmp")])
    res = os.path.join(tmp, "result")
    if not os.path.exists(res + ".dbtype"):
        _linsearch([qpath, tpath, res, os.path.join(tmp, "linsearch_tmp")],
                   space, stats)
    from .tools import _convertalis
    return _convertalis([qpath, tpath, res, positional[2]], space, stats)


COMMANDS = [
    Command("kmerindexdb", _kmerindexdb, lambda: port_space(
        P.common_flags() + P.kmermatcher_flags() + [
            P.Flag("--seed-sub-mat", "seed_sub_mat", str, "VTML80.out",
                   "Substitution matrix for k-mer generation")]),
            "<i:seqDB> <o:indexBase>",
            "Create a sorted k-mer index for linsearch", hidden=True),
    Command("kmersearch", _kmersearch, lambda: port_space(
        P.common_flags() + P.kmermatcher_flags() + [
            P.Flag("--seed-sub-mat", "seed_sub_mat", str, "VTML80.out",
                   "Substitution matrix for k-mer generation"),
            P.Flag("--result-direction", "result_direction", int, 1,
                   "result is 0: query, 1: target centric", r"[0-1]")]),
            "<i:queryDB> <i:indexDB> <o:prefDB>",
            "Match k-mers against a linsearch index", hidden=True),
    Command("createlinindex", _createlinindex, lambda: port_space(
        P.common_flags() + P.kmermatcher_flags() + [
            P.Flag("--search-type", "search_type", int, 0,
                   "0 auto, 2 translated, 3 nucleotide, 4 translated "
                   "nucl align", r"[0-4]")]),
            "<i:seqDB> <tmpDir>",
            "Create a linsearch index", hidden=True),
    Command("linsearch", _linsearch, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--search-type", "search_type", int, 0,
                   "0 auto, 2 translated, 3 nucleotide", r"[0-4]")]),
            "<i:queryDB> <i:targetDB> <o:alnDB> <tmpDir>",
            "Linear-time sequence search", hidden=True),
    Command("easy-linsearch", _easy_linsearch, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--search-type", "search_type", int, 0,
                   "0 auto, 2 translated, 3 nucleotide", r"[0-4]")]),
            "<i:queryFasta> <i:targetFasta> <o:tsv> <tmpDir>",
            "Linear-time search from FASTA input", hidden=True),
]


def _indexdb(positional, space, stats):
    """indexdb (util/indexdb.cpp:42-155): precompute the sensitive
    prefilter's inverted k-mer index + masked target sequences into
    <target>.idx (TPU-native payload; `search` auto-detects it)."""
    from ..ops import prefilter as pf
    from .. import constants
    if len(positional) != 2:
        raise ValueError("usage: indexdb <i:seqDB> <o:indexBase>")
    v = space.values
    was = space.was_set
    db = seqdb.SeqDB.open(positional[0])
    if db.dbtype != seqdb.AMINO_ACIDS:
        raise ValueError("indexdb: only amino-acid databases are supported")
    sens = v["sensitivity"] if "sensitivity" in was else 5.7
    k = (v["kmer_size"].aminoacids
         if isinstance(v.get("kmer_size"), P.MultiParam)
         else v.get("kmer_size", 0)) if "kmer_size" in was else 0
    k = k or pf.auto_kmer_size(db.total_residues())
    mask = v.get("search_mask", v.get("mask_mode", 1))
    spaced = bool(v.get("search_spaced_kmer", v.get("spaced_kmer", 1)))
    thr = pf.kmer_threshold(sens, k)
    seed = constants.vtml80_8()
    index = pf.KmerIndex(db, k, thr, seed, spaced, mask)
    pf.save_prefilter_index(index, positional[1], thr, mask, spaced,
                            db.dbtype)
    return 0


def _createindex(positional, space, stats):
    """createindex (workflow/CreateIndex.cpp:105-180 + createindex.sh),
    indexer = indexdb."""
    run = _runner(space, stats)
    if len(positional) != 2:
        raise ValueError("usage: createindex <i:seqDB> <tmpDir>")
    db_path, tmp = positional
    os.makedirs(tmp, exist_ok=True)
    dbtype = seqdb.read_dbtype(db_path)
    search_type = space.values.get("search_type", 0)
    extra = []
    for flag, attr in (("-s", "sensitivity"), ("-k", "kmer_size"),
                       ("--mask", "search_mask")):
        if attr in space.was_set:
            val = space.values[attr]
            if isinstance(val, P.MultiParam):
                val = val.aminoacids
            extra += [flag, val]
    if dbtype == seqdb.NUCLEOTIDES:
        if search_type == 0:
            logger.warning(
                "Database %s is a nucleotide database. Please provide the "
                "parameter --search-type 2 (translated) or 3 (nucleotide)",
                db_path)
            return 1
        if search_type in (2, 4):
            orfs = os.path.join(tmp, "orfs_aa")
            if not os.path.exists(orfs + "_trans.dbtype"):
                run("extractorfs", [db_path, orfs, "--orf-start-mode", 1,
                                    "--min-length", 30,
                                    "--max-length", 32734])
                run("translatenucs", [orfs, orfs + "_trans"])
            run("indexdb", [orfs + "_trans", db_path, *extra])
        else:
            raise ValueError("createindex: nucleotide search indexes are "
                             "not supported yet (use --search-type 2)")
    else:
        run("indexdb", [db_path, db_path, *extra])
    return 0


COMMANDS.extend([
    Command("indexdb", _indexdb, lambda: port_space(
        P.common_flags() + P.search_flags()),
            "<i:seqDB> <o:indexBase>",
            "Precompute the prefilter index table", hidden=True),
    Command("createindex", _createindex, lambda: port_space(
        P.common_flags() + P.search_flags() + [
            P.Flag("--search-type", "search_type", int, 0,
                   "0 auto, 2 translated, 3 nucleotide", r"[0-4]")]),
            "<i:seqDB> <tmpDir>",
            "Precompute an index for faster searches", hidden=True),
])


def _clusterupdate(positional, space, stats):
    """clusterupdate (workflow/ClusterUpdate.cpp:19-90 +
    data/workflow/update_clustering.sh): update an old clustering with a
    new sequence DB — map common sequences to old keys, drop (or recover)
    removed ones, assign new sequences to old representatives with
    --max-accept 1, cluster the leftovers separately, merge."""
    run = _runner(space, stats)
    import numpy as np
    if len(positional) != 6:
        raise ValueError(
            "usage: clusterupdate <i:oldSeqDB> <i:newSeqDB> <i:oldClustDB> "
            "<o:newMappedSeqDB> <o:newClustDB> <tmpDir>")
    old_db, new_db, old_clust, new_map_db, new_clust, tmp = positional
    v = space.values
    was = space.was_set
    os.makedirs(tmp, exist_ok=True)
    if os.path.exists(new_clust + ".dbtype"):
        raise ValueError(f"{new_clust}.dbtype exists already!")
    recover = bool(v.get("recover_deleted", False))

    def t(name):
        return os.path.join(tmp, name)

    if not os.path.exists(t("newSeqs")):
        run("diffseqdbs", [old_db, new_db, t("removedSeqs"),
                           t("mappingSeqs"), t("newSeqs")])
    if os.path.getsize(t("mappingSeqs")) == 0:
        logger.warning("There are no common sequences between %s and %s.",
                       old_db, new_db)
        return 1

    def _max_key(*index_files):
        m = 0
        for f in index_files:
            for line in open(f):
                k = int(line.split("\t", 1)[0])
                m = max(m, k)
        return m

    if os.path.getsize(t("removedSeqs")) > 0:
        if recover:
            highest = _max_key(new_db + ".index")
            with open(t("OLDDB.removedMapping"), "w") as out, \
                    open(t("removedSeqs")) as fh:
                start = highest + 1
                mapping_extra = []
                for line in fh:
                    key = line.split()[0]
                    out.write(f"{key}\t{start}\n")
                    mapping_extra.append(f"{key}\t{start}\n")
                    start += 1
            with open(t("mappingSeqs"), "a") as fh:
                fh.writelines(mapping_extra)
            run("renamedbkeys", [t("OLDDB.removedMapping"), old_db,
                                 t("OLDDB.removedDb"),
                                 "--subdb-mode", 1])
            run("concatdbs", [new_db, t("OLDDB.removedDb"),
                              t("NEWDB.withOld"), "--preserve-keys"])
            run("concatdbs", [new_db + "_h", t("OLDDB.removedDb") + "_h",
                              t("NEWDB.withOld") + "_h",
                              "--preserve-keys"])
            new_db = t("NEWDB.withOld")
        else:
            run("createsubdb", [t("mappingSeqs"), old_clust,
                                t("OLCLUST.withoutDeletedKeys"),
                                "--subdb-mode", 1])
            run("filterdb", [t("OLCLUST.withoutDeletedKeys"),
                             t("OLCLUST.withoutDeleted"),
                             "--filter-file", t("removedSeqs"),
                             "--positive-filter", 0])
            old_clust = t("OLCLUST.withoutDeleted")

    # remap new DB: common sequences get old keys, new ones fresh keys
    max_id = _max_key(old_db + ".index", new_db + ".index")
    new_seq_keys = [line.split()[0] for line in open(t("newSeqs"))
                    if line.strip()]
    with open(t("newMappingSeqs"), "w") as out:
        for line in open(t("mappingSeqs")):
            parts = line.split()
            if len(parts) >= 2:
                out.write(f"{parts[1]}\t{parts[0]}\n")
        start = max_id + 1
        mapped_new = []
        for key in new_seq_keys:
            out.write(f"{key}\t{start}\n")
            mapped_new.append(start)
            start += 1
    with open(t("newSeqs"), "w") as out:
        out.writelines(f"{k}\n" for k in mapped_new)

    if not os.path.exists(new_map_db + ".dbtype"):
        run("renamedbkeys", [t("newMappingSeqs"), new_db, new_map_db])
    new_db = new_map_db

    run("createsubdb", [t("newSeqs"), new_db, t("NEWDB.newSeqs"),
                        "--subdb-mode", 1])
    run("result2repseq", [old_db, old_clust, t("OLDDB.repSeq")])

    search_args = [t("NEWDB.newSeqs"), t("OLDDB.repSeq"), t("newSeqsHits"),
                   t("search"), "--max-accept", 1, "--alignment-mode", 3]
    for flag, attr in (("--min-seq-id", "min_seq_id"), ("-c", "cov_thr"),
                       ("--cov-mode", "cov_mode"), ("-e", "eval_thr"),
                       ("-s", "sensitivity")):
        if attr in was:
            val = v[attr]
            if isinstance(val, P.MultiParam):
                val = val.aminoacids
            search_args += [flag, val]
    run("search", search_args)
    run("swapdb", [t("newSeqsHits"), t("newSeqsHits.swapped.all")])

    has_hits = any(int(line.split("\t")[2]) > 1
                   for line in open(t("newSeqsHits.swapped.all") + ".index"))
    updated_clust = old_clust
    if has_hits:
        run("filterdb", [t("newSeqsHits.swapped.all"),
                         t("newSeqsHits.swapped"),
                         "--trim-to-one-column"])
        run("mergedbs", [old_clust, t("updatedClust"), old_clust,
                         t("newSeqsHits.swapped")])
        updated_clust = t("updatedClust")

    with open(t("noHitSeqList"), "w") as out:
        for line in open(t("newSeqsHits") + ".index"):
            parts = line.split("\t")
            if int(parts[2]) == 1:
                out.write(parts[0] + "\n")
    run("createsubdb", [t("noHitSeqList"), new_db,
                        t("toBeClusteredSeparately"), "--subdb-mode", 1])

    clustered_new = False
    if os.path.getsize(t("toBeClusteredSeparately") + ".index") > 0:
        clust_args = [t("toBeClusteredSeparately"), t("newClusters"),
                      t("cluster")]
        for flag, attr in (("--min-seq-id", "min_seq_id"), ("-c", "cov_thr"),
                           ("--cov-mode", "cov_mode"), ("-e", "eval_thr"),
                           ("-s", "sensitivity")):
            if attr in was:
                val = v[attr]
                if isinstance(val, P.MultiParam):
                    val = val.aminoacids
                clust_args += [flag, val]
        run("cluster", clust_args)
        clustered_new = os.path.exists(t("newClusters") + ".dbtype")
    if clustered_new:
        run("concatdbs", [updated_clust, t("newClusters"), new_clust,
                          "--preserve-keys"])
    else:
        run("mvdb", [updated_clust, new_clust])
    return 0


COMMANDS.append(
    Command("clusterupdate", _clusterupdate, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--recover-deleted", "recover_deleted", bool, False,
                   "Include deleted sequences with fresh keys")]),
            "<i:oldSeqDB> <i:newSeqDB> <i:oldClustDB> <o:newMappedSeqDB> "
            "<o:newClustDB> <tmpDir>",
            "Update clustering of an evolving sequence DB", hidden=True))


def _enrich(positional, space, stats):
    """enrich (workflow/Enrich.cpp:16-90 + data/workflow/enrich.sh):
    iterative profile-boosted enrichment — exhaustive search against the
    target profiles, then NUM_IT rounds of profile-query prefilter/align
    against the profile consensus sequences with expandaln through the
    profiles' own search results.

    Note: the reference binary's enrich is broken as shipped — Enrich.cpp
    registers a 4-path validator but enrich.sh consumes 6 arguments, so
    every invocation dies with "Too many input paths" / "Cannot create
    temporary folder". This implementation follows the enrich.sh data
    flow, which is the documented intent."""
    run = _runner(space, stats)
    if len(positional) != 6:
        raise ValueError(
            "usage: enrich <i:queryDB> <i:profTargetSeqDB> <i:targetProfDB> "
            "<i:profResultDB> <o:alnDB> <tmpDir>")
    query, prof_target_seq, target_prof, prof_result, out, tmp = positional
    v = space.values
    was = space.was_set
    os.makedirs(tmp, exist_ok=True)
    if os.path.exists(out + ".dbtype"):
        raise ValueError(f"{out}.dbtype exists already!")
    num_it = v["num_iterations"] if "num_iterations" in was else 3
    if isinstance(num_it, P.MultiParam):
        num_it = num_it.aminoacids
    eval_thr = v["eval_thr"] if "eval_thr" in was else 0.001
    eval_profile = v.get("eval_profile", 0.1)

    def t(name):
        return os.path.join(tmp, name)

    # exhaustive search against the target profiles (PROF_SEARCH_PAR:
    # numIterations=1, exhaustiveSearch=true, addBacktrace=true)
    if not os.path.exists(t("search_slice") + ".dbtype"):
        run("search", [query, target_prof, t("search_slice"),
                       t("slice_tmp"), "--exhaustive-search", "-a",
                       "-e", eval_thr])
    if not os.path.exists(t("prof_slice") + ".dbtype"):
        # PROF_PROF_PAR carries the GLOBAL --pca 1.0, overriding
        # result2profile's own 0.0 default (Enrich.cpp:45)
        run("result2profile", [query, target_prof, t("search_slice"),
                               t("prof_slice"), "--pca", 1.0,
                               "-e", eval_thr])

    inp = t("prof_slice")
    # enrich.sh searches against "${TARGET_PROF}_consensus"; result2profile
    # does not produce it, so generate one into tmp when absent
    consensus = target_prof + "_consensus"
    if not os.path.exists(consensus + ".dbtype"):
        consensus = t("prof_consensus")
        if not os.path.exists(consensus + ".dbtype"):
            run("profile2consensus", [target_prof, consensus])
    for step in range(num_it):
        ev = eval_thr if step == num_it - 1 else min(eval_thr, eval_profile)
        pref = t(f"pref_{step}")
        if not os.path.exists(pref + ".dbtype"):
            run("prefilter", [inp, consensus, pref])
        if step >= 1:
            run("subtractdbs", [pref, t("aln_0"), t(f"pref_next_{step}"),
                                "-e", eval_thr,
                                "--e-profile", eval_profile])
            for ext in ("", ".index", ".dbtype"):
                os.replace(t(f"pref_next_{step}") + ext, pref + ext)
        aln = t(f"aln_{step}")
        if not os.path.exists(aln + ".dbtype"):
            run("align", [inp, consensus, pref, aln, "-e", ev, "-a"])
        # expand the profile-consensus hits through the profiles' own
        # search results
        run("expandaln", [inp, prof_target_seq, aln, prof_result,
                          t(f"aln_exp_{step}")])
        for ext in ("", ".index", ".dbtype"):
            os.replace(t(f"aln_exp_{step}") + ext, aln + ext)
        if step > 0:
            run("mergedbs", [inp, t("aln_new"), t("aln_0"), aln])
            for ext in ("", ".index", ".dbtype"):
                os.replace(t("aln_new") + ext, t("aln_0") + ext)
        if step - 1 != num_it:
            profdb = t(f"profile_{step}")
            if not os.path.exists(profdb + ".dbtype"):
                run("result2profile", [query, prof_target_seq, t("aln_0"),
                                       profdb, "--pca", 1.0,
                                       "-e", eval_thr])
            inp = profdb
    for ext in ("", ".index", ".dbtype"):
        os.replace(t("aln_0") + ext, out + ext)
    return 0


COMMANDS.append(
    Command("enrich", _enrich, lambda: port_space(
        P.common_flags() + P.search_flags() + P.align_flags() + [
            P.Flag("--num-iterations", "num_iterations", int, 3,
                   "Number of enrichment iterations"),
            P.Flag("--e-profile", "eval_profile", float, 0.1,
                   "Include sequences matching below this E-value in the "
                   "profile")]),
            "<i:queryDB> <i:profTargetSeqDB> <i:targetProfDB> "
            "<i:profResultDB> <o:alnDB> <tmpDir>",
            "Boost diversity of search result", hidden=True))
