"""Profile / MSA tools (reference: lib/mmseqs/src/util/result2profile.cpp,
result2msa.cpp, msa2profile.cpp, profile2pssm.cpp, profile2seq.cpp,
convertprofiledb.cpp).

A copy of the JAX package's cli/tools_profile.py: host code on every
device. Each command takes the port's (positional, space, stats) and the
flag list of its JAX counterpart plus --device.
"""
import os

import numpy as np

from .. import constants
from ..data import seqdb
from ..utils.log import logger
from . import params as P
from .app import Command, port_space

EVAL_PROFILE_DEFAULT = 0.1  # Parameters.cpp evalProfile default


def _parse_aln_line(line):
    from ..ops.msa import expand_cigar
    f = line.split("\t")
    return {
        "dbKey": int(f[0]), "score": int(f[1]), "seqId": float(f[2]),
        "eval": float(f[3]), "qStartPos": int(f[4]), "qEndPos": int(f[5]),
        "qLen": int(f[6]), "dbStartPos": int(f[7]), "dbEndPos": int(f[8]),
        "dbLen": int(f[9]),
        "backtrace": expand_cigar(f[10]) if len(f) > 10 else "",
        "raw": line,
    }


def _collect_msa_inputs(qdb, tdb, rdb, i, same_db, eval_profile, mat,
                        recompute_missing_bt=True):
    """Shared result2profile/result2msa record loop: returns (center_num,
    edge_seqs, alns). Hits >= evalProfile are skipped (result2profile.cpp
    only; result2msa keeps all — pass eval_profile=None)."""
    qkey = int(rdb.keys[i])
    qid = qdb.key_to_id(qkey)
    center = mat.aa2num[qdb.get_seq(qid)]
    edge_seqs = []
    alns = []
    aligner = None
    for line in rdb.get_data(i).tobytes().decode().split("\n"):
        if not line:
            continue
        r = _parse_aln_line(line)
        if r["dbKey"] == qkey and same_db:
            continue
        if eval_profile is not None and not (r["eval"] < eval_profile):
            continue
        tid = tdb.key_to_id(r["dbKey"])
        if tid is None:
            raise ValueError(f"Sequence {r['dbKey']} does not exist in "
                             "target sequence database")
        if tdb.dbtype == seqdb.HMM_PROFILE:
            # profile targets contribute their stored query residues
            # (Sequence::mapProfile numSequence, result2profile.cpp:144)
            raw = np.asarray(tdb.get_data(tid))
            tnum = raw.reshape(-1, 23)[:, 20].copy()
        else:
            tnum = mat.aa2num[tdb.get_seq(tid)]
        if not r["backtrace"] and recompute_missing_bt:
            # Matcher::getSWResult recompute (result2profile.cpp:200-207):
            # SubstitutionMatrix(2.0, -0.2) striped SW with backtrace
            if aligner is None:
                from ..ops.protein_align import ProteinAligner
                from ..ops.evalue import EvalueComputer
                from .. import constants
                aligner = ProteinAligner(constants.blosum62_pref())
                aligner.init_query(center)
                evaluer = EvalueComputer.for_matrix(
                    "blosum62_11_1", tdb.total_residues())
                aligner._evaluer = evaluer
            res = aligner.ssw_align(tnum, 11, 1, 2, float("inf"),
                                    aligner._evaluer, 0, 0.0,
                                    max(len(center) // 2, 15))
            r["qStartPos"] = res["qStart"]
            r["dbStartPos"] = res["dbStart"]
            r["backtrace"] = res.get("cigar") or ""
        edge_seqs.append(tnum)
        alns.append(r)
    return center, edge_seqs, alns


def _qid_vec(space):
    qid = space.values.get("qid", "0.0")
    return sorted(int(float(s) * 100) for s in str(qid).split(","))


def _result2profile(positional, space, return_aln=False):
    """result2profile / filterresult (result2profile.cpp:17-291)."""
    from .. import constants
    from ..ops import msa as MSA
    if len(positional) != 4:
        raise ValueError("usage: result2profile <i:qDB> <i:tDB> <i:resDB> <o:db>")
    v = space.values
    mat = constants.blosum62()
    eval_thr = v.get("eval_thr", 0.001)
    eval_profile = v.get("eval_profile", EVAL_PROFILE_DEFAULT)
    if eval_thr < eval_profile or return_aln:
        eval_profile = eval_thr
    filter_msa = v.get("filter_msa", 1)
    is_filtering = filter_msa != 0 or return_aln
    same_db = positional[0] == positional[1]
    qdb = seqdb.SeqDB.open(positional[0])
    tdb = qdb if same_db else seqdb.SeqDB.open(positional[1])
    rdb = seqdb.SeqDB.open(positional[2])
    writer = seqdb.DBWriter(
        seqdb.ALIGNMENT_RES if return_aln else seqdb.HMM_PROFILE)
    for i in seqdb.data_order(rdb):
        i = int(i)
        qkey = int(rdb.keys[i])
        if qdb.key_to_id(qkey) is None:
            logger.warning("Invalid query sequence %s", qkey)
            continue
        center, edge_seqs, alns = _collect_msa_inputs(
            qdb, tdb, rdb, i, same_db, eval_profile, mat)
        msa, center_len = MSA.compute_msa(center, edge_seqs, alns,
                                          no_deletion=True)
        if is_filtering:
            keep, filtered_size = MSA.msa_filter(
                msa, center_len, coverage=int(v.get("cov_msa_thr", 0.0) * 100),
                qid_vec=_qid_vec(space), qsc=v.get("qsc", -20.0),
                max_seqid=int(v.get("filter_max_seq_id", 0.9) * 100),
                ndiff=v.get("filter_ndiff", 1000),
                filter_min_enable=v.get("filter_min_enable", 0),
                gap_open=v.get("gap_open", 11), gap_extend=v.get("gap_extend", 1))
            # MsaFilter::shuffleSequences compacts kept rows in order
            kept_rows = [k for k in range(msa.shape[0]) if keep[k] != 0]
            msa = msa[kept_rows]
            alns = [alns[k - 1] for k in kept_rows[1:]]
            set_size = filtered_size
        else:
            set_size = msa.shape[0]
        if return_aln:
            from ..ops.rescore import format_seq_id
            out = []
            for r in alns[:set_size - 1]:
                f = r["raw"].split("\t")
                bt = f[10] if len(f) > 10 else f"{len(r['backtrace'])}M"
                out.append("\t".join(f[:10]) + f"\t{bt}\n")
            writer.write(qkey, "".join(out).encode(), add_newline=False)
        else:
            res = MSA.compute_pssm(msa[:set_size], center_len,
                                   wg=bool(v.get("wg", False)),
                                   pca=v.get("pca", 0.0), pcb=v.get("pcb", 1.5))
            if v.get("mask_profile", 1):
                MSA.mask_profile(center, res)
            writer.write(qkey, MSA.profile_record(center, res),
                         add_newline=False)
    writer.finish().save(positional[3])
    return 0


def _result2profile_cmd(positional, space, stats):
    return _result2profile(positional, space, return_aln=False)


def _filterresult(positional, space, stats):
    return _result2profile(positional, space, return_aln=True)


def _msa_format_rows(msa, center_len, mat):
    rows = []
    for k in range(msa.shape[0]):
        row = msa[k, :center_len]
        rows.append("".join(mat.letters[c] if c < 20 else "-" for c in row))
    return rows


def _result2msa(positional, space, stats):
    """result2msa (result2msa.cpp): FASTA-MSA / A3M / STOCKHOLM formats."""
    from .. import constants
    from ..data.headers import parse_fasta_header
    from ..ops import msa as MSA
    if len(positional) != 4:
        raise ValueError("usage: result2msa <i:qDB> <i:tDB> <i:resDB> <o:msaDB>")
    v = space.values
    mat = constants.blosum62()
    fmt = v.get("msa_format_mode", 2)
    filter_msa = v.get("filter_msa", 0)  # result2msa default: no filter
    skip_query = v.get("skip_query", False)
    same_db = positional[0] == positional[1]
    qdb = seqdb.SeqDB.open(positional[0])
    qhdr = seqdb.SeqDB.open(positional[0] + "_h")
    tdb = qdb if same_db else seqdb.SeqDB.open(positional[1])
    thdr = qhdr if same_db else seqdb.SeqDB.open(positional[1] + "_h")
    rdb = seqdb.SeqDB.open(positional[2])
    is_stockholm = fmt == 4
    writer = seqdb.DBWriter(seqdb.MSA_DB)
    chunks = []
    for i in seqdb.data_order(rdb):
        i = int(i)
        qkey = int(rdb.keys[i])
        if qdb.key_to_id(qkey) is None:
            logger.warning("Invalid query sequence %s", qkey)
            continue
        center, edge_seqs, alns = _collect_msa_inputs(
            qdb, tdb, rdb, i, same_db, None, mat)
        msa, center_len = MSA.compute_msa(
            center, edge_seqs, alns,
            no_deletion=not v.get("allow_deletion", False))
        kept = np.ones(msa.shape[0], dtype=bool)
        if filter_msa != 0:
            keep, _ = MSA.msa_filter(
                msa, center_len, coverage=int(v.get("cov_msa_thr", 0.0) * 100),
                qid_vec=_qid_vec(space), qsc=v.get("qsc", -20.0),
                max_seqid=int(v.get("filter_max_seq_id", 0.9) * 100),
                ndiff=v.get("filter_ndiff", 1000),
                filter_min_enable=v.get("filter_min_enable", 0))
            kept = keep != 0
        headers = [qhdr.get_data(qhdr.key_to_id(qkey)).tobytes().decode()]
        for r in alns:
            headers.append(
                thdr.get_data(thdr.key_to_id(r["dbKey"])).tobytes().decode())
        result = []
        start = 1 if skip_query else 0
        rows = _msa_format_rows(msa, center_len, mat)
        if fmt in (1, 2):  # FASTADB(+SUMMARY)
            for k in range(start, msa.shape[0]):
                if not kept[k]:
                    continue
                result.append(">" + headers[k].rstrip("\n") + "\n")
                result.append(rows[k] + "\n")
        elif fmt == 4:  # STOCKHOLM_FLAT
            result.append("# STOCKHOLM 1.0\n")
            if skip_query:
                result.append("#=GF ID " +
                              parse_fasta_header(headers[0]) + "\n")
            for k in range(start, msa.shape[0]):
                if not kept[k]:
                    continue
                result.append(parse_fasta_header(headers[k]) + " " + rows[k] + "\n")
            result.append("//\n")
        elif fmt == 5:  # A3M
            for k in range(start, msa.shape[0]):
                if not kept[k]:
                    continue
                result.append(">" + parse_fasta_header(headers[k]) + "\n")
                if k == 0:
                    result.append(rows[k] + "\n")
                else:
                    seq = edge_seqs[k - 1]
                    r = alns[k - 1]
                    bt = r["backtrace"]
                    out = []
                    seq_pos = 0
                    bt_pos = 0
                    for pos in range(center_len):
                        aa = int(msa[k, pos])
                        if aa >= MSA.GAP:
                            out.append("-")
                        else:
                            out.append(mat.letters[aa])
                            bt_pos += 1
                            seq_pos += 1
                        while bt_pos < len(bt) and bt[bt_pos] == "I":
                            bt_pos += 1
                        while bt_pos < len(bt) and bt[bt_pos] == "D":
                            out.append(mat.letters[
                                seq[r["dbStartPos"] + seq_pos]].lower())
                            bt_pos += 1
                            seq_pos += 1
                    result.append("".join(out) + "\n")
        body = "".join(result).encode()
        if is_stockholm:
            chunks.append(body)
        else:
            writer.write(qkey, body, add_newline=False)
    if is_stockholm:
        with open(positional[3], "wb") as f:
            f.writelines(chunks)
    else:
        writer.finish().save(positional[3])
    return 0


def _msa2profile(positional, space, stats):
    """msa2profile (util/msa2profile.cpp:26-380): MSA DB -> profile DB +
    header DB. match-mode 0: columns where the first member has a residue
    are match states (msa2profile.cpp:231-239); match-mode 1: weighted-gap
    fraction <= match-ratio (sequence weights, ENDGAP exclusion,
    msa2profile.cpp:289-333). The MsaFilter shuffle reorders rows in place
    before the PSSM (MsaFilter.cpp:557-568); header comes from the .lookup
    if present, else from the first member header."""
    import ctypes
    from ..ops import msa as MSA
    from ..native import lib as native_lib
    if len(positional) != 2:
        raise ValueError("usage: msa2profile <i:msaDB> <o:profileDB>")
    v = space.values
    mat = constants.blosum62()
    nat = native_lib()
    msa_type = v.get("msa_type", 2)
    match_mode = v.get("match_mode", 0)
    match_ratio = np.float32(v.get("match_ratio", 0.5))
    filter_msa = v.get("filter_msa", 1)
    skip_query = v.get("skip_query", False)
    wg = bool(v.get("wg", False))
    pca = v.get("pca", 0.0)
    pcb = v.get("pcb", 1.5)
    mask_by_first = match_mode == 0

    seq_reader = hdr_reader = None
    if msa_type == 0:
        from ..data import ca3m
        db = ca3m.open_ffindex(positional[0] + "_ca3m.ffdata",
                               positional[0] + "_ca3m.ffindex")
        seq_reader = ca3m.open_ffindex(positional[0] + "_sequence.ffdata",
                                       positional[0] + "_sequence.ffindex")
        hdr_reader = ca3m.open_ffindex(positional[0] + "_header.ffdata",
                                       positional[0] + "_header.ffindex")
        order = list(range(db.size))
    else:
        db = seqdb.SeqDB.open(positional[0])
        order = [int(i) for i in seqdb.data_order(db)]
    lookup = None
    if os.path.exists(positional[0] + ".lookup"):
        lookup = {}
        with open(positional[0] + ".lookup") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and int(parts[0]) not in lookup:
                    lookup[int(parts[0])] = parts[1]

    writer = seqdb.DBWriter(seqdb.HMM_PROFILE)
    hwriter = seqdb.DBWriter(seqdb.GENERIC_DB)
    kseq_buf = bytearray()
    for rank, i in enumerate(order):
        qkey = int(db.keys[i])
        raw = db.get_data(i).tobytes()
        if msa_type == 0:
            from ..data import ca3m
            raw = ca3m.extract_a3m(raw[:max(0, len(raw) - 1)],
                                   seq_reader, hdr_reader)
            if isinstance(raw, str):
                raw = raw.encode()
        if raw[:1] == b"#":
            nl = raw.find(b"\n")
            raw = raw[nl + 1:] if nl >= 0 else b""
        records = _kseq_records(raw)
        if skip_query:
            next(records, None)

        rows = []
        first_header = None
        fasta_error = False
        center_len_gaps = 0
        masked = None
        masked_count = 0
        for name, comment, s in records:
            if len(name) == 0 or len(s) == 0:
                fasta_error = True
                break
            if msa_type in (0, 1) and name.startswith(b"ss_"):
                continue
            if len(kseq_buf) < len(s) + 1:
                kseq_buf.extend(b"\x00" * (len(s) + 1 - len(kseq_buf)))
            kseq_buf[:len(s)] = s
            kseq_buf[len(s)] = 0
            if not rows:
                center_len_gaps = len(s)
                if mask_by_first:
                    arr0 = np.frombuffer(bytes(s), dtype=np.uint8)
                    masked = (arr0 == ord("-")).astype(np.uint8)
                    masked_count = int(masked.sum())
                else:
                    masked = np.zeros(center_len_gaps, dtype=np.uint8)
                first_header = name + (b" " + comment if comment else b"") \
                    + b"\n"
            arr = np.frombuffer(bytes(kseq_buf[:center_len_gaps]),
                                dtype=np.uint8)
            keep_cols = np.ones(center_len_gaps, dtype=bool)
            if mask_by_first:
                keep_cols &= masked == 0
            if msa_type == 1:
                keep_cols &= ~((arr >= ord("a")) & (arr <= ord("z")))
            arr = arr[keep_cols]
            num = mat.aa2num[arr].astype(np.uint8)
            num[arr == ord("-")] = MSA.GAP
            rows.append(num)
        if fasta_error:
            logger.warning(f"Invalid msa {rank}! Skipping entry.")
            continue
        set_size = len(rows)
        if set_size == 0:
            logger.warning(f"Empty msa {rank}! Skipping entry.")
            continue

        width = max(len(r) for r in rows)
        msa_arr = np.full((set_size, width), MSA.GAP, dtype=np.uint8)
        for k, r in enumerate(rows):
            msa_arr[k, :len(r)] = r

        if not mask_by_first:
            stride = ((center_len_gaps // 32) + 1) * 32
            wbuf = np.full((set_size, stride), MSA.GAP, dtype=np.uint8)
            wbuf[:, :width] = msa_arr
            weights = np.zeros(set_size, dtype=np.float32)
            f32p = ctypes.POINTER(ctypes.c_float)
            nat.pssm_seq_weights(
                wbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                set_size, stride, center_len_gaps,
                weights.ctypes.data_as(f32p))
            work = msa_arr[:, :center_len_gaps].copy()
            for k in range(set_size):
                l = 0
                while l < center_len_gaps and work[k, l] == MSA.GAP:
                    work[k, l] = MSA.ENDGAP
                    l += 1
                l = center_len_gaps - 1
                while l >= 0 and work[k, l] == MSA.GAP:
                    work[k, l] = MSA.ENDGAP
                    l -= 1
            masked = np.zeros(center_len_gaps, dtype=np.uint8)
            for l in range(center_len_gaps):
                res_w = np.float32(0)
                gap_w = np.float32(0)
                for k in range(set_size):
                    c = work[k, l]
                    if c < MSA.GAP:
                        res_w += weights[k]
                    elif c != MSA.ENDGAP:
                        gap_w += weights[k]
                    else:
                        work[k, l] = MSA.GAP
                masked[l] = 1 if (gap_w / (res_w + gap_w)) > match_ratio \
                    else 0
            masked_count = int(masked.sum())
            keep_cols = np.nonzero(masked == 0)[0]
            # masked columns are dropped (GAP fill), msa2profile.cpp:321-333
            msa_arr = np.full((set_size, width), MSA.GAP, dtype=np.uint8)
            msa_arr[:, :len(keep_cols)] = work[:, keep_cols]

        center_len = center_len_gaps - masked_count
        stride = ((center_len_gaps // 32) + 1) * 32
        buf = np.full((set_size, stride), MSA.GAP, dtype=np.uint8)
        buf[:, :width] = msa_arr

        filtered_size = set_size
        if filter_msa == 1:
            keep, filtered_size = MSA.msa_filter(
                buf, center_len, coverage=int(v.get("cov_msa_thr", 0.0) * 100),
                qid_vec=_qid_vec(space), qsc=v.get("qsc", -20.0),
                max_seqid=int(v.get("filter_max_seq_id", 0.9) * 100),
                ndiff=v.get("filter_ndiff", 1000),
                filter_min_enable=v.get("filter_min_enable", 0))
            row_order = list(range(set_size))
            ii = 0
            for j in range(set_size):
                if keep[j] != 0:
                    if ii < j:
                        row_order[ii], row_order[j] = \
                            row_order[j], row_order[ii]
                    ii += 1
            buf = buf[row_order]

        res = MSA.compute_pssm(buf[:filtered_size], center_len, wg=wg,
                               pca=pca, pcb=pcb)
        writer.write(qkey, MSA.profile_record(buf[0][:center_len], res),
                     add_newline=False)
        if lookup is not None:
            hwriter.write(qkey, (lookup.get(qkey, "") + "\n").encode(),
                          add_newline=False)
        else:
            hwriter.write(qkey, first_header, add_newline=False)
    writer.finish().save(positional[1])
    hwriter.finish().save(positional[1] + "_h")
    import shutil
    for ext in (".lookup", ".source"):
        if os.path.exists(positional[0] + ext):
            shutil.copy(positional[0] + ext, positional[1] + ext)
    return 0


def _profile2pssm(positional, space, stats):
    """profile2pssm (profile2pssm.cpp): profile DB -> integer PSSM (flat
    TSV or DB with --db-output)."""
    from ..ops.profiledb import read_profile, profile_to_pssm_lines
    if len(positional) != 2:
        raise ValueError("usage: profile2pssm <i:profileDB> <o:pssm>")
    v = space.values
    db_out = v.get("db_output", False)
    comp_bias = bool(v.get("comp_bias_corr", 1))
    db = seqdb.SeqDB.open(positional[0])
    writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    flat = []
    for i in seqdb.data_order(db):
        i = int(i)
        key = int(db.keys[i])
        prof = read_profile(db.get_data(i).tobytes(), add_pc=False)
        body = profile_to_pssm_lines(prof, comp_bias_correction=comp_bias)
        if db_out:
            writer.write(key, body.encode(), add_newline=False)
        else:
            flat.append(f"Query profile of sequence {key}\n{body}")
    if db_out:
        writer.finish().save(positional[1])
    else:
        with open(positional[1], "w") as f:
            f.writelines(flat)
    return 0


def _profile2seq(positional, space, consensus):
    """profile2consensus / profile2repseq (profile2seq.cpp)."""
    from .. import constants
    from ..ops.profiledb import read_profile
    if len(positional) != 2:
        raise ValueError("usage: profile2(consensus|repseq) <i:profileDB> <o:seqDB>")
    mat = constants.blosum62()
    db = seqdb.SeqDB.open(positional[0])
    writer = seqdb.DBWriter(seqdb.AMINO_ACIDS)
    for i in seqdb.data_order(db):
        i = int(i)
        prof = read_profile(db.get_data(i).tobytes(), add_pc=False)
        nums = prof["consensus"] if consensus else prof["query"]
        writer.write(int(db.keys[i]),
                     "".join(mat.letters[c] for c in nums).encode())
    writer.finish().save(positional[1])
    return 0


def _profile2consensus(positional, space, stats):
    return _profile2seq(positional, space, True)


def _profile2repseq(positional, space, stats):
    return _profile2seq(positional, space, False)


def _convertprofiledb(positional, space, stats):
    """convertprofiledb (util/convertprofiledb.cpp:15-189): HH-suite HHM
    flat-file DB (ffindex .ffdata/.ffindex or mmseqs layout) -> HMM-profile
    DB + header DB. Record keys are the ffindex line numbers; the HHM score
    columns are stored in file (HH-suite) amino-acid order, exactly as the
    reference does (convertprofiledb.cpp:61-98)."""
    import ctypes
    if len(positional) != 2:
        raise ValueError("usage: convertprofiledb <i:hhmDB> <o:profileDB>")
    from ..data import ca3m
    from ..native import lib as native_lib
    nat = native_lib()
    mat = constants.blosum62()
    src = positional[0]
    if (os.path.exists(src + ".ffdata") and os.path.exists(src + ".ffindex")):
        reader = ca3m.open_ffindex(src + ".ffdata", src + ".ffindex")
    else:
        reader = ca3m.open_linewise(src)
    pw = seqdb.DBWriter(seqdb.HMM_PROFILE)
    hw = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in range(reader.size):
        raw = reader.get_data(i).tobytes()
        lines = raw.decode("latin-1").split("\n")
        li = 0
        while not lines[li].startswith("NAME"):
            li += 1
        header = lines[li][6:] + "\n"
        while not lines[li].startswith(">Consensus"):
            li += 1
        li += 1
        while not lines[li].startswith(">"):
            li += 1
        li += 1
        seq = []
        while not (lines[li][:1] == ">" or lines[li][:1] == "#"):
            seq.append(lines[li])
            li += 1
        sequence = "".join(seq)
        while lines[li][:1] != "#":
            li += 1
        li += 5
        buf = bytearray()
        seq_pos = 0
        while not lines[li].startswith("//"):
            words = lines[li].split()
            probs = np.zeros(20, dtype=np.float32)
            for aa in range(20):
                w = words[aa + 2]
                if w[0] == "*":
                    probs[aa] = 0.0
                elif w[0] == "0":
                    probs[aa] = 1.0
                else:
                    entry = int(w)
                    probs[aa] = np.float32(nat.ps_fpow2(
                        ctypes.c_float(-(np.float32(entry) / np.float32(1000.0)))))
                b = nat.pssm_score_mask(ctypes.c_float(probs[aa]))
                if b == 0:
                    raise ValueError(
                        f"PSSM score of 0 is too large at id: {i}.hhm")
                buf.append(b)
            maxw = np.float32(0.0)
            maxa = 21
            for aa in range(20):
                d = probs[aa] - np.float32(mat.pback[aa])
                if d > maxw:
                    maxw = d
                    maxa = aa
            buf.append(int(mat.aa2num[ord(sequence[seq_pos])]))
            buf.append(maxa)
            # NEFF read from words[7] of the same emission line
            # (convertprofiledb.cpp:115-118 — reference reads the match line
            # again, not the transition line; fast_atoi('*') == 0)
            neff_tok = words[7] if len(words) > 7 else "0"
            entry = int(neff_tok) if neff_tok.lstrip("-").isdigit() else 0
            buf.append(nat.pssm_neff_to_char(
                ctypes.c_float(np.float32(entry) / np.float32(1000.0))))
            seq_pos += 1
            li += 3
        pw.write(i, bytes(buf), add_newline=False)
        hw.write(i, header.encode("latin-1"), add_newline=False)
    pw.finish().save(positional[1])
    hw.finish().save(positional[1] + "_h")
    return 0


def _profile2cs(positional, space, stats):
    """profile2cs (util/profile2cs.cpp:16-105): profile DB -> column-state
    sequence DBs — <o> in the 219-state cs219 alphabet and <o>.255 in the
    255-state alphabet; states stored +1 to avoid null bytes, record
    terminated by an extra null."""
    if len(positional) != 2:
        raise ValueError("usage: profile2cs <i:profileDB> <o:csDB>")
    from ..ops.profiledb import read_profile
    from ..ops.profilestates import ProfileStates
    v = space.values
    pca = v.get("pca", 1.0)
    pcb = v.get("pcb", 1.5)
    db = seqdb.SeqDB.open(positional[0])
    order = [int(i) for i in seqdb.data_order(db)]
    probs = [read_profile(db.get_data(i).tobytes(), add_pc=pca > 0.0,
                          pca=pca, pcb=pcb)["prob"] for i in order]
    for alph in (219, 255):
        ps = ProfileStates(alph)
        out = positional[1] if alph == 219 else positional[1] + f".{alph}"
        writer = seqdb.DBWriter(seqdb.PROFILE_STATE_SEQ)
        for i, prob in zip(order, probs):
            states = (ps.discretize_cs219(prob) if alph == 219
                      else ps.discretize(prob))
            writer.write(int(db.keys[i]),
                         (states + 1).astype(np.uint8).tobytes() + b"\x00",
                         add_newline=False)
        writer.finish().save(out)
    return 0


def _convertca3m(positional, space, stats):
    """convertca3m (util/convertca3m.cpp:13-63): expand a compressed-A3M DB
    (<db>_ca3m.ffdata + <db>_sequence.ffdata) into an alignment result DB
    with backtraces."""
    if len(positional) != 2:
        raise ValueError("usage: convertca3m <i:ca3mDB> <o:alnDB>")
    from ..data import ca3m
    from ..ops.rescore import format_seq_id
    from ..ops.protein_align import compress_cigar
    reader = ca3m.open_ffindex(positional[0] + "_ca3m.ffdata",
                               positional[0] + "_ca3m.ffindex")
    seqs = ca3m.open_ffindex(positional[0] + "_sequence.ffdata",
                             positional[0] + "_sequence.ffindex")
    writer = seqdb.DBWriter(seqdb.CA3M_DB)
    for i in range(reader.size):
        key, results = ca3m.extract_matcher_results(
            reader.get_data(i).tobytes(), seqs, skip_first=True)
        out = []
        for r in results:
            out.append(
                f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
                f"{r['eval']:.3E}\t{r['qStartPos']}\t{r['qEndPos']}\t"
                f"{r['qLen']}\t{r['dbStartPos']}\t{r['dbEndPos']}\t"
                f"{r['dbLen']}\t{compress_cigar(r['backtrace'])}\n")
        writer.write(key, "".join(out).encode(), add_newline=False)
    writer.finish().save(positional[1])
    return 0


_TRANSITIONS = {
    ("M", "M"): "M", ("I", "M"): "I", ("D", "M"): "D",
    ("M", "D"): "D", ("I", "D"): None, ("D", "D"): "D",
    ("M", "I"): "I", ("I", "I"): "I", ("D", "I"): None,
}


def translate_backtrace(ab, bc):
    """BacktraceTranslator::translateResult (commons/BacktraceTranslator.h):
    compose A->B and B->C alignments into A->C. Returns dict or None."""
    start_b_ab = ab["dbStartPos"]
    start_b_bc = bc["qStartPos"]
    dist = abs(start_b_ab - start_b_bc)
    bt_ab, bt_bc = ab["backtrace"], bc["backtrace"]
    if start_b_ab < start_b_bc:
        a_off = b_off = bt_off = 0
        while b_off < dist and bt_off < len(bt_ab):
            b_off += bt_ab[bt_off] in "MD"
            a_off += bt_ab[bt_off] in "MI"
            bt_off += 1
        off_ab, off_bc = bt_off, 0
        start_a = ab["qStartPos"] + a_off
        start_c = bc["dbStartPos"]
    elif start_b_ab > start_b_bc:
        b_off = c_off = bt_off = 0
        while b_off < dist and bt_off < len(bt_bc):
            b_off += bt_bc[bt_off] in "MI"
            c_off += bt_bc[bt_off] in "MD"
            bt_off += 1
        off_ab, off_bc = 0, bt_off
        start_a = ab["qStartPos"]
        start_c = bc["dbStartPos"] + c_off
    else:
        off_ab = off_bc = 0
        start_a = ab["qStartPos"]
        start_c = bc["dbStartPos"]

    out = []
    last_m = 0
    q_aln = db_aln = 0
    i = 0
    while off_ab < len(bt_ab) and off_bc < len(bt_bc):
        i += 1
        t = _TRANSITIONS[(bt_ab[off_ab], bt_bc[off_bc])]
        if t is None:
            i -= 1
        else:
            if t == "M":
                last_m = i
                q_aln += 1
                db_aln += 1
            elif t == "D":
                q_aln += 1
            else:
                db_aln += 1
            out.append(t)
        off_ab += 1
        off_bc += 1
    return {
        "dbKey": bc["dbKey"], "score": bc["score"], "seqId": bc["seqId"],
        "eval": bc["eval"], "qStartPos": start_a,
        "qEndPos": start_a + q_aln - 1, "qLen": ab["qLen"],
        "dbStartPos": start_c, "dbEndPos": start_c + db_aln - 1,
        "dbLen": bc["dbLen"], "backtrace": "".join(out[:last_m]),
    }


def _expandaln(positional, space, return_aln=True):
    """expandaln / expand2profile (util/expandaln.cpp): transitively expand
    A->B hits with B->C hits into A->C alignments or a profile."""
    from .. import constants
    from ..ops import msa as MSA
    from ..ops.evalue import EvalueComputer
    from ..ops.protein_align import calc_local_aa_bias, compress_cigar
    from ..ops.rescore import format_seq_id
    if len(positional) != 5:
        raise ValueError("usage: expandaln <i:aDB> <i:cDB> <i:abDB> "
                         "<i:bcDB> <o:db>")
    v = space.values
    mat = constants.blosum62()
    adb = seqdb.SeqDB.open(positional[0])
    cdb = adb if positional[1] == positional[0] else seqdb.SeqDB.open(positional[1])
    a_is_prof = adb.dbtype == seqdb.HMM_PROFILE
    c_is_prof = cdb.dbtype == seqdb.HMM_PROFILE
    if a_is_prof and c_is_prof:
        raise ValueError("Profile-profile is currently not supported")
    abdb = seqdb.SeqDB.open(positional[2])
    bcdb = seqdb.SeqDB.open(positional[3])
    eval_profile = v.get("eval_profile", EVAL_PROFILE_DEFAULT)
    cov_thr = v.get("cov_thr", 0.0)
    cov_mode = v.get("cov_mode", 0)
    seq_id_thr = v.get("seq_id_thr", 0.0)
    eval_thr = v.get("eval_thr", 0.001)
    aln_len_thr = v.get("aln_len_thr", 0)
    expansion_mode = v.get("expansion_mode", 0)  # EXPAND_TRANSFER_EVALUE
    comp_bias = bool(v.get("comp_bias_corr", 1))
    gap_open, gap_extend = v.get("gap_open", 11), v.get("gap_extend", 1)
    evaluer = EvalueComputer.for_matrix("blosum62_11_1", cdb.total_residues())
    writer = seqdb.DBWriter(
        seqdb.ALIGNMENT_RES if return_aln else seqdb.HMM_PROFILE)
    sub = mat.sub.astype(np.int64)

    # pre-parse B->C result lists lazily
    bc_cache = {}

    def bc_results(bkey):
        if bkey not in bc_cache:
            bid = bcdb.key_to_id(bkey)
            recs = [_parse_aln_line(ln) for ln in
                    bcdb.get_data(bid).tobytes().decode().split("\n") if ln]
            recs.sort(key=lambda r: -r["score"])  # stable by construction
            bc_cache[bkey] = recs
        return bc_cache[bkey]

    for i in seqdb.data_order(abdb):
        i = int(i)
        qkey = int(abdb.keys[i])
        aid = adb.key_to_id(qkey)
        aprof = None
        if a_is_prof:
            # Sequence aSeq(..., DBTYPE_HMM_PROFILE, ..., compBiasCorrection)
            # (expandaln.cpp:164): mapProfile already folds the bias in;
            # rescoring indexes profile_for_alignment (expandaln.cpp:46)
            from ..ops.profile_query import ProfileQuery
            pq = ProfileQuery(adb.get_data(aid).tobytes(), comp_bias=comp_bias)
            anum = pq.qnum
            aprof = pq.aln_profile.astype(np.int64)
        else:
            anum = mat.aa2num[adb.get_seq(aid)]
        La = len(anum)
        bias = np.zeros(La, dtype=np.float64)
        if comp_bias and not a_is_prof:
            # bias only computed for amino-acid A dbs (expandaln.cpp:211)
            bias = calc_local_aa_bias(mat.sub, mat.pback, anum)
        bias_short = np.where(bias < 0.0, bias - 0.5, bias + 0.5).astype(np.int64)
        intervals = {}
        results_ac = []
        seq_set = []
        for line in abdb.get_data(i).tobytes().decode().split("\n"):
            if not line:
                continue
            ab = _parse_aln_line(line)
            if not return_aln and ab["eval"] > eval_profile:
                continue
            if not ab["backtrace"]:
                raise ValueError("Alignment must contain a backtrace")
            for bc in bc_results(ab["dbKey"]):
                if not bc["backtrace"]:
                    raise ValueError("Alignment must contain a backtrace")
                ac = translate_backtrace(ab, bc)
                if not ac["backtrace"]:
                    continue
                from ..ops.rescore import _can_be_covered
                if not _can_be_covered(cov_thr, cov_mode, ac["qLen"], ac["dbLen"]):
                    continue
                ckey = ac["dbKey"]
                if ckey in intervals:
                    lo, hi = min(ac["qStartPos"], ac["qEndPos"]), max(
                        ac["qStartPos"], ac["qEndPos"])
                    if intervals[ckey][lo:hi + 1].any():
                        continue
                    # reference quirk: an already-seen C key that does NOT
                    # overlap is silently dropped (expandaln.cpp:262-268)
                    continue
                cid = cdb.key_to_id(ckey)
                cprof = None
                if c_is_prof:
                    # cSeq is built WITHOUT bias correction (expandaln.cpp:165)
                    from ..ops.profile_query import ProfileQuery
                    cq = ProfileQuery(cdb.get_data(cid).tobytes(),
                                      comp_bias=False)
                    cnum = cq.qnum
                    cprof = cq.aln_profile.astype(np.int64)
                else:
                    cnum = mat.aa2num[cdb.get_seq(cid)]
                # rescoreResultByBacktrace (expandaln.cpp:24-73)
                score = 0
                idents = 0
                qp, tp = ac["qStartPos"], ac["dbStartPos"]
                last = ""
                for st in ac["backtrace"]:
                    if st == "M":
                        if cprof is not None:
                            score += int(cprof[anum[qp]][tp])
                        elif aprof is not None:
                            score += int(aprof[cnum[tp]][qp])
                        else:
                            score += int(sub[anum[qp]][cnum[tp]]) + int(bias_short[qp])
                        idents += int(anum[qp] == cnum[tp])
                        qp += 1
                        tp += 1
                    elif st == "I":
                        score -= gap_extend if last == "I" else gap_open
                        qp += 1
                    else:
                        score -= gap_extend if last == "D" else gap_open
                        tp += 1
                    last = st
                if score < -6:
                    continue
                if expansion_mode == 1:  # EXPAND_RESCORE_BACKTRACE
                    ac["eval"] = float(evaluer.evalue(score, La))
                    ac["score"] = int(float(evaluer.bit_score(score)) + 0.5)
                    ac["seqId"] = float(np.float32(idents) / np.float32(len(ac["backtrace"])))
                else:  # transfer from AB
                    ac["eval"] = ab["eval"]
                    ac["score"] = ab["score"]
                    ac["seqId"] = ab["seqId"]
                qcov = np.float32(abs(ac["qEndPos"] - ac["qStartPos"]) + 1) / np.float32(ac["qLen"])
                tcov = np.float32(abs(ac["dbEndPos"] - ac["dbStartPos"]) + 1) / np.float32(ac["dbLen"])
                from ..ops.rescore import _has_cov
                has_cov = _has_cov(cov_thr, cov_mode, qcov, tcov)
                has_seq_id = ac["seqId"] >= (seq_id_thr - np.finfo(np.float32).eps)
                has_eval = ac["eval"] <= eval_thr
                has_aln_len = len(ac["backtrace"]) >= aln_len_thr
                if has_cov and has_seq_id and has_eval and has_aln_len:
                    if not return_aln:
                        seq_set.append(cnum)
                    results_ac.append(ac)
                    iv = intervals.setdefault(ckey, np.zeros(ac["qLen"] + 1, dtype=bool))
                    lo, hi = min(ac["qStartPos"], ac["qEndPos"]), max(
                        ac["qStartPos"], ac["qEndPos"])
                    iv[lo:hi + 1] = True
        if return_aln:
            results_ac.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"], r["dbKey"]))
            out = []
            for r in results_ac:
                out.append(
                    f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
                    f"{r['eval']:.3E}\t{r['qStartPos']}\t{r['qEndPos']}\t"
                    f"{r['qLen']}\t{r['dbStartPos']}\t{r['dbEndPos']}\t"
                    f"{r['dbLen']}\t{compress_cigar(r['backtrace'])}\n")
            writer.write(qkey, "".join(out).encode(), add_newline=False)
        else:
            msa, center_len = MSA.compute_msa(anum, seq_set, results_ac,
                                              no_deletion=True)
            if v.get("filter_msa", 1):
                keep, filtered = MSA.msa_filter(
                    msa, center_len, coverage=int(v.get("cov_msa_thr", 0.0) * 100),
                    qid_vec=_qid_vec(space), qsc=v.get("qsc", -20.0),
                    max_seqid=int(v.get("filter_max_seq_id", 0.9) * 100),
                    ndiff=v.get("filter_ndiff", 1000),
                    filter_min_enable=v.get("filter_min_enable", 0))
                msa = msa[[k for k in range(msa.shape[0]) if keep[k] != 0]]
            res = MSA.compute_pssm(msa, center_len, wg=bool(v.get("wg", False)),
                                   pca=v.get("pca", 0.0), pcb=v.get("pcb", 1.5))
            if v.get("mask_profile", 1):
                MSA.mask_profile(anum, res)
            writer.write(qkey, MSA.profile_record(anum, res), add_newline=False)
    writer.finish().save(positional[4])
    return 0


def _expandaln_cmd(positional, space, stats):
    return _expandaln(positional, space, return_aln=True)


def _expand2profile(positional, space, stats):
    return _expandaln(positional, space, return_aln=False)


def _summarizealis(positional, space, stats):
    """summarizealis (util/summarizealis.cpp): per query — hit count,
    unique coverage, total coverage, average seq.id."""
    if len(positional) != 2:
        raise ValueError("usage: summarizealis <i:alnDB> <o:db>")
    db = seqdb.SeqDB.open(positional[0])
    writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in seqdb.data_order(db):
        i = int(i)
        recs = [_parse_aln_line(ln) for ln in
                db.get_data(i).tobytes().decode().split("\n") if ln]
        if not recs:
            writer.write(int(db.keys[i]), b"", add_newline=False)
            continue
        recs.sort(key=lambda r: min(r["qStartPos"], r["qEndPos"]))
        res_cov = np.float32(0)
        avg_id = np.float32(0)
        uniq_cov = np.float32(0)
        seq_len = 1
        prev_qend = -1
        for r in recs:
            seq_len = r["qLen"]
            qs = min(r["qStartPos"], r["qEndPos"])
            qe = max(r["qStartPos"], r["qEndPos"])
            uniq_cov += np.float32(max(prev_qend, qe) - max(prev_qend, qs))
            res_cov += np.float32(qe - qs)
            avg_id += np.float32(r["seqId"])
            prev_qend = max(prev_qend, r["qEndPos"])
        avg_id = np.float32(avg_id / np.float32(len(recs)))
        res_cov = np.float32(res_cov / np.float32(seq_len))
        uniq_cov = np.float32(uniq_cov / np.float32(seq_len))
        body = (f"{len(recs)}\t{uniq_cov:.3f}\t{res_cov:.3f}\t{avg_id:.3f}\n")
        writer.write(int(db.keys[i]), body.encode(), add_newline=False)
    writer.finish().save(positional[1])
    return 0


def _result2dnamsa(positional, space, stats):
    """result2dnamsa (util/result2dnamsa.cpp): nucleotide MSA records with
    strand-aware target rendering."""
    from ..data.createdb import IUPAC_COMPLEMENT
    if len(positional) != 4:
        raise ValueError("usage: result2dnamsa <i:qDB> <i:tDB> <i:resDB> <o:msaDB>")
    v = space.values
    skip_query = v.get("skip_query", False)
    same_db = positional[0] == positional[1]
    qdb = seqdb.SeqDB.open(positional[0])
    qhdr = seqdb.SeqDB.open(positional[0] + "_h")
    tdb = qdb if same_db else seqdb.SeqDB.open(positional[1])
    thdr = qhdr if same_db else seqdb.SeqDB.open(positional[1] + "_h")
    rdb = seqdb.SeqDB.open(positional[2])
    writer = seqdb.DBWriter(seqdb.MSA_DB)
    for i in seqdb.data_order(rdb):
        i = int(i)
        qkey = int(rdb.keys[i])
        qid = qdb.key_to_id(qkey)
        parts = []
        if not skip_query:
            parts.append(b">" + qhdr.get_data(qhdr.key_to_id(qkey)).tobytes())
            parts.append(qdb.get_data(qid).tobytes())
        for line in rdb.get_data(i).tobytes().decode().split("\n"):
            if not line:
                continue
            r = _parse_aln_line(line)
            tid = tdb.key_to_id(r["dbKey"])
            parts.append(b">" + thdr.get_data(tid).tobytes())
            tseq = tdb.get_seq(tid).tobytes()
            bt = r["backtrace"]
            q_rev = r["qStartPos"] > r["qEndPos"]
            t_rev = r["dbStartPos"] > r["dbEndPos"]
            ts, te = r["dbStartPos"], r["dbEndPos"]
            is_rev_strand = False
            if q_rev and t_rev:
                ts, te = te, ts
                bt = bt[::-1]
            elif q_rev and not t_rev:
                is_rev_strand = True
                ts, te = te, ts
                bt = bt[::-1]
            elif not q_rev and t_rev:
                is_rev_strand = True
            out = bytearray(b"-" * min(r["qStartPos"], r["qEndPos"]))
            seq_pos = 0
            for st in bt:
                if st == "M":
                    if is_rev_strand:
                        c = IUPAC_COMPLEMENT[tseq[ts - seq_pos]]
                    else:
                        c = tseq[ts + seq_pos]
                    out.append(c)
                    seq_pos += 1
                elif st == "I":
                    out.append(ord("-"))
                else:
                    seq_pos += 1
            qe = max(r["qStartPos"], r["qEndPos"])
            out += b"-" * (r["qLen"] - (qe + 1))
            out.append(ord("\n"))
            parts.append(bytes(out))
        writer.write(qkey, b"".join(parts), add_newline=False)
    writer.finish().save(positional[3])
    return 0


def _convertmsa(positional, space, stats):
    """convertmsa (util/convertmsa.cpp): Stockholm flat file -> MSA DB of
    FASTA blocks."""
    import gzip
    if len(positional) != 2:
        raise ValueError("usage: convertmsa <i:stockholm[.gz]> <o:msaDB>")
    v = space.values
    ident_field = v.get("identifier_field", 0)
    opener = gzip.open if positional[0].endswith(".gz") else open
    writer = seqdb.DBWriter(seqdb.MSA_DB)
    key = 0
    in_entry = False
    seq_order = []
    seqs = {}
    identifier = ""
    with opener(positional[0], "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) < 1:
                continue
            if not in_entry and line == "# STOCKHOLM 1.0":
                in_entry = True
                continue
            if in_entry and line == "//":
                in_entry = False
                parts = []
                for j, acc in enumerate(seq_order):
                    head = acc
                    if j == 0 and identifier:
                        head = identifier + " " + acc
                    parts.append(f">{head}\n{seqs[acc]}\n")
                writer.write(key, "".join(parts).encode(), add_newline=False)
                key += 1
                seq_order = []
                seqs = {}
                identifier = ""
                continue
            if not in_entry:
                continue
            cols = line.split()
            if line[0] == "#":
                if line.startswith("#=GF") and len(cols) >= 3:
                    if ident_field == 1 and cols[1].startswith("AC"):
                        identifier = cols[2]
                    elif ident_field == 0 and cols[1].startswith("ID"):
                        identifier = cols[2]
            else:
                if len(cols) < 2:
                    logger.error("Invalid sequence!")
                    in_entry = False
                    continue
                acc = cols[0]
                if acc in seqs:
                    # the reference only '.'-replaces the FIRST chunk
                    # (convertmsa.cpp:120-128)
                    seqs[acc] += cols[1]
                else:
                    seq_order.append(acc)
                    seqs[acc] = cols[1].replace(".", "-")
    writer.finish().save(positional[1])
    return 0


def _profile_flags():
    return P.common_flags() + [
        P.Flag("-e", "eval_thr", float, 0.001, "E-value threshold"),
        P.Flag("--e-profile", "eval_profile", float, EVAL_PROFILE_DEFAULT, "Profile E-value threshold"),
        P.Flag("--filter-msa", "filter_msa", int, 1, "Filter MSA", r"[0-1]"),
        P.Flag("--max-seq-id", "filter_max_seq_id", float, 0.9, "Filter max seq id"),
        P.Flag("--qid", "qid", str, "0.0", "Filter min seq id with query"),
        P.Flag("--qsc", "qsc", float, -20.0, "Filter min score per column"),
        P.Flag("--cov", "cov_msa_thr", float, 0.0, "Filter min coverage"),
        P.Flag("--diff", "filter_ndiff", int, 1000, "Keep N most diverse seqs"),
        P.Flag("--filter-min-enable", "filter_min_enable", int, 0, "Only filter MSAs with more than N seqs"),
        P.Flag("--wg", "wg", bool, False, "Global sequence weighting"),
        P.Flag("--pca", "pca", float, 0.0, "Pseudocount admixture strength"),
        P.Flag("--pcb", "pcb", float, 1.5, "Pseudocount Neff dependence"),
        P.Flag("--mask-profile", "mask_profile", int, 1, "Mask profile with tantan", r"[0-1]"),
        P.Flag("--comp-bias-corr", "comp_bias_corr", int, 1, "Composition bias correction", r"[0-1]"),
        P.Flag("--gap-open", "gap_open", int, 11, "Gap open cost"),
        P.Flag("--gap-extend", "gap_extend", int, 1, "Gap extend cost"),
        P.Flag("--db-output", "db_output", bool, False, "Write DB output instead of flat file"),
        P.Flag("--msa-format-mode", "msa_format_mode", int, 2, "1 FASTA-sum, 2 FASTA, 4 Stockholm, 5 A3M"),
        P.Flag("--allow-deletion", "allow_deletion", bool, False, "Allow deletions in MSA"),
        P.Flag("--skip-query", "skip_query", bool, False, "Skip the query sequence"),
        P.Flag("--match-mode", "match_mode", int, 0, "0 query columns, 1 by match-ratio", r"[0-1]"),
        P.Flag("--match-ratio", "match_ratio", float, 0.5, "Match-column residue ratio"),
        P.Flag("--summary-prefix", "summary_prefix", str, "cl", "Summary prefix"),
    ]


def _expand_flags():
    return [
        P.Flag("-c", "cov_thr", float, 0.0, "Coverage threshold"),
        P.Flag("--cov-mode", "cov_mode", int, 0, "Coverage mode", r"[0-5]"),
        P.Flag("--min-seq-id", "seq_id_thr", float, 0.0, "Sequence identity threshold"),
        P.Flag("--min-aln-len", "aln_len_thr", int, 0, "Minimum alignment length"),
        P.Flag("--expansion-mode", "expansion_mode", int, 0,
               "0: transfer input alignment values, 1: rescore backtrace", r"[0-2]"),
        P.Flag("--seq-id-mode", "seq_id_mode", int, 0, "SeqId denominator mode", r"[0-2]"),
    ]


def _result2pp(positional, space, stats):
    """result2pp (util/result2pp.cpp): merge target profiles into the query
    profile along alignment backtraces, producing a profile-profile merged
    HMM_PROFILE DB."""
    from ..native import lib as native_lib
    from ..ops.msa import PROFILE_AA_SIZE
    from ..ops.profiledb import read_profile
    if len(positional) != 4:
        raise ValueError(
            "usage: result2pp <i:qProfDB> <i:tProfDB> <i:resDB> <o:profDB>")
    v = space.values
    eval_profile = v.get("eval_profile", EVAL_PROFILE_DEFAULT)
    qdbr = seqdb.SeqDB.open(positional[0])
    same_db = positional[0] == positional[1]
    tdbr = qdbr if same_db else seqdb.SeqDB.open(positional[1])
    rdb = seqdb.SeqDB.open(positional[2])
    nat = native_lib()
    writer = seqdb.DBWriter(seqdb.HMM_PROFILE)
    f32, f64 = np.float32, np.float64
    tcache = {}
    for i in seqdb.data_order(rdb):
        qkey = int(rdb.keys[i])
        qid = qdbr.key_to_id(qkey)
        qraw = qdbr.get_data(qid).tobytes()
        lines = [ln for ln in rdb.get_data(i).tobytes().decode().split("\n")
                 if ln]
        if not lines:
            writer.write(qkey, qraw, add_newline=False)
            continue
        qp = read_profile(qraw)
        L = len(qp["query"])
        qprob = qp["prob"]
        qneff = qp["neff"]
        max_neff_q = f32(qneff.max()) if L else f32(0.0)
        out = np.zeros((L, PROFILE_AA_SIZE), dtype=np.float32)
        neff_m = qneff.copy()
        min_qstart = 2**31 - 1
        max_qend = 0
        did_merge = False
        for line in lines:
            r = _parse_aln_line(line)
            if len(line.split("\t")) <= 10:
                raise ValueError(
                    "Alignment must contain the alignment information. "
                    "Compute the alignment with option -a.")
            if not (r["eval"] <= eval_profile
                    and (r["dbKey"] != qkey or not same_db)):
                continue
            did_merge = True
            tid = tdbr.key_to_id(r["dbKey"])
            if tid not in tcache:
                tcache[tid] = read_profile(tdbr.get_data(tid).tobytes())
            tp = tcache[tid]
            tprob, tneff = tp["prob"], tp["neff"]
            max_neff_t = f32(tneff.max()) if len(tneff) else f32(0.0)
            qpos, tpos = r["qStartPos"], r["dbStartPos"]
            min_qstart = min(min_qstart, r["qStartPos"])
            max_qend = max(max_qend, r["qEndPos"])
            bt = r["backtrace"]
            avg_entropy = f32(0.0)
            qpn, tpn = qpos, tpos
            for op in bt:
                q_prob = qprob[qpn] * qneff[qpn]          # float32 vector
                t_prob = tprob[tpn] * tneff[tpn]
                mixed = q_prob + t_prob
                out[qpn] += mixed
                mixed = mixed / f32(qneff[qpn] + tneff[tpn])
                terms = np.where(mixed > 0.0,
                                 -mixed.astype(f64) * np.log(mixed,
                                                             dtype=f64),
                                 0.0)
                for t in terms:  # float += double, per reference order
                    avg_entropy = f32(f64(avg_entropy) + t)
                if op == "M":
                    qpn += 1
                    tpn += 1
                elif op == "I":
                    qpn += 1
                else:
                    tpn += 1
            for li in range(r["qStartPos"], r["qEndPos"]):
                s = f32(0.0)
                for val in out[li]:
                    s = f32(s + val)
                if s != 0.0:
                    out[li] *= f32(f64(1.0) / f64(s))
            avg_entropy = f32(avg_entropy / f32(len(bt)))
            avg_new_neff = f32(np.exp(f64(avg_entropy)))
            qpn, tpn = qpos, tpos
            for op in bt:
                w = f32((qneff[qpn] + tneff[tpn])
                        / (max_neff_q + max_neff_t))
                neff_m[qpn] = f32(f64(avg_new_neff) + 1
                                  - np.exp(np.log(f64(avg_new_neff))
                                           * (1 - f64(w))))
                if op == "M":
                    qpn += 1
                    tpn += 1
                elif op == "I":
                    qpn += 1
                else:
                    tpn += 1
        if not did_merge:
            writer.write(qkey, qraw, add_newline=False)
            continue
        out[:min_qstart] = qprob[:min_qstart]
        out[max_qend:L] = qprob[max_qend:L]
        rec = bytearray()
        for li in range(L):
            max_prob = -np.inf
            cons = 0
            for aa in range(PROFILE_AA_SIZE):
                p = float(out[li, aa])
                rec.append(nat.pssm_score_mask(f32(p)))
                if p > max_prob:
                    cons = aa
                    max_prob = p
            rec.append(int(qp["query"][li]))
            rec.append(cons)
            rec.append(nat.pssm_neff_to_char(f32(neff_m[li])))
        writer.write(qkey, bytes(rec), add_newline=False)
    writer.finish().save(positional[3])
    return 0


COMMANDS = [
    Command("result2profile", _result2profile_cmd, lambda: port_space(_profile_flags()),
            "<i:qDB> <i:tDB> <i:resDB> <o:profileDB>", "Compute profiles from results", hidden=True),
    Command("filterresult", _filterresult, lambda: port_space(_profile_flags()),
            "<i:qDB> <i:tDB> <i:resDB> <o:resDB>", "Filter results by MSA redundancy filter", hidden=True),
    Command("result2msa", _result2msa, lambda: port_space(_profile_flags()),
            "<i:qDB> <i:tDB> <i:resDB> <o:msaDB>", "Compute MSAs from results", hidden=True),
    Command("msa2profile", _msa2profile, lambda: port_space(_profile_flags()),
            "<i:msaDB> <o:profileDB>", "Convert MSA DB to profile DB", hidden=True),
    Command("profile2pssm", _profile2pssm, lambda: port_space(_profile_flags()),
            "<i:profileDB> <o:pssmFile>", "Convert profiles to integer PSSMs", hidden=True),
    Command("profile2consensus", _profile2consensus, lambda: port_space(_profile_flags()),
            "<i:profileDB> <o:seqDB>", "Extract consensus sequences", hidden=True),
    Command("profile2repseq", _profile2repseq, lambda: port_space(_profile_flags()),
            "<i:profileDB> <o:seqDB>", "Extract representative sequences", hidden=True),
    Command("expandaln", _expandaln_cmd, lambda: port_space(_profile_flags() + _expand_flags()),
            "<i:aDB> <i:cDB> <i:abDB> <i:bcDB> <o:alnDB>",
            "Expand A->B alignments with B->C alignments", hidden=True),
    Command("expand2profile", _expand2profile, lambda: port_space(_profile_flags() + _expand_flags()),
            "<i:aDB> <i:cDB> <i:abDB> <i:bcDB> <o:profileDB>",
            "Expand alignment results into a profile", hidden=True),
    Command("summarizealis", _summarizealis, lambda: port_space(_profile_flags()),
            "<i:alnDB> <o:db>", "Summarize alignment results per query", hidden=True),
    Command("result2dnamsa", _result2dnamsa, lambda: port_space(_profile_flags()),
            "<i:qDB> <i:tDB> <i:resDB> <o:msaDB>", "Compute DNA MSAs from results", hidden=True),
    Command("convertmsa", _convertmsa, lambda: port_space(_profile_flags() + [
        P.Flag("--identifier-field", "identifier_field", int, 0, "0: ID, 1: AC", r"[0-1]")]),
            "<i:stockholm[.gz]> <o:msaDB>", "Convert Stockholm MSAs to an MSA DB", hidden=True),
    Command("result2pp", _result2pp, lambda: port_space(_profile_flags()),
            "<i:qProfDB> <i:tProfDB> <i:resDB> <o:profDB>",
            "Merge target profiles into query profiles along alignments", hidden=True),
    # profile2cs keeps the global pca=1.0 default (result2profile/msa2profile
    # override it to 0.0, profile2cs does not — result2profile.cpp:23)
    Command("profile2cs", _profile2cs,
            lambda: port_space([f if f.name != "--pca" else
                                  P.Flag("--pca", "pca", float, 1.0,
                                         "Pseudo count admixture strength")
                                  for f in _profile_flags()]),
            "<i:profileDB> <o:csDB>",
            "Convert profiles to column-state sequences", hidden=True),
    Command("convertprofiledb", _convertprofiledb, lambda: port_space(_profile_flags()),
            "<i:hhsuiteHHMDB> <o:profileDB>",
            "Convert an HH-suite HHM DB to a profile DB", hidden=True),
    Command("convertca3m", _convertca3m, lambda: port_space(_profile_flags()),
            "<i:ca3mDB> <o:alnDB>",
            "Convert a compressed A3M DB to an alignment result DB", hidden=True),
]


def _kseq_records(buf):
    """kseq_read over an in-memory buffer (ksw2/kseq.h:184-235): yields
    (name, comment, seq bytes); name = chars up to the first isspace,
    comment = rest of the header line, sequence lines concatenated until
    the next '>'/'+'/'@' record marker (empty lines skipped)."""
    spaces = b" \t\n\v\f\r"
    n = len(buf)
    pos = 0
    while True:
        while pos < n and buf[pos] not in (0x3E, 0x40):
            pos += 1
        if pos >= n:
            return
        pos += 1
        start = pos
        while pos < n and buf[pos] not in spaces:
            pos += 1
        name = buf[start:pos]
        comment = b""
        if pos < n and buf[pos] != 0x0A:
            pos += 1
            eol = buf.find(b"\n", pos)
            if eol < 0:
                eol = n
            comment = buf[pos:eol]
            if comment.endswith(b"\r"):
                comment = comment[:-1]
            pos = eol
        if pos < n:
            pos += 1
        chunks = []
        while pos < n and buf[pos] not in (0x3E, 0x40, 0x2B):
            if buf[pos] == 0x0A:
                pos += 1
                continue
            eol = buf.find(b"\n", pos)
            if eol < 0:
                eol = n
            line = buf[pos:eol]
            chunks.append(line)
            pos = eol + 1 if eol < n else n
        yield name, comment, b"".join(chunks)


def _biased_ascii_mat(bit_factor, bias):
    """SubstitutionMatrix(name, bitFactor, bias) int matrix as a 256x256
    ASCII LUT (BaseMatrix::generateSubMatrix short version +
    SubstitutionMatrix::createAsciiSubMat)."""
    d = constants._load("blosum62")
    prob = d["prob"]
    n = prob.shape[0]
    pback = prob.sum(axis=1)
    pback[n - 1] = 1e-5  # ANY_BACK (BaseMatrix.cpp:10)
    sub = np.log2(prob / (pback[:, None] * pback[None, :]))
    scaled = bit_factor * sub + bias
    sub_int = np.where(scaled < 0.0, scaled - 0.5,
                       scaled + 0.5).astype(np.int64).astype(np.int16)
    aa2num = d["aa2num"]
    return sub_int[aa2num[:, None], aa2num[None, :]]


def _msa2result(positional, space, stats):
    """msa2result (util/msa2result.cpp:26-488): MSA DB -> renumbered member
    sequence DB + header DB + per-MSA alignment result DB (each member
    aligned/rescored against the filtered-profile consensus).

    Reference quirks replicated: the counting state machine includes the
    record's trailing NUL so each MSA reserves one extra key
    (msa2result.cpp:80-127); match-mode 0 never writes maskedColumns (the
    mask-by-first block is commented out, msa2result.cpp:277-287) so no
    column is masked; the MsaFilter in-place shuffle permutes the member
    rows that the result records are emitted in (MsaFilter.cpp:557-568);
    member rows shorter than the first row re-read the kseq buffer's stale
    tail bytes (kseq buffer reuse)."""
    import ctypes
    from ..ops import msa as MSA
    from ..ops.evalue import EvalueComputer
    from ..ops.protein_align import (compress_cigar,
                                     update_result_by_rescoring_backtrace)
    from ..ops.rescore import format_seq_id
    from ..native import lib as native_lib
    if len(positional) != 3:
        raise ValueError("usage: msa2result <i:msaDB> <o:seqDB> <o:resultDB>")
    v = space.values
    mat = constants.blosum62()
    nat = native_lib()
    msa_type = v.get("msa_type", 2)
    match_mode = v.get("match_mode", 0)
    match_ratio = np.float32(v.get("match_ratio", 0.5))
    filter_msa = v.get("filter_msa", 1)
    skip_query = v.get("skip_query", False)
    gap_open, gap_extend = 11, 1
    wg = bool(v.get("wg", False))
    pca = v.get("pca", 0.0)
    pcb = v.get("pcb", 1.5)

    seq_reader = hdr_reader = None
    if msa_type == 0:
        from ..data import ca3m
        db = ca3m.open_ffindex(positional[0] + "_ca3m.ffdata",
                               positional[0] + "_ca3m.ffindex")
        seq_reader = ca3m.open_ffindex(positional[0] + "_sequence.ffdata",
                                       positional[0] + "_sequence.ffindex")
        hdr_reader = ca3m.open_ffindex(positional[0] + "_header.ffdata",
                                       positional[0] + "_header.ffindex")
        order = list(range(db.size))
    else:
        db = seqdb.SeqDB.open(positional[0])
        order = [int(i) for i in seqdb.data_order(db)]

    # counting pass (msa2result.cpp:71-127): state machine over the raw
    # record INCLUDING the trailing NUL byte
    set_sizes = np.zeros(db.size + 1, dtype=np.uint32)
    max_seq_length = 0
    for rank, i in enumerate(order):
        raw = db.get_data(i).tobytes() + b"\x00"
        in_header = False
        set_size = 0
        seq_len = 0
        for b in raw:
            if b == 0x3E:
                max_seq_length = max(max_seq_length, seq_len)
                seq_len = 0
                in_header = True
                set_size += 1
            elif b == 0x0A:
                in_header = False
            elif not in_header:
                seq_len += 1
        if not in_header and seq_len > 0:
            max_seq_length = max(max_seq_length, seq_len)
            set_size += 1
        set_sizes[rank] = set_size
    offsets = np.concatenate(([0], np.cumsum(set_sizes[:db.size])))
    max_seq_length = (max_seq_length // 32 + 2) * 32

    seq_writer = seqdb.DBWriter(seqdb.AMINO_ACIDS)
    hdr_writer = seqdb.DBWriter(seqdb.GENERIC_DB)
    res_writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)

    ascii_mat = _biased_ascii_mat(2.0, -0.2)
    evaluer = EvalueComputer.for_matrix("blosum62_11_1", db.size)

    kseq_buf = bytearray()

    for rank, i in enumerate(order):
        qkey = int(db.keys[i])
        raw = db.get_data(i).tobytes()
        if msa_type == 0:
            from ..data import ca3m
            raw = ca3m.extract_a3m(raw[:max(0, len(raw) - 1)],
                                   seq_reader, hdr_reader)
            if isinstance(raw, str):
                raw = raw.encode()
        # strip a leading comment line
        if raw[:1] == b"#":
            nl = raw.find(b"\n")
            raw = raw[nl + 1:] if nl >= 0 else b""

        records = _kseq_records(raw)
        if skip_query:
            next(records, None)

        rows = []       # uint8 numeric rows (centerLengthWithGaps wide)
        headers = []    # (name, comment)
        seqs_nogap = []
        fasta_error = False
        center_len_gaps = 0
        for name, comment, s in records:
            if len(name) == 0 or len(s) == 0:
                fasta_error = True
                break
            if len(s) > max_seq_length:
                fasta_error = True
                break
            if msa_type in (0, 1) and name.startswith(b"ss_"):
                continue
            if len(kseq_buf) < len(s) + 1:
                kseq_buf.extend(b"\x00" * (len(s) + 1 - len(kseq_buf)))
            kseq_buf[:len(s)] = s
            kseq_buf[len(s)] = 0
            headers.append((name, comment))
            seqs_nogap.append(bytes(s).replace(b"-", b""))
            if not rows:
                center_len_gaps = len(s)
            arr = np.frombuffer(bytes(kseq_buf[:center_len_gaps]),
                                dtype=np.uint8)
            if msa_type == 1:
                keep_cols = ~((arr >= ord("a")) & (arr <= ord("z")))
                arr = arr[keep_cols]
            num = mat.aa2num[arr].astype(np.uint8)
            num[arr == ord("-")] = MSA.GAP
            rows.append(num)
        if fasta_error:
            logger.warning(f"Invalid msa {rank}! Skipping entry.")
            continue
        set_size = len(rows)
        if set_size == 0:
            logger.warning(f"Empty msa {rank}! Skipping entry.")
            continue

        start_key = int(offsets[rank])
        for k, (name, comment) in enumerate(headers):
            hdr = name + (b" " + comment if comment else b"") + b"\n"
            hdr_writer.write(start_key + k, hdr, add_newline=False)
            seq_writer.write(start_key + k, seqs_nogap[k] + b"\n",
                             add_newline=False)

        width = max(len(r) for r in rows)
        msa_arr = np.full((set_size, width), MSA.GAP, dtype=np.uint8)
        for k, r in enumerate(rows):
            msa_arr[k, :len(r)] = r

        masked = np.zeros(center_len_gaps, dtype=np.uint8)
        if match_mode != 0:
            # weighted gap-fraction masking (msa2result.cpp:326-371)
            stride = ((center_len_gaps // 32) + 1) * 32
            wbuf = np.full((set_size, stride), MSA.GAP, dtype=np.uint8)
            wbuf[:, :width] = msa_arr
            weights = np.zeros(set_size, dtype=np.float32)
            f32p = ctypes.POINTER(ctypes.c_float)
            nat.pssm_seq_weights(
                wbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                set_size, stride, center_len_gaps,
                weights.ctypes.data_as(f32p))
            work = msa_arr[:, :center_len_gaps].copy()
            for k in range(set_size):
                l = 0
                while l < center_len_gaps and work[k, l] == MSA.GAP:
                    work[k, l] = MSA.ENDGAP
                    l += 1
                l = center_len_gaps - 1
                while l >= 0 and work[k, l] == MSA.GAP:
                    work[k, l] = MSA.ENDGAP
                    l -= 1
            for l in range(center_len_gaps):
                res_w = np.float32(0)
                gap_w = np.float32(0)
                for k in range(set_size):
                    c = work[k, l]
                    if c < MSA.GAP:
                        res_w += weights[k]
                    elif c != MSA.ENDGAP:
                        gap_w += weights[k]
                    else:
                        work[k, l] = MSA.GAP
                masked[l] = 1 if (gap_w / (res_w + gap_w)) > match_ratio \
                    else 0
            keep_cols = np.nonzero(masked == 0)[0]
            mask_cols = np.nonzero(masked == 1)[0]
            reordered = np.concatenate([work[:, keep_cols],
                                        work[:, mask_cols]], axis=1)
            msa_arr = np.full((set_size, width), MSA.GAP, dtype=np.uint8)
            msa_arr[:, :center_len_gaps] = reordered

        masked_count = int(masked.sum())
        center_len = center_len_gaps - masked_count

        # pad rows to the reference's 32B row stride for filter/PSSM
        stride = ((center_len_gaps // 32) + 1) * 32
        buf = np.full((set_size, stride), MSA.GAP, dtype=np.uint8)
        buf[:, :width] = msa_arr

        row_order = list(range(set_size))
        filtered_size = set_size
        if filter_msa == 1:
            keep, filtered_size = MSA.msa_filter(
                buf, center_len, coverage=int(v.get("cov_msa_thr", 0.0) * 100),
                qid_vec=_qid_vec(space), qsc=v.get("qsc", -20.0),
                max_seqid=int(v.get("filter_max_seq_id", 0.9) * 100),
                ndiff=v.get("filter_ndiff", 1000),
                filter_min_enable=v.get("filter_min_enable", 0))
            # MsaFilter::shuffleSequences in-place compaction
            ii = 0
            for j in range(set_size):
                if keep[j] != 0:
                    if ii < j:
                        row_order[ii], row_order[j] = \
                            row_order[j], row_order[ii]
                    ii += 1
            buf = buf[row_order]

        pssm = MSA.compute_pssm(buf[:filtered_size], center_len, wg=wg,
                                pca=pca, pcb=pcb)
        consensus_ascii = mat.num2aa[pssm["consensus"]]

        out_lines = []
        for k in range(set_size):
            row = buf[k]
            bt = []
            curr_nogap = []
            cons_nogap = []
            n_ident = 0
            col = 0
            cmask = 0
            for j in range(center_len_gaps):
                if masked[j] == 1:
                    cmask += 1
                    con_res = ord("-")
                    seq_v = row[center_len + cmask - 1]
                else:
                    col += 1
                    con_res = int(consensus_ascii[col - 1])
                    seq_v = row[col - 1]
                seq_res = ord("-") if seq_v == MSA.GAP \
                    else int(mat.num2aa[seq_v])
                if con_res == ord("-") and seq_res == ord("-"):
                    continue
                elif seq_res == ord("-"):
                    bt.append("I")
                    cons_nogap.append(con_res)
                elif con_res == ord("-"):
                    bt.append("D")
                    curr_nogap.append(seq_res)
                else:
                    bt.append("M")
                    curr_nogap.append(seq_res)
                    cons_nogap.append(con_res)
                if con_res == seq_res:
                    n_ident += 1
            bt = "".join(bt)
            seq_id = np.float32(n_ident) / np.float32(len(bt))
            res = {
                "dbKey": start_key + k, "score": 0, "seqId": seq_id,
                "eval": 0.0, "alnLength": len(bt),
                "qStartPos": 0, "qEndPos": len(cons_nogap) - 1,
                "qLen": len(cons_nogap),
                "dbStartPos": 0, "dbEndPos": len(curr_nogap) - 1,
                "dbLen": len(curr_nogap), "backtrace": bt,
            }
            update_result_by_rescoring_backtrace(
                bytes(cons_nogap), bytes(curr_nogap), ascii_mat, evaluer,
                gap_open, gap_extend, res)
            out_lines.append(
                f"{res['dbKey']}\t{res['score']}\t"
                f"{format_seq_id(res['seqId'])}\t{res['eval']:.3E}\t"
                f"{res['qStartPos']}\t{res['qEndPos']}\t{res['qLen']}\t"
                f"{res['dbStartPos']}\t{res['dbEndPos']}\t{res['dbLen']}\t"
                f"{compress_cigar(res['backtrace'])}\n")
        res_writer.write(qkey, "".join(out_lines).encode(),
                         add_newline=False)

    seq_writer.finish().save(positional[1])
    hdr_writer.finish().save(positional[1] + "_h")
    res_writer.finish().save(positional[2])
    for ext in (".lookup", ".source"):
        if os.path.exists(positional[0] + ext) and \
                not os.path.exists(positional[1] + ext):
            os.symlink(os.path.abspath(positional[0] + ext),
                       positional[1] + ext)
    return 0


# msa2result keeps msaType=2/pca=0.0 defaults (msa2result.cpp:21-24)
COMMANDS.append(
    Command("msa2result", _msa2result, lambda: port_space(_profile_flags() + [
        P.Flag("--msa-type", "msa_type", int, 2, "0: ca3m, 1: a3m, 2: FASTA", r"[0-2]")]),
            "<i:msaDB> <o:seqDB> <o:resultDB>",
            "Convert an MSA DB to a profile-vs-member result DB", hidden=True))
