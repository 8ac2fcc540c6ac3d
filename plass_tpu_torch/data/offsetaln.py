"""offsetalignment: project ORF-level alignments back to source-contig
coordinates (reference: lib/mmseqs/src/util/offsetalignment.cpp).

Handles the non-precomputed-index cases:
 - query nucleotide: alignments of the query ORF DB are re-grouped per
   source contig (one output record per contig key, ORF-key order);
 - target nucleotide: per-entry coordinate update only;
 - translated searches multiply protein coordinates by 3 and extend the
   end by +2 (updateOffset, offsetalignment.cpp:94-160).
"""
import numpy as np

from . import seqdb
from ..ops.orf import parse_orf_header
from ..ops.rescore import format_seq_id

# Parameters.h search types
SEARCH_TYPE_AUTO = 0
SEARCH_TYPE_PROTEIN = 1
SEARCH_TYPE_TRANSLATED = 2
SEARCH_TYPE_NUCLEOTIDES = 3
SEARCH_TYPE_TRANS_NUCL_ALN = 4


def _parse_line(line):
    f = line.split("\t")
    r = {
        "dbKey": int(f[0]), "score": int(f[1]), "seqId": float(f[2]),
        "eval": float(f[3]), "qStart": int(f[4]), "qEnd": int(f[5]),
        "qLen": int(f[6]), "tStart": int(f[7]), "tEnd": int(f[8]),
        "tLen": int(f[9]),
        "backtrace": f[10] if len(f) > 10 else "",
        "qOrfStart": -1, "qOrfEnd": -1, "tOrfStart": -1, "tOrfEnd": -1,
    }
    return r


def _serialize(r, trans_nucl_aln=False):
    bt = r["backtrace"]
    if trans_nucl_aln and bt:
        # Matcher::result_t::protein2nucl: each cigar op repeated x3
        out = []
        num = ""
        for c in bt:
            if c.isdigit():
                num += c
            else:
                n = int(num) if num else 1
                out.append(f"{3 * n}{c}" if num else c * 3)
                num = ""
        bt = "".join(out)
    tail = f"\t{bt}" if bt else ""
    return (f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
            f"{r['eval']:.3E}\t{r['qStart']}\t{r['qEnd']}\t{r['qLen']}\t"
            f"{r['tStart']}\t{r['tEnd']}\t{r['tLen']}\t"
            f"{r['qOrfStart']}\t{r['qOrfEnd']}\t{r['tOrfStart']}\t"
            f"{r['tOrfEnd']}{tail}\n")


def _update_offset(results, qloc, t_hdr_db, target_needs_update, is_nucl_search):
    """updateOffset (offsetalignment.cpp:94-160)."""
    for r in results:
        if target_needs_update or qloc is None:
            tid = t_hdr_db.key_to_id(r["dbKey"])
            tloc = parse_orf_header(t_hdr_db.get_data(tid).tobytes().decode())
            if tloc is not None:
                r["dbKey"] = tloc["id"]
                frm = tloc["from"]
                to = tloc["to"]
            else:
                # headerless target: minus strand impossible to detect; from=0
                frm, to = 0, -1
            ts = r["tStart"] if is_nucl_search else r["tStart"] * 3
            te = r["tEnd"] if is_nucl_search else r["tEnd"] * 3
            r["tOrfStart"] = frm
            r["tOrfEnd"] = to
            if tloc is not None and tloc["from"] > tloc["to"]:  # minus strand
                r["tStart"] = frm - ts
                r["tEnd"] = frm - te
                if not is_nucl_search:
                    r["tEnd"] -= 2
            else:
                r["tStart"] = frm + ts
                r["tEnd"] = frm + te
                if not is_nucl_search:
                    r["tEnd"] += 2
        if qloc is not None:
            qs = r["qStart"] if is_nucl_search else r["qStart"] * 3
            qe = r["qEnd"] if is_nucl_search else r["qEnd"] * 3
            frm = qloc["from"]
            r["qOrfStart"] = frm
            r["qOrfEnd"] = qloc["to"]
            if qloc["from"] > qloc["to"]:  # minus strand
                r["qStart"] = frm - qs
                r["qEnd"] = frm - qe
                if not is_nucl_search:
                    r["qEnd"] -= 2
            else:
                r["qStart"] = frm + qs
                r["qEnd"] = frm + qe
                if not is_nucl_search:
                    r["qEnd"] += 2


def offset_alignment(q_src_path, q_hdr_db, t_src_path, t_hdr_db, aln_db,
                     search_type=SEARCH_TYPE_AUTO):
    """Returns the offsetted alignment SeqDB."""
    query_dbtype = seqdb.read_dbtype(q_src_path)
    target_dbtype = seqdb.read_dbtype(t_src_path)
    query_nucl = query_dbtype == seqdb.NUCLEOTIDES
    target_nucl = target_dbtype == seqdb.NUCLEOTIDES

    is_nucl_nucl = False
    is_trans_trans = False
    is_trans_nucl_aln = False
    if target_nucl:
        seqtarget_nuc = True
        if search_type == SEARCH_TYPE_TRANSLATED:
            seqtarget_nuc = False
            is_trans_trans = True
        elif search_type == SEARCH_TYPE_NUCLEOTIDES:
            seqtarget_nuc = True
        elif search_type == SEARCH_TYPE_TRANS_NUCL_ALN:
            is_trans_nucl_aln = True
            seqtarget_nuc = False
            is_trans_trans = True
        is_nucl_nucl = query_nucl and target_nucl and seqtarget_nuc
    target_needs_update = is_nucl_nucl or is_trans_trans

    q_src = seqdb.SeqDB.open(q_src_path) if query_nucl else None
    t_src = seqdb.SeqDB.open(t_src_path) if target_nucl else None
    emit_trans_bt = is_trans_nucl_aln and not is_nucl_nucl and is_trans_trans

    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)

    def finish_record(qkey, qlen, results):
        # updateLengths + compareHits stable sort (offsetalignment.cpp:163-176)
        for r in results:
            if qlen is not None:
                r["qLen"] = qlen
            if t_src is not None:
                r["tLen"] = t_src.seq_len(t_src.key_to_id(r["dbKey"]))
        results.sort(key=lambda r: (r["eval"], -r["score"], r["tLen"], r["dbKey"]))
        writer.write(qkey, "".join(
            _serialize(r, emit_trans_bt) for r in results).encode(),
            add_newline=False)

    if query_nucl:
        # contig -> [orf keys] from the ORF headers, ORF-key ascending
        contig_orfs = {}
        aln_keyset = set(int(k) for k in aln_db.keys)
        max_orf_key = max(aln_keyset) if aln_keyset else -1
        for orf_key in range(max_orf_key + 1):
            qid = q_hdr_db.key_to_id(orf_key)
            if qid is None:
                continue
            loc = parse_orf_header(q_hdr_db.get_data(qid).tobytes().decode())
            cid = loc["id"] if loc is not None else orf_key
            contig_orfs.setdefault(cid, []).append(orf_key)
        for i in range(q_src.size):
            contig_key = int(q_src.keys[i])
            qlen = q_src.seq_len(i)
            results = []
            for orf_key in contig_orfs.get(contig_key, []):
                aid = aln_db.key_to_id(orf_key)
                if aid is None:
                    continue
                qid = q_hdr_db.key_to_id(orf_key)
                qloc = parse_orf_header(q_hdr_db.get_data(qid).tobytes().decode())
                recs = [_parse_line(ln) for ln in
                        aln_db.get_data(aid).tobytes().decode().split("\n") if ln]
                _update_offset(recs, qloc, t_hdr_db, target_needs_update,
                               is_nucl_nucl)
                results.extend(recs)
            finish_record(contig_key, qlen, results)
    elif target_nucl:
        for i in seqdb.data_order(aln_db):
            i = int(i)
            qkey = int(aln_db.keys[i])
            recs = [_parse_line(ln) for ln in
                    aln_db.get_data(i).tobytes().decode().split("\n") if ln]
            _update_offset(recs, None, t_hdr_db, True, is_nucl_nucl)
            finish_record(qkey, None, recs)
    else:
        raise ValueError("offsetalignment requires a nucleotide query or "
                         "target source DB")
    return writer.finish()
