"""Six-frame ORF extraction (reference: lib/mmseqs/src/commons/Orf.cpp:171-348,
lib/mmseqs/src/util/extractorfs.cpp:19-159).

Semantics replicated exactly:
 - per-frame scan over codons; state machine starts "inside" an ORF so the
   leading fragment before the first stop is emitted with an incomplete start
 - START_TO_STOP(0): ORF begins at the first start codon after a stop;
   ANY_TO_STOP(1): at the first codon after a stop;
   LAST_START_TO_STOP(2): restarts at every start codon
 - ORFs end right before a stop codon (stop excluded) or at the last complete
   codon of the frame (included, incomplete end)
 - emission order is by ending-codon position, frames interleaved, forward
   strand then reverse strand — this ordering defines the renumbered keys
 - length/gap filters count codons; gaps are codons containing N or letters
   with no IUPAC complement
"""
import numpy as np

from ..data.createdb import IUPAC_COMPLEMENT, iupac_revcomp
from ..data.seqdb import SeqDB, DBWriter, NUCLEOTIDES, GENERIC_DB, renumber

START_TO_STOP = 0
ANY_TO_STOP = 1
LAST_START_TO_STOP = 2

STRAND_PLUS = 1
STRAND_MINUS = -1

# stop codons of the canonical table; for other tables pass explicit lists
_STOPS_T1 = (b"TAA", b"TAG", b"TGA")
_STARTS_ATG = (b"ATG",)


def _codon_flags(seq_u8, codons):
    """bool[L] - position p starts one of the given 3-byte codons (uppercased)."""
    L = len(seq_u8)
    if L < 3:
        return np.zeros(L, dtype=bool)
    up = seq_u8 & np.uint8(~0x20 & 0xFF)
    flags = np.zeros(L, dtype=bool)
    c0 = up[:-2]
    c1 = up[1:-1]
    c2 = up[2:]
    hit = np.zeros(L - 2, dtype=bool)
    for c in codons:
        hit |= (c0 == c[0]) & (c1 == c[1]) & (c2 == c[2])
    flags[: L - 2] = hit
    return flags


def _gap_flags(seq_u8):
    """bool[L] - codon at p contains N or a letter without IUPAC complement."""
    up = seq_u8 & np.uint8(~0x20 & 0xFF)
    bad = (up == ord("N")) | (IUPAC_COMPLEMENT[seq_u8] == ord("."))
    L = len(seq_u8)
    flags = np.zeros(L, dtype=bool)
    if L >= 3:
        flags[: L - 2] = bad[:-2] | bad[1:-1] | bad[2:]
    return flags


def find_orfs_in_strand(seq_u8, min_length, max_length, max_gaps, start_mode,
                        frames_mask=0b111, stop_codons=_STOPS_T1,
                        start_codons=_STARTS_ATG):
    """Find ORFs on one strand. Returns list of (from, to, incomplete_start,
    incomplete_end) in reference emission order (ending position ascending)."""
    L = len(seq_u8)
    results = []
    if L < 3:
        return results
    is_stop = _codon_flags(seq_u8, stop_codons)
    is_start = _codon_flags(seq_u8, start_codons)
    is_gap = _gap_flags(seq_u8)

    for frame in range(3):
        if not (frames_mask >> frame) & 1:
            continue
        # complete-codon positions for this frame
        positions = np.arange(frame, L - 2, 3)
        if len(positions) == 0:
            continue
        stops = positions[is_stop[positions]]
        starts = positions[is_start[positions]]
        last_pos = int(positions[-1])

        # segments are delimited by stop codons; None marks the frame end
        # (the isLast emission at the final complete codon, Orf.cpp:276,318)
        inside = True
        has_start = False
        cur_from = frame
        prev_stop = None
        for stop_pos in list(int(s) for s in stops) + [None]:
            if inside and (stop_pos is None or cur_from <= stop_pos):
                end_by_stop = stop_pos is not None
                to = (stop_pos - 1) if end_by_stop else (last_pos + 2)
                from_ = cur_from
                if start_mode == LAST_START_TO_STOP:
                    # every start codon resets the ORF begin (Orf.cpp:292-303)
                    lo = np.searchsorted(starts, from_)
                    hi = np.searchsorted(starts, to, side="right")
                    if hi > lo:
                        from_ = int(starts[hi - 1])
                        has_start = True
                if end_by_stop:
                    n_codons = (stop_pos - from_) // 3
                else:
                    n_codons = (last_pos + 3 - from_) // 3
                if not (n_codons == 0 and end_by_stop):
                    seg_end = stop_pos if end_by_stop else last_pos + 1
                    seg_positions = np.arange(from_, seg_end, 3)
                    n_gaps = int(is_gap[seg_positions].sum()) if len(seg_positions) else 0
                    if not (n_gaps > max_gaps or n_codons > max_length or n_codons < min_length):
                        emit_pos = stop_pos if end_by_stop else last_pos
                        results.append((from_, to, not has_start,
                                        not end_by_stop, emit_pos))
                inside = False
                has_start = False
            if stop_pos is None:
                break
            if not inside:
                # next ORF begins after this stop
                nxt = stop_pos + 3
                if start_mode == ANY_TO_STOP:
                    if nxt <= last_pos:
                        cur_from = nxt
                        inside = True
                        has_start = False
                else:
                    idx = np.searchsorted(starts, nxt)
                    if idx < len(starts):
                        cur_from = int(starts[idx])
                        inside = True
                        has_start = True
            prev_stop = stop_pos
    # reference emits an ORF at the scan position where it ends (the stop
    # codon, or the frame's last codon), walking positions ascending across
    # interleaved frames — sort by that emission position
    results.sort(key=lambda r: r[4])
    return [r[:4] for r in results]


def _setseq(seq_u8):
    """Orf::setSequence char handling: only lowercase 'u' -> 't'
    (Orf.cpp:141-144 — the 'U' branch is overwritten by the next statement)."""
    out = seq_u8.copy()
    out[out == ord("u")] = ord("t")
    return out


def _revcomp_orf(seq_u8):
    """Orf revcomp: IUPAC complement with '.' replaced by 'N' (Orf.cpp:146-151)."""
    rc = iupac_revcomp(seq_u8)
    rc = rc.copy()
    rc[rc == ord(".")] = ord("N")
    return rc


def _batch_codon_flags(up2d, codons):
    """bool[N, L] - position starts one of the 3-byte codons (rows padded)."""
    n, L = up2d.shape
    flags = np.zeros((n, L), dtype=bool)
    if L < 3:
        return flags
    c0 = up2d[:, :-2]
    c1 = up2d[:, 1:-1]
    c2 = up2d[:, 2:]
    hit = np.zeros((n, L - 2), dtype=bool)
    for c in codons:
        hit |= (c0 == c[0]) & (c1 == c[1]) & (c2 == c[2])
    flags[:, : L - 2] = hit
    return flags


def _batch_strand_orfs(s2d, lens, min_length, max_length, max_gaps,
                       start_mode, frames_mask, stop_codons, start_codons):
    """Vectorized find_orfs_in_strand over a padded batch [N, L].

    Returns (row, from, to, inc_start, inc_end, emit_pos) arrays covering
    every ORF of every row, unsorted. Same segment semantics as the scalar
    reference loop (Orf.cpp:171-348): segments delimited by stop codons, a
    leading incomplete-start segment, start-codon anchoring per mode, the
    n_codons==0-at-stop skip, and codon-window gap/length filters.
    """
    n, L = s2d.shape
    up = s2d & np.uint8(~0x20 & 0xFF)
    is_stop = _batch_codon_flags(up, stop_codons)
    is_start = _batch_codon_flags(up, start_codons)
    bad = (up == ord("N")) | (IUPAC_COMPLEMENT[s2d] == ord("."))
    is_gap = np.zeros((n, L), dtype=bool)
    if L >= 3:
        is_gap[:, : L - 2] = bad[:, :-2] | bad[:, 1:-1] | bad[:, 2:]

    out = []
    for frame in range(3):
        if not (frames_mask >> frame) & 1:
            continue
        # codon-index grid: position = frame + 3*c, c in [0, ncod)
        C = (L - frame + 2) // 3
        if C <= 0:
            continue
        cpos = frame + 3 * np.arange(C)
        cpos = cpos[cpos <= L - 3] if L >= 3 else cpos[:0]
        C = len(cpos)
        if C == 0:
            continue
        ncod = np.maximum((lens - frame) // 3, 0)  # complete codons per row
        V = np.arange(C)[None, :] < ncod[:, None]
        Sstop = is_stop[:, cpos] & V
        Sstart = is_start[:, cpos] & V
        Sgap = is_gap[:, cpos] & V

        # prefix sums of gaps: gaps in [a, b) = Pg[b] - Pg[a]
        Pg = np.zeros((n, C + 1), dtype=np.int64)
        np.cumsum(Sgap, axis=1, out=Pg[:, 1:])
        # next start codon at-or-after c (suffix min), C where none
        ci = np.arange(C)
        ns = np.where(Sstart, ci[None, :], C)
        ns = np.minimum.accumulate(ns[:, ::-1], axis=1)[:, ::-1]
        ns = np.concatenate([ns, np.full((n, 1), C)], axis=1)  # ns[c] valid c<=C
        # last start codon at-or-before c (prefix max), -1 where none
        ps = np.where(Sstart, ci[None, :], -1)
        ps = np.maximum.accumulate(ps, axis=1)
        ps = np.concatenate([np.full((n, 1), -1), ps], axis=1)  # ps1[c] = last<=c-1

        rows_k, c_k = np.nonzero(Sstop)  # row-major, c ascending per row
        first_in_row = np.ones(len(rows_k), dtype=bool)
        first_in_row[1:] = rows_k[1:] != rows_k[:-1]
        prev_c = np.empty(len(c_k), dtype=np.int64)
        if len(c_k):
            prev_c[1:] = c_k[:-1]
        prev_c[first_in_row] = -1

        # final (incomplete-end) segment per row: anchor = last stop or -1
        last_stop = np.full(n, -1, dtype=np.int64)
        if len(rows_k):
            last_stop[rows_k] = c_k  # ascending per row: last write wins
        frow = np.nonzero(ncod > 0)[0]

        seg_row = np.concatenate([rows_k, frow])
        seg_anchor = np.concatenate([prev_c, last_stop[frow]])
        seg_end = np.concatenate([c_k, ncod[frow]])      # exclusive codon end
        by_stop = np.zeros(len(seg_row), dtype=bool)
        by_stop[: len(rows_k)] = True

        lead = seg_anchor < 0
        if start_mode == ANY_TO_STOP:
            from_c = np.where(lead, 0, seg_anchor + 1)
            has_start = np.zeros(len(seg_row), dtype=bool)
        else:  # START / LAST: first start codon after the previous stop
            nxt = np.clip(seg_anchor + 1, 0, C)
            from_c = np.where(lead, 0, ns[seg_row, nxt])
            has_start = ~lead
        if start_mode == LAST_START_TO_STOP:
            # last start <= (seg_end - 1): stop segments search up to the
            # codon before the stop; final segments up to the last codon
            pl = ps[seg_row, seg_end]
            upd = pl >= from_c
            from_c = np.where(upd, pl, from_c)
            has_start = has_start | upd

        n_codons = seg_end - from_c
        # stop segments: from<=stop_c and n_codons>0 collapse to from<=c_k-1;
        # final segments: the scalar `inside` guard requires from<=ncod-1
        emit = from_c <= (seg_end - 1)
        n_gaps = Pg[seg_row, seg_end] - Pg[seg_row, np.minimum(from_c, C)]
        emit &= ~((n_gaps > max_gaps) | (n_codons > max_length)
                  | (n_codons < min_length))

        sel = np.nonzero(emit)[0]
        r = seg_row[sel]
        fc = from_c[sel]
        ec = seg_end[sel]
        bs = by_stop[sel]
        from_pos = frame + 3 * fc
        to_pos = np.where(bs, frame + 3 * ec - 1,
                          frame + 3 * (ncod[r] - 1) + 2)
        emit_pos = np.where(bs, frame + 3 * ec, frame + 3 * (ncod[r] - 1))
        out.append((r, from_pos, to_pos, ~has_start[sel], ~bs, emit_pos))
    if not out:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z.astype(bool), z.astype(bool), z
    return tuple(np.concatenate(parts) for parts in zip(*out))


def extract_orfs(seq_db, min_length=30, max_length=32734, max_gaps=2**31 - 1,
                 start_mode=ANY_TO_STOP, contig_start_mode=2, contig_end_mode=2,
                 forward_frames=0b111, reverse_frames=0b111,
                 stop_codons=_STOPS_T1, start_codons=_STARTS_ATG,
                 chunk_cells=64_000_000):
    """extractorfs: nucleotide DB -> (orf nucleotide DB, orf header DB).

    Output keys are renumbered 0..N-1; headers are
    ``<contig key>\\t<from>±<len>[\\t<completeflag>]`` (Orf::writeOrfHeader).

    Batched: records are processed as padded [rows, Lmax] chunks through
    vectorized segment scans instead of a per-record / per-stop-codon loop
    (the scalar oracle find_orfs_in_strand stays for equivalence tests).
    """
    all_lens = seq_db.seq_lens()
    n_all = seq_db.size
    frag_parts, hdr_parts, frag_lens = [], [], []
    row0 = 0
    while row0 < n_all:
        # contiguous row chunk bounded by padded cell count (order-preserving)
        lmax_run = 0
        row1 = row0
        while row1 < n_all:
            lmax_run = max(lmax_run, int(all_lens[row1]))
            if (row1 + 1 - row0) * max(lmax_run, 1) > chunk_cells and row1 > row0:
                break
            row1 += 1
        lens = all_lens[row0:row1].astype(np.int64)
        nloc = row1 - row0
        lmax = max(int(lens.max()) if nloc else 0, 3)
        fwd = np.zeros((nloc, lmax), dtype=np.uint8)
        total = int(lens.sum())
        rr = np.repeat(np.arange(nloc), lens)
        cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
        cc = np.arange(total) - np.repeat(cum, lens)
        src = np.repeat(seq_db.offsets[row0:row1].astype(np.int64), lens) + cc
        flat = np.asarray(seq_db.data[src])
        flat[flat == ord("u")] = ord("t")  # Orf::setSequence (Orf.cpp:141-144)
        fwd[rr, cc] = flat
        # reverse complement per row (complement then reverse within length)
        rc_flat = IUPAC_COMPLEMENT[flat].copy()
        rc_flat[rc_flat == ord(".")] = ord("N")
        rev = np.zeros((nloc, lmax), dtype=np.uint8)
        rev[rr, lens[rr] - 1 - cc] = rc_flat

        chunk = []
        for strand, s2d, mask in ((STRAND_PLUS, fwd, forward_frames),
                                  (STRAND_MINUS, rev, reverse_frames)):
            if mask == 0:
                continue
            ok = lens >= 3
            r, fp, tp, inc_s, inc_e, ep = _batch_strand_orfs(
                s2d, np.where(ok, lens, 0), min_length, max_length, max_gaps,
                start_mode, mask, stop_codons, start_codons)
            if contig_start_mode < 2:
                keep = inc_s.astype(np.int64) != contig_start_mode
                r, fp, tp, inc_s, inc_e, ep = (x[keep] for x in
                                               (r, fp, tp, inc_s, inc_e, ep))
            if contig_end_mode < 2:
                keep = inc_e.astype(np.int64) != contig_end_mode
                r, fp, tp, inc_s, inc_e, ep = (x[keep] for x in
                                               (r, fp, tp, inc_s, inc_e, ep))
            sidx = np.full(len(r), 0 if strand == STRAND_PLUS else 1,
                           dtype=np.int64)
            chunk.append((r, sidx, fp, tp, inc_s, inc_e, ep))
        if not chunk:
            row0 = row1
            continue
        r, sidx, fp, tp, inc_s, inc_e, ep = (np.concatenate(p)
                                             for p in zip(*chunk))
        # reference emission order: per record, + strand then -, then by
        # the scan position where each ORF ends (frames interleaved)
        order = np.lexsort((ep, sidx, r))
        r, sidx, fp, tp, inc_s, inc_e = (x[order] for x in
                                         (r, sidx, fp, tp, inc_s, inc_e))
        # fragment bytes gathered from the strand matrices in one shot
        flen = tp - fp + 1
        if len(flen):
            strand_flat = np.concatenate([fwd.reshape(-1), rev.reshape(-1)])
            base = sidx * (nloc * lmax) + r * lmax + fp
            fsrc = np.repeat(base, flen) + (
                np.arange(int(flen.sum()))
                - np.repeat(np.concatenate([[0], np.cumsum(flen)[:-1]]),
                            flen))
            frag_parts.append(strand_flat[fsrc])
            frag_lens.append(flen)
        # header coordinates: minus strand flips to contig coordinates
        Lr = lens[r]
        hfp = np.where(sidx == 1, (Lr - 1) - fp, fp)
        htp = np.where(sidx == 1, (Lr - 1) - tp, tp)
        keys = seq_db.keys[row0:row1]
        for i in range(len(r)):
            hdr_parts.append(_orf_header(int(keys[r[i]]), int(hfp[i]),
                                         int(htp[i]), bool(inc_s[i]),
                                         bool(inc_e[i])))
        row0 = row1

    # assemble the two DBs directly (write order == key order 0..N-1)
    flen = (np.concatenate(frag_lens) if frag_lens
            else np.zeros(0, dtype=np.int64))
    n_orfs = len(flen)
    rec_lens = flen + 2  # payload + "\n\0"
    offsets = np.zeros(n_orfs, dtype=np.int64)
    if n_orfs > 1:
        np.cumsum(rec_lens[:-1], out=offsets[1:])
    data = np.zeros(int(rec_lens.sum()), dtype=np.uint8)
    if n_orfs:
        fill = (np.repeat(offsets, flen)
                + (np.arange(int(flen.sum()))
                   - np.repeat(np.concatenate([[0], np.cumsum(flen)[:-1]]),
                               flen)))
        data[fill] = np.concatenate(frag_parts)
        data[offsets + flen] = ord("\n")
    keys = np.arange(n_orfs, dtype=np.uint32)
    orf_db = SeqDB(data, keys, offsets, rec_lens, NUCLEOTIDES)
    hdr_writer = DBWriter(GENERIC_DB)
    for k, h in enumerate(hdr_parts):
        hdr_writer.write(k, h)
    hdr_db = hdr_writer.finish(sort_by_key=False)
    return orf_db, hdr_db


def _orf_header(key, from_pos, to_pos, inc_start, inc_end):
    """Orf::writeOrfHeader (Orf.cpp:440-457)."""
    sign = "+" if from_pos < to_pos else "-"
    length = abs(from_pos - to_pos)
    complete = int(inc_start) | (int(inc_end) << 1)
    s = f"{key}\t{from_pos}{sign}{length}"
    if complete != 0:
        s += f"\t{complete}"
    return s.encode()


def parse_orf_header(data):
    """Orf::parseOrfHeader (Orf.cpp:351-438) -> dict or None."""
    parts = data.split()
    if len(parts) < 2:
        return None
    try:
        key = int(parts[0])
        span = parts[1].decode() if isinstance(parts[1], bytes) else parts[1]
    except ValueError:
        return None
    for sep in ("+", "-"):
        if sep in span[1:]:
            a, _, b = span.partition(sep)
            try:
                frm = int(a)
                ln = int(b)
            except ValueError:
                return None
            to = frm + ln if sep == "+" else frm - ln
            complete = 0
            if len(parts) == 3:
                try:
                    complete = int(parts[2])
                except ValueError:
                    complete = 0
            return {
                "id": key, "from": frm, "to": to,
                "incomplete_start": bool(complete & 1),
                "incomplete_end": bool(complete & 2),
                "strand": STRAND_MINUS if frm > to else STRAND_PLUS,
            }
    return None
