"""The one traffic generator: a sequence DB made from a traffic file and a
seed, on the device, with a seeded `torch.Generator` and in a few large
calls.

A traffic file (`perfbench/traffic/<name>.json`) is data only:

  community   {"kind": "coding" | "random", "genomes", "genome_len"}; a
              coding genome is a row of genes (ATG, `gene_codons` seeded
              sense codons, a stop) on either strand with `spacer` random
              bases between them; a random genome is uniform ACGT
  abundance_sigma  genome weights exp(sigma * N(0, 1)), log-normal
  sequences   how many reads or contigs are drawn
  length      {"min", "max"}: fixed when equal, else log-uniform
  revcomp_share, sub_rate  reverse-complemented share; substitutions per
              residue (a substituted base is drawn from all four)

Each seed gets the same amount of work (_draw).
  db          "nucleotide": the sequences as they are; "orfs": their
              six-frame ORFs, translated with table 1 (`orfs` below)

Returns the DB as plain arrays (`Db`): data uint8 (each sequence followed
by "\\n\\0", as a SeqDB holds it), keys uint32 0..N-1, offsets and record
lengths int64. The same seed and device give the same arrays.
"""
import math
from dataclasses import dataclass

import numpy as np
import torch

ACGT = b"ACGT"
# codons as b0 * 16 + b1 * 4 + b2, bases A0 C1 G2 T3
ATG = 0 * 16 + 3 * 4 + 2
STOPS = (3 * 16 + 0 * 4 + 0, 3 * 16 + 0 * 4 + 2, 3 * 16 + 2 * 4 + 0)
SENSE = [c for c in range(64) if c not in STOPS]
# NCBI translation table 1 in the TCAG order it is published in
TABLE1_TCAG = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
# elements of a generation chunk
CHUNK = 1 << 25


@dataclass
class Db:
    data: np.ndarray
    keys: np.ndarray
    offsets: np.ndarray
    lengths: np.ndarray

    @property
    def size(self):
        return len(self.keys)


def _table1_acgt():
    """uint8[64] amino-acid char of a codon b0 * 16 + b1 * 4 + b2."""
    tcag = {b: i for i, b in enumerate("TCAG")}
    acgt = "ACGT"
    out = np.zeros(64, dtype=np.uint8)
    for c in range(64):
        b = (acgt[c >> 4], acgt[(c >> 2) & 3], acgt[c & 3])
        out[c] = ord(TABLE1_TCAG[tcag[b[0]] * 16 + tcag[b[1]] * 4
                                 + tcag[b[2]]])
    return out


def community(spec, gen, device):
    """uint8[genomes, genome_len] base codes (A0 C1 G2 T3)."""
    n, length = spec["genomes"], spec["genome_len"]
    if spec["kind"] == "random":
        return torch.randint(0, 4, (n, length), generator=gen, device=device,
                             dtype=torch.uint8)
    if spec["kind"] != "coding":
        raise ValueError(f"unknown community kind {spec['kind']!r}")
    lo_c, hi_c = spec["gene_codons"]
    lo_s, hi_s = spec["spacer"]
    units = length // (3 * (lo_c + 2) + lo_s) + 2
    ncod = torch.randint(lo_c, hi_c, (n, units), generator=gen, device=device)
    spacer = torch.randint(lo_s, hi_s, (n, units), generator=gen,
                           device=device)
    rev = torch.rand((n, units), generator=gen, device=device) < 0.5
    stop = torch.randint(0, 3, (n, units), generator=gen, device=device)
    sense = torch.randint(0, len(SENSE), (n, length), generator=gen,
                          device=device)
    filler = torch.randint(0, 4, (n, length), generator=gen, device=device)
    gene_len = 3 * (ncod + 2)
    unit_len = gene_len + spacer
    start = torch.cumsum(unit_len, 1) - unit_len
    pos = torch.arange(length, device=device).expand(n, length).contiguous()
    u = torch.searchsorted(start, pos, right=True) - 1
    o = pos - start.gather(1, u)
    glen = gene_len.gather(1, u)
    urev = rev.gather(1, u)
    of = torch.where(urev, glen - 1 - o, o)      # place in the forward gene
    c, ph = of // 3, of % 3
    slot = (start.gather(1, u) + c).clamp(0, length - 1)
    sense_codon = torch.tensor(SENSE, device=device)[sense.gather(1, slot)]
    stop_codon = torch.tensor(STOPS, device=device)[stop.gather(1, u)]
    codon = torch.where(c == 0, ATG,
                        torch.where(c <= ncod.gather(1, u), sense_codon,
                                    stop_codon))
    base = (codon >> (2 * (2 - ph))) & 3
    base = torch.where(urev, 3 - base, base)
    return torch.where(o < glen, base, filler).to(torch.uint8)


def _fixed_counts(weights, total):
    """Whole counts summing to `total` in proportion to `weights`: the
    floors, and one more for the largest remainders."""
    share = weights / weights.sum() * total
    counts = share.floor().long()
    rest = total - int(counts.sum())
    counts[torch.argsort(share - counts, descending=True)[:rest]] += 1
    return counts


def _draw(traffic, genomes, gen, device):
    """Per sequence: genome, start, length, reverse flag (device tensors).

    Every seed draws the same amount of work in another order: the
    genomes' abundances are the log-normal's quantiles, the sequences a
    genome gets are fixed by its abundance, the lengths are the
    log-uniform's quantiles, and the reverse-complemented share is exact;
    the seed permutes which genome gets which abundance, which sequence
    which length and genome, and draws the genomes and the starts."""
    n_gen, glen = genomes.shape
    s = traffic["sequences"]
    q = (torch.arange(n_gen, device=device, dtype=torch.float64) + 0.5) / n_gen
    w = torch.exp(traffic["abundance_sigma"] * torch.special.ndtri(q))
    w = w[torch.randperm(n_gen, generator=gen, device=device)]
    g = torch.repeat_interleave(torch.arange(n_gen, device=device),
                                _fixed_counts(w, s))
    g = g[torch.randperm(s, generator=gen, device=device)]
    lo, hi = traffic["length"]["min"], min(traffic["length"]["max"], glen)
    q = (torch.arange(s, device=device, dtype=torch.float64) + 0.5) / s
    lens = torch.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))
    lens = lens.floor().long().clamp(lo, hi)
    lens = lens[torch.randperm(s, generator=gen, device=device)]
    u = torch.rand(s, generator=gen, device=device, dtype=torch.float64)
    start = (u * (glen - lens + 1)).floor().long().clamp(max=glen - lens)
    rc = torch.zeros(s, dtype=torch.bool, device=device)
    rc[torch.randperm(s, generator=gen, device=device)
       [:round(s * traffic["revcomp_share"])]] = True
    return g, start, lens, rc


def _chunks(lens):
    """[lo, hi) sequence ranges of at most CHUNK residues (one sequence at
    least)."""
    cs = np.concatenate([[0], np.cumsum(lens)])
    lo, n = 0, len(lens)
    while lo < n:
        hi = int(np.searchsorted(cs, cs[lo] + CHUNK, side="right")) - 1
        hi = min(max(hi, lo + 1), n)
        yield lo, hi
        lo = hi


def _sequences(traffic, genomes, gen, device):
    """(lengths, chunks): the sequences' lengths, and an iterator of (lo,
    hi, codes) per chunk of sequences [lo, hi), codes int64 of their
    residues back to back, read from their genomes, reverse-complemented
    where drawn, with seeded substitutions."""
    g, start, lens, rc = _draw(traffic, genomes, gen, device)
    lens_h = lens.cpu().numpy()
    return lens_h, _codes(traffic, genomes, gen, device, g, start, lens, rc,
                          lens_h)


def _codes(traffic, genomes, gen, device, g, start, lens, rc, lens_h):
    flat = genomes.reshape(-1)
    glen = genomes.shape[1]
    for lo, hi in _chunks(lens_h):
        ln = lens[lo:hi]
        sid = torch.repeat_interleave(torch.arange(hi - lo, device=device), ln)
        off = torch.cumsum(ln, 0) - ln
        j = torch.arange(sid.numel(), device=device) - off[sid]
        r = rc[lo:hi][sid]
        src = torch.where(r, ln[sid] - 1 - j, j)
        base = flat[g[lo:hi][sid] * glen + start[lo:hi][sid] + src].long()
        base = torch.where(r, 3 - base, base)
        # distinct positions: a position drawn twice would take whichever
        # write lands last
        n_sub = round(traffic["sub_rate"] * base.numel())
        at = torch.randperm(base.numel(), generator=gen,
                            device=device)[:n_sub]
        base[at] = torch.randint(0, 4, (n_sub,), generator=gen, device=device)
        yield lo, hi, base


def _pack(pieces, lens):
    """A Db of sequences given as flat uint8 device pieces in key order."""
    lens = np.asarray(lens, dtype=np.int64)
    rec = lens + 2
    offsets = np.concatenate([[0], np.cumsum(rec)[:-1]]).astype(np.int64)
    data = np.empty(int(rec.sum()), dtype=np.uint8)
    ends = offsets + lens
    seq_pos = np.ones(len(data), dtype=bool)
    seq_pos[ends] = False
    seq_pos[ends + 1] = False
    data[seq_pos] = np.concatenate([p.cpu().numpy() for p in pieces]) \
        if pieces else np.zeros(0, np.uint8)
    data[ends] = ord("\n")
    data[ends + 1] = 0
    return Db(data, np.arange(len(lens), dtype=np.uint32), offsets, rec)


def nucleotide_db(traffic, genomes, gen, device):
    lens, it = _sequences(traffic, genomes, gen, device)
    acgt = torch.tensor(list(ACGT), dtype=torch.uint8, device=device)
    pieces = [acgt[base] for _, _, base in it]
    return _pack(pieces, lens)


def orfs_db(traffic, genomes, gen, device):
    """Six-frame ORFs of fixed-length reads, translated with table 1, as
    `plass assemble` makes its protein DB (Assembler.cpp:117-130): the
    LONG set, ORFs of long_min to long_max codons whether or not they
    start at a start codon or end at a stop, then the START set, ORFs of
    start_min to start_max codons that begin at the first ATG after a stop
    and run off the read's end. An ORF starts at the read's first codon
    of its frame (an open start) or at the first ATG after a stop, and
    ends before the next stop (a closed end) or at the frame's last codon.
    '*' brackets a closed start or end, as translatenucs --add-orf-stop
    writes them."""
    o = traffic["orfs"]
    if traffic["length"]["min"] != traffic["length"]["max"]:
        raise ValueError("ORFs are made of fixed-length reads")
    _, it = _sequences(traffic, genomes, gen, device)
    read_len = traffic["length"]["min"]
    aa = torch.from_numpy(_table1_acgt()).to(device)
    star = ord("*")
    stop_t = torch.tensor(STOPS, device=device)
    sets = ([], [])   # LONG, START pieces and lengths, in read order
    lens = ([], [])
    for lo, hi, base in it:
        fwd = base.view(hi - lo, read_len)
        strands = (fwd, 3 - fwd.flip(1))
        frames = []
        ncod = read_len // 3
        for s in strands:
            for f in range(3):
                c = (read_len - f) // 3
                b = s[:, f:f + 3 * c].reshape(-1, c, 3)
                codon = b[..., 0] * 16 + b[..., 1] * 4 + b[..., 2]
                if c < ncod:
                    codon = torch.cat([codon, torch.full(
                        (codon.shape[0], ncod - c), -1, device=device)], 1)
                frames.append(codon)
        codon = torch.stack(frames, 1).reshape(-1, ncod)   # [reads * 6, C]
        width = torch.tensor([(read_len - f) // 3 for f in range(3)] * 2,
                             device=device).repeat(hi - lo)
        cidx = torch.arange(ncod, device=device)
        valid = cidx[None, :] < width[:, None]
        is_stop = torch.isin(codon, stop_t) & valid
        is_atg = (codon == ATG) & valid
        # first stop at or after c; last stop before c
        nxt = torch.where(is_stop, cidx, ncod).flip(1).cummin(1).values.flip(1)
        nxt = torch.minimum(nxt, width[:, None])
        prev = torch.where(is_stop, cidx, -1).cummax(1).values
        prev = torch.cat([torch.full_like(prev[:, :1], -1), prev[:, :-1]], 1)
        atg_cs = torch.cumsum(is_atg.long(), 1)
        atg_before = torch.where(
            prev >= 0, atg_cs.gather(1, prev.clamp(min=0)), 0)
        first_atg = is_atg & (prev >= 0) & (atg_cs - 1 - atg_before == 0)
        # the open-start ORF of each frame begins at codon 0
        frame_rows = torch.arange(codon.shape[0], device=device)
        end0 = nxt[:, 0]
        rows_b, from_b = first_atg.nonzero(as_tuple=True)
        rows = torch.cat([frame_rows, rows_b])
        frm = torch.cat([torch.zeros_like(frame_rows), from_b])
        end = torch.cat([end0, nxt[rows_b, from_b]])
        closed_start = torch.cat([
            torch.zeros_like(frame_rows, dtype=torch.bool),
            torch.ones_like(rows_b, dtype=torch.bool)])
        n = end - frm
        closed_end = end < width[rows]
        ok = ~((n == 0) & closed_end)
        long_sel = ok & (n >= o["long_min"]) & (n <= o["long_max"])
        start_sel = (ok & closed_start & ~closed_end & (n >= o["start_min"])
                     & (n <= o["start_max"]))
        for k, sel in enumerate((long_sel, start_sel)):
            # read order, then frame, then start codon
            idx = sel.nonzero()[:, 0]
            key = rows[idx] * (ncod + 1) + frm[idx]
            idx = idx[torch.argsort(key)]
            r, f0, nn = rows[idx], frm[idx], n[idx]
            cs_, ce_ = closed_start[idx].long(), closed_end[idx].long()
            plen = nn + cs_ + ce_
            pid = torch.repeat_interleave(torch.arange(idx.numel(),
                                                       device=device), plen)
            poff = torch.cumsum(plen, 0) - plen
            p = torch.arange(pid.numel(), device=device) - poff[pid]
            ci = (f0[pid] + p - cs_[pid]).clamp(0, ncod - 1)
            ch = aa[codon[r[pid], ci].clamp(min=0)]
            edge = ((p == 0) & (cs_[pid] == 1)) | \
                ((p == plen[pid] - 1) & (ce_[pid] == 1))
            sets[k].append(torch.where(edge, star, ch))
            lens[k].append(plen.cpu().numpy())
    pieces = sets[0] + sets[1]
    all_lens = np.concatenate(lens[0] + lens[1]) if pieces else np.zeros(0)
    return _pack(pieces, all_lens)


def make_db(traffic, seed, device):
    """The traffic's DB for `seed` (any whole number; its low 64 bits seed
    the generator)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    genomes = community(traffic["community"], gen, device)
    kind = traffic["db"]
    if kind == "nucleotide":
        return nucleotide_db(traffic, genomes, gen, device)
    if kind == "orfs":
        return orfs_db(traffic, genomes, gen, device)
    raise ValueError(f"unknown db kind {kind!r}")
