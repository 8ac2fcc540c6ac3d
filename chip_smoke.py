"""Smoke run of the PyTorch/CUDA port (plass_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. environment: versions, the card's name and power limit, the kernel
     builds (nvcc, from csrc/ in this checkout) and the host C++ build;
  2. kernel K1 (segmented scan) against its plain PyTorch version on the
     card, exact: every kind, direction and column count at 1,031
     elements, at the tile size and one either side of it, and at 24M, with
     segment densities from one segment over the whole array (the look-back
     crosses every tile) to a flag on every element; two 24M cases are
     launched 50 times and every result compared;
  3. the protein fixture assembly through the CLI, byte for byte against
     the committed golden, then with default parameters;
  3a. standalone: a copy of plass_tpu_torch/ alone (its built kernels and
     host library included) as a child process's working directory and
     only PYTHONPATH entry, where plass_tpu cannot be imported: both
     fixture assemblies through the CLIs, byte for byte against their
     goldens, with K1 and K2 launched in the child;
  4. a default protein assembly of 204,800 reads (the 512 fixture reads
     x400 with 1.5% seeded substitutions), with per-stage seconds;
  5. K1 and K2 at the shapes of phase 4's iteration 0: the matcher with K1
     equals the matcher with K1's plain version, and K2 equals its plain
     version on the operands rescore_diagonal_torch launches it with (the
     real hits, then a diagonal-0 self row a sequence; caught by a spy on
     the backend's kernel entry points) and on synthetic edge cases (flat
     rows at
     every alignment mod 16, windows on both sides of the kernel's
     long-window threshold; exact); the table's first-carry scan and the
     real rescore are timed beside their bounds, K1 also beside a device
     copy of the same bytes; the sizes of the matcher's scans and the bytes
     a rescore call uploads are printed;
  6. nucl-fixture: `penguin nuclassemble` on the fixture through the CLI,
     byte for byte against the committed golden, then with default
     parameters on the card and on the CPU, byte for byte against each
     other;
  7. nucl-scale: a default nuclassemble of a seeded simulated metagenome
     (50 random genomes of 20,000 nt, 100,000 single-end 150-nt reads from
     both strands with 0.2% substitutions, 15x coverage), with per-stage
     seconds;
  8. nucl-main: at phase 7's iteration-0 shapes, the nucleotide matcher
     with K1 equals it with K1's plain version, and K2's reverse-strand
     variants (uniform matrix and generic matrix) equal the plain version
     on the launch's operands (real hits and self rows, as in phase 5) and
     on synthetic edge cases (exact); both timed. Both variants also equal
     it on the launch of phase 7's last iteration,
     whose rows hold contigs of up to 20,000 nt;
  9. guided-fixture: `penguin guided_nuclassemble` on the fixture through
     the CLI with default parameters (5 + 5 iterations) and min-contig-len
     150, on the card and on the CPU, byte for byte against each other;
 10. guided-scale: a default guided_nuclassemble of a seeded simulated
     metagenome of coding genomes (104 genomes of 5,000 nt, genes on both
     strands between short spacers; 52,000 single-end 150-nt reads from
     both strands with 0.2% substitutions, 15x coverage), with the seconds
     of every stage, of the nested nuclassemble and of the linclust tail;
 11. guided-main: at phase 10's shapes, the amino-acid matcher (k 14, the
     nucleotide k-mer scale, only extendable hits) with K1 equals it with
     K1's plain version at iteration 0, and K2 equals its plain version on
     the launch of the last amino-acid iteration (real hits and self rows,
     as in phase 5), whose rows are the longest
     and begin and end with the '*' of --add-orf-stop (exact; timed beside
     its bound); each of the matcher's six scans timed alone;
 12. split-main: the hash-range split matcher on the iteration-0 DBs of
     phases 4 and 10 and the first and last DBs of phase 7, with a budget
     that gives at least 8 ranges and, on phase 4's DB and phase 7's last,
     one an entry below the largest range-key bin, equals the monolithic
     matcher (flat hits and device hits); the monolithic matcher's device
     memory by stage, whose largest bytes per table entry the automatic
     budget must cover;
 13. nucl-split: phase 7's nuclassemble through the CLI with a
     --split-memory-limit that splits iteration 0 into at least 8 ranges:
     byte-identical to phase 7, with its stage seconds and peak memory;
 14. linclust-aa: `plass linclust` through the CLI on phase 4's contigs
     at the defaults and at --min-seq-id 0.95, and on seeded protein
     families (about 6,000 distinct proteins of a median 300 residues with
     near and far relatives) at the defaults, each DB made with the port's
     createdb, each run on the card and with --device cpu: the cluster DBs
     byte for byte equal; stage seconds, the pairs the device
     Smith-Waterman (B9) scored and its launches, peak device memory;
 15. search-aa: `plass search` through the CLI with default parameters
     (-s 5.7, --max-seqs 300): every 15th of phase 14's family proteins
     (made with `plass createsubdb` from the target DB `plass createdb`
     made) against all of them, on the card; the same align stage with
     --device cpu on the same prefilter DB: the alignment DBs byte for
     byte equal; stage seconds, candidate pairs, the pairs B9 scored and
     rejected, its launches, peak device memory;
 16. profile-aa, in a process of its own beside phases 17-20 (its
     stages are host code but for B9 on step 0; it counts its own
     launches and prints them for the kernels line): `plass search
     --num-iterations 2` through the CLI with phase 15's queries and
     targets at the defaults, on the card: B9
     scores step 0's candidate pairs (sequence queries), step 1 aligns the
     profiles on the host, as in the JAX package; step 0's align stage
     again with --device cpu on the same prefilter DB, byte for byte
     equal; then `plass result2profile` of its alignments (a profile per
     query) and `plass search` of every 5th family protein against those
     profiles. Each step's stage seconds, pairs and B9 launches, peak
     device memory, and the sha256 of both alignment DBs, which must equal
     those of --cpu-reference profile;
 17. cluster-aa: `plass cluster --min-seq-id 0.9 -c 0.9` (the paper's
     setting) through the CLI on the family proteins, on the card and with
     --device cpu: the cluster DBs byte for byte equal; seconds per stage
     and step, B9's launches and pairs, the cluster count;
 18. easy-aa: `plass easy-search` and `plass easy-cluster` on 100 family
     records, `plass easy-rbh` and `plass easy-linsearch` of records f1,
     f3, ... against f0, f2, ... to f99 (by name), and `plass
     easy-taxonomy` of f1, f3, ... against a taxonomy DB of f0, f2, ...
     (phase 25's synthetic taxonomy), on the card and with --device cpu:
     the BLAST-tab files, the cluster TSV and FASTA files and
     easy-taxonomy's four files byte for byte equal;
 19. sw-main: B9 on the candidate pairs of phase 14's align stage (for
     each input the run with the most) and of phase 15's, on edge rows
     (query length 1, target lengths 0, 1 and 33, queries at the edges of
     the warp-path classes, of a warp's strip and of a block's strips, a
     query that wraps the block's warps, 5,000 x 6,000) and on 600 long
     pairs (more than the card holds blocks, launched 50 times, all equal)
     against its plain version and the native striped Smith-Waterman's
     scores (exact; the edge and long pairs at gaps 5/2 and 11/1); timed
     beside its bound (DPX-fused int32 operations per cell over the card's
     integer rate) and in cells a second, with the pairs on the block
     path, the share of the pairs failing the E-value test (which B9
     spares a host ssw), and the kernel's registers and resident warps;
 20. hamming: `plass assemble` and `penguin nuclassemble` with
     --rescore-mode 0 on the fixture, on the card and with --device cpu,
     byte for byte; K2's HAMMING forms (B10) against their plain version on
     the iteration-0 launches of phases 4 and 7 at --rescore-mode 0 (real
     hits, reverse hits included, and self rows, as in phase 5) and on
     edge rows (exact), timed beside their bound;
 21. nucl-large: the nucleotide matcher at iteration 0 on the fewest
     seeded 150-nt reads whose table the monolithic matcher would need more
     than the card's free memory for, with the automatic budget and at half
     of it: equal hits, peak memory under the card's (the matcher only).
Phases 22-26 run one after the other in a process of their own beside
phases 17-20, started with phase 16's (22-25 count their own launches and
print them for the kernels line); once the main process has finished
phase 20, that process also holds B9 against its plain version (and the
native ssw on 300 pairs) on each of phases 22-25's largest align calls
and times it there beside its bound, as sw-main does ([sw-side]):
 22. linsearch-aa: `plass createlinindex` and `plass linsearch` through
     the CLI on the card, the odd-numbered keys of phase 14's family
     proteins against the even-numbered (both made with `plass
     createsubdb`); linsearch's align stage again with --device cpu on the
     same filtered prefilter DB, byte for byte equal; seconds per stage,
     candidate pairs, the pairs that pass the ungapped filter, the pairs
     B9 scored and rejected, its launches, peak device memory;
 23. rbh-aa: `plass rbh A B` through the CLI on the card and with
     --device cpu, family records f0-f1199 (about 300 whole families), even
     numbers in A and odd in B: the result DBs byte for byte equal; each
     search's seconds, candidate pairs (at least 512, so that B9
     launches), B9's launches and rejections;
 24. multihit-nt: `plass multihitdb` of phase 10's 104 coding genomes in 8
     target sets and of every 13th with 1% substitutions in 2 query sets,
     then `plass multihitsearch` through the CLI on the card and with
     --device cpu: the output DBs byte for byte equal; seconds, ORFs per
     set DB, candidate pairs (at least 512), B9's launches;
 25. taxonomy-aa: every 5th of phase 14's family records as queries
     (`plass createdb`), the others as targets labelled by a synthetic
     NCBI taxonomy (150 genera in 10 families, a protein family's members
     spread over its genus's 3 species; `plass createtaxdb`); `plass
     taxonomy` through the CLI on the card at the defaults (--lca-mode 3,
     the host's lcaalign) and at --lca-mode 4 (top hit, whose `search` B9
     scores); --lca-mode 4's align stage again with --device cpu on the
     same prefilter DB, byte for byte equal; both taxonomy DBs' sha256
     must equal those of --cpu-reference taxonomy; seconds per stage,
     candidate pairs, the pairs B9 scored and rejected, its launches, peak
     device memory and the ranks of each output;
 26. db-tools: the thirty DB, misc, domain and `databases` tools, which do
     no device work in either package, through the CLI (penguin's for
     extractframes) at the default device and again with --device cpu,
     all outputs (files and standard output) byte for byte equal: on phase
     14's family proteins (compress, decompress, dbtype, view, touchdb,
     unpackdb, splitdb, countkmer, masksequence, translateaa, clusthash,
     tar2db of their FASTA in ten members, tsv2db, convertkb of UniProtKB
     text made of them, `databases` listing and building its Swiss-Prot
     entry from a UniProt-headed FASTA placed in its <tmpDir>, then
     summarizeheaders of that DB's headers), on their `plass kmermatcher`
     + `plass align -a` alignments (suffixid, prefixid, summarizeresult,
     extractalignedregion, transitivealign, summarizetabs of a BLAST-tab
     DB made of them and extractdomains of its output through their `plass
     result2msa` MSAs), alignall on the first DB_TOOLS_CLUSTERS clusters of
     phase 14's families linclust, on phase 10's 104 coding genomes
     (countkmer, masksequence, clusthash, reverseseq, extractframes,
     gff2db and maskbygff with seeded GFFs, apply with a short program) and
     diskspaceavail of the work dir; each command's seconds both ways and
     its outputs' sha256.
 27. sharded, in a process of its own started before phase 10 and joined
     after it (guided-scale's linclust tail leaves the card idle), whose
     ranks are processes of their own (PLASS_COORDINATOR on a local port):
     `plass assemble --backend sharded` of phase 4's reads at world 1
     (NCCL), byte-identical to phase 4; at world 2, two ranks sharing the
     card (gloo), the iteration-0 sharded matcher on phase 4's DB on the
     card equal to it on the CPU in each rank (hits and rescore columns),
     the same assembly in both ranks, byte-identical to each other and to
     --cpu-reference sharded's sha256, and `penguin nuclassemble` and
     `guided_nuclassemble --backend sharded` on the fixture, card and
     --device cpu byte for byte; each rank's stage seconds, exchange bytes
     and seconds, peak device memory and K1/K2 launches (counted from 0 in
     the rank around each run; every rank must launch both); then a
     failing rank (its input missing) must make both ranks exit non-zero
     within the group's timeout;
 28. align: `plass assemble` and `penguin nuclassemble` with
     --rescore-mode 2 (ALIGNMENT) on the fixture, on the card and with
     --device cpu, byte for byte, and both byte-identical to the committed
     goldens (which plass_tpu's host path also gives at mode 2); B12, the
     ALIGNMENT form of the rescore kernel, against its plain version on
     the iteration-0 launches of phases 4 and 7 at --rescore-mode 2 (real
     hits and self rows, as in phase 5; the reverse variant with the
     uniform and the generic matrix) and on edge rows (exact), timed
     beside its bound;
 29. align-scale, in a process of its own at a lower priority beside
     phases 17-20 and 28:
     phase 4's reads through `plass assemble --rescore-mode 2` on the
     card, its sha256 equal to --cpu-reference align's, B12 launched at
     every rescore call and K2 at none; stage seconds, wall and launches,
     and whether the bytes differ from phase 4's (mode 3).
The kernels' launch counters are set to 0 just before phases 4, 7, 10, 13,
14, 15, 16, 17, 18, 20, 22, 23, 24, 25, 27, 28 and 29's CLI runs and read
just after;
every kernel of each path must have run there. Before phase 26's runs
they are set to 0 too, and none may have run after them. The last lines
are the script's seconds, a JSON summary of the kernels (times, launches
by path, bytes or operations counted and the bound they give at 3.35 TB/s
or the card's integer rate; for the rescore's forms the launch's hits, the
self rows among them and their share of its window residues), the card's
name and power limit, and {"ok":
true, "device": {...}}.

--cpu-rehearsal runs every phase on the CPU at a tiny size (the kernels'
plain versions against themselves) to check the script itself;
--cpu-reference runs phases 4, 7 and 10 (or, with a value, those of
assemble, nuclassemble, guided_nuclassemble, profile, taxonomy, sharded
and align it names; profile is phase 16's searches, taxonomy phase 25's
runs, sharded phase 27's world-2 assembly in two ranks, align phase 29's
assembly) at full size on the CPU,
for the sha256 of their outputs; --cards N runs phase 27's assembly
across N cards, one rank a card (NCCL), and with --device cpu. None of
them prints a result; each exits with code 2.
"""
import argparse
import contextlib
import gzip
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
GOLDEN = os.path.join(FIX, "mini_golden_protein.fas")
GOLDEN_NUCL = os.path.join(FIX, "mini_golden_nucl.fasta")


def say(*parts):
    print(*parts, flush=True)


def smi(query="name,power.limit", units=True):
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader" + ("" if units else ",nounits")],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


KERNEL_REPS = 5   # a kernel is timed over this many times the plain reps


def cuda_ms(fn, reps, device, queued=False):
    """Mean milliseconds of fn() over reps launches, by CUDA events. With
    queued=True the card is first kept busy (torch.cuda._sleep) while the
    host enqueues every launch, so that the events bracket launches that
    run back to back: a kernel of tens of microseconds is otherwise timed
    at the rate the host can launch it, not at its own."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(1e6 * reps))   # about 0.6 ms per launch
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def max_abs_err(got, want):
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_OPS_PER_S = 67e12      # H100 SXM, published, outside the tensor cores


SMS = 132                   # H100 SXM
INT32_LANES_PER_SM = 64     # Hopper: 4 partitions of 16 INT32 units


def bound(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its rate for their type (float32 unless
    given)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def int32_ops_per_s(device):
    """(ops/s, MHz): the card's int32 rate, its SMs x INT32 lanes per SM x
    the clock nvidia-smi gives as clocks.max.sm. The rehearsal, with no
    card, takes 1,980 MHz (the H100 SXM's boost clock)."""
    text = smi("clocks.max.sm", units=False) if device.type == "cuda" else ""
    try:
        mhz = float(text.splitlines()[0])
    except (IndexError, ValueError):
        if device.type == "cuda":
            raise AssertionError(f"clocks.max.sm unreadable: {text!r}")
        mhz = 1980.0
    return SMS * INT32_LANES_PER_SM * mhz * 1e6, mhz


def scan_bytes(n, nvals):
    """Bytes a segmented scan must move: a one-byte flag and nvals int32 in,
    nvals int32 out, per element."""
    return n * (1 + 8 * nvals)


def copy_ms(n_bytes, reps, device):
    """Milliseconds of a device copy that moves n_bytes in all (half read,
    half written): what the card reaches on the same traffic."""
    import torch
    src = torch.empty(max(n_bytes // 2, 1), dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    return cuda_ms(lambda: dst.copy_(src), KERNEL_REPS * reps, device, queued=True)


def rescore_traffic(args, qrev=None, ops_per_residue=2, n_out=4):
    """(bytes, operations, residues) of one rescore call: every operand
    read once (the matrix where args hold one), the n_out int32 outputs
    written once; ops_per_residue operations per window residue of these
    hits (two for END_TO_END, a score and an identity; one for
    HAMMING)."""
    from plass_tpu_torch.ops.rescore_kernel import _overlap
    lengths, qrow, trow, diag = args[2], args[4], args[5], args[6]
    n_bytes = sum(x.numel() * x.element_size() for x in args)
    if qrev is not None:
        n_bytes += qrev.numel()
    n_bytes += n_out * 4 * qrow.numel()
    residues = int(_overlap(lengths, qrow.long(), trow.long(), diag)[0]
                   .clamp(min=0).sum())
    return n_bytes, ops_per_residue * residues, residues


def upload_bytes(db, device):
    """(flat, padded): the bytes rescore_diagonal_torch uploads for the
    rows of `db` (data, offsets, lengths, code table), and what the padded
    [N, W] codes and chars of the earlier design took."""
    from plass_tpu_torch.ops.backend import flat_rows as db_rows
    flat = sum(x.numel() * x.element_size() for x in db_rows(db, device))
    lens = db.seq_lens()
    padded = 2 * db.size * (int(lens.max()) if db.size else 0)
    return flat, padded


def flat_rows(seqs, device):
    """(rows, offsets, lengths) tensors of the byte strings `seqs` laid out
    as a SeqDB's data: each followed by "\\n\\0" and preceded by 0-15
    filler bytes so that row i starts at residue i mod 16."""
    import torch
    parts, offsets, pos = [], [], 0
    for i, seq in enumerate(seqs):
        gap = (i - pos) % 16
        offsets.append(pos + gap)
        parts += [b"Z" * gap, bytes(seq), b"\n\x00"]
        pos += gap + len(seq) + 2
    rows = np.frombuffer(b"".join(parts), dtype=np.uint8).copy()
    return (torch.from_numpy(rows).to(device),
            torch.tensor(offsets, dtype=torch.int64, device=device),
            torch.tensor([len(x) for x in seqs], dtype=torch.int32,
                         device=device))


def recorded_scans(fn, keep=False):
    """fn() with every seg_scan call of the matcher recorded: returns
    (fn's result, [(kind, elements, columns, reverse), ...]); with keep,
    each entry also holds the call's (flag, columns)."""
    from plass_tpu_torch.ops import device_kmer
    from plass_tpu_torch.ops.seg_scan import seg_scan
    calls = []

    def spy(kind, flag, *vals, reverse=False):
        calls.append((kind, flag.numel(), len(vals), reverse)
                     + (((flag, vals),) if keep else ()))
        return seg_scan(kind, flag, *vals, reverse=reverse)

    device_kmer.seg_scan = spy
    try:
        return fn(), calls
    finally:
        device_kmer.seg_scan = seg_scan


def launched_rescore(db, hits, mode=3):
    """The operands that rescore_diagonal_torch hands its kernel for `hits`
    at --rescore-mode `mode` (3: K2, 0: B10, 2: B12), the matcher's hits
    followed by the self rows, from a spy on the backend's kernel entry
    points: (args, keyword arguments but `uniform`, {"hits": the launch's
    hits, "self_rows": the self rows among them, "self_row_share": their
    share of its window residues})."""
    from plass_tpu_torch.ops import backend
    from plass_tpu_torch.ops.rescore import RescoreParams
    from plass_tpu_torch.ops.rescore_kernel import _overlap
    real = {name: getattr(backend, name)
            for name in ("rescore_e2e", "rescore_hamming", "rescore_align")}
    calls = []

    def spy(fn):
        def call(*args, **kw):
            calls.append((args, kw))
            return fn(*args, **kw)
        return call

    for name, fn in real.items():
        setattr(backend, name, spy(fn))
    before = backend.SELF_ROWS
    try:
        backend.rescore_diagonal_torch(db, hits,
                                       RescoreParams(rescore_mode=mode))
    finally:
        for name, fn in real.items():
            setattr(backend, name, fn)
    n_self = backend.SELF_ROWS - before
    if len(calls) != 1 or n_self != db.size:
        raise AssertionError(f"rescore_diagonal_torch: {len(calls)} kernel "
                             f"launches, {n_self} self rows of {db.size}")
    args, kw = calls[0]
    lengths, q, t, d = args[2], args[4], args[5], args[6]
    ov = _overlap(lengths, q.long(), t.long(), d)[0].clamp(min=0)
    share = float(ov[q.numel() - n_self:].sum()) / max(float(ov.sum()), 1.0)
    return (args, {k: v for k, v in kw.items() if k != "uniform"},
            {"hits": q.numel(), "self_rows": n_self,
             "self_row_share": share})


def launch_text(shape):
    """The launch's hits and self rows, for a log line."""
    return (f"{shape['hits']} launched hits ({shape['self_rows']} of them "
            f"self rows, {100 * shape['self_row_share']:.1f}% of the window "
            f"residues)")


def scans_text(calls):
    return ", ".join(f"{kind}/{nv}{'r' if rev else ''} n={n}"
                     for kind, n, nv, rev, *_ in calls)


def peaks_text(stats):
    """A run's peak device memory by stage, GiB (stats["peak_bytes"])."""
    return ", ".join(f"{k} {v / 2**30:.2f}"
                     for k, v in stats["peak_bytes"].items())


# ---------------------------------------------------------------------------

def phase_env(device, rehearsal):
    import torch
    from plass_tpu_torch import native
    from plass_tpu_torch.kernels import build

    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say(f"[env] card: {smi()}")
    if not rehearsal:
        # one nvcc per source, all started together
        names = ("seg_scan", "rescore", "sw_score")
        with ThreadPoolExecutor(len(names)) as pool:
            infos = list(pool.map(build.build, names))
        for name, info in zip(names, infos):
            say(f"[env] built {os.path.relpath(info.path, ROOT)} in "
                f"{info.seconds:.1f} s")
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[env]   ptxas: {line.strip()}")
            build.load(name)
    t0 = time.perf_counter()
    native.lib()
    say(f"[env] host library ready in {time.perf_counter() - t0:.1f} s")


K1_REPEATS = 50
# guided-scale: 104 coding genomes of 5,000 nt (small viral genomes, what
# PenguiN is made for) at 15x, 52,000 reads
GUIDED_GENOMES = (104, 5000)
SCALE_RUNS = ("assemble", "nuclassemble", "guided_nuclassemble")
# --cpu-reference also takes "profile": phase profile-aa's two searches
REFERENCE_RUNS = SCALE_RUNS + ("profile", "taxonomy", "sharded", "align")


def phase_k1(device, sizes, reps, timed_sizes=()):
    """K1 against its plain version: every kind, direction and column
    count, five segment densities from one segment over the whole array to
    a flag on every element; times at the largest size, where two cases
    whose look-back crosses every tile are also launched K1_REPEATS times
    with every result compared (a look-back race shows only sometimes).
    The 3-column first-carry is also compared and timed on seeded columns
    of each of timed_sizes elements (the sizes of real tables)."""
    import torch
    from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

    combos = [(k, nv) for k in ("first", "cummax") for nv in (1, 2, 3)] + \
        [("sfx2", 2), ("sfx2", 3)]
    worst = 0
    checked = 0
    repeated = 0
    for t in sizes:
        rng = np.random.default_rng(t)
        vals = [torch.from_numpy(rng.integers(-2**31, 2**31, t, dtype=np.int64)
                                 .astype(np.int32)).to(device)]
        # sfx2 keys: few distinct counts so that ties happen
        vals.append(torch.from_numpy(rng.integers(-1, 2**24, t)
                                     .astype(np.int32)).to(device))
        vals.append(torch.from_numpy(rng.integers(-2**31, 2**31, t,
                                                  dtype=np.int64)
                                     .astype(np.int32)).to(device))
        small = torch.from_numpy(rng.integers(-1, 50, t).astype(np.int32)) \
            .to(device)
        for dens in (0.0, 0.005, 0.05, 0.5, 1.0):
            fl = rng.random(t) < dens
            for reverse in (False, True):
                f = fl.copy()
                f[-1 if reverse else 0] = True
                flag = torch.from_numpy(f).to(device)
                # no flag at all: the scan's first element starts a segment
                # whatever its flag says ("first" asks for the flag)
                bare = torch.from_numpy(fl).to(device)
                for kind, nv in combos:
                    cols = ([small] + vals[1:nv]) if kind == "sfx2" \
                        else vals[:nv]
                    fg = bare if dens == 0.0 and kind != "first" else flag
                    got = seg_scan(kind, fg, *cols, reverse=reverse)
                    want = seg_scan_plain(kind, fg, *cols, reverse=reverse)
                    err = max_abs_err(got, want)
                    worst = max(worst, err)
                    checked += 1
                    if err:
                        raise AssertionError(
                            f"K1 {kind} nv={nv} reverse={reverse} T={t} "
                            f"density={dens}: max |err| {err}")
                    case = (kind, nv, reverse)
                    if (t == sizes[-1] and dens == 0.0 and case in (
                            ("first", 3, False), ("sfx2", 3, True))):
                        for i in range(K1_REPEATS):
                            again = seg_scan(kind, fg, *cols, reverse=reverse)
                            if not all(torch.equal(g, w)
                                       for g, w in zip(again, want)):
                                raise AssertionError(
                                    f"K1 {kind} nv={nv} reverse={reverse} "
                                    f"T={t}, one segment: launch {i} differs")
                        repeated += 1
                        say(f"[k1] T={t} {kind} nvals={nv} "
                            f"{'reverse' if reverse else 'forward'}, one "
                            f"segment: {K1_REPEATS} of {K1_REPEATS} launches "
                            f"equal to the plain version")
                    if (t == sizes[-1] and dens == 0.05 and case in (
                            ("first", 3, False), ("cummax", 1, True),
                            ("sfx2", 3, True))):
                        ms = cuda_ms(lambda: seg_scan(
                            kind, fg, *cols, reverse=reverse),
                            KERNEL_REPS * reps, device, queued=True)
                        pms = cuda_ms(lambda: seg_scan_plain(
                            kind, fg, *cols, reverse=reverse), reps, device)
                        n_bytes = scan_bytes(t, nv)
                        bms = bound(n_bytes, 0)[0]
                        say(f"[k1] T={t} {kind} nvals={nv} "
                            f"{'reverse' if reverse else 'forward'}: kernel "
                            f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
                            f"{bms:.4f} ms ({n_bytes} bytes, "
                            f"{100 * bms / ms:.0f}% of it reached), device "
                            f"copy of the same bytes "
                            f"{copy_ms(n_bytes, reps, device):.4f} ms")
        say(f"[k1] T={t}: all kinds/directions/densities equal")
    for t in timed_sizes:
        rng = np.random.default_rng(t)
        f = rng.random(t) < 0.3
        f[0] = True
        flag = torch.from_numpy(f).to(device)
        cols = [torch.from_numpy(rng.integers(0, 2**30, t).astype(np.int32))
                .to(device) for _ in range(3)]
        err = max_abs_err(seg_scan("first", flag, *cols),
                          seg_scan_plain("first", flag, *cols))
        if err:
            raise AssertionError(f"K1 first nv=3 T={t}: max |err| {err}")
        checked += 1
        ms = cuda_ms(lambda: seg_scan("first", flag, *cols),
                     KERNEL_REPS * reps, device, queued=True)
        n_bytes = scan_bytes(t, 3)
        bms = bound(n_bytes, 0)[0]
        say(f"[k1] T={t} first nvals=3 forward, seeded columns: equal; "
            f"kernel {ms:.4f} ms, bound {bms:.4f} ms ({n_bytes} bytes, "
            f"{100 * bms / ms:.0f}% of it reached), device copy of the same "
            f"bytes {copy_ms(n_bytes, reps, device):.4f} ms")
    if repeated != 2:
        raise AssertionError("the K1 repeat check did not run")
    say(f"[k1] {checked} comparisons, max |err| {worst}")
    return worst


def fixture_cli(out_dir, extra, device):
    from plass_tpu_torch.cli.plass import run
    out = os.path.join(out_dir, "assembly.fas")
    rc = run(["assemble", *READS, out, os.path.join(out_dir, "tmp"),
              "--device", str(device), *extra])
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    return out


def phase_fixture(device, work):
    from plass_tpu_torch.ops import rescore_kernel, seg_scan

    before = (seg_scan.LAUNCHES, rescore_kernel.LAUNCHES)
    out = fixture_cli(os.path.join(work, "fix2"),
                      ["--num-iterations", "2", "--filter-proteins", "0"],
                      device)
    if open(out, "rb").read() != open(GOLDEN, "rb").read():
        raise AssertionError("fixture assembly differs from "
                             "tests/fixtures/mini_golden_protein.fas")
    say("[fixture] 2 iterations, filter 0: byte-identical to the golden")
    t0 = time.perf_counter()
    out = fixture_cli(os.path.join(work, "fix12"), [], device)
    n = sum(1 for line in open(out) if line.startswith(">"))
    say(f"[fixture] default parameters (12 iterations, filter on): {n} "
        f"contigs in {time.perf_counter() - t0:.1f} s")
    after = (seg_scan.LAUNCHES, rescore_kernel.LAUNCHES)
    if device.type == "cuda" and not (after[0] > before[0]
                                      and after[1] > before[1]):
        raise AssertionError(f"kernel launch counters did not rise: "
                             f"{before} -> {after}")
    say(f"[fixture] launches: seg_scan {after[0] - before[0]}, "
        f"rescore_e2e {after[1] - before[1]}")


# the child of phase_standalone: argv is the device, the two read files and
# the output directory; prints one line, "[standalone] child {json}"
STANDALONE_CHILD = r"""
import importlib.util, json, os, sys
spec = importlib.util.find_spec("plass_tpu")
import plass_tpu_torch
from plass_tpu_torch import native
from plass_tpu_torch.cli import penguin, plass
from plass_tpu_torch.ops import rescore_kernel, seg_scan
device, reads, out = sys.argv[1], sys.argv[2:4], sys.argv[4]
rcs = [plass.run(["assemble", *reads, os.path.join(out, "assembly.fas"),
                  os.path.join(out, "ptmp"), "--num-iterations", "2",
                  "--filter-proteins", "0", "--device", device]),
       penguin.run(["nuclassemble", *reads,
                    os.path.join(out, "contigs.fasta"),
                    os.path.join(out, "ntmp"), "--num-iterations", "2",
                    "--min-contig-len", "150", "--device", device])]
print("[standalone] child " + json.dumps({
    "find_spec": None if spec is None else spec.origin,
    "files": [plass_tpu_torch.__file__, native.lib()._name], "rcs": rcs,
    "jax_modules": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "plass_tpu")),
    "seg_scan": seg_scan.LAUNCHES, "rescore_e2e": rescore_kernel.LAUNCHES,
    "rescore_e2e_rev_uniform": rescore_kernel.LAUNCHES_REV_UNIFORM}))
"""
STANDALONE_TIMEOUT = 300


def _port_only_ignore(d, names):
    """copytree's filter: no bytecode, and no build in progress."""
    skip = {"__pycache__"} & set(names)
    if os.path.basename(d) == "_build":
        skip |= {n for n in names if n.startswith("tmp")}
    return skip


def phase_standalone(device, work, epilogue=""):
    """plass_tpu_torch/ alone (with its _build/, so nothing is built again)
    in a directory that is the child's working directory and its only
    PYTHONPATH entry: both fixture assemblies byte for byte against their
    goldens, the package and its host library loaded from there, with
    plass_tpu not importable and, on a card, K1 and K2 launched. The child
    runs `epilogue` (Python) last; returns its standard output."""
    port = os.path.join(work, "port_only")
    shutil.copytree(os.path.join(ROOT, "plass_tpu_torch"),
                    os.path.join(port, "plass_tpu_torch"),
                    ignore=_port_only_ignore)
    out = os.path.join(work, "standalone_out")
    os.makedirs(out)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = port
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", STANDALONE_CHILD + epilogue, str(device),
         *READS, out], cwd=port, env=env, capture_output=True, text=True,
        timeout=STANDALONE_TIMEOUT)
    secs = time.perf_counter() - t0
    tag = "[standalone] child "
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    if proc.returncode != 0 or len(lines) != 1:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"[standalone] the port-only process exited "
                             f"with {proc.returncode}")
    r = json.loads(lines[0][len(tag):])
    if r["find_spec"] is not None or r["jax_modules"]:
        raise AssertionError(f"[standalone] the JAX package was visible: "
                             f"{r['find_spec']} {r['jax_modules']}")
    if (not all(f.startswith(port + os.sep) for f in r["files"])
            or r["rcs"] != [0, 0]):
        raise AssertionError(f"[standalone] loaded {r['files']}, exit codes "
                             f"{r['rcs']}")
    for name, golden in (("assembly.fas", GOLDEN),
                         ("contigs.fasta", GOLDEN_NUCL)):
        if (open(os.path.join(out, name), "rb").read()
                != open(golden, "rb").read()):
            raise AssertionError(f"[standalone] {name} differs from "
                                 f"{os.path.relpath(golden, ROOT)}")
    launched = {k: r[k] for k in ("seg_scan", "rescore_e2e",
                                  "rescore_e2e_rev_uniform")}
    if device.type == "cuda" and not all(launched.values()):
        raise AssertionError(f"[standalone] a kernel was not launched: "
                             f"{launched}")
    say(f"[standalone] plass_tpu_torch/ alone as working directory and "
        f"PYTHONPATH, find_spec('plass_tpu') None: `plass assemble` and "
        f"`penguin nuclassemble` on the fixture at --device {device} "
        f"byte-identical to both goldens in {secs:.1f} s; launches "
        f"{json.dumps(launched)}")
    return proc.stdout


def make_reads(path, copies, seed=42):
    """Single-end FASTA: the 512 fixture reads x copies; every copy after
    the first with 1.5% seeded ACGT substitutions."""
    seqs = []
    for f in READS:
        lines = gzip.open(f, "rt").read().splitlines()
        seqs += [s.encode() for s in lines[1::4]]
    base = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    lens = np.array([len(s) for s in seqs])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    key = 0
    with open(path, "wb") as fh:
        for c in range(copies):
            s = base.copy()
            if c:
                mask = rng.random(len(s)) < 0.015
                s[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
            raw = s.tobytes()
            fh.write(b"".join(b">%d\n%s\n" % (key + i, raw[a:a + n])
                              for i, (a, n) in enumerate(zip(starts, lens))))
            key += len(seqs)
    return key


def phase_scale(device, work, copies):
    from plass_tpu_torch.cli.plass import run
    from plass_tpu_torch.ops import rescore_kernel, seg_scan

    t0 = time.perf_counter()
    fasta = os.path.join(work, "reads.fasta")
    n_reads = make_reads(fasta, copies)
    say(f"[scale] {n_reads} reads written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "scale", "assembly.fas")
    tmp = os.path.join(work, "scale", "tmp")
    stats = {}
    seg_scan.LAUNCHES = 0
    rescore_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = run(["assemble", fasta, out, tmp, "--device", str(device)],
             stats=stats)
    wall = time.perf_counter() - t0
    launches = {"seg_scan": seg_scan.LAUNCHES,
                "rescore_e2e": rescore_kernel.LAUNCHES}
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    lines = open(out).read().splitlines()
    heads, body = lines[0::2], lines[1::2]
    for h, s in zip(heads, body):
        if not h.startswith(">") or not h.endswith(f" len:{len(s)}"):
            raise AssertionError(f"malformed FASTA record {h!r}")
    if not body:
        raise AssertionError("the assembly produced no contigs")
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    say(f"[scale] reads {stats['reads']}, ORFs {stats['orfs']}, "
        f"iteration-0 table entries {stats['table_entries']}, "
        f"iteration-0 hits {stats['hits']}")
    say("[scale] seconds per stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stats["seconds"].items()))
    say(f"[scale] wall {wall:.1f} s, {stats['reads'] / wall:.0f} reads/s, "
        f"{len(body)} contigs, sha256 {digest}")
    say(f"[scale] launches: seg_scan {launches['seg_scan']}, rescore_e2e "
        f"{launches['rescore_e2e']}")
    if device.type == "cuda":
        say(f"[scale] max_memory_allocated "
            f"{max(stats['peak_bytes'].values()) / 2**30:.2f} GiB; by stage, "
            f"GiB: {peaks_text(stats)}")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel of the main path never launched: "
                                 f"{launches}")
    return launches, os.path.join(tmp, "latest", "aa_6f_start_long"), out


# the protein matcher at iteration 0 (`plass assemble` defaults)
PROTEIN_MATCH = dict(kmers_per_sequence=60, hash_shift=67,
                     ignore_multi_kmer=True, include_only_extendable=False)
# K2 sends windows of more than LONG_WINDOW residues to its second pass
# (kLongWindow in csrc/rescore.cu); the edge cases sit on both sides of it
LONG_WINDOW = 512
EDGE_LENS = [40, 40, 3000, 2500, 1, 2, 1500, 64, LONG_WINDOW - 1, LONG_WINDOW,
             LONG_WINDOW + 1, LONG_WINDOW + 16, 33, 17, 150, 151,
             # the protein cases make these two begin and end with '*', as
             # the rows of guided_nuclassemble's amino-acid DB do
             700, 47]
EDGE_DIAGS = (0, 1, -1, 5, -5, 39, -39, 40, -40, 1499, -2499, 2999, -2999,
              3000, -3000)


def _edge_hits(n_rows, device, both_strands):
    """Every (query row, target row, diagonal of EDGE_DIAGS) as int32
    tensors (and the reverse flag, each hit on both strands)."""
    import torch
    q, t, d, r = [], [], [], []
    for a in range(n_rows):
        for b in range(n_rows):
            for dg in EDGE_DIAGS:
                for rv in ((False, True) if both_strands else (False,)):
                    q.append(a)
                    t.append(b)
                    d.append(dg)
                    r.append(rv)
    i32 = lambda x: torch.tensor(np.asarray(x, dtype=np.int32), device=device)
    return i32(q), i32(t), i32(d), torch.tensor(r, device=device)


def _edge_case_rows(device):
    """Synthetic K2 inputs on flat rows whose starts take every residue
    mod 16: '*' at j=0 and at ov-1, no overlap (ov <= 0), rows longer than
    1024, windows of LONG_WINDOW - 1, LONG_WINDOW and LONG_WINDOW + 1
    residues, lower-case letters. Returns (rows, offsets, lengths, code
    table, qrow, trow, diag)."""
    import torch
    from plass_tpu_torch import constants

    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)
    seqs = [letters[rng.integers(0, len(letters), n)] for n in EDGE_LENS]
    star = ord("*")
    seqs[0][0] = seqs[1][39] = seqs[2][0] = seqs[2][2999] = star
    seqs[3][100] = seqs[5][0] = seqs[9][0] = seqs[10][LONG_WINDOW] = star
    seqs[16][0] = seqs[16][-1] = seqs[17][0] = seqs[17][-1] = star
    seqs[7][:32] = np.char.lower(seqs[7][:32].view("S1")).view(np.uint8)
    rows, offsets, lengths = flat_rows([x.tobytes() for x in seqs], device)
    if len(set(int(o) % 16 for o in offsets)) != 16:
        raise AssertionError("edge-case rows do not cover every alignment")
    lut = torch.from_numpy(constants.blosum62().aa2num.astype(np.uint8)) \
        .to(device)
    q, t, d, _ = _edge_hits(len(seqs), device, False)
    return rows, offsets, lengths, lut, q, t, d


def _check_star_windows(args, want):
    """The protein edge cases must hold hits whose window begins and ends
    with '*' on rows that begin and end with it (the last two rows)."""
    from plass_tpu_torch.ops.rescore_kernel import _overlap
    lengths, q, t, d = args[2], args[4], args[5], args[6]
    ov = _overlap(lengths, q.long(), t.long(), d)[0]
    both = int(((q >= 16) & (t >= 16) & (want[1] == 1) & (ov > 1)
                & (want[2] == ov - 2)).sum())
    if not both:
        raise AssertionError("no edge-case window begins and ends with '*'")
    return both


def _check_edge_windows(args, want, name):
    """The edge cases must hold windows on both sides of LONG_WINDOW, hits
    with no overlap and '*' at both window ends."""
    from plass_tpu_torch.ops.rescore_kernel import _overlap
    rows, offsets, lengths, _, q, t, d = args[:7]
    ov = _overlap(lengths, q.long(), t.long(), d)[0]
    sides = [int((ov == LONG_WINDOW + k).sum()) for k in (-1, 0, 1)]
    n_none = int((want[1] == -1).sum())
    n_first = int((want[1] == 1).sum())
    n_last = int(((want[2] < ov - 1) & (ov > 0)).sum())
    if not (all(sides) and int((ov > 2 * LONG_WINDOW).sum()) and n_none
            and n_first and n_last):
        raise AssertionError(f"{name}: the edge cases miss a case: windows "
                             f"of {LONG_WINDOW}-1/+0/+1: {sides}, no overlap "
                             f"{n_none}, '*' first {n_first}, last {n_last}")
    return (f"{q.numel()} synthetic edge-case hits ({n_none} with no overlap, "
            f"{int((ov > LONG_WINDOW).sum())} windows over {LONG_WINDOW}, "
            f"rows up to {int(lengths.max())} at every alignment mod 16)")


def phase_main_shapes(device, db_path, reps):
    """K1 and K2 at the shapes of phase 4's iteration 0 (its first match
    and rescore): the matcher with every scan in the kernel equals the
    matcher with every scan in the plain version; the table's first-carry
    scan and K2 on the operands of rescore_diagonal_torch's launch (the
    real hits and the self rows) are timed against their plain versions
    and their bounds; K2 also runs on synthetic edge cases."""
    import torch
    from plass_tpu_torch import constants
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import device_kmer
    from plass_tpu_torch.ops.backend import flat_rows as db_rows
    from plass_tpu_torch.ops.backend import kmermatcher_torch
    from plass_tpu_torch.ops.rescore_kernel import (rescore_e2e,
                                                    rescore_e2e_plain)
    from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

    db = seqdb.SeqDB.open(db_path)
    kw = PROTEIN_MATCH
    hits, scans = recorded_scans(lambda: kmermatcher_torch(db, 14, device,
                                                           **kw))
    device_kmer.seg_scan = seg_scan_plain
    try:
        plain_hits = kmermatcher_torch(db, 14, device, **kw)
    finally:
        device_kmer.seg_scan = seg_scan
    k1_err = max(int(np.abs(np.asarray(g, np.int64)
                            - np.asarray(w, np.int64)).max(initial=0))
                 for g, w in zip(hits, plain_hits))
    if k1_err or len(hits[0]) != len(plain_hits[0]):
        raise AssertionError(f"K1 in the matcher: max |err| {k1_err}")
    say(f"[main] matcher on {db.size} ORFs ({hits.table_entries} table "
        f"entries, {len(hits.hit_slots)} hits): kernel scans equal plain")
    say(f"[main] the matcher's scans (kind/columns, r = reverse): "
        f"{scans_text(scans)}")
    table = device_kmer.build_table(
        *db_rows(db, device, "kmer"),
        torch.from_numpy(db.keys.astype(np.int32)).to(device),
        device_kmer.KmerParams(k=14, alphabet_size=13, kmers_per_sequence=60,
                               kmers_per_sequence_scale=0.0, ksel=60), 67)
    new_group, sid_s, pos_s, len_s, fwd_s = device_kmer.sort_table(
        *table[:4], False)
    cols = (new_group, sid_s, (pos_s << 1) | fwd_s, len_s)
    k1 = {"ms": cuda_ms(lambda: seg_scan("first", *cols), KERNEL_REPS * reps,
                        device, queued=True),
          "plain_ms": cuda_ms(lambda: seg_scan_plain("first", *cols), reps,
                              device),
          "bytes": scan_bytes(cols[0].numel(), 3), "elements": cols[0].numel()}
    k1["bound_ms"], k1["bound_by"] = bound(k1["bytes"], 0)
    k1["copy_ms"] = copy_ms(k1["bytes"], reps, device)
    say(f"[main] K1 first-carry, 3 columns, T={cols[0].numel()}: kernel "
        f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, bound "
        f"{k1['bound_ms']:.4f} ms ({k1['bytes']} bytes), device copy of the "
        f"same bytes {k1['copy_ms']:.4f} ms")

    sub = torch.from_numpy(constants.blosum62().sub.astype(np.int32)) \
        .to(device)
    args, _, shape = launched_rescore(db, hits)
    err = max_abs_err(rescore_e2e(*args), rescore_e2e_plain(*args))
    if err:
        raise AssertionError(f"K2 on real hits: max |err| {err}")
    n_hits = args[4].numel()
    flat, padded = upload_bytes(db, device)
    say(f"[main] K2 on iteration 0's {launch_text(shape)}, as "
        f"rescore_diagonal_torch launches them ({db.size} flat rows, "
        f"{args[0].numel()} bytes): equal to the plain version")
    say(f"[main] rescore upload per call at iteration 0: {flat} bytes (flat "
        f"rows, offsets, lengths, code table); the padded codes and chars "
        f"took {padded} bytes")
    k2 = {"ms": cuda_ms(lambda: rescore_e2e(*args), KERNEL_REPS * reps,
                        device, queued=True),
          "plain_ms": cuda_ms(lambda: rescore_e2e_plain(*args), reps, device),
          **shape}
    k2["bytes"], n_ops, residues = rescore_traffic(args)
    k2["bound_ms"], k2["bound_by"] = bound(k2["bytes"], n_ops)
    say(f"[main] K2 {n_hits} hits, {residues} window residues: kernel "
        f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms by {k2['bound_by']} ({k2['bytes']} bytes)")
    edge = _edge_case_rows(device) + (sub,)
    want = rescore_e2e_plain(*edge)
    e2 = max_abs_err(rescore_e2e(*edge), want)
    if e2:
        raise AssertionError(f"K2 on edge cases: max |err| {e2}")
    say(f"[main] K2 on {_check_edge_windows(edge, want, 'K2')}, "
        f"{_check_star_windows(edge, want)} windows with '*' at both ends: "
        f"equal to the plain version")
    k2["max_abs_err"] = max(err, e2)
    return (k1_err, k1), k2


# ---------------------------------------------------------------------------
# nucleotide: penguin nuclassemble

def _rescore_launches():
    from plass_tpu_torch.ops import rescore_kernel as rk
    return {"rescore_e2e": rk.LAUNCHES, "rescore_e2e_rev": rk.LAUNCHES_REV,
            "rescore_e2e_rev_uniform": rk.LAUNCHES_REV_UNIFORM,
            "rescore_hamming": rk.LAUNCHES_HAMMING,
            "rescore_hamming_rev": rk.LAUNCHES_HAMMING_REV,
            "rescore_align": rk.LAUNCHES_ALIGN,
            "rescore_align_rev": rk.LAUNCHES_ALIGN_REV}


def _launches():
    from plass_tpu_torch.ops import device_align, seg_scan
    return {"seg_scan": seg_scan.LAUNCHES, **_rescore_launches(),
            "sw_score": device_align.LAUNCHES}


def _reset_launches():
    from plass_tpu_torch.ops import device_align, seg_scan
    from plass_tpu_torch.ops import rescore_kernel as rk
    seg_scan.LAUNCHES = 0
    rk.LAUNCHES = rk.LAUNCHES_REV = rk.LAUNCHES_REV_UNIFORM = 0
    rk.LAUNCHES_HAMMING = rk.LAUNCHES_HAMMING_REV = 0
    rk.LAUNCHES_ALIGN = rk.LAUNCHES_ALIGN_REV = 0
    device_align.LAUNCHES = device_align.PAIRS = device_align.BLOCK_PAIRS = 0


def nucl_cli(inputs, out_dir, extra, device, stats=None):
    from plass_tpu_torch.cli.penguin import run
    out = os.path.join(out_dir, "contigs.fasta")
    rc = run(["nuclassemble", *inputs, out, os.path.join(out_dir, "tmp"),
              "--device", str(device), *extra], stats=stats)
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    return out


def phase_nucl_fixture(device, work):
    from plass_tpu_torch.ops import seg_scan

    before = (seg_scan.LAUNCHES, _rescore_launches()["rescore_e2e_rev_uniform"])
    out = nucl_cli(READS, os.path.join(work, "nfix2"),
                   ["--num-iterations", "2", "--min-contig-len", "150"],
                   device)
    if open(out, "rb").read() != open(GOLDEN_NUCL, "rb").read():
        raise AssertionError("nucleotide fixture assembly differs from "
                             "tests/fixtures/mini_golden_nucl.fasta")
    say("[nucl-fixture] 2 iterations, min-contig-len 150: byte-identical to "
        "the golden")
    after = (seg_scan.LAUNCHES, _rescore_launches()["rescore_e2e_rev_uniform"])
    if device.type == "cuda" and not (after[0] > before[0]
                                      and after[1] > before[1]):
        raise AssertionError(f"kernel launch counters did not rise: "
                             f"{before} -> {after}")
    t0 = time.perf_counter()
    dev_out = nucl_cli(READS, os.path.join(work, "nfix8"),
                       ["--min-contig-len", "150"], device)
    secs = time.perf_counter() - t0
    cpu_out = nucl_cli(READS, os.path.join(work, "nfix8cpu"),
                       ["--min-contig-len", "150"], "cpu")
    data = open(dev_out, "rb").read()
    if not data or data != open(cpu_out, "rb").read():
        raise AssertionError("default nuclassemble on the device differs "
                             "from the CPU run (or is empty)")
    say(f"[nucl-fixture] default parameters (8 iterations), min-contig-len "
        f"150: {data.count(b'>')} contigs in {secs:.1f} s, byte-identical to "
        f"the run with --device cpu")


def make_metagenome(path, n_genomes, genome_len, reads_per_genome,
                    read_len=150, sub_rate=0.002, seed=7):
    """Single-end FASTA of a seeded simulated metagenome: n_genomes random
    ACGT genomes, reads with uniform starts, half of them reverse
    complemented, with seeded substitutions."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genomes = acgt[rng.integers(0, 4, (n_genomes, genome_len))]
    n = n_genomes * reads_per_genome
    g = rng.integers(0, n_genomes, n)
    start = rng.integers(0, genome_len - read_len + 1, n)
    reads = genomes[g[:, None], start[:, None] + np.arange(read_len)]
    mut = rng.random(reads.shape) < sub_rate
    reads[mut] = acgt[rng.integers(0, 4, int(mut.sum()))]
    rc = rng.random(n) < 0.5
    reads[rc] = comp[reads[rc, ::-1]]
    with open(path, "wb") as fh:
        fh.write(b"".join(b">%d\n%s\n" % (i, r.tobytes())
                          for i, r in enumerate(reads)))
    return n


def phase_nucl_scale(device, work, n_genomes, genome_len):
    t0 = time.perf_counter()
    fasta = os.path.join(work, "metagenome.fasta")
    # 15x coverage of each genome by 150-nt reads
    n_reads = make_metagenome(fasta, n_genomes, genome_len,
                              genome_len * 15 // 150)
    say(f"[nucl-scale] {n_reads} reads of {n_genomes} genomes x {genome_len} "
        f"nt written in {time.perf_counter() - t0:.1f} s")
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    out = nucl_cli([fasta], os.path.join(work, "nscale"), [], device,
                   stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    _, body = check_nucl_fasta(out, "nucl-scale")
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    say(f"[nucl-scale] reads {stats['reads']}, iteration-0 table entries "
        f"{stats['table_entries']}, iteration-0 hits {stats['hits']}, "
        f"reverse hits {stats['reverse_hits']}")
    say("[nucl-scale] seconds per stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stats["seconds"].items()))
    say(f"[nucl-scale] wall {wall:.1f} s, {stats['reads'] / wall:.0f} "
        f"reads/s, {len(body)} contigs (longest "
        f"{max(len(s) for s in body)} nt), sha256 {digest}")
    say("[nucl-scale] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if stats["reverse_hits"] <= 0:
        raise AssertionError("no reverse-strand hits at iteration 0")
    if device.type == "cuda":
        say(f"[nucl-scale] max_memory_allocated "
            f"{max(stats['peak_bytes'].values()) / 2**30:.2f} GiB; by stage, "
            f"GiB: {peaks_text(stats)}")
        if not (launches["seg_scan"] and launches["rescore_e2e_rev_uniform"]):
            raise AssertionError(f"a kernel of the nucleotide path never "
                                 f"launched: {launches}")
    tmp = os.path.join(work, "nscale", "tmp", "latest")
    # the input of the last iteration (8 by default) is iteration 6's
    # active set
    run = {"fasta": fasta, "sha256": digest, "stats": stats}
    return launches, (os.path.join(tmp, "nucl_reads"),
                      os.path.join(tmp, "assembly_6_active")), run


def _nucl_edge_case_rows(device):
    """Synthetic nucleotide K2 inputs on flat rows whose starts take every
    residue mod 16: forward and reverse hits at both row ends, no overlap
    (ov <= 0), N bases, lower case, '*' at a window end, rows longer than
    1,024, windows of LONG_WINDOW - 1, LONG_WINDOW and LONG_WINDOW + 1 nt,
    and a true reverse-complement match. Returns (rows, offsets, lengths,
    code table, qrow, trow, diag, qrev)."""
    import torch
    from plass_tpu_torch import constants

    rng = np.random.default_rng(11)
    letters = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)
    seqs = [letters[rng.integers(0, len(letters), n)] for n in EDGE_LENS]
    star = ord("*")
    seqs[0][0] = seqs[1][39] = seqs[2][2999] = star
    seqs[9][0] = seqs[10][LONG_WINDOW] = star
    comp = np.arange(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGTNacgt", np.uint8)] = np.frombuffer(
        b"TGCANtgca", np.uint8)
    seqs[6][:300] = comp[seqs[2][400:700][::-1]]
    rows, offsets, lengths = flat_rows([x.tobytes() for x in seqs], device)
    if len(set(int(o) % 16 for o in offsets)) != 16:
        raise AssertionError("edge-case rows do not cover every alignment")
    lut = torch.from_numpy(constants.nucleotide().aa2num.astype(np.uint8)) \
        .to(device)
    return (rows, offsets, lengths, lut,
            *_edge_hits(len(seqs), device, True))


NUCL_MATCH = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
                  hash_shift=67, ignore_multi_kmer=True,
                  include_only_extendable=True)
NUCL_K2 = ("rescore_e2e_rev_uniform", "rescore_e2e_rev")


def _nucl_rescore_inputs(db, device, mode=3):
    """The nucleotide matcher's hits on `db` (default parameters), the
    operands rescore_diagonal_torch hands the kernel of --rescore-mode
    `mode` for them (self rows included) and the matcher's scans: (hits,
    args, reverse operands, uniform pattern, scans, launch_text's
    shape)."""
    from plass_tpu_torch import constants
    from plass_tpu_torch.ops.backend import kmermatcher_torch
    from plass_tpu_torch.ops.rescore_kernel import uniform_pattern

    hits, scans = recorded_scans(lambda: kmermatcher_torch(db, 22, device,
                                                           **NUCL_MATCH))
    uniform = uniform_pattern(constants.nucleotide().sub)
    if uniform is None:
        raise AssertionError("the nucleotide matrix is not uniform")
    args, rkw, shape = launched_rescore(db, hits, mode)
    return hits, args, rkw, uniform, scans, shape


def phase_nucl_main(device, first_db, last_db, reps):
    """K1 and K2's reverse-strand variants at the shapes of phase 7: the
    nucleotide matcher with every scan in the kernel equals it with every
    scan in the plain version (iteration 0); the uniform and the generic
    matrix variants of K2 equal the plain version on the operands of
    rescore_diagonal_torch's launch (hits and self rows) at the first and
    at the last iteration and on edge cases, and are timed
    against it and their bound at iteration 0 and, the kernel alone, at the
    last iteration."""
    import torch
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import device_kmer
    from plass_tpu_torch.ops.backend import kmermatcher_torch
    from plass_tpu_torch.ops.rescore_kernel import (rescore_e2e,
                                                    rescore_e2e_plain)
    from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

    db = seqdb.SeqDB.open(first_db)
    hits, args, rkw, uniform, scans, shape = _nucl_rescore_inputs(db, device)
    device_kmer.seg_scan = seg_scan_plain
    try:
        plain_hits = kmermatcher_torch(db, 22, device, **NUCL_MATCH)
    finally:
        device_kmer.seg_scan = seg_scan
    k1_err = max(int(np.abs(np.asarray(g, np.int64)
                            - np.asarray(w, np.int64)).max(initial=0))
                 for g, w in zip(hits, plain_hits))
    if k1_err or len(hits[0]) != len(plain_hits[0]):
        raise AssertionError(f"K1 in the nucleotide matcher: max |err| "
                             f"{k1_err}")
    n_rev = int((hits[2] < 0).sum())
    say(f"[nucl-main] matcher on {db.size} reads ({hits.table_entries} table "
        f"entries, {len(hits.hit_slots)} hits, {n_rev} reverse): kernel scans "
        f"equal plain")
    say(f"[nucl-main] the matcher's scans at iteration 0 (kind/columns, r = "
        f"reverse): {scans_text(scans)}")
    flat, padded = upload_bytes(db, device)
    say(f"[nucl-main] rescore upload per call at iteration 0: {flat} bytes "
        f"(flat rows, offsets, lengths, code table); the padded codes and "
        f"chars took {padded} bytes")

    want = rescore_e2e_plain(*args, **rkw)
    n_bytes, n_ops, residues = rescore_traffic(args, rkw["qrev"])
    bms, bby = bound(n_bytes, n_ops)
    out = {}
    edge = _nucl_edge_case_rows(device)
    edge_args, edge_rev = edge[:7] + (args[7],), edge[7]
    edge_kw = dict(rkw, qrev=edge_rev)
    edge_want = rescore_e2e_plain(*edge_args, **edge_kw)
    edge_text = _check_edge_windows(edge_args, edge_want, "K2 rev")
    for name in NUCL_K2:
        uni = uniform if name == "rescore_e2e_rev_uniform" else None
        err = max_abs_err(rescore_e2e(*args, uniform=uni, **rkw), want)
        e2 = max_abs_err(rescore_e2e(*edge_args, uniform=uni, **edge_kw),
                         edge_want)
        if err or e2:
            raise AssertionError(f"{name}: max |err| {err} on real hits, "
                                 f"{e2} on edge cases")
        ms = cuda_ms(lambda: rescore_e2e(*args, uniform=uni, **rkw),
                     KERNEL_REPS * reps, device, queued=True)
        pms = cuda_ms(lambda: rescore_e2e_plain(*args, **rkw), reps, device)
        out[name] = {"max_abs_err": max(err, e2), "ms": ms, "plain_ms": pms,
                     "bytes": n_bytes, "bound_ms": bms, "bound_by": bby,
                     **shape}
        say(f"[nucl-main] K2 {name} on iteration 0's {launch_text(shape)} "
            f"({db.size} flat rows, {args[0].numel()} bytes, {residues} "
            f"window residues) and {edge_text}: equal to the plain version; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms by "
            f"{bby} ({n_bytes} bytes)")

    # the last iteration: contigs up to max_seq_len beside the reads, so
    # reverse hits index far into long rows and most windows are long
    db = seqdb.SeqDB.open(last_db)
    hits, args, rkw, uniform, scans, shape = _nucl_rescore_inputs(db, device)
    del hits
    say(f"[nucl-main] the matcher's scans at the last iteration: "
        f"{scans_text(scans)}")
    t0 = time.perf_counter()
    want = rescore_e2e_plain(*args, **rkw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    last_plain_ms = (time.perf_counter() - t0) * 1e3
    n_rev = int(rkw["qrev"].sum())
    n_bytes, n_ops, residues = rescore_traffic(args, rkw["qrev"])
    bms, bby = bound(n_bytes, n_ops)
    last_ms = {}
    for name in NUCL_K2:
        uni = uniform if name == "rescore_e2e_rev_uniform" else None
        err = max_abs_err(rescore_e2e(*args, uniform=uni, **rkw), want)
        if err:
            raise AssertionError(f"{name} on the last iteration's hits: max "
                                 f"|err| {err}")
        last_ms[name] = cuda_ms(
            lambda: rescore_e2e(*args, uniform=uni, **rkw),
            KERNEL_REPS * reps, device, queued=True)
    flat, padded = upload_bytes(db, device)
    say(f"[nucl-main] K2 {' and '.join(NUCL_K2)} on the last iteration's "
        f"{launch_text(shape)} ({n_rev} reverse; {db.size} rows, longest "
        f"{int(args[2].max())} nt, {residues} window residues): equal to the "
        f"plain version; kernel "
        + ", ".join(f"{last_ms[k]:.4f} ms" for k in NUCL_K2)
        + f", plain {last_plain_ms:.1f} ms (one call), bound {bms:.4f} ms "
        f"by {bby} ({n_bytes} bytes)")
    say(f"[nucl-main] rescore upload per call at the last iteration: {flat} "
        f"bytes (flat rows, offsets, lengths, code table); the padded codes "
        f"and chars took {padded} bytes ({padded / 2**30:.2f} GiB)")
    return k1_err, out


# ---------------------------------------------------------------------------
# protein-guided nucleotide: penguin guided_nuclassemble

def guided_cli(inputs, out_dir, extra, device, stats=None):
    from plass_tpu_torch.cli.penguin import run
    out = os.path.join(out_dir, "contigs.fasta")
    rc = run(["guided_nuclassemble", *inputs, out,
              os.path.join(out_dir, "tmp"), "--device", str(device), *extra],
             stats=stats)
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    return out


def guided_seconds_text(stats):
    """The seconds of every stage of a guided run, the nested nuclassemble's
    and the linclust tail's own stages in brackets."""
    def fmt(d):
        return ", ".join(f"{k} {v:.2f}" for k, v in d.items())
    return (fmt(stats["seconds"])
            + f"; nuclassemble [{fmt(stats['nuclassemble']['seconds'])}]"
            + f"; linclust [{fmt(stats['linclust_seconds'])}]")


def check_nucl_fasta(path, name):
    """The (headers, sequences) of a contig FASTA with cycle annotations,
    or an AssertionError."""
    lines = open(path).read().splitlines()
    heads, body = lines[0::2], lines[1::2]
    for h, s in zip(heads, body):
        if not h.startswith(">") or f" len:{len(s)} " not in h + " ":
            raise AssertionError(f"{name}: malformed FASTA record {h!r}")
        if set(s) - set("ACGTN"):
            raise AssertionError(f"{name}: non-nucleotide contig {h!r}")
    if not body:
        raise AssertionError(f"{name}: the assembly produced no contigs")
    return heads, body


def phase_guided_fixture(device, work, extra=()):
    before = (_launches()["seg_scan"], _launches()["rescore_e2e"],
              _launches()["rescore_e2e_rev_uniform"])
    flags = ["--min-contig-len", "150", *extra]
    stats = {}
    t0 = time.perf_counter()
    dev_out = guided_cli(READS, os.path.join(work, "gfix"), flags, device,
                         stats=stats)
    secs = time.perf_counter() - t0
    cpu_out = guided_cli(READS, os.path.join(work, "gfixcpu"), flags, "cpu")
    data = open(dev_out, "rb").read()
    if data != open(cpu_out, "rb").read():
        raise AssertionError("guided_nuclassemble on the device differs from "
                             "the run with --device cpu")
    heads, _ = check_nucl_fasta(dev_out, "guided-fixture")
    after = (_launches()["seg_scan"], _launches()["rescore_e2e"],
             _launches()["rescore_e2e_rev_uniform"])
    if device.type == "cuda" and not all(a > b for a, b in zip(after, before)):
        raise AssertionError(f"kernel launch counters did not rise: "
                             f"{before} -> {after}")
    say(f"[guided-fixture] default parameters{' ' + ' '.join(extra) if extra else ''}"
        f", min-contig-len 150: {len(heads)} contigs in {secs:.1f} s, sha256 "
        f"{hashlib.sha256(data).hexdigest()}, byte-identical to the run with "
        f"--device cpu")
    say(f"[guided-fixture] seconds per stage: {guided_seconds_text(stats)}")


def coding_genomes(rng, n_genomes, genome_len):
    """uint8[n_genomes, genome_len] of seeded coding genomes: each a row
    of genes (ATG, 100-700 seeded sense codons, a stop codon) on either
    strand, 20-150 nt of random sequence between them."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    codons = np.array([[a, b, c] for a in acgt for b in acgt for c in acgt
                       if bytes([a, b, c]) not in (b"TAA", b"TAG", b"TGA")],
                      dtype=np.uint8)
    stops = np.frombuffer(b"TAATAGTGA", dtype=np.uint8).reshape(3, 3)
    genomes = np.empty((n_genomes, genome_len), dtype=np.uint8)
    for g in range(n_genomes):
        parts, total = [], 0
        while total < genome_len:
            gene = np.concatenate([
                np.frombuffer(b"ATG", dtype=np.uint8),
                codons[rng.integers(0, len(codons),
                                    int(rng.integers(100, 700)))].reshape(-1),
                stops[rng.integers(3)]])
            if rng.random() < 0.5:
                gene = comp[gene[::-1]]
            parts += [gene, acgt[rng.integers(0, 4, int(rng.integers(20, 150)))]]
            total += len(gene) + len(parts[-1])
        genomes[g] = np.concatenate(parts)[:genome_len]
    return genomes


def make_coding_metagenome(path, n_genomes, genome_len, reads_per_genome,
                           read_len=150, sub_rate=0.002, seed=19):
    """Single-end FASTA of a seeded simulated metagenome of coding genomes
    (coding_genomes): reads with uniform starts, half of them reverse
    complemented, with seeded substitutions. The replicated fixture reads
    cannot serve here: their copies differ by 3% from each other, so at
    the nucleotide identity of 0.99 nothing grows beyond the fixture's own
    386 nt and the default --min-contig-len 1000 leaves no contig."""
    rng = np.random.default_rng(seed)
    genomes = coding_genomes(rng, n_genomes, genome_len)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    n = n_genomes * reads_per_genome
    g = rng.integers(0, n_genomes, n)
    start = rng.integers(0, genome_len - read_len + 1, n)
    reads = genomes[g[:, None], start[:, None] + np.arange(read_len)]
    mut = rng.random(reads.shape) < sub_rate
    reads[mut] = acgt[rng.integers(0, 4, int(mut.sum()))]
    rc = rng.random(n) < 0.5
    reads[rc] = comp[reads[rc, ::-1]]
    with open(path, "wb") as fh:
        fh.write(b"".join(b">%d\n%s\n" % (i, r.tobytes())
                          for i, r in enumerate(reads)))
    return n


def phase_guided_scale(device, work, n_genomes, genome_len):
    t0 = time.perf_counter()
    fasta = os.path.join(work, "guided_reads.fasta")
    # 15x coverage of each genome by 150-nt reads
    n_reads = make_coding_metagenome(fasta, n_genomes, genome_len,
                                     genome_len * 15 // 150)
    say(f"[guided-scale] {n_reads} reads of {n_genomes} coding genomes x "
        f"{genome_len} nt written in {time.perf_counter() - t0:.1f} s")
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    # every amino-acid iteration's DB is kept for phase_guided_main
    out = guided_cli([fasta], os.path.join(work, "gscale"),
                     ["--delete-tmp-inc", "0"], device, stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    _, body = check_nucl_fasta(out, "guided-scale")
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    nested = stats["nuclassemble"]
    say(f"[guided-scale] reads {stats['reads']}, ORFs {stats['orfs']}, "
        f"aa iteration-0 table entries {stats['table_entries']}, aa "
        f"iteration-0 hits {stats['hits']}, only-assembled "
        f"{stats['only_assembled']}; nested nuclassemble on "
        f"{nested['reads']} sequences, iteration-0 hits {nested['hits']} "
        f"({nested['reverse_hits']} reverse)")
    say(f"[guided-scale] seconds per stage: {guided_seconds_text(stats)}")
    say(f"[guided-scale] wall {wall:.1f} s, {stats['reads'] / wall:.0f} "
        f"reads/s, {len(body)} contigs (longest "
        f"{max(len(s) for s in body)} nt), sha256 {digest}")
    say("[guided-scale] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if stats["only_assembled"] <= 0:
        raise AssertionError("guided-scale: the amino-acid loop extended "
                             "nothing")
    if device.type == "cuda":
        say(f"[guided-scale] max_memory_allocated "
            f"{max(stats['peak_bytes'].values()) / 2**30:.2f} GiB; by stage, "
            f"GiB: {peaks_text(stats)}; nuclassemble by stage, GiB: "
            f"{peaks_text(stats['nuclassemble'])}")
        if not (launches["seg_scan"] and launches["rescore_e2e"]
                and launches["rescore_e2e_rev_uniform"]):
            raise AssertionError(f"a kernel of the guided path never "
                                 f"launched: {launches}")
    tmp = os.path.join(work, "gscale", "tmp", "latest")
    # the input of the last amino-acid iteration (5 by default) is
    # iteration 3's output
    return launches, (os.path.join(tmp, "aa_6f_start_long"),
                      os.path.join(tmp, "assembly_aa_3"))


AA_MATCH = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
                hash_shift=67, ignore_multi_kmer=True,
                include_only_extendable=True)


def phase_guided_main(device, first_db, last_db, reps):
    """K1 and K2 at the shapes of phase 10's amino-acid loop: the matcher
    (k 14 with the nucleotide k-mer scale, only extendable hits) with every
    scan in the kernel equals it with every scan in the plain version at
    iteration 0; K2 equals its plain version on the launch of the last
    iteration (its hits and self rows), whose rows are the longest, and is
    timed against it and its bound."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import device_kmer
    from plass_tpu_torch.ops.backend import kmermatcher_torch
    from plass_tpu_torch.ops.rescore_kernel import (rescore_e2e,
                                                    rescore_e2e_plain)
    from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

    db = seqdb.SeqDB.open(first_db)
    hits, scans = recorded_scans(lambda: kmermatcher_torch(db, 14, device,
                                                           **AA_MATCH),
                                 keep=True)
    device_kmer.seg_scan = seg_scan_plain
    try:
        plain_hits = kmermatcher_torch(db, 14, device, **AA_MATCH)
    finally:
        device_kmer.seg_scan = seg_scan
    k1_err = max(int(np.abs(np.asarray(g, np.int64)
                            - np.asarray(w, np.int64)).max(initial=0))
                 for g, w in zip(hits, plain_hits))
    if k1_err or len(hits[0]) != len(plain_hits[0]):
        raise AssertionError(f"K1 in the guided matcher: max |err| {k1_err}")
    say(f"[guided-main] aa matcher on {db.size} ORFs (longest "
        f"{int(db.seq_lens().max())} residues, {hits.table_entries} table "
        f"entries, {len(hits.hit_slots)} hits): kernel scans equal plain")
    say(f"[guided-main] the matcher's scans at iteration 0 (kind/columns, r "
        f"= reverse): {scans_text(scans)}")
    # each of the matcher's scans again, alone: kernel, plain, bound
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0}
    for kind, n, nv, rev, (flag, vals) in scans:
        err = max_abs_err(seg_scan(kind, flag, *vals, reverse=rev),
                          seg_scan_plain(kind, flag, *vals, reverse=rev))
        if err:
            raise AssertionError(f"K1 {kind} in the guided matcher: max |err| "
                                 f"{err}")
        k1["ms"] += cuda_ms(lambda: seg_scan(kind, flag, *vals, reverse=rev),
                            KERNEL_REPS * reps, device, queued=True)
        k1["plain_ms"] += cuda_ms(lambda: seg_scan_plain(
            kind, flag, *vals, reverse=rev), reps, device)
        k1["bytes"] += scan_bytes(n, nv)
    k1["bound_ms"] = bound(k1["bytes"], 0)[0]
    say(f"[guided-main] K1, the aa matcher's {len(scans)} scans at "
        f"iteration 0, each alone: equal to the plain version; together: "
        f"kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, bound "
        f"{k1['bound_ms']:.4f} ms ({k1['bytes']} bytes)")
    del scans

    db = seqdb.SeqDB.open(last_db)
    hits = kmermatcher_torch(db, 14, device, **AA_MATCH)
    if not hits.dev[0].numel():
        raise AssertionError("guided-main: the last aa iteration has no hits")
    args, _, shape = launched_rescore(db, hits)
    err = max_abs_err(rescore_e2e(*args), rescore_e2e_plain(*args))
    if err:
        raise AssertionError(f"K2 on the last aa iteration's hits: max |err| "
                             f"{err}")
    data = np.asarray(db.data)
    lens = db.seq_lens()
    nonempty = lens > 0
    star_first = int((data[db.offsets[nonempty]] == ord("*")).sum())
    star_last = int((data[(db.offsets + lens - 1)[nonempty]]
                     == ord("*")).sum())
    ms = cuda_ms(lambda: rescore_e2e(*args), KERNEL_REPS * reps, device,
                 queued=True)
    pms = cuda_ms(lambda: rescore_e2e_plain(*args), reps, device)
    n_bytes, n_ops, residues = rescore_traffic(args)
    bms, bby = bound(n_bytes, n_ops)
    flat, padded = upload_bytes(db, device)
    say(f"[guided-main] K2 rescore_e2e on the last aa iteration's "
        f"{launch_text(shape)} ({db.size} flat rows, longest "
        f"{int(lens.max())} "
        f"residues, {star_first} begin and {star_last} end with '*'; "
        f"{residues} window residues): equal to the plain version; kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms by {bby} "
        f"({n_bytes} bytes)")
    say(f"[guided-main] rescore upload per call at the last aa iteration: "
        f"{flat} bytes (flat rows, offsets, lengths, code table); padded "
        f"codes and chars would take {padded} bytes")
    return k1_err, err


# ---------------------------------------------------------------------------
# the memory-bounded (hash-range split) matcher

def _peak_reset(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    """Peak device memory since the last _peak_reset, bytes (0 on the
    CPU)."""
    import torch
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def _match_args(kw):
    """kmermatcher_torch's keywords split into matcher_params' and the
    hash shift."""
    kw = dict(kw)
    return kw.pop("hash_shift"), kw


def matcher_memory(db, k, kw, device):
    """The monolithic matcher's device memory on `db`, stage by stage, and
    its largest range-key bin: the selection stage's peak above the table
    it builds, the table's bytes, the peak of the pairs and the merge per
    table entry (the table included) and (bin, entries) of the fullest
    range-key bin."""
    import torch
    from plass_tpu_torch.ops import device_kmer as dk
    from plass_tpu_torch.ops.backend import flat_rows as db_rows
    from plass_tpu_torch.ops.backend import matcher_params

    shift, pkw = _match_args(kw)
    params = matcher_params(db, k, **pkw)
    args = (*db_rows(db, device, "kmer"),
            torch.from_numpy(db.keys.astype(np.int32)).to(device))
    _peak_reset(device)
    base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    table = dk.build_table(*args, params, shift)
    select = _peak(device)
    table_bytes = sum(x.numel() * x.element_size() for x in table[:4])
    hist = torch.bincount(table[4], minlength=dk.RANGE_BINS)
    top = int(hist.argmax())
    largest = int(hist[top])
    table = table[:4]
    del hist
    _peak_reset(device)
    hits = dk._hits(*dk.sort_pairs(*dk.pairs_from_table(*table, params)))
    pairs = _peak(device)
    n = table[0].numel()
    del hits, table
    return {"entries": n, "select_bytes": max(select - base - table_bytes, 0),
            "table_bytes": table_bytes,
            "bytes_per_entry": (pairs - base) / max(n, 1),
            "peak": max(select, pairs) - base, "largest_bin": (top, largest)}


def _same_hits(a, b):
    """Flat hit arrays and device hits equal."""
    import torch
    return (all(np.array_equal(x, y) for x, y in zip(a, b))
            and all(torch.equal(x, y) for x, y in zip(a.dev, b.dev)))


def phase_split_main(device, inputs, rehearsal):
    """The split matcher against the monolithic one at the main paths'
    shapes: for each (name, DB path, k, matcher keywords, edge), the
    monolithic call, a split into at least 8 ranges and, where edge is
    true, a split whose budget is one entry below the largest range-key bin
    (thousands of ranges at about 2 ms each) give equal flat hits and
    device hits; the monolithic matcher's memory by stage gives its bytes
    per table entry, which the automatic budget assumes. Returns the
    largest bytes per entry measured."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops.backend import BYTES_PER_ENTRY, kmermatcher_torch
    from plass_tpu_torch.ops.kmermatch import ENTRY_BYTES

    worst = 0.0
    for name, path, k, kw, edge in inputs:
        db = seqdb.SeqDB.open(path)
        mem = matcher_memory(db, k, kw, device)
        _peak_reset(device)
        t0 = time.perf_counter()
        mono = kmermatcher_torch(db, k, device, **kw)
        secs = {"monolithic": time.perf_counter() - t0}
        peaks = {"monolithic": _peak(device)}
        top, largest = mem["largest_bin"]
        # the rehearsal's tables are too small for one range per few bins
        budgets = {"8+ ranges": mono.table_entries // 10}
        if edge:
            budgets["below the largest bin"] = largest - 1 if not rehearsal \
                else max(largest - 1, mono.table_entries // 40)
        ranges = {}
        for label, budget in budgets.items():
            _peak_reset(device)
            t0 = time.perf_counter()
            split = kmermatcher_torch(db, k, device, split_memory_limit=budget
                                      * ENTRY_BYTES, **kw)
            secs[label] = time.perf_counter() - t0
            peaks[label] = _peak(device)
            ranges[label] = len(split.ranges)
            if not _same_hits(split, mono):
                raise AssertionError(f"split-main {name}, {label}: the split "
                                     f"hits differ from the monolithic ones")
            del split
        if ranges["8+ ranges"] < 8 or len(mono.hit_slots) == 0 or (
                largest <= budgets.get("below the largest bin", 0)
                and not rehearsal):
            raise AssertionError(f"split-main {name}: {ranges} ranges, "
                                 f"largest bin {largest}")
        say(f"[split-main] {name}: {db.size} sequences, {mono.table_entries} "
            f"table entries, {len(mono.hit_slots)} hits; split into "
            + ", ".join(f"{ranges[b]} ranges ({b}, budget {budgets[b]})"
                        for b in budgets)
            + f": equal to the monolithic matcher; seconds "
            + ", ".join(f"{b} {v:.2f}" for b, v in secs.items())
            + "; peak device memory, GiB: "
            + ", ".join(f"{b} {v / 2**30:.2f}" for b, v in peaks.items()))
        if device.type == "cuda":
            worst = max(worst, mem["bytes_per_entry"])
            say(f"[split-main] {name}: monolithic matcher memory by stage: "
                f"selection block {mem['select_bytes'] / 2**30:.2f} GiB above "
                f"the table, table {mem['table_bytes']} bytes ("
                f"{mem['table_bytes'] / max(mem['entries'], 1):.1f} per "
                f"entry), pairs and merge {mem['bytes_per_entry']:.1f} bytes "
                f"per table entry (the table included); largest range-key "
                f"bin {top}, {largest} entries")
        del mono
    if device.type == "cuda":
        say(f"[split-main] largest bytes per table entry measured "
            f"{worst:.1f}; the automatic budget assumes {BYTES_PER_ENTRY}")
        if worst > BYTES_PER_ENTRY:
            raise AssertionError("the automatic split budget assumes fewer "
                                 "bytes per entry than the matcher takes")
    return worst


def phase_nucl_split(device, work, ref):
    """penguin nuclassemble of phase 7's reads through the CLI with a
    --split-memory-limit that splits iteration 0 into at least 8 ranges:
    the contigs equal phase 7's byte for byte."""
    from plass_tpu_torch.ops.kmermatch import ENTRY_BYTES

    limit = ref["stats"]["table_entries"] // 10 * ENTRY_BYTES
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    out = nucl_cli([ref["fasta"]], os.path.join(work, "nsplit"),
                   ["--split-memory-limit", str(limit)], device, stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    if digest != ref["sha256"]:
        raise AssertionError(f"nucl-split: sha256 {digest} differs from the "
                             f"monolithic run's {ref['sha256']}")
    if stats["ranges"][0] < 8:
        raise AssertionError(f"nucl-split: {stats['ranges'][0]} ranges at "
                             f"iteration 0")
    say(f"[nucl-split] --split-memory-limit {limit} (table bytes at "
        f"{ENTRY_BYTES} per entry): ranges per iteration {stats['ranges']}; "
        f"sha256 {digest}, equal to nucl-scale's")
    say("[nucl-split] seconds per stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stats["seconds"].items())
        + f"; wall {wall:.1f} s (nucl-scale: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ref["stats"]["seconds"].items())
        + ")")
    say("[nucl-split] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if device.type == "cuda":
        say(f"[nucl-split] peak device memory by stage, GiB: "
            f"{peaks_text(stats)} (nucl-scale: {peaks_text(ref['stats'])})")
        if not (launches["seg_scan"] and launches["rescore_e2e_rev_uniform"]):
            raise AssertionError(f"a kernel of the split path never launched: "
                                 f"{launches}")
    return launches


def metagenome_db(n_reads, genome_len=20000, read_len=150, sub_rate=0.002,
                  seed=23, chunk=1 << 20):
    """A nucleotide SeqDB, built in memory, of n_reads seeded reads in the
    manner of make_metagenome: random genomes read at 15x, uniform starts,
    half of the reads reverse complemented, seeded substitutions."""
    from plass_tpu_torch.data import seqdb

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    n_genomes = max(1, n_reads * read_len // (15 * genome_len))
    genomes = acgt[rng.integers(0, 4, (n_genomes, genome_len), dtype=np.uint8)]
    width = read_len + 2
    data = np.empty((n_reads, width), dtype=np.uint8)
    data[:, read_len] = ord("\n")
    data[:, read_len + 1] = 0
    for lo in range(0, n_reads, chunk):
        m = min(chunk, n_reads - lo)
        g = rng.integers(0, n_genomes, m)
        start = rng.integers(0, genome_len - read_len + 1, m)
        reads = genomes[g[:, None], start[:, None] + np.arange(read_len)]
        n_mut = int(rng.binomial(m * read_len, sub_rate))
        reads.reshape(-1)[rng.integers(0, m * read_len, n_mut)] = \
            acgt[rng.integers(0, 4, n_mut)]
        rc = rng.random(m) < 0.5
        reads[rc] = comp[reads[rc, ::-1]]
        data[lo:lo + m, :read_len] = reads
    return seqdb.SeqDB(data.reshape(-1), np.arange(n_reads, dtype=np.uint32),
                       np.arange(n_reads, dtype=np.int64) * width,
                       np.full(n_reads, width, dtype=np.int64),
                       seqdb.NUCLEOTIDES), n_genomes


def _hits_digest(hits):
    h = hashlib.sha256()
    for x in hits:
        h.update(np.ascontiguousarray(x, dtype=np.int64).tobytes())
    return h.hexdigest()


def phase_nucl_large(device, rehearsal):
    """The nucleotide matcher (iteration 0, nuclassemble defaults) on a DB
    of seeded 150-nt reads, the fewest whose table the monolithic matcher
    would need more than the card's free memory for: once with the
    automatic budget, once at half of it; equal hits, peak memory under
    the card's. The rescore and the later iterations are left out."""
    import torch
    from plass_tpu_torch.ops.backend import (BYTES_PER_ENTRY,
                                             kmermatcher_torch,
                                             matcher_params, split_budget)
    from plass_tpu_torch.ops.device_kmer import ksel_capacity
    from plass_tpu_torch.ops.kmermatch import ENTRY_BYTES

    _, pkw = _match_args(NUCL_MATCH)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        # the estimate of one read of 150 nt: ksel + 1 selected entries and
        # its own entry
        per_read = ksel_capacity(pkw["kmers_per_sequence"],
                                 pkw["kmers_per_sequence_scale"], 150) + 2
        n_reads = free // (per_read * BYTES_PER_ENTRY) + 1
    else:
        n_reads, total = 3000, 0
    t0 = time.perf_counter()
    db, n_genomes = metagenome_db(n_reads)
    params = matcher_params(db, 22, **pkw)
    est = db.size * (params.ksel + 1) + db.size
    say(f"[nucl-large] {n_reads} reads of {n_genomes} genomes x 20000 nt "
        f"built in {time.perf_counter() - t0:.1f} s; table estimate {est} "
        f"entries, {est * BYTES_PER_ENTRY} bytes for the monolithic matcher "
        f"at {BYTES_PER_ENTRY} per entry")
    budget = split_budget(db, params, device, 0)
    if budget is None:
        if not rehearsal:
            raise AssertionError("nucl-large: the automatic budget does not "
                                 "split")
        budget = est // 4    # the CPU has no automatic budget
    runs = {}
    for label, limit in (("automatic", 0 if not rehearsal else budget
                          * ENTRY_BYTES),
                         ("half", budget // 2 * ENTRY_BYTES)):
        _peak_reset(device)
        t0 = time.perf_counter()
        hits = kmermatcher_torch(db, 22, device, split_memory_limit=limit,
                                 **NUCL_MATCH)
        secs = time.perf_counter() - t0
        runs[label] = (len(hits.ranges), secs, _peak(device),
                       _hits_digest(hits), hits.table_entries,
                       len(hits.hit_slots))
        del hits
    (r1, s1, p1, d1, n, h), (r2, s2, p2, d2, _, _) = runs.values()
    if d1 != d2 or r1 < 2 or r2 <= r1:
        raise AssertionError(f"nucl-large: {r1} and {r2} ranges, hits "
                             f"{d1} and {d2}")
    if device.type == "cuda" and max(p1, p2) >= total:
        raise AssertionError("nucl-large: peak memory above the card's")
    say(f"[nucl-large] {n} table entries, {h} hits; automatic budget "
        f"(before the call: {budget} entries a range): {r1} ranges, "
        f"{s1:.1f} s, peak {p1 / 2**30:.2f} GiB; half of it: {r2} ranges, "
        f"{s2:.1f} s, peak {p2 / 2**30:.2f} GiB; card {total / 2**30:.2f} "
        f"GiB; equal hits, sha256 {d1}; the rescore and the later "
        f"iterations are left out")


# ---------------------------------------------------------------------------
# the amino-acid aligner: `plass linclust` on the assembled proteins

# `plass linclust` runs: (input, label, flags). "contigs" are phase 4's;
# "families" is family_fasta's DB of distinct proteins
LINCLUST_RUNS = (("contigs", "defaults", ()),
                 ("contigs", "--min-seq-id 0.95", ("--min-seq-id", "0.95")),
                 ("families", "defaults", ()))
# families in family_fasta's DB: about 6,000 proteins, 1.9M residues
FAMILIES = 1500


def family_fasta(path, n_fam, seed=17, families=None):
    """A seeded FASTA of protein families, the kind of input `plass
    linclust` clusters after an assembly: many distinct proteins of
    hundreds of residues with near and far relatives. A family's root has
    a log-normal length (median 300 residues, 80 to 1,500), its letters
    drawn from BLOSUM62's background frequencies; 1 + Poisson(3) members,
    all but the root with 1-20% substitutions, Poisson(L / 200) indels of 1
    to 5 residues and up to 15% cut from the ends; records shuffled, each
    named f<i> by its place before the shuffle. A `families` list receives
    the family of f0, f1, ... in that order. Returns the number of
    records."""
    from plass_tpu_torch import constants
    mat = constants.blosum62()
    # a copy: the matrix is cached for the whole process
    freq = np.array(mat.pback[:20], dtype=np.float64)
    freq /= freq.sum()
    letters = mat.num2aa[:20]
    rng = np.random.default_rng(seed)

    def draw(n):
        return letters[rng.choice(20, n, p=freq)]

    recs = []
    for f in range(n_fam):
        root = draw(int(np.clip(rng.lognormal(np.log(300), 0.5), 80, 1500)))
        recs.append(root)
        n_before = len(recs)
        for _ in range(rng.poisson(3)):
            s = root.copy()
            mut = rng.random(len(s)) < rng.uniform(0.01, 0.2)
            s[mut] = draw(int(mut.sum()))
            for _ in range(rng.poisson(len(root) / 200)):
                at, n = int(rng.integers(0, len(s))), int(rng.integers(1, 6))
                s = np.delete(s, slice(at, at + n)) if rng.random() < 0.5 \
                    else np.insert(s, at, draw(n))
            cut = int(rng.integers(0, max(1, int(0.15 * len(s)))))
            a = int(rng.integers(0, cut + 1))
            recs.append(s[a:len(s) - (cut - a)])
        if families is not None:
            families.extend([f] * (len(recs) - n_before + 1))
    with open(path, "w") as fh:
        for i in rng.permutation(len(recs)):
            fh.write(f">f{i}\n{recs[i].tobytes().decode()}\n")
    return len(recs)


def make_families(path, rehearsal):
    """family_fasta's FASTA at path (12 families in the rehearsal, else
    FAMILIES), the family of each record in path + ".families.npy"."""
    families = []
    family_fasta(path, 12 if rehearsal else FAMILIES, families=families)
    np.save(path + ".families.npy", np.asarray(families, dtype=np.int64))


def linclust_cli(db_path, out_dir, extra, device, stats=None):
    from plass_tpu_torch.cli.plass import run
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "clu")
    rc = run(["linclust", db_path, out, os.path.join(out_dir, "tmp"),
              "--device", str(device), *extra], stats=stats)
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    return out


def db_bytes(prefix):
    """A DB's data, index and dbtype files, one after the other."""
    return b"".join(open(prefix + ext, "rb").read()
                    for ext in ("", ".index", ".dbtype"))


def seconds_text(seconds):
    return ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())


@contextlib.contextmanager
def recorded_align_calls():
    """Within the block, each call of protein_align._maybe_device_prefilter
    (the aligner's candidate pairs, before B9 scores them) is recorded in
    the yielded list: its DBs, hits, scoring parameters and pairs."""
    from plass_tpu_torch.ops import protein_align
    real = protein_align._maybe_device_prefilter
    spied = []

    def spy(*args):
        pdb, tdb, hits, _mat, bias_corr, gapo, gape, incl, same = args[:9]
        spied.append(dict(db=pdb, tdb=tdb, hits=hits,
                          comp_bias_corr=bias_corr, gap_open=gapo,
                          gap_extend=gape, include_identity=incl,
                          same_db=same, pairs=protein_align.candidate_pairs(
                              hits, incl, same)))
        return real(*args)

    protein_align._maybe_device_prefilter = spy
    try:
        yield spied
    finally:
        protein_align._maybe_device_prefilter = real


def phase_linclust_aa(device, work, fasta, rehearsal):
    """`plass linclust` through the CLI at each of LINCLUST_RUNS, on the
    device and with --device cpu: the cluster DBs byte for byte equal. The
    inputs are phase 4's contigs and family_fasta's proteins, each made
    into a DB with the port's createdb. The align stage's candidate pairs
    (the arguments of protein_align._maybe_device_prefilter) of each
    device run are recorded for phase sw-main. Returns (the launches of the
    device runs, summed, {input: the recorded call with the most
    candidate pairs}, and the path of family_fasta's FASTA)."""
    from plass_tpu_torch.data.createdb import create_db
    from plass_tpu_torch.ops import device_align

    paths = {}
    for name, src in (("contigs", fasta), ("families", None)):
        t0 = time.perf_counter()
        if src is None:
            src = os.path.join(work, "families.fasta")
            make_families(src, rehearsal)
        db, hdb = create_db([src])
        paths[name] = os.path.join(work, name + "_db", name)
        os.makedirs(os.path.dirname(paths[name]))
        db.save(paths[name])
        hdb.save(paths[name] + "_h")
        lens = db.seq_lens()
        what = (f"phase 4's {db.size} contigs" if name == "contigs" else
                f"{db.size} proteins of family_fasta")
        say(f"[linclust-aa] {what} made into a DB with createdb in "
            f"{time.perf_counter() - t0:.1f} s: {int(lens.sum())} residues, "
            f"median {int(np.median(lens))}, longest {int(lens.max())}")
    calls = {}
    total = {}
    for name, label, flags in LINCLUST_RUNS:
        tag = name + "".join(c for c in label if c.isalnum())
        stats, cpu_stats = {}, {}
        _reset_launches()
        _peak_reset(device)
        with recorded_align_calls() as spied:
            t0 = time.perf_counter()
            out = linclust_cli(paths[name], os.path.join(work, "lc_" + tag),
                               flags, device, stats)
            wall = time.perf_counter() - t0
        peak = _peak(device)
        launches = _launches()
        scored, blocked = device_align.PAIRS, device_align.BLOCK_PAIRS
        c = spied[-1]
        if len(c["pairs"]) >= len(calls.get(name, c)["pairs"]):
            calls[name] = c
        t0 = time.perf_counter()
        cpu_out = linclust_cli(paths[name], os.path.join(work, "lccpu_" + tag),
                               flags, "cpu", cpu_stats)
        cpu_wall = time.perf_counter() - t0
        data = db_bytes(out)
        if data != db_bytes(cpu_out):
            raise AssertionError(f"linclust-aa {name} {label}: the cluster DB "
                                 f"differs from the run with --device cpu")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        say(f"[linclust-aa] {name} {label}: {stats['clusters']} clusters of "
            f"{stats['sequences']} sequences in {wall:.1f} s (--device cpu "
            f"{cpu_wall:.1f} s), cluster DB sha256 "
            f"{hashlib.sha256(data).hexdigest()}, byte-identical to the run "
            f"with --device cpu")
        say(f"[linclust-aa] {name} {label}: seconds per stage: "
            f"{seconds_text(stats['seconds'])}; with --device cpu: "
            f"{seconds_text(cpu_stats['seconds'])}")
        say(f"[linclust-aa] {name} {label}: {len(c['db'].keys)} "
            f"representatives, {len(c['pairs'])} candidate pairs in the align "
            f"stage, {scored} scored by B9 in {launches['sw_score']} "
            f"launches ({blocked} on the block path); peak device memory "
            f"{peak / 2**30:.2f} GiB")
        if device.type == "cuda" and name == "families" \
                and not launches["sw_score"]:
            raise AssertionError("linclust-aa: B9 never launched on the "
                                 "families (under 512 candidate pairs)")
    if device.type == "cuda" and not total["sw_score"]:
        raise AssertionError("linclust-aa: B9 never launched through the CLI")
    return total, calls, os.path.join(work, "families.fasta")


# ---------------------------------------------------------------------------
# the sensitive prefilter: `plass search`, `plass cluster` and the easy-*
# forms on family_fasta's proteins

# search-aa's queries: every SEARCH_EVERY-th record of the families' DB
SEARCH_EVERY = 15
# easy-aa's input: the first EASY_RECORDS records of family_fasta's FASTA
EASY_RECORDS = 100
CLUSTER_FLAGS = ("--min-seq-id", "0.9", "-c", "0.9")   # the paper's


def plass_cli(args, device, stats=None):
    """`plass <args> --device <device>`; raises unless it exits 0."""
    from plass_tpu_torch.cli.plass import run
    rc = run([*args, "--device", str(device)], stats=stats)
    if rc != 0:
        raise AssertionError(f"plass {args[0]}: CLI exit code {rc}")


def pairs_text(stats):
    """The aligner's pair counts of a CLI run (align_protein's counts)."""
    c = stats.get("pairs", {})
    return (f"{c.get('candidate_pairs', 0)} candidate pairs, "
            f"{c.get('device_pairs', 0)} scored by B9, "
            f"{c.get('device_rejected', 0)} of them rejected by it")


def keyed_subdb(tpath, keys, out, device):
    """The records of the DB at tpath with these keys, as a DB at out
    (`plass createsubdb`)."""
    from plass_tpu_torch.data import seqdb
    subset = out + ".keys.txt"
    with open(subset, "w") as fh:
        fh.writelines(f"{k}\n" for k in keys)
    plass_cli(["createsubdb", subset, tpath, out], device)
    return seqdb.SeqDB.open(out)


def subset_db(tpath, every, out, device):
    """Every `every`-th record of the DB at tpath, by key, as a DB at out."""
    from plass_tpu_torch.data import seqdb
    keys = np.sort(seqdb.SeqDB.open(tpath).keys)[::every]
    return keyed_subdb(tpath, keys, out, device)


def search_dbs(work, fasta, device):
    """search-aa's DBs: family_fasta's proteins made into the target DB
    with `plass createdb`, every SEARCH_EVERY-th record of it the queries.
    Returns their paths."""
    from plass_tpu_torch.data import seqdb
    d = os.path.join(work, "search_aa")
    os.makedirs(d)
    tpath, qpath = os.path.join(d, "famDB"), os.path.join(d, "qDB")
    t0 = time.perf_counter()
    plass_cli(["createdb", fasta, tpath], device)
    qdb = subset_db(tpath, SEARCH_EVERY, qpath, device)
    tdb = seqdb.SeqDB.open(tpath)
    say(f"[search-aa] target DB of {tdb.size} proteins "
        f"({int(tdb.seq_lens().sum())} residues) with `plass createdb`, "
        f"{qdb.size} queries (every {SEARCH_EVERY}th) with `plass "
        f"createsubdb`, in {time.perf_counter() - t0:.1f} s")
    return tpath, qpath


def phase_search_aa(device, tpath, qpath):
    """`plass search` through the CLI: search_dbs's queries (qpath)
    against its target DB (tpath), default parameters (-s 5.7, --max-seqs
    300), on the device; then the same align stage with --device cpu on
    the same prefilter DB (the tmp dir's prefilter step is reused, the
    align step's sentinel removed): the alignment DBs byte for byte equal.
    Returns (the device run's launches, its recorded align call)."""
    from plass_tpu_torch.data import seqdb
    d = os.path.dirname(tpath)
    tdb, qdb = seqdb.SeqDB.open(tpath), seqdb.SeqDB.open(qpath)
    aln, cpu_aln = os.path.join(d, "aln"), os.path.join(d, "aln_cpu")
    tmp = os.path.join(d, "tmp")
    stats, cpu_stats = {}, {}
    _reset_launches()
    _peak_reset(device)
    with recorded_align_calls() as spied:
        t0 = time.perf_counter()
        plass_cli(["search", qpath, tpath, aln, tmp], device, stats)
        wall = time.perf_counter() - t0
    peak = _peak(device)
    launches = _launches()
    os.unlink(os.path.join(tmp, "latest", "aln_0.done"))
    t0 = time.perf_counter()
    plass_cli(["search", qpath, tpath, cpu_aln, tmp], "cpu", cpu_stats)
    cpu_wall = time.perf_counter() - t0
    data = db_bytes(aln)
    if data != db_bytes(cpu_aln):
        raise AssertionError("search-aa: the alignment DB differs from the "
                             "align stage with --device cpu")
    say(f"[search-aa] {qdb.size} queries against {tdb.size} targets in "
        f"{wall:.1f} s; alignment DB sha256 "
        f"{hashlib.sha256(data).hexdigest()}, byte-identical to the align "
        f"stage with --device cpu ({cpu_wall:.1f} s, the prefilter reused)")
    say(f"[search-aa] seconds per stage: {seconds_text(stats['seconds'])}; "
        f"with --device cpu: {seconds_text(cpu_stats['seconds'])}")
    say(f"[search-aa] {pairs_text(stats)}; B9 launches "
        f"{launches['sw_score']}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if device.type == "cuda" and not launches["sw_score"]:
        raise AssertionError("search-aa: B9 never launched through the CLI")
    return launches, spied[-1]


def phase_cluster_aa(device, work, famdb):
    """`plass cluster` through the CLI on the families' DB at
    CLUSTER_FLAGS, on the device and with --device cpu: the cluster DBs
    byte for byte equal. Returns the device run's launches."""
    from plass_tpu_torch.data import seqdb
    d = os.path.join(work, "cluster_aa")
    stats, cpu_stats = {}, {}
    _reset_launches()
    _peak_reset(device)
    t0 = time.perf_counter()
    plass_cli(["cluster", famdb, os.path.join(d, "clu"),
               os.path.join(d, "tmp"), *CLUSTER_FLAGS], device, stats)
    wall = time.perf_counter() - t0
    peak = _peak(device)
    launches = _launches()
    t0 = time.perf_counter()
    plass_cli(["cluster", famdb, os.path.join(d, "clu_cpu"),
               os.path.join(d, "tmp_cpu"), *CLUSTER_FLAGS], "cpu", cpu_stats)
    cpu_wall = time.perf_counter() - t0
    data = db_bytes(os.path.join(d, "clu"))
    if data != db_bytes(os.path.join(d, "clu_cpu")):
        raise AssertionError("cluster-aa: the cluster DB differs from the "
                             "run with --device cpu")
    n_clu = seqdb.SeqDB.open(os.path.join(d, "clu")).size
    say(f"[cluster-aa] `plass cluster {' '.join(CLUSTER_FLAGS)}`: {n_clu} "
        f"clusters of {seqdb.SeqDB.open(famdb).size} proteins in "
        f"{wall:.1f} s (--device cpu {cpu_wall:.1f} s); cluster DB sha256 "
        f"{hashlib.sha256(data).hexdigest()}, byte-identical to the run "
        f"with --device cpu")
    say(f"[cluster-aa] seconds per stage and step: "
        f"{seconds_text(stats['seconds'])}; with --device cpu: "
        f"{seconds_text(cpu_stats['seconds'])}")
    say(f"[cluster-aa] {pairs_text(stats)}; B9 launches "
        f"{launches['sw_score']}; peak device memory {peak / 2**30:.2f} GiB")
    if device.type == "cuda" and not launches["sw_score"]:
        raise AssertionError("cluster-aa: B9 never launched through the CLI")
    return launches


# profile-aa: run 1 is search-aa's search with --num-iterations
# PROFILE_ITERATIONS; run 2 searches every PROFILE_QUERY_EVERY-th record of
# the families' DB against run 1's profiles
PROFILE_ITERATIONS = 2
PROFILE_QUERY_EVERY = 5
# the sha256 of run 1's and run 2's alignment DBs (data, index and dbtype
# files) at full size, from `python3 chip_smoke.py --cpu-reference profile`
PROFILE_SHA256 = {
    "iterative":
        "dda3350f9a8f75e868cfed15e9a99c94e4ac9efcaf0d9ec842f9f5a161c306df",
    "target-profiles":
        "72ac0008704d6057ab7a88e7db2fe07859eb81de920ee2745e0dba78d2f5458f"}


@contextlib.contextmanager
def recorded_align_launches():
    """Within the block, each call of protein_align.align_protein appends
    (whether its query DB holds profiles, B9's launches during the call)
    to the yielded list."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import device_align, protein_align
    real = protein_align.align_protein
    calls = []

    def spy(db, *args, **kw):
        before = device_align.LAUNCHES
        out = real(db, *args, **kw)
        calls.append((db.dbtype == seqdb.HMM_PROFILE,
                      device_align.LAUNCHES - before))
        return out

    protein_align.align_protein = spy
    try:
        yield calls
    finally:
        protein_align.align_protein = real


# profile-aa ("profile-aa"), and linsearch-aa, rbh-aa, multihit-nt and
# taxonomy-aa ("slice"), run in processes of their own beside phases 17-20
# (their stages are host code but for B9's launches), as does protein x400
# at --rescore-mode 2 ("align-scale", whose extender is host Python), the
# sharded phase ("sharded") beside phase 10; each process prints its phases' lines,
# which start with its SIDE_TAGS, and its result (its launches; the
# slice's also B9's measurements) on a line that starts with
# side_result(name)
SIDE_TAGS = {"profile-aa": ("[profile-aa]",),
             "slice": ("[linsearch-aa]", "[rbh-aa]", "[multihit-nt]",
                       "[taxonomy-aa]", "[db-tools]", "[sw-side]"),
             "sharded": ("[sharded]",), "align-scale": ("[align-scale]",)}
PROFILE_TIMEOUT = 1000
SLICE_TIMEOUT = 900


def side_result(name):
    return f"[{name}] result "


def start_side(name, work, famdb, arg, rehearsal):
    """`chip_smoke.py --side-phase name work famdb arg` in a process of
    its own, its output to a file in work. Returns (name, the process, the
    file's path)."""
    log = os.path.join(work, name + ".log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side-phase", name,
             work, famdb, arg, *(["--cpu-rehearsal"] if rehearsal else [])],
            stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT)
    return name, proc, log


def stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finish_side(name, proc, log, timeout):
    """Wait for start_side's process; print its phases' lines and return
    the result it printed. Fails unless it exits 0."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        stop(proc)
    lines = open(log).read().splitlines()
    result = None
    for line in lines:
        if line.startswith(side_result(name)):
            result = json.loads(line[len(side_result(name)):])
        elif line.startswith(SIDE_TAGS[name]):
            say(line)
    if rc != 0 or result is None:
        print("\n".join(lines[-40:]), file=sys.stderr)
        raise AssertionError(f"{name}: its process exited with {rc}")
    return result


def _step_pairs_text(pairs, step):
    c, n, r = (pairs.get(f"{k}_{step}", 0) for k in (
        "candidate_pairs", "device_pairs", "device_rejected"))
    share = f" ({100 * r / n:.1f}%)" if n else ""
    return (f"step {step}: {c} candidate pairs, {n} scored by B9, {r} of "
            f"them rejected by it{share}")


def phase_profile_aa(device, work, famdb, qdb, check_sha=False):
    """Run 1: `plass search --num-iterations PROFILE_ITERATIONS` through
    the CLI at the defaults (search-aa's queries and targets), on the
    device: step 0 scores its sequence queries' candidate pairs with B9,
    step 1 aligns the profiles on the host; step 0's align stage again with
    --device cpu on the same prefilter DB, byte for byte equal. Run 2:
    `plass result2profile` of run 1's alignments (a profile per query),
    then `plass search` of every PROFILE_QUERY_EVERY-th family protein
    against those profiles at the defaults. Prints each stage's seconds,
    the pairs, B9's launches per step, peak device memory and the sha256
    of both alignment DBs; with check_sha, the sha256 must be
    PROFILE_SHA256's. Returns run 1's launches."""
    from plass_tpu_torch.data import seqdb
    d = os.path.join(work, "profile_aa")
    os.makedirs(d)
    out1, tmp1 = os.path.join(d, "aln_iterative"), os.path.join(d, "tmp1")
    stats = {}
    _reset_launches()
    _peak_reset(device)
    with recorded_align_launches() as calls:
        t0 = time.perf_counter()
        plass_cli(["search", qdb, famdb, out1, tmp1, "--num-iterations",
                   str(PROFILE_ITERATIONS)], device, stats)
        wall = time.perf_counter() - t0
    peak = _peak(device)
    launches = _launches()
    aln0, cpu0 = os.path.join(tmp1, "aln_0"), os.path.join(d, "aln_0_cpu")
    t0 = time.perf_counter()
    # step 0's align stage (cli/tools.py::_search_iterative) with the CPU
    plass_cli(["align", qdb, famdb, os.path.join(tmp1, "pref_0"), cpu0,
               "-e", "0.001", "-a", "--alignment-mode", "2", "--realign"],
              "cpu")
    cpu_wall = time.perf_counter() - t0
    if db_bytes(cpu0) != db_bytes(aln0):
        raise AssertionError("profile-aa: step 0's alignment DB differs "
                             "from its align stage with --device cpu")
    digests = {"iterative": hashlib.sha256(db_bytes(out1)).hexdigest()}
    n_q, n_t = seqdb.SeqDB.open(qdb).size, seqdb.SeqDB.open(famdb).size
    say(f"[profile-aa] run 1: `plass search --num-iterations "
        f"{PROFILE_ITERATIONS}`, {n_q} queries against {n_t} proteins in "
        f"{wall:.1f} s; alignment DB sha256 {digests['iterative']}; step "
        f"0's align stage byte-identical with --device cpu ({cpu_wall:.1f} "
        f"s)")
    say(f"[profile-aa] run 1 seconds per stage and step: "
        f"{seconds_text(stats['seconds'])}")
    step_launches = [n for _, n in calls]
    say(f"[profile-aa] run 1 " + "; ".join(
        _step_pairs_text(stats["pairs"], step)
        for step in range(PROFILE_ITERATIONS)) + f"; B9 launches by step "
        f"{step_launches}; peak device memory {peak / 2**30:.2f} GiB")
    if [prof for prof, _ in calls] != [False] + [True] * (
            PROFILE_ITERATIONS - 1):
        raise AssertionError(f"profile-aa: the align calls' query types "
                             f"are not one of sequences, then profiles: "
                             f"{calls}")
    if any(step_launches[1:]):
        raise AssertionError(f"profile-aa: B9 launched on a profile step: "
                             f"{step_launches}")
    if device.type == "cuda" and not step_launches[0]:
        raise AssertionError("profile-aa: B9 never launched on step 0")

    prof = os.path.join(d, "profDB")
    t0 = time.perf_counter()
    plass_cli(["result2profile", qdb, famdb, out1, prof], device)
    r2p = time.perf_counter() - t0
    q5path = os.path.join(d, "q5DB")
    q5 = subset_db(famdb, PROFILE_QUERY_EVERY, q5path, device)
    out2, stats2 = os.path.join(d, "aln_targetprofile"), {}
    _reset_launches()
    _peak_reset(device)
    t0 = time.perf_counter()
    plass_cli(["search", q5path, prof, out2, os.path.join(d, "tmp2")],
              device, stats2)
    wall2 = time.perf_counter() - t0
    peak2 = _peak(device)
    launches2 = _launches()
    digests["target-profiles"] = hashlib.sha256(db_bytes(out2)).hexdigest()
    c = stats2["pairs"]
    say(f"[profile-aa] run 2: `plass result2profile` of run 1 "
        f"({seqdb.SeqDB.open(prof).size} profiles) in {r2p:.1f} s, then "
        f"`plass search` of {q5.size} proteins (every "
        f"{PROFILE_QUERY_EVERY}th) against them in {wall2:.1f} s; "
        f"alignment DB sha256 {digests['target-profiles']}")
    say(f"[profile-aa] run 2 seconds per stage: "
        f"{seconds_text(stats2['seconds'])}; {c.get('candidate_pairs', 0)} "
        f"candidate pairs (profile queries, on the host), B9 launches "
        f"{launches2['sw_score']}; peak device memory "
        f"{peak2 / 2**30:.2f} GiB")
    if check_sha:
        for name, want in PROFILE_SHA256.items():
            if digests[name] != want:
                raise AssertionError(f"profile-aa: {name} sha256 "
                                     f"{digests[name]}, the CPU's is {want}")
        say("[profile-aa] both sha256 equal those of --cpu-reference profile")
    return launches


# easy-taxonomy's outputs, after its <o:out> prefix
TAX_OUTPUTS = ("_lca.tsv", "_report", "_tophit_report", "_tophit_aln")


def phase_easy_aa(device, work, fasta):
    """`plass easy-search` (the records against themselves) and `plass
    easy-cluster` on the first EASY_RECORDS records of family_fasta's
    FASTA; `plass easy-rbh` and `plass easy-linsearch` of its records f1,
    f3, ... against f0, f2, ... up to f{EASY_RECORDS - 1}, by name (whole
    families, whose members are numbered one after the other, so each
    side has relatives on the other; a linsearch of records against
    themselves writes nothing: each query passes the ungapped filter on
    itself, which then drops all its pairs), and `plass easy-taxonomy` of
    the same records against a taxonomy DB of f0, f2, ... (tax_db). Each
    on the device and with --device cpu: the BLAST-tab files, the cluster
    TSV and FASTA files and easy-taxonomy's four files byte for byte
    equal. Returns the device runs' launches, summed."""
    d = os.path.join(work, "easy_aa")
    os.makedirs(d)
    src = os.path.join(d, "input.fasta")
    halves = [os.path.join(d, f"input{i}.fasta") for i in (0, 1)]
    with open(fasta) as fh:
        lines = fh.readlines()
    with open(src, "w") as out:
        out.writelines(lines[:2 * EASY_RECORDS])
    for i, half in enumerate(halves):
        with open(half, "w") as out:
            out.writelines(h + s for h, s in zip(lines[::2], lines[1::2])
                           if int(h[2:]) < EASY_RECORDS
                           and int(h[2:]) % 2 == i)
    names = ("m8", "_cluster.tsv", "_rep_seq.fasta", "_all_seqs.fasta",
             "rbh.m8", "linsearch.m8", *TAX_OUTPUTS)
    taxdb = os.path.join(d, "tax", "taxDB")
    tax_db(os.path.dirname(taxdb), fasta, halves[0], taxdb, "cpu")
    total, outputs = {}, {}
    for tag, dev in (("dev", device), ("cpu", "cpu")):
        stats = {}
        _reset_launches()
        t0 = time.perf_counter()
        m8, prefix = os.path.join(d, tag + ".m8"), os.path.join(d, tag)
        plass_cli(["easy-search", src, src, m8, os.path.join(d, tag + "_st")],
                  dev, stats)
        plass_cli(["easy-cluster", src, prefix, os.path.join(d, tag + "_ct")],
                  dev, stats)
        wall = time.perf_counter() - t0
        rbh_stats = {}
        t0 = time.perf_counter()
        plass_cli(["easy-rbh", halves[1], halves[0], prefix + "rbh.m8",
                   os.path.join(d, tag + "_rt")], dev, rbh_stats)
        plass_cli(["easy-linsearch", halves[1], halves[0],
                   prefix + "linsearch.m8", os.path.join(d, tag + "_lt")],
                  dev, rbh_stats)
        rbh_wall = time.perf_counter() - t0
        tax_stats = {}
        t0 = time.perf_counter()
        plass_cli(["easy-taxonomy", halves[1], taxdb, prefix + "tax",
                   os.path.join(d, tag + "_xt")], dev, tax_stats)
        tax_wall = time.perf_counter() - t0
        if tag == "dev":
            total = _launches()
        outputs[tag] = [open(p, "rb").read() for p in (
            m8, prefix + "_cluster.tsv", prefix + "_rep_seq.fasta",
            prefix + "_all_seqs.fasta", prefix + "rbh.m8",
            prefix + "linsearch.m8",
            *(prefix + "tax" + n for n in TAX_OUTPUTS))]
        say(f"[easy-aa] {tag}: easy-search and easy-cluster on "
            f"{EASY_RECORDS} records in {wall:.1f} s; {pairs_text(stats)}")
        c = rbh_stats["pairs"]
        say(f"[easy-aa] {tag}: easy-rbh and easy-linsearch of records "
            f"f1, f3, ... against f0, f2, ... to f{EASY_RECORDS - 1} in "
            f"{rbh_wall:.1f} s; easy-rbh's searches "
            f"{c.get('candidate_pairs_AB', 0)} and "
            f"{c.get('candidate_pairs_BA', 0)} candidate pairs, "
            f"easy-linsearch's align {c.get('candidate_pairs', 0)}")
        say(f"[easy-aa] {tag}: easy-taxonomy of records f1, f3, ... against "
            f"the taxonomy DB of f0, f2, ... to f{EASY_RECORDS - 1} in "
            f"{tax_wall:.1f} s; {pairs_text(tax_stats)}")
    for name, a, b in zip(names, outputs["dev"], outputs["cpu"]):
        if a != b:
            raise AssertionError(f"easy-aa: {name} differs from the run "
                                 f"with --device cpu")
    digests = ", ".join(f"{n} {len(a)} bytes sha256 "
                        f"{hashlib.sha256(a).hexdigest()[:16]}"
                        for n, a in zip(names, outputs["dev"]))
    say(f"[easy-aa] {digests}: byte-identical to the runs with --device "
        f"cpu; B9 launches {total['sw_score']}")
    return total


# ---------------------------------------------------------------------------
# linsearch, rbh and the multi-hit search ("slice", a process of its own)

# rbh-aa: family_fasta's records f0 to f{RBH_RECORDS - 1}, by name (about
# 300 whole families: their members are numbered one after the other),
# even numbers to A and odd to B
RBH_RECORDS = 1200
# multihit-nt: phase 10's coding genomes as MULTIHIT_SETS target FASTA
# files; every MULTIHIT_EVERY-th genome with MULTIHIT_SUB substitutions
# as the query sets, MULTIHIT_QUERY_FILES files
MULTIHIT_SETS = 8
MULTIHIT_EVERY = 13
MULTIHIT_SUB = 0.01
MULTIHIT_QUERY_FILES = 2


def db_lines(path):
    """Result lines of a DB."""
    return open(path, "rb").read().count(b"\n")


def need_launches(device, name, launches, what):
    if device.type == "cuda" and not launches:
        raise AssertionError(f"{name}: B9 never launched on {what}")


def phase_linsearch_aa(device, work, famdb):
    """`plass createlinindex` and `plass linsearch` through the CLI, on the
    device: the odd-numbered keys of the families' DB (phase 14's
    proteins) against the even-numbered, both made with `plass
    createsubdb`; then linsearch's align stage again with --device cpu on
    the same filtered prefilter DB: the alignment DBs byte for byte equal.
    Returns the device run's launches."""
    from plass_tpu_torch.data import seqdb
    d = os.path.join(work, "linsearch_aa")
    os.makedirs(d)
    keys = np.sort(seqdb.SeqDB.open(famdb).keys)
    tpath, qpath = os.path.join(d, "tDB"), os.path.join(d, "qDB")
    tdb = keyed_subdb(famdb, keys[::2], tpath, device)
    qdb = keyed_subdb(famdb, keys[1::2], qpath, device)
    tmp, aln = os.path.join(d, "tmp"), os.path.join(d, "aln")
    stats = {}
    _reset_launches()
    _peak_reset(device)
    t0 = time.perf_counter()
    plass_cli(["createlinindex", tpath, os.path.join(d, "itmp")], device)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plass_cli(["linsearch", qpath, tpath, aln, tmp], device, stats)
    wall = time.perf_counter() - t0
    peak = _peak(device)
    launches = _launches()
    cpu_aln = os.path.join(d, "reverse_aln_cpu")
    t0 = time.perf_counter()
    # the align step of cli/tools_linsearch.py::_linsearch, on the CPU
    plass_cli(["align", tpath + ".linidx", qpath,
               os.path.join(tmp, "pref_filter"), cpu_aln, "-e", "100000",
               "-a", "--min-seq-id", "0.0", "--min-aln-len", "0"], "cpu")
    cpu_wall = time.perf_counter() - t0
    data = db_bytes(os.path.join(tmp, "reverse_aln"))
    if data != db_bytes(cpu_aln):
        raise AssertionError("linsearch-aa: the align stage's alignment DB "
                             "differs from the one with --device cpu")
    c = stats["pairs"]
    say(f"[linsearch-aa] {qdb.size} queries (odd keys) against {tdb.size} "
        f"targets (even keys): index in {index_s:.1f} s, linsearch in "
        f"{wall:.1f} s; alignment DB sha256 "
        f"{hashlib.sha256(db_bytes(aln)).hexdigest()}; the align stage "
        f"byte-identical with --device cpu ({cpu_wall:.1f} s)")
    say(f"[linsearch-aa] seconds per stage: {seconds_text(stats['seconds'])}")
    say(f"[linsearch-aa] {db_lines(os.path.join(tmp, 'pref'))} candidate "
        f"pairs, {db_lines(os.path.join(tmp, 'reverse_ungapaln'))} pass the "
        f"ungapped filter, {c.get('candidate_pairs', 0)} reach align "
        f"({c.get('device_pairs', 0)} scored by B9, "
        f"{c.get('device_rejected', 0)} of them rejected by it), "
        f"{db_lines(aln)} alignments; B9 launches {launches['sw_score']}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    need_launches(device, "linsearch-aa", launches["sw_score"],
                  "linsearch's align stage")
    return launches


def phase_rbh_aa(device, work, fasta, rehearsal):
    """`plass rbh A B` through the CLI on the device and with --device cpu:
    family_fasta's records f0 to f{RBH_RECORDS - 1}, even numbers in A and
    odd in B (each made with `plass createdb`). The result DBs byte for
    byte equal; each search (A against B, B against A) needs at least
    DEVICE_PREFILTER_PAIRS candidate pairs, so that B9 scores them on a
    card. Returns the device run's launches."""
    from plass_tpu_torch.ops.protein_align import DEVICE_PREFILTER_PAIRS
    d = os.path.join(work, "rbh_aa")
    os.makedirs(d)
    lines = open(fasta).read().splitlines()
    sides = {"A": [], "B": []}
    for head, seq in zip(lines[::2], lines[1::2]):
        i = int(head[2:])
        if i < RBH_RECORDS:
            sides["AB"[i % 2]].append(f"{head}\n{seq}\n")
    for side, recs in sides.items():
        with open(os.path.join(d, side + ".fasta"), "w") as fh:
            fh.writelines(recs)
        plass_cli(["createdb", os.path.join(d, side + ".fasta"),
                   os.path.join(d, side)], device)
    a, b = os.path.join(d, "A"), os.path.join(d, "B")
    out, cpu_out = os.path.join(d, "res"), os.path.join(d, "res_cpu")
    stats, cpu_stats = {}, {}
    _reset_launches()
    _peak_reset(device)
    with recorded_align_launches() as calls:
        t0 = time.perf_counter()
        plass_cli(["rbh", a, b, out, os.path.join(d, "tmp")], device, stats)
        wall = time.perf_counter() - t0
    peak = _peak(device)
    launches = _launches()
    t0 = time.perf_counter()
    plass_cli(["rbh", a, b, cpu_out, os.path.join(d, "tmp_cpu")], "cpu",
              cpu_stats)
    cpu_wall = time.perf_counter() - t0
    data = db_bytes(out)
    if data != db_bytes(cpu_out):
        raise AssertionError("rbh-aa: the result DB differs from the run "
                             "with --device cpu")
    say(f"[rbh-aa] {len(sides['A'])} records in A, {len(sides['B'])} in B: "
        f"{db_lines(out)} reciprocal best hits in {wall:.1f} s "
        f"(--device cpu {cpu_wall:.1f} s); result DB sha256 "
        f"{hashlib.sha256(data).hexdigest()}, byte-identical to the run "
        f"with --device cpu")
    say(f"[rbh-aa] seconds per stage: {seconds_text(stats['seconds'])}; "
        f"with --device cpu: {seconds_text(cpu_stats['seconds'])}")
    c = stats["pairs"]
    say(f"[rbh-aa] " + "; ".join(
        f"{tag}: {c.get('candidate_pairs_' + tag, 0)} candidate pairs, "
        f"{c.get('device_pairs_' + tag, 0)} scored by B9, "
        f"{c.get('device_rejected_' + tag, 0)} of them rejected by it"
        for tag in ("AB", "BA")) + f"; B9 launches by search "
        f"{[n for _, n in calls]}; peak device memory {peak / 2**30:.2f} GiB")
    for tag in ("AB", "BA"):
        if not rehearsal and c.get("candidate_pairs_" + tag, 0) \
                < DEVICE_PREFILTER_PAIRS:
            raise AssertionError(f"rbh-aa: the {tag} search has fewer than "
                                 f"{DEVICE_PREFILTER_PAIRS} candidate pairs; "
                                 f"take more families")
    if device.type == "cuda" and not all(n for _, n in calls):
        raise AssertionError(f"rbh-aa: B9 did not launch in each search: "
                             f"{calls}")
    return launches


def phase_multihit_nt(device, work, rehearsal):
    """`plass multihitdb` of phase 10's coding genomes, MULTIHIT_SETS
    FASTA files of the same number of genomes (the target sets), and of
    every MULTIHIT_EVERY-th genome with MULTIHIT_SUB seeded substitutions
    in MULTIHIT_QUERY_FILES files (the query sets); `plass multihitsearch`
    through the CLI on the device and with --device cpu: the output DBs
    byte for byte equal. The search needs at least DEVICE_PREFILTER_PAIRS
    candidate pairs, so that B9 scores them on a card. Returns the device
    run's launches."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops.protein_align import DEVICE_PREFILTER_PAIRS
    d = os.path.join(work, "multihit_nt")
    os.makedirs(d)
    n_genomes, genome_len = (16, 2000) if rehearsal else GUIDED_GENOMES
    rng = np.random.default_rng(19)
    genomes = coding_genomes(rng, n_genomes, genome_len)
    queries = genomes[::MULTIHIT_EVERY].copy()
    mut = rng.random(queries.shape) < MULTIHIT_SUB
    queries[mut] = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, int(mut.sum()))]

    def write(prefix, rows, n_files):
        paths = []
        for f, part in enumerate(np.array_split(np.arange(len(rows)),
                                                n_files)):
            paths.append(os.path.join(d, f"{prefix}{f}.fasta"))
            with open(paths[-1], "wb") as fh:
                fh.writelines(b">%s%d_%d\n%s\n" % (prefix.encode(), f, i,
                                                     rows[i].tobytes())
                              for i in part)
        return paths
    tset, qset = os.path.join(d, "tset"), os.path.join(d, "qset")
    t0 = time.perf_counter()
    plass_cli(["multihitdb", *write("t", genomes, MULTIHIT_SETS), tset,
               os.path.join(d, "ttmp")], device)
    plass_cli(["multihitdb", *write("q", queries, MULTIHIT_QUERY_FILES),
               qset, os.path.join(d, "qtmp")], device)
    db_s = time.perf_counter() - t0
    out, cpu_out = os.path.join(d, "out"), os.path.join(d, "out_cpu")
    stats, cpu_stats = {}, {}
    _reset_launches()
    _peak_reset(device)
    t0 = time.perf_counter()
    plass_cli(["multihitsearch", qset, tset, out, os.path.join(d, "tmp")],
              device, stats)
    wall = time.perf_counter() - t0
    peak = _peak(device)
    launches = _launches()
    t0 = time.perf_counter()
    plass_cli(["multihitsearch", qset, tset, cpu_out,
               os.path.join(d, "tmp_cpu")], "cpu", cpu_stats)
    cpu_wall = time.perf_counter() - t0
    data = db_bytes(out)
    if data != db_bytes(cpu_out):
        raise AssertionError("multihit-nt: the output DB differs from the "
                             "run with --device cpu")
    n_t, n_q = seqdb.SeqDB.open(tset).size, seqdb.SeqDB.open(qset).size
    say(f"[multihit-nt] {n_genomes} coding genomes of {genome_len} nt in "
        f"{MULTIHIT_SETS} target sets ({n_t} ORFs), {len(queries)} of them "
        f"with {MULTIHIT_SUB:.0%} substitutions in {MULTIHIT_QUERY_FILES} "
        f"query sets ({n_q} ORFs), set DBs in {db_s:.1f} s; multihitsearch "
        f"in {wall:.1f} s (--device cpu {cpu_wall:.1f} s); output sha256 "
        f"{hashlib.sha256(data).hexdigest()}, byte-identical to the run "
        f"with --device cpu")
    say(f"[multihit-nt] seconds per stage: {seconds_text(stats['seconds'])}; "
        f"with --device cpu: {seconds_text(cpu_stats['seconds'])}")
    say(f"[multihit-nt] {pairs_text(stats)}; B9 launches "
        f"{launches['sw_score']}; peak device memory {peak / 2**30:.2f} GiB")
    if not rehearsal and stats["pairs"].get("candidate_pairs", 0) \
            < DEVICE_PREFILTER_PAIRS:
        raise AssertionError(f"multihit-nt: fewer than "
                             f"{DEVICE_PREFILTER_PAIRS} candidate pairs; "
                             f"enlarge the query sets")
    need_launches(device, "multihit-nt", launches["sw_score"],
                  "multihitsearch's search")
    return launches


# ---------------------------------------------------------------------------
# taxonomy: `plass taxonomy` and `plass easy-taxonomy` against family_fasta's
# proteins labelled by a synthetic NCBI taxonomy (TAX_GENERA genera in
# TAX_FAMILIES families under Bacteria, TAX_SPECIES species a genus); a
# protein family's members are spread over its genus's species

TAX_FAMILIES = 10
TAX_GENERA = 150
TAX_SPECIES = 3
# taxonomy-aa's queries: every TAXONOMY_QUERY_EVERY-th record of the FASTA
TAXONOMY_QUERY_EVERY = 5
# the sha256 of the default run's and the --lca-mode 4 run's taxonomy DBs
# (data, index and dbtype files) at full size, from `python3 chip_smoke.py
# --cpu-reference taxonomy`
TAXONOMY_SHA256 = {
    "default":
        "8416b5640a0d86aa788b637fd95ee94b4770484311e2d43850fd0ed1f645d7a8",
    "lca-mode-4":
        "0c8a2a5cce1fa2072376928400a1d62272d111ad692aea44d2a4923503ef284d"}


def write_tax_dump(d):
    """The synthetic taxonomy's nodes.dmp, names.dmp, merged.dmp and
    delnodes.dmp in d, in the NCBI files' column layout (the way
    util/gen_goldens_tax.sh writes them)."""
    os.makedirs(d)
    nodes = [(1, 1, "no rank", "root"),
             (131567, 1, "no rank", "cellular organisms"),
             (2, 131567, "superkingdom", "Bacteria"),
             (12908, 1, "no rank", "unclassified sequences"),
             (28384, 1, "no rank", "other sequences")]
    nodes += [(200 + f, 2, "family", f"Family{f}")
              for f in range(TAX_FAMILIES)]
    for g in range(TAX_GENERA):
        nodes.append((1000 + g, 200 + g % TAX_FAMILIES, "genus", f"Genus{g}"))
        nodes += [(100000 + 10 * g + s, 1000 + g, "species",
                   f"Species{g}_{s}") for s in range(TAX_SPECIES)]
    with open(os.path.join(d, "nodes.dmp"), "w") as fh:
        fh.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\n"
                      for t, p, r, _ in nodes)
    with open(os.path.join(d, "names.dmp"), "w") as fh:
        fh.writelines(f"{t}\t|\t{name}\t|\t\t|\tscientific name\t|\n"
                      for t, _, _, name in nodes)
    with open(os.path.join(d, "merged.dmp"), "w") as fh:
        fh.write("99\t|\t100000\t|\n")
    with open(os.path.join(d, "delnodes.dmp"), "w") as fh:
        fh.write("98\t|\n")


def write_tax_mapping(path, fasta):
    """Each record's accession (its name, f<i>) and taxon: the species
    member % TAX_SPECIES of genus family % TAX_GENERA, where member is the
    record's place in its family (make_families's file)."""
    families = np.load(fasta + ".families.npy")
    first = {}
    with open(path, "w") as fh:
        for i, fam in enumerate(families.tolist()):
            member = i - first.setdefault(fam, i)
            taxon = (100000 + 10 * (fam % TAX_GENERA)
                     + member % TAX_SPECIES)
            fh.write(f"f{i}\t{taxon}\n")


def tax_db(d, fasta, target_fasta, out, device):
    """The target DB at out, `plass createdb` of target_fasta (records of
    family_fasta's FASTA `fasta`), with the synthetic taxonomy attached by
    `plass createtaxdb` (its dump and accession mapping written into d)."""
    dump, mapping = os.path.join(d, "dump"), os.path.join(d, "acc2tax.tsv")
    write_tax_dump(dump)
    write_tax_mapping(mapping, fasta)
    plass_cli(["createdb", target_fasta, out], device)
    plass_cli(["createtaxdb", out, os.path.join(d, "ctmp"),
               "--ncbi-tax-dump", dump, "--tax-mapping-file", mapping],
              device)


def rank_counts(path):
    """{rank: records} of a taxonomy result DB."""
    counts = {}
    for line in open(path, "rb").read().replace(b"\0", b"").splitlines():
        if line:
            rank = line.split(b"\t")[1].decode()
            counts[rank] = counts.get(rank, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def phase_taxonomy_aa(device, work, fasta, check_sha=False):
    """`plass createtaxdb` of family_fasta's records but every
    TAXONOMY_QUERY_EVERY-th (the targets, made with `plass createdb`) with
    the synthetic taxonomy, then `plass taxonomy` of the others through
    the CLI on the device: at the defaults (--lca-mode 3, the host's
    lcaalign) and at --lca-mode 4 (top hit, whose `search` B9 scores);
    the --lca-mode 4 run's align stage again with --device cpu on the same
    prefilter DB, byte for byte equal. Prints each run's seconds per
    stage, pairs, B9's launches, peak device memory, the ranks of its
    output and its sha256, which with check_sha must be
    TAXONOMY_SHA256's. Returns the device runs' launches, summed."""
    from plass_tpu_torch.data import seqdb
    d = os.path.join(work, "taxonomy_aa")
    os.makedirs(d)
    lines = open(fasta).read().splitlines()
    halves = {"q": os.path.join(d, "q.fasta"), "t": os.path.join(d, "t.fasta")}
    with open(halves["q"], "w") as q, open(halves["t"], "w") as t:
        for k, (head, seq) in enumerate(zip(lines[::2], lines[1::2])):
            (q if k % TAXONOMY_QUERY_EVERY == 0 else t).write(
                f"{head}\n{seq}\n")
    t0 = time.perf_counter()
    qpath, tpath = os.path.join(d, "qDB"), os.path.join(d, "tDB")
    plass_cli(["createdb", halves["q"], qpath], device)
    tax_db(d, fasta, halves["t"], tpath, device)
    n_q, n_t = seqdb.SeqDB.open(qpath).size, seqdb.SeqDB.open(tpath).size
    say(f"[taxonomy-aa] {n_q} queries (every {TAXONOMY_QUERY_EVERY}th record) "
        f"and {n_t} targets with `plass createdb`, the targets' taxonomy "
        f"({TAX_GENERA} genera in {TAX_FAMILIES} families, {TAX_SPECIES} "
        f"species a genus) with `plass createtaxdb`, in "
        f"{time.perf_counter() - t0:.1f} s")
    total, digests = {}, {}
    for name, extra in (("default", ()), ("lca-mode-4", ("--lca-mode", "4"))):
        out = os.path.join(d, "tax_" + name)
        tmp = os.path.join(d, "tmp_" + name)
        stats = {}
        _reset_launches()
        _peak_reset(device)
        t0 = time.perf_counter()
        plass_cli(["taxonomy", qpath, tpath, out, tmp, *extra], device, stats)
        wall = time.perf_counter() - t0
        peak = _peak(device)
        launches = _launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        digests[name] = hashlib.sha256(db_bytes(out)).hexdigest()
        command = " ".join(("plass taxonomy",) + extra)
        say(f"[taxonomy-aa] {name}: `{command}` in {wall:.1f} s; taxonomy "
            f"DB sha256 {digests[name]}; ranks {rank_counts(out)}")
        say(f"[taxonomy-aa] {name}: seconds per stage: "
            f"{seconds_text(stats['seconds'])}; {pairs_text(stats)}; B9 "
            f"launches {launches['sw_score']}; peak device memory "
            f"{peak / 2**30:.2f} GiB")
    # the --lca-mode 4 run's align stage (cli/tools.py::_taxonomy's
    # search, setTaxonomyDefaults) with the CPU, its prefilter reused
    hsp = os.path.join(d, "tmp_lca-mode-4", "tmp_hsp1")
    os.unlink(os.path.join(hsp, "latest", "aln_0.done"))
    cpu_aln, cpu_stats = os.path.join(d, "first_cpu"), {}
    t0 = time.perf_counter()
    plass_cli(["search", qpath, tpath, cpu_aln, hsp, "-s", "2", "-e", "1",
               "--max-accept", "30", "--max-rejected", "5",
               "--alignment-mode", "1"], "cpu", cpu_stats)
    cpu_wall = time.perf_counter() - t0
    if "prefilter" in cpu_stats["seconds"]:
        raise AssertionError("taxonomy-aa: the align stage with --device cpu "
                             "did not reuse the prefilter DB")
    if db_bytes(cpu_aln) != db_bytes(os.path.join(d, "tmp_lca-mode-4",
                                                  "first")):
        raise AssertionError("taxonomy-aa: --lca-mode 4's alignment DB "
                             "differs from its align stage with --device cpu")
    say(f"[taxonomy-aa] lca-mode-4: the align stage byte-identical with "
        f"--device cpu ({cpu_wall:.1f} s; {pairs_text(cpu_stats)})")
    if device.type == "cuda" and not total["sw_score"]:
        raise AssertionError("taxonomy-aa: B9 never launched at --lca-mode 4")
    if check_sha:
        for name, want in TAXONOMY_SHA256.items():
            if digests[name] != want:
                raise AssertionError(f"taxonomy-aa: {name} sha256 "
                                     f"{digests[name]}, the CPU's is {want}")
        say("[taxonomy-aa] both sha256 equal those of --cpu-reference "
            "taxonomy")
    return total


# ---------------------------------------------------------------------------
# db-tools: the thirty DB, misc, domain and `databases` tools of the CLIs,
# host code on every device as in the JAX package, each through the CLI at
# the default device and again with --device cpu

# alignall's input: the first DB_TOOLS_CLUSTERS clusters (by key) of phase
# 14's `plass linclust` of the families, a third of them (the cut keeps the
# phase short)
DB_TOOLS_CLUSTERS = 1600
# the `databases` entry built from its file placed in <tmpDir> beforehand
DB_TOOLS_ENTRY = ("UniProtKB/Swiss-Prot", "uniprot_sprot.fasta.gz")
# apply's program: each record's bases complemented
APPLY_PROGRAM = ("tr", "ACGT", "TGCA")


def tool_cli(binary, args, device):
    """`<binary> <args> --device <device>` in this process; returns the
    bytes of its standard output. Raises unless it exits 0."""
    from plass_tpu_torch.cli import penguin, plass
    run = plass.run if binary == "plass" else penguin.run
    buf = io.BytesIO()
    fh = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(fh):
        rc = run([*args, "--device", str(device)])
    fh.flush()
    if rc != 0:
        raise AssertionError(f"{binary} {args[0]}: CLI exit code {rc}")
    return buf.getvalue()


def tree_bytes(d):
    """{path under d: bytes} of every file under d."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, d)] = open(path, "rb").read()
    return out


def free_bytes(path):
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def db_tools_inputs(d, work, famdb, fasta, genomes, device):
    """The phase's inputs, made before its launch counters are set to 0:
    the coding genomes' DB (`plass createdb`) and two seeded GFFs of it;
    the families' `plass kmermatcher` prefilter, `plass align -a`
    alignments and `plass result2msa` MSAs, and a BLAST-tab DB with a
    length file made from the alignments; the first DB_TOOLS_CLUSTERS
    clusters of phase 14's families linclust (`plass createsubdb`); a tar
    of the families' FASTA in ten members, a TSV, UniProtKB text and a
    UniProt-headed gzip FASTA of the families. Returns their paths."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.data.createdb import read_lookup
    import tarfile
    p = {k: os.path.join(d, k) for k in (
        "genomes.fasta", "G", "gff", "gffkeys", "pref", "ALN", "MSA",
        "TAB", "lens", "CLU", "tar", "tsv", "kb", "sprot")}
    p["F"], p["LC"] = famdb, os.path.join(work, "families_db", "families")
    with open(p["genomes.fasta"], "wb") as fh:
        fh.writelines(b">g%d coding genome %d\n%s\n" % (i, i, g.tobytes())
                      for i, g in enumerate(genomes))
    plass_cli(["createdb", p["genomes.fasta"], p["G"]], device)
    rng = np.random.default_rng(29)
    n, glen = genomes.shape
    with open(p["gff"], "w") as gff, open(p["gffkeys"], "w") as keyed:
        gff.write("##gff-version 3\n")
        keyed.write("# masked regions\n")
        for g in range(n):
            for f in range(3):
                a = int(rng.integers(1, glen - 500))
                b = a + int(rng.integers(90, 450))
                kind = ("CDS", "gene")[f % 2]
                strand = "+-"[int(rng.integers(2))]
                gff.write(f"g{g}\tsim\t{kind}\t{a}\t{b}\t.\t{strand}\t0\t"
                          f"ID=g{g}_{f}\n")
                keyed.write(f"{g}\tsim\t{('CDS', 'repeat')[f % 2]}\t{a}\t"
                            f"{b}\t.\t+\t0\t.\n")
        gff.write("g0\tsim\tCDS\t40\t40\t.\t+\t0\tID=empty\n")
        keyed.write("1\tsim\tCDS\t30\t10\t.\t+\t0\t.\n")
    families = np.load(fasta + ".families.npy")
    name2key = {name: k for k, name, _ in read_lookup(famdb)}
    plass_cli(["kmermatcher", famdb, p["pref"]], device)
    plass_cli(["align", famdb, famdb, p["pref"], p["ALN"], "-a"], device)
    plass_cli(["result2msa", famdb, famdb, p["ALN"], p["MSA"]], device)
    aln, fdb = seqdb.SeqDB.open(p["ALN"]), seqdb.SeqDB.open(famdb)
    tabs = []
    for i in range(aln.size):
        lines = []
        for line in aln.get_data(i).tobytes().decode().splitlines():
            f = line.split("\t")
            if len(f) < 10:
                continue
            qs, qe, ts, te = (int(f[j]) + 1 for j in (4, 5, 7, 8))
            lines.append(f"{int(aln.keys[i])}\t{f[0]}\t{float(f[2]) * 100:.1f}"
                         f"\t{abs(qe - qs) + 1}\t0\t0\t{qs}\t{qe}\t{ts}\t{te}\t"
                         f"{f[3]}\t{f[1]}\n")
        tabs.append((int(aln.keys[i]), "".join(lines).encode()))
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for key, body in tabs:
        w.write(key, body, add_newline=False)
    w.finish().save(p["TAB"])
    with open(p["lens"], "w") as fh:
        fh.writelines(f"{int(k)}\t{fdb.seq_len(i)}\n"
                      for i, k in enumerate(fdb.keys))
    clu = os.path.join(work, "lc_familiesdefaults", "clu")
    keyed_subdb(clu, np.sort(seqdb.SeqDB.open(clu).keys)[:DB_TOOLS_CLUSTERS],
                p["CLU"], device)
    lines = open(fasta).read().splitlines()
    records = list(zip(lines[::2], lines[1::2]))
    with tarfile.open(p["tar"], "w") as tf:
        for c, part in enumerate(np.array_split(np.arange(len(records)), 10)):
            chunk = os.path.join(d, f"families_{c}.fasta")
            with open(chunk, "w") as fh:
                fh.writelines(f"{records[j][0]}\n{records[j][1]}\n"
                              for j in part)
            tf.add(chunk, arcname=f"families/part_{c}.fasta")
    # the gzip header's time set to 0, so that the file's bytes are the
    # same in every run
    with open(p["tsv"], "w") as tsv, open(p["kb"], "w") as kb, \
            gzip.GzipFile(p["sprot"], "wb", mtime=0) as gz, \
            io.TextIOWrapper(gz) as sprot:
        for j, (head, seq) in enumerate(records):
            i = int(head[2:])
            fam = int(families[i])
            tsv.write(f"{name2key[head[1:]]}\tfamily {fam}\t{len(seq)}\n")
            kb.write(f"ID   F{i}_SYNTH               Reviewed;   {len(seq)} "
                     f"AA.\nAC   Q{i:05d}; R{fam:05d};\nDE   RecName: "
                     f"Full=Family {fam} protein;\nGN   Name=fam{fam};\n"
                     f"OS   Synthetic organism {fam % 7}.\nOX   "
                     f"NCBI_TaxID={1000 + fam % 7};\nPE   {1 + i % 5}: "
                     f"Predicted;\nSQ   SEQUENCE   {len(seq)} AA;\n")
            kb.writelines("     " + " ".join(
                seq[k + c:k + c + 10] for c in range(0, 60, 10)
                if k + c < len(seq)) + "\n" for k in range(0, len(seq), 60))
            kb.write("//\n")
            sprot.write(f">{('tr', 'sp')[fam % 2]}|Q{i:05d}|F{i}_SYNTH "
                        f"Family {fam} protein{' fragment' * (i % 9 == 0)} "
                        f"OS=Synthetic organism {fam % 7} OX={1000 + fam % 7} "
                        f"GN=fam{fam} PE={1 + i % 5} SV=1\n{seq}\n")
    return p


def db_tools_runs(p, work):
    """(name, binary, argv with OUT and TMP for paths in the run's dir,
    setup of the run's dir or None) of each command, in the order run."""
    def entry_file(run_dir):
        os.makedirs(os.path.join(run_dir, "TMP"))
        shutil.copyfile(p["sprot"], os.path.join(run_dir, "TMP",
                                                  DB_TOOLS_ENTRY[1]))

    F, G, ALN = p["F"], p["G"], p["ALN"]
    keys = ",".join(str(k) for k in range(0, 300, 3))
    return [
        ("compress", "plass", ["compress", F, "OUT"], None),
        ("decompress", "plass", ["decompress", p["Fz"], "OUT"], None),
        ("dbtype", "plass", ["dbtype", F], None),
        ("view", "plass", ["view", F, "--id-list", keys], None),
        ("touchdb", "plass", ["touchdb", F], None),
        ("diskspaceavail", "plass", ["diskspaceavail", work], None),
        ("unpackdb", "plass", ["unpackdb", F, "OUT", "--unpack-suffix",
                               ".fasta"], None),
        ("splitdb", "plass", ["splitdb", F, "OUT", "--split", "3"], None),
        ("countkmer", "plass", ["countkmer", F], None),
        ("masksequence", "plass", ["masksequence", F, "OUT"], None),
        ("translateaa", "plass", ["translateaa", F, "OUT"], None),
        ("clusthash", "plass", ["clusthash", F, "OUT"], None),
        ("suffixid", "plass", ["suffixid", ALN, "OUT"], None),
        ("prefixid", "plass", ["prefixid", ALN, "OUT"], None),
        ("summarizeresult", "plass", ["summarizeresult", ALN, "OUT"], None),
        ("extractalignedregion", "plass", ["extractalignedregion", F, F,
                                           ALN, "OUT"], None),
        ("transitivealign", "plass", ["transitivealign", F, ALN, "OUT"],
         None),
        ("alignall", "plass", ["alignall", p["LC"], p["CLU"], "OUT"], None),
        ("summarizetabs", "plass", ["summarizetabs", p["TAB"], p["lens"],
                                    "OUT"], None),
        ("extractdomains", "plass", ["extractdomains", p["DOM"], p["MSA"],
                                     "OUT", "-e", "1000"], None),
        ("convertkb", "plass", ["convertkb", p["kb"], "OUT"], None),
        ("tar2db", "plass", ["tar2db", p["tar"], "OUT"], None),
        ("tsv2db", "plass", ["tsv2db", p["tsv"], "OUT"], None),
        ("databases", "plass", ["databases"], None),
        ("databases-entry", "plass", ["databases", DB_TOOLS_ENTRY[0], "OUT",
                                      "TMP"], entry_file),
        ("summarizeheaders", "plass", ["summarizeheaders", p["SP"] + "_h",
                                       p["SP"] + "_h", p["CLU"], "OUT"],
         None),
        ("countkmer-nucl", "plass", ["countkmer", G], None),
        ("masksequence-nucl", "plass", ["masksequence", G, "OUT"], None),
        ("clusthash-nucl", "plass", ["clusthash", G, "OUT"], None),
        ("reverseseq", "plass", ["reverseseq", G, "OUT"], None),
        ("extractframes", "penguin", ["extractframes", G, "OUT",
                                      "--forward-frames", "1",
                                      "--reverse-frames", "1"], None),
        ("gff2db", "plass", ["gff2db", p["gff"], G, "OUT"], None),
        ("maskbygff", "plass", ["maskbygff", p["gffkeys"], G, "OUT",
                                "--gff-type", "CDS"], None),
        ("apply", "plass", ["apply", G, "OUT", *APPLY_PROGRAM], None),
    ]


def db_tool_pair(d, name, binary, argv, setup, device, work):
    """A command through the CLI on the device and again with --device cpu,
    each in a dir of its own (OUT and TMP name paths there): the files
    they write and what they print must be equal byte for byte. For
    diskspaceavail, whose answer moves with the disk, the pair is run
    again until no byte of work's filesystem was taken or freed between
    the two runs (at most 20 times). Returns (seconds on the device, with
    --device cpu, the outputs' sha256, files, bytes)."""
    tries = 20 if name == "diskspaceavail" else 1
    for attempt in range(tries):
        runs = [(os.path.join(d, name, f"{tag}{attempt}"), dev)
                for tag, dev in (("card", device), ("cpu", "cpu"))]
        for run_dir, _ in runs:
            os.makedirs(run_dir)
            if setup is not None:
                setup(run_dir)
        free, outs, secs = [free_bytes(work)], [], []
        for run_dir, dev in runs:
            t0 = time.perf_counter()
            outs.append(tool_cli(binary, [
                os.path.join(run_dir, a) if a in ("OUT", "TMP") else a
                for a in argv], dev))
            secs.append(time.perf_counter() - t0)
            free.append(free_bytes(work))
        if tries == 1 or len(set(free)) == 1:
            break
    else:
        raise AssertionError(f"db-tools: {name}: the free space of {work} "
                             f"moved during each of 20 pairs of runs")
    got = [(out, tree_bytes(run_dir)) for out, (run_dir, _) in zip(outs, runs)]
    if got[0] != got[1]:
        raise AssertionError(f"db-tools: {name}: the outputs differ from "
                             f"the run with --device cpu")
    out, files = got[0]
    if not out and not files and name != "touchdb":
        raise AssertionError(f"db-tools: {name} wrote and printed nothing")
    h = hashlib.sha256(b"stdout\0" + out)
    for rel in sorted(files):
        h.update(b"\0" + rel.encode() + b"\0" + files[rel])
    return (secs[0], secs[1], h.hexdigest(), len(files),
            len(out) + sum(len(b) for b in files.values()))


def phase_db_tools(device, work, famdb, fasta, rehearsal):
    """The thirty DB, misc, domain and `databases` tools through the port's
    CLI (penguin's for extractframes), on the amino-acid inputs of phase
    14's family proteins and the nucleotide inputs of phase 10's coding
    genomes (db_tools_inputs), each at the default device and again with
    --device cpu: equal outputs byte for byte (db_tool_pair). The kernels'
    launch counters are set to 0 after the inputs are made and must still
    be 0 after the runs: these tools keep the card idle. `databases`
    builds its entry from a file placed in its <tmpDir>; any download
    raises instead."""
    import urllib.request
    # host work that fills the side process's wait for the main process:
    # at a lower priority, it takes no CPU from the main process's phases
    # or profile-aa's
    os.nice(10)
    d = os.path.join(work, "db_tools")
    os.makedirs(d)
    t0 = time.perf_counter()
    genomes = coding_genomes(np.random.default_rng(19), *(
        (16, 2000) if rehearsal else GUIDED_GENOMES))
    p = db_tools_inputs(d, work, famdb, fasta, genomes, device)
    inputs_s = time.perf_counter() - t0
    p["Fz"] = os.path.join(d, "compress", "card0", "OUT")
    p["DOM"] = os.path.join(d, "summarizetabs", "card0", "OUT")
    p["SP"] = os.path.join(d, "databases-entry", "card0", "OUT")

    def no_download(url, *args, **kw):
        raise AssertionError(f"db-tools: a download of {url} was attempted")

    real = urllib.request.urlretrieve
    urllib.request.urlretrieve = no_download
    _reset_launches()
    rows, runs = [], db_tools_runs(p, work)
    t0 = time.perf_counter()
    try:
        for name, binary, argv, setup in runs:
            rows.append((name, *db_tool_pair(d, name, binary, argv, setup,
                                             device, work)))
    finally:
        urllib.request.urlretrieve = real
    wall = time.perf_counter() - t0
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"db-tools: kernels launched: {launches}")
    from plass_tpu_torch.data import seqdb
    n_f, n_c = seqdb.SeqDB.open(famdb).size, seqdb.SeqDB.open(p["CLU"]).size
    say(f"[db-tools] {len(rows)} runs of {len({r[2][0] for r in runs})} "
        f"commands on {n_f} family proteins and {len(genomes)} coding genomes "
        f"of {genomes.shape[1]} nt, each on the card and with --device cpu, "
        f"byte for byte equal, in {wall:.1f} s (inputs in {inputs_s:.1f} s); "
        f"cut: alignall on the first {n_c} of the linclust's clusters; "
        f"transitivealign on `plass kmermatcher` + `plass align -a` of all "
        f"the proteins; kernel launches during the runs: "
        f"{sum(launches.values())}")
    for name, card_s, cpu_s, digest, n_files, n_bytes in rows:
        say(f"[db-tools] {name}: {card_s:.2f} s (--device cpu {cpu_s:.2f} "
            f"s), {n_files} files and {n_bytes} bytes out, sha256 {digest}")


# B9's measurements in the side process: on the largest align call of
# phases 22-25, timed once the main process has finished its own work on
# the card (it writes MAIN_IDLE into the work dir); the first
# SIDE_NATIVE_PAIRS of each also held against the native ssw
SIDE_NATIVE_PAIRS = 300
MAIN_IDLE = "main_idle"


def phase_slice(device, work, famdb, fasta, rehearsal):
    """linsearch-aa, rbh-aa, multihit-nt and taxonomy-aa, one after the
    other, each align call recorded, and db-tools; then, once the main
    process is idle,
    B9 on each phase's largest call against its plain version and the
    native ssw, timed beside its bound as in sw-main. Returns
    {"launches": {path: launches}, "sw": {path: measurements}}."""
    phases = (("linsearch", lambda: phase_linsearch_aa(device, work, famdb)),
              ("rbh", lambda: phase_rbh_aa(device, work, fasta, rehearsal)),
              ("multihit", lambda: phase_multihit_nt(device, work,
                                                     rehearsal)),
              ("taxonomy", lambda: phase_taxonomy_aa(
                  device, work, fasta, check_sha=not rehearsal)))
    launches, calls = {}, {}
    for name, run in phases:
        with recorded_align_calls() as spied:
            launches[name] = run()
        calls[name] = max(spied, key=lambda c: len(c["pairs"]))
    phase_db_tools(device, work, famdb, fasta, rehearsal)
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(work, MAIN_IDLE)):
        time.sleep(0.5)
    say(f"[sw-side] waited {time.perf_counter() - t0:.1f} s for the main "
        f"process to leave the card")
    return {"launches": launches,
            "sw": {name: sw_on_call(name, call, 1 if rehearsal else 20,
                                    device)
                   for name, call in calls.items()}}


def sw_on_call(name, call, reps, device):
    """B9 on a recorded align call's candidate pairs: equal to its plain
    version and, on the first SIDE_NATIVE_PAIRS, to the native ssw; timed
    beside its bound (_sw_time). Returns the measurements."""
    pairs = call["pairs"]
    gaps = (call["gap_open"], call["gap_extend"])
    if not pairs:
        raise AssertionError(f"sw-side: {name}'s align stage had no pairs")
    args, _ = _sw_check(call["db"], call["tdb"], pairs,
                        call["comp_bias_corr"], gaps, device,
                        SIDE_NATIVE_PAIRS)
    m = _sw_time(args, gaps, reps, device)
    qlen = args[2][args[8].long()]
    tlen = args[6][args[9].long()]
    say(f"[sw-side] B9 on the {len(pairs)} candidate pairs of {name}'s "
        f"align stage ({call['db'].size} queries of median "
        f"{int(qlen.median())} and up to {int(qlen.max())}, targets of median "
        f"{int(tlen.median())} and up to {int(tlen.max())} residues, "
        f"{m['cells']} cells, gaps {gaps[0]}/{gaps[1]}): equal to the plain "
        f"version, and to the native ssw on the first "
        f"{min(len(pairs), SIDE_NATIVE_PAIRS)}")
    say("[sw-side]" + _sw_line(f"{name}'s", m)[len("[sw-main]"):])
    return m


# B9's edge rows: a row per lane up to 32, the edges of the warp-path
# classes around 16, 32, 64, 128 and 256 rows, of a warp's strip
# (STRIP_ROWS, 512) and of a block's 8 warps of 4, 8 and 16 rows a lane
# (1,024, 2,048, 4,096), and a query that wraps the block's warps (5,000),
# against targets of 0, 1, 33, 700 and 6,000; the rehearsal's are shorter
SW_EDGE_LENS = ((1, 2, 16, 17, 31, 32, 33, 64, 65, 128, 129, 256, 257, 511,
                 512, 513, 1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096,
                 4097, 5000), (0, 1, 33, 700, 6000))
SW_REHEARSAL_LENS = ((1, 2, 31, 32, 33, 65, 513), (0, 1, 33, 100))
# the edge rows timed before the kernel's redesign (119 pairs, 65,135,651
# cells): the timed "edge" input
SW_EDGE_TIMED = ((1, 2, 31, 32, 33, 64, 65, 128, 129, 256, 257, 511, 512,
                  513, 1024, 1025, 5000), (0, 1, 31, 32, 33, 700, 6000))
# more block-path pairs than the card holds blocks: queries of 513-3,000
# residues against targets of 300-2,000, launched SW_REPEATS times
SW_LONG = (600, (513, 3000), (300, 2000))
SW_REHEARSAL_LONG = (6, (513, 600), (30, 60))
SW_REPEATS = 50
SW_LONG_NATIVE = 100   # of them also held against the native ssw
SW_NATIVE_PAIRS = 4000   # real pairs also held against the native ssw
# The least int32 work of a DP cell of the affine local score, with the
# bias folded into the query's profile and every add-and-max and three-way
# max one Hopper DPX instruction: H = max(Hdiag + p, E, F, 0) 2 (an add,
# a __vimax3_s32_relu), H - gapo 1, E and F one __viaddmax_s32 each, the
# best 1. NVIDIA publishes no DPX rate; counted at the INT32 rate, the
# bound can only come out below what the card can reach. Without DPX the
# same cell takes 10.
SW_OPS_PER_CELL = 6
SW_OPS_PER_CELL_NO_DPX = 10


def _sw_dbs(queries, targets, pairs_of):
    """(query DB, target DB, pairs) of these rows; pairs_of(query keys,
    target keys) gives the pairs."""
    from plass_tpu_torch.data import seqdb
    qdb, tdb = (seqdb.SeqDB.from_records([x.tobytes() for x in rows],
                                         dbtype=seqdb.AMINO_ACIDS)
                for rows in (queries, targets))
    return qdb, tdb, pairs_of([int(k) for k in qdb.keys],
                              [int(k) for k in tdb.keys])


def _sw_rows(rng, qlens, tlens, src_of):
    """Seeded queries and targets of these lengths, target i a copy of the
    start of query src_of(i) with 8% substitutions, so that they score."""
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)
    queries = [letters[rng.integers(0, 20, n)] for n in qlens]
    targets = []
    for i, n in enumerate(tlens):
        t = letters[rng.integers(0, 21, n)]
        src = queries[src_of(i)]
        m = min(n, len(src))
        t[:m] = src[:m]
        mut = rng.random(n) < 0.08
        t[mut] = letters[rng.integers(0, 20, int(mut.sum()))]
        targets.append(t)
    return queries, targets


def _sw_edge_dbs(lens):
    """(query DB, target DB, pairs): seeded rows of the given lengths, the
    targets copies of queries with 8% substitutions so that they score,
    every (query, target) pair."""
    rng = np.random.default_rng(5)
    queries, targets = _sw_rows(rng, lens[0], lens[1],
                                lambda i: -1 - (i % 5))
    return _sw_dbs(queries, targets,
                   lambda qk, tk: [(a, b) for a in qk for b in tk])


def _sw_long_dbs(n, qrange, trange):
    """(query DB, target DB, pairs): n seeded pairs of a query of qrange
    and a target of trange residues, the target a relative of its query."""
    rng = np.random.default_rng(9)
    queries, targets = _sw_rows(rng, rng.integers(*qrange, n),
                                rng.integers(*trange, n), lambda i: i)
    return _sw_dbs(queries, targets, lambda qk, tk: list(zip(qk, tk)))


def _sw_kernel_info(args):
    """(registers a thread, local bytes a thread, resident warps an SM) of
    the kernel instance these operands take."""
    import ctypes
    import torch
    from plass_tpu_torch.kernels import build
    lib = build.load("sw_score")
    plan = args[11]
    span = int(plan[2]) - int(plan[1]) + 1
    regs, local, smem = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    lib.sw_score_attributes(args[13].shape[0], span, ctypes.byref(regs),
                            ctypes.byref(local), ctypes.byref(smem))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = lib.sw_score_resident_blocks(args[13].shape[0], span) // sms \
        * lib.sw_score_block_warps()
    return regs.value, local.value, warps


def _native_scores(db, tdb, pairs, comp_bias_corr, gap_open, gap_extend):
    """The native striped Smith-Waterman's best score of each pair (the
    host aligner, ProteinAligner.ssw_align score only)."""
    from plass_tpu_torch import constants
    from plass_tpu_torch.ops.evalue import EvalueComputer
    from plass_tpu_torch.ops.protein_align import ProteinAligner

    mat = constants.blosum62()
    aligner = ProteinAligner(mat, comp_bias_corr)
    ev = EvalueComputer.for_matrix("blosum62_11_1", tdb.total_residues())
    by_query = {}
    for i, (q, t) in enumerate(pairs):
        by_query.setdefault(q, []).append((i, t))
    scores = np.zeros(len(pairs), dtype=np.int64)
    for q, items in by_query.items():
        qnum = mat.aa2num[np.asarray(db.get_seq(db.key_to_id(q)))]
        if not len(qnum):
            continue
        aligner.init_query(qnum)
        for i, t in items:
            tnum = mat.aa2num[np.asarray(tdb.get_seq(tdb.key_to_id(t)))]
            if len(tnum):
                scores[i] = aligner.ssw_align(
                    tnum, gap_open, gap_extend, 0, 1e-3, ev, 0, 0.0,
                    len(qnum) // 2)["score1"]
    return scores


def _sw_check(db, tdb, pairs, comp_bias_corr, gaps, device, n_native):
    """B9 on (db, tdb, pairs) against its plain version and, on the first
    n_native pairs, against the native ssw. Returns (operands, scores)."""
    from plass_tpu_torch import constants
    from plass_tpu_torch.ops import protein_align as pa
    from plass_tpu_torch.ops.device_align import (pair_operands, sw_score,
                                                  sw_score_plain)
    mat = constants.blosum62()
    args = pair_operands(
        db, tdb, pairs,
        lambda qid: pa.query_profile_row(db, qid, mat, comp_bias_corr),
        device)
    got = sw_score(*args, *gaps)
    err = max_abs_err([got], [sw_score_plain(*args, *gaps, budget=1 << 25)])
    native = _native_scores(db, tdb, pairs[:n_native], comp_bias_corr, *gaps)
    nerr = int(np.abs(got.cpu().numpy()[:n_native].astype(np.int64)
                      - native).max(initial=0))
    if err or nerr:
        raise AssertionError(f"B9: max |err| {err} against the plain "
                             f"version, {nerr} against the native ssw")
    return args, got


def _sw_time(args, gaps, reps, device):
    """B9's kernel ms (launches queued), its plain version's (one call),
    the cells, GCUPS and bound of one call on these operands."""
    import torch
    from plass_tpu_torch.ops.device_align import sw_score, sw_score_plain
    ms = cuda_ms(lambda: sw_score(*args, *gaps), KERNEL_REPS * reps, device,
                 queued=True)
    pms = cuda_ms(lambda: sw_score_plain(*args, *gaps, budget=1 << 25), 1,
                  device)
    qlen = args[2][args[8].long()].long()
    tlen = args[6][args[9].long()].long()
    cells = int((qlen * tlen).sum())
    rate, mhz = int32_ops_per_s(device)
    n_bytes = sum(x.numel() * x.element_size() for x in args
                  if isinstance(x, torch.Tensor)) + 4 * args[8].numel()
    n_ops = SW_OPS_PER_CELL * cells
    bms, bby = bound(n_bytes, n_ops, rate)
    return {"max_abs_err": 0, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": bby, "bytes": n_bytes, "operations": n_ops,
            "cells": cells, "gcups": cells / (ms * 1e-3) / 1e9,
            "pairs": args[8].numel(), "mhz": mhz, "rate": rate,
            "block_pairs": int(sum(args[11][4:7])),
            "no_dpx_bound_ms": bound(n_bytes, SW_OPS_PER_CELL_NO_DPX * cells,
                                     rate)[0]}


# sw-main's inputs: the recorded align calls of linclust-aa (the run with
# the most pairs of each input) and of search-aa; (name, owner, stage)
SW_INPUTS = (("contigs", "the contigs'",
              "linclust's align stage on the contigs"),
             ("families", "the families'",
              "linclust's align stage on the families"),
             ("search", "search-aa's", "search-aa's align stage"))


def _sw_line(owner, m):
    return (f"[sw-main] B9 on {owner} {m['pairs']} pairs: kernel "
            f"{m['ms']:.4f} ms ({m['gcups']:.1f} GCUPS), plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms by "
            f"{m['bound_by']} ({100 * m['bound_ms'] / m['ms']:.1f}% of it "
            f"reached; {SW_OPS_PER_CELL} DPX-fused int32 operations a cell "
            f"over {SMS} SMs x {INT32_LANES_PER_SM} INT32 lanes x "
            f"{m['mhz']:.0f} MHz clocks.max.sm = {m['rate'] / 1e12:.2f} "
            f"Tops/s; without DPX, {SW_OPS_PER_CELL_NO_DPX} a cell, "
            f"{m['no_dpx_bound_ms']:.4f} ms; {m['bytes']} bytes); "
            f"{m['block_pairs']} pairs on the block path")


def phase_sw_main(device, calls, rehearsal):
    """B9 on the candidate pairs of each of SW_INPUTS, on edge rows and on
    more long pairs than the card holds blocks: equal to its plain version
    and to the native ssw's scores at both gap settings, the long pairs
    SW_REPEATS times; timed against its plain version and its bound; the
    share of the pairs that fail the E-value test (-e 0.001 in linclust and
    search), which B9 spares a host ssw. Returns the measurements on the
    families' pairs, with the contigs', search-aa's and the edge rows'
    under "contigs", "search" and "edge"."""
    import torch
    from plass_tpu_torch.ops.device_align import sw_score
    from plass_tpu_torch.ops.evalue import EvalueComputer

    reps = 1 if rehearsal else 20
    out = {}
    for name, owner, what in SW_INPUTS:
        call = calls[name]
        pairs = call["pairs"]
        gaps = (call["gap_open"], call["gap_extend"])
        if not pairs:
            raise AssertionError(f"sw-main: {what} had no pairs")
        args, got = _sw_check(call["db"], call["tdb"], pairs,
                              call["comp_bias_corr"], gaps, device,
                              SW_NATIVE_PAIRS)
        m = out[name] = _sw_time(args, gaps, reps, device)
        qlen = args[2][args[8].long()]
        tlen = args[6][args[9].long()]
        ev = EvalueComputer.for_matrix("blosum62_11_1",
                                       call["tdb"].total_residues())
        fail = m["rejected"] = sum(
            float(ev.evalue(int(sc), int(ql))) > 1e-3
            for sc, ql in zip(got.tolist(), qlen.tolist()))
        say(f"[sw-main] B9 on the {len(pairs)} candidate pairs of {what} "
            f"({call['db'].size} queries, "
            f"queries of median {int(qlen.median())} and up to "
            f"{int(qlen.max())}, targets of median {int(tlen.median())} and "
            f"up to {int(tlen.max())} residues, {m['cells']} cells, gaps "
            f"{gaps[0]}/{gaps[1]}, {int((got > 0).sum())} scores above 0, "
            f"{fail} ({100 * fail / len(pairs):.1f}%) failing the E-value "
            f"test, whose host ssw B9 spares): equal to the plain version, "
            f"and to the native ssw on the first "
            f"{min(len(pairs), SW_NATIVE_PAIRS)}")
        say(_sw_line(owner, m))
    for lens, owner in ((SW_REHEARSAL_LENS, "the edge") if rehearsal else
                        (SW_EDGE_LENS, "the boundary"),
                        (SW_REHEARSAL_LENS if rehearsal else SW_EDGE_TIMED,
                         "the edge")):
        edb, etdb, epairs = _sw_edge_dbs(lens)
        for egaps in ((5, 2), (11, 1)):
            eargs, egot = _sw_check(edb, etdb, epairs, True, egaps, device,
                                    len(epairs))
        m = out[owner] = _sw_time(eargs, egaps, 1 if rehearsal else 4,
                                  device)
        say(f"[sw-main] B9 on {len(epairs)} {owner[4:]} pairs (queries of "
            f"{', '.join(str(n) for n in edb.seq_lens())}, targets of "
            f"{', '.join(str(n) for n in etdb.seq_lens())} residues; gaps "
            f"5/2 and 11/1; best {int(egot.max())}): equal to the plain "
            f"version and to the native ssw")
        say(_sw_line(owner, m))
    n, qr, tr = SW_REHEARSAL_LONG if rehearsal else SW_LONG
    ldb, ltdb, lpairs = _sw_long_dbs(n, qr, tr)
    for lgaps in ((5, 2), (11, 1)):
        largs, lgot = _sw_check(ldb, ltdb, lpairs, True, lgaps, device,
                                SW_LONG_NATIVE)
    differ = sum(int(not torch.equal(sw_score(*largs, *lgaps), lgot))
                 for _ in range(SW_REPEATS))
    if differ:
        raise AssertionError(f"sw-main: {differ} of {SW_REPEATS} launches "
                             f"on the long pairs differ from the first")
    m = _sw_time(largs, lgaps, 1 if rehearsal else 4, device)
    say(f"[sw-main] B9 on {len(lpairs)} long pairs (queries of {qr[0]}-"
        f"{qr[1]}, targets of {tr[0]}-{tr[1]} residues; gaps 5/2 and 11/1): "
        f"equal to the plain version, and to the native ssw on the first "
        f"{min(len(lpairs), SW_LONG_NATIVE)}; {SW_REPEATS} launches all "
        f"equal")
    say(_sw_line("the long", m))
    if device.type == "cuda":
        regs, local, warps = _sw_kernel_info(args)
        say(f"[sw-main] B9's folded instance: {regs} registers and {local} "
            f"bytes of local memory a thread, {warps} warps resident an SM")
    return dict(out["families"], contigs=out["contigs"],
                search=out["search"], edge=out["the edge"])


# `--rescore-mode 0` on the fixture: the protein loop cut to 3 iterations
# without the coding filter, the nucleotide one to 2, every contig written
HAMMING_PROTEIN = ("--rescore-mode", "0", "--num-iterations", "3",
                   "--filter-proteins", "0")
HAMMING_NUCL = ("--rescore-mode", "0", "--num-iterations", "2",
                "--min-contig-len", "1", "--contig-output-mode", "0")


def _check_hamming(name, args, kw, edge, edge_kw, shape, what, reps,
                   device):
    """A HAMMING form against its plain version on the operands of a
    launch of rescore_diagonal_torch (launch_text's `shape`) and on edge
    rows (exact); timed beside its bound, one operation (an identity) a
    window residue."""
    from plass_tpu_torch.ops.rescore_kernel import (rescore_hamming,
                                                    rescore_hamming_plain)
    err = max_abs_err(rescore_hamming(*args, **kw),
                      rescore_hamming_plain(*args, **kw))
    e2 = max_abs_err(rescore_hamming(*edge, **edge_kw),
                     rescore_hamming_plain(*edge, **edge_kw))
    if err or e2:
        raise AssertionError(f"{name}: max |err| {err} on real hits, {e2} "
                             f"on edge cases")
    ms = cuda_ms(lambda: rescore_hamming(*args, **kw), KERNEL_REPS * reps,
                 device, queued=True)
    pms = cuda_ms(lambda: rescore_hamming_plain(*args, **kw), reps, device)
    n_bytes, n_ops, residues = rescore_traffic(args, kw.get("qrev"), 1)
    bms, bby = bound(n_bytes, n_ops)
    say(f"[hamming] {name} on {what} ({residues} window residues) and "
        f"{edge[4].numel()} edge-case hits: equal to the plain version; "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms by "
        f"{bby} ({n_bytes} bytes)")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": pms, "bytes": n_bytes,
            "bound_ms": bms, "bound_by": bby, **shape}


def phase_hamming(device, work, protein_db, nucl_db, reps):
    """--rescore-mode 0 through both CLIs on the fixture, the device's
    output byte for byte the CPU's; the HAMMING forms on the operands of
    rescore_diagonal_torch's iteration-0 launches (hits and self rows) of
    phases 4 and 7 and on edge rows. Returns (launches of the
    device runs, measurements by kernel)."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops.backend import kmermatcher_torch

    _reset_launches()
    t0 = time.perf_counter()
    outs = [fixture_cli(os.path.join(work, "ham_p"), HAMMING_PROTEIN, device),
            nucl_cli(READS, os.path.join(work, "ham_n"), HAMMING_NUCL,
                     device)]
    secs = time.perf_counter() - t0
    launches = _launches()
    cpu_outs = [fixture_cli(os.path.join(work, "ham_pcpu"), HAMMING_PROTEIN,
                            "cpu"),
                nucl_cli(READS, os.path.join(work, "ham_ncpu"), HAMMING_NUCL,
                         "cpu")]
    for name, flags, out, cpu_out in zip(
            ("plass assemble", "penguin nuclassemble"),
            (HAMMING_PROTEIN, HAMMING_NUCL), outs, cpu_outs):
        data = open(out, "rb").read()
        if not data or data != open(cpu_out, "rb").read():
            raise AssertionError(f"hamming: {name} on the device differs from "
                                 f"the run with --device cpu (or is empty)")
        say(f"[hamming] {name} {' '.join(flags)}: {data.count(b'>')} "
            f"contigs, sha256 {hashlib.sha256(data).hexdigest()}, "
            f"byte-identical to the run with --device cpu")
    say(f"[hamming] both device runs in {secs:.1f} s; launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if device.type == "cuda" and not (launches["seg_scan"]
                                      and launches["rescore_hamming"]
                                      and launches["rescore_hamming_rev"]):
        raise AssertionError(f"a kernel of the --rescore-mode 0 path never "
                             f"launched: {launches}")
    out = {}
    db = seqdb.SeqDB.open(protein_db)
    args, _, shape = launched_rescore(
        db, kmermatcher_torch(db, 14, device, **PROTEIN_MATCH), 0)
    out["rescore_hamming"] = _check_hamming(
        "rescore_hamming", args, {}, _edge_case_rows(device), {}, shape,
        f"phase 4's iteration 0's {launch_text(shape)}", reps, device)
    db = seqdb.SeqDB.open(nucl_db)
    _, args, rkw, _, _, shape = _nucl_rescore_inputs(db, device, 0)
    edge = _nucl_edge_case_rows(device)
    out["rescore_hamming_rev"] = _check_hamming(
        "rescore_hamming_rev", args, rkw, edge[:7], dict(rkw, qrev=edge[7]),
        shape, f"phase 7's iteration 0's {launch_text(shape)} "
        f"({int(rkw['qrev'].sum())} reverse)", reps, device)
    return launches, out


# ---------------------------------------------------------------------------
# align: --rescore-mode 2, the ALIGNMENT rescore (B12)

ALIGN_PROTEIN = ("--rescore-mode", "2")
ALIGN_NUCL = ("--rescore-mode", "2", "--min-contig-len", "150")
# sha256 of protein x400's assembly at --rescore-mode 2, from `python3
# chip_smoke.py --cpu-reference align` (the port with --device cpu)
ALIGN_SHA256 = \
    "0bb05de6a07aa800a54a0b1cf87be1b876b7fa4313f335c22d47fcab9060f596"
ALIGN_TIMEOUT = 900
# B12's operations a window residue, for its bound: the score, the running
# sum, the running minimum and the running maximum, all int32
ALIGN_OPS_PER_RESIDUE = 4


def phase_align_scale(device, work, reads, mode3_fasta=None):
    """protein x400 (phase 4's reads) through `plass assemble
    --rescore-mode 2`: sha256, wall, stage seconds and launches; on a card
    the sha256 must equal ALIGN_SHA256, B12 must run and K2 must not.
    With mode3_fasta (phase 4's assembly), says whether the bytes differ
    from mode 3's. Returns {"launches", "sha256", "wall"}."""
    from plass_tpu_torch.cli.plass import run

    out_dir = os.path.join(work, "align_scale")
    out = os.path.join(out_dir, "assembly.fas")
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    rc = run(["assemble", reads, out, os.path.join(out_dir, "tmp"),
              *ALIGN_PROTEIN, "--device", str(device)], stats=stats)
    wall = time.perf_counter() - t0
    launches = _launches()
    if rc != 0:
        raise AssertionError(f"[align-scale] CLI exit code {rc}")
    data = open(out, "rb").read()
    n = data.count(b">")
    if not n:
        raise AssertionError("[align-scale] the assembly produced no contigs")
    digest = hashlib.sha256(data).hexdigest()
    say(f"[align-scale] `plass assemble --rescore-mode 2` of {stats['reads']} "
        f"reads ({stats['orfs']} ORFs, iteration-0 hits {stats['hits']}) at "
        f"--device {device}: wall {wall:.1f} s, {n} contigs, sha256 {digest}")
    say("[align-scale] seconds per stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stats["seconds"].items()))
    say("[align-scale] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if mode3_fasta is not None:
        mode3 = hashlib.sha256(open(mode3_fasta, "rb").read()).hexdigest()
        say(f"[align-scale] {'differs from' if mode3 != digest else 'equals'}"
            f" phase 4's assembly at --rescore-mode 3 (sha256 {mode3})")
    if device.type == "cuda":
        if not (launches["seg_scan"] and launches["rescore_align"]) or \
                launches["rescore_e2e"]:
            raise AssertionError(f"[align-scale] B12 must run at every "
                                 f"rescore and K2 at none: {launches}")
        if digest != ALIGN_SHA256:
            raise AssertionError(f"[align-scale] sha256 {digest} differs "
                                 f"from --cpu-reference align's "
                                 f"{ALIGN_SHA256}")
    return {"launches": launches, "sha256": digest, "wall": wall}


# B12's rows over 32,768 residues (C12): (query length, target length, the
# hit's diagonal, planted segments as (diagonal, length, offset in the
# window, segment id)); a segment id's copies are equal, so equal
# lengths tie
WIDE_CASES = (
    # the wrapped diagonal r - 65,536 outscores the hit's own
    (40000, 40000, 30000, ((30000, 300, 4000, 0), (-35536, 900, 1000, 1))),
    # a tie, kept by the negative candidate, which is scored first
    (40000, 40000, 30000, ((30000, 500, 7000, 2), (-35536, 500, 2000, 2))),
    # a query over 65,536: the positive candidate 65,536 + u16 wins
    (70000, 5000, 1000, ((1000, 100, 50, 3), (66536, 700, 2000, 4))),
)
WIDE_HITS = 6   # hits a pair of WIDE_CASES's rows: its case's, 66,536, random


def _wide_edge_rows(device, nucl):
    """B12's C12 edge rows: WIDE_CASES's pairs of rows, every residue a
    mismatching pair but the planted segments (random letters), each pair
    hit on its case's diagonal, on 66,536 and on WIDE_HITS - 2 random ones;
    nucleotide hits on both strands, the case's own forward. Returns
    (rows, offsets, lengths, code table, qrow, trow, diag[, qrev])."""
    import torch
    from plass_tpu_torch import constants

    rng = np.random.default_rng(13)
    mat = constants.nucleotide() if nucl else constants.blosum62()
    letters = np.frombuffer(b"ACGT" if nucl else b"ACDEFGHIKLMNPQRSTVWY",
                            np.uint8)
    bq, bt = (b"A", b"C") if nucl else (b"W", b"A")   # -3 in both matrices
    segs = [letters[rng.integers(0, len(letters), 900)] for _ in range(5)]
    seqs, q, t, d = [], [], [], []
    for qlen, tlen, dg, runs in WIDE_CASES:
        qs = np.full(qlen, ord(bq), np.uint8)
        ts = np.full(tlen, ord(bt), np.uint8)
        for rd, n, off, sid in runs:
            qo, to = (rd, 0) if rd >= 0 else (0, -rd)
            qs[qo + off:qo + off + n] = segs[sid][:n]
            ts[to + off:to + off + n] = segs[sid][:n]
        i = len(seqs)
        seqs += [qs.tobytes(), ts.tobytes()]
        diags = [dg, 66536] + list(rng.integers(-tlen + 1, qlen,
                                                WIDE_HITS - 2))
        q += [i] * len(diags)
        t += [i + 1] * len(diags)
        d += diags
    rows, offsets, lengths = flat_rows(seqs, device)
    i32 = lambda x: torch.tensor(np.asarray(x, dtype=np.int32), device=device)
    out = (rows, offsets, lengths,
           torch.from_numpy(mat.aa2num.astype(np.uint8)).to(device),
           i32(q), i32(t), i32(d))
    if nucl:
        rv = rng.random(len(q)) < 0.5
        rv[::WIDE_HITS] = False
        out += (torch.from_numpy(rv).to(device),)
    return out


def _check_align(name, args, kw, edge, edge_kw, wide, wide_kw, what, reps,
                 device):
    """A B12 form against its plain version on a launch's operands (`what`
    says which), edge rows and C12's rows over 32,768 (exact, all five outputs); timed beside its
    bound, ALIGN_OPS_PER_RESIDUE int32 operations a window residue at the
    card's integer rate. The edge rows must give segments in windows over
    LONG_WINDOW (the kernel's long-window pass), windows with no positive
    score and segments that stop short of either window end; the wide
    rows hits won by another diagonal than their own: the wrapped one, a
    tie kept by it and 65,536 + u16."""
    from plass_tpu_torch.ops.rescore_kernel import (_overlap, rescore_align,
                                                    rescore_align_plain)
    want = rescore_align_plain(*edge, **edge_kw)
    wide_want = rescore_align_plain(*wide, **wide_kw)
    err = max_abs_err(rescore_align(*args, **kw),
                      rescore_align_plain(*args, **kw))
    e2 = max_abs_err(rescore_align(*edge, **edge_kw), want)
    e3 = max_abs_err(rescore_align(*wide, **wide_kw), wide_want)
    if err or e2 or e3:
        raise AssertionError(f"{name}: max |err| {err} on real hits, {e2} "
                             f"on edge cases, {e3} on rows over 32,768")
    ov = _overlap(edge[2], edge[4].long(), edge[5].long(), edge[6])[0]
    score, first, last = want[:3]
    cases = {"long": int(((ov > LONG_WINDOW) & (score > 0)).sum()),
             "none": int(((ov > 0) & (score == 0)).sum()),
             "inner": int(((first > 0) & (last < ov - 1)).sum())}
    won = wide_want[4][::WIDE_HITS].tolist()
    planted = [-35536, -35536, 66536]   # WIDE_CASES's winners
    cases["wide_won"] = int((wide_want[4] != wide[6]).sum())
    if not all(cases.values()) or won != planted:
        raise AssertionError(f"{name}: the edge cases miss a case: {cases}, "
                             f"wide rows won by {won}, not {planted}")
    ms = cuda_ms(lambda: rescore_align(*args, **kw), KERNEL_REPS * reps,
                 device, queued=True)
    pms = cuda_ms(lambda: rescore_align_plain(*args, **kw), reps, device)
    n_bytes, n_ops, residues = rescore_traffic(args, kw.get("qrev"),
                                               ALIGN_OPS_PER_RESIDUE, 5)
    bms, bby = bound(n_bytes, n_ops, int32_ops_per_s(device)[0])
    say(f"[align] {name} on {what} ({residues} window "
        f"residues), {edge[4].numel()} edge-case hits ({cases['long']} "
        f"segments in windows over {LONG_WINDOW}, {cases['none']} windows "
        f"with no positive score, {cases['inner']} segments inside their "
        f"window) and {wide[4].numel()} hits on rows over 32,768 "
        f"({cases['wide_won']} won by another diagonal than their own): "
        f"equal to the plain version; kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms by {bby} ({n_bytes} bytes, "
        f"{n_ops} operations)")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": pms, "bytes": n_bytes,
            "operations": n_ops, "bound_ms": bms, "bound_by": bby,
            "wide_hits": wide[4].numel(), "wide_won": cases["wide_won"]}


def phase_align(device, work, protein_db, nucl_db, reps):
    """--rescore-mode 2 through both CLIs on the fixture: the device's
    output byte for byte the CPU's and the golden; B12 on the operands of
    rescore_diagonal_torch's iteration-0 launches (hits and self rows) of
    phases 4 and 7 and on edge rows. Returns (launches of the
    device runs, measurements by kernel)."""
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops.backend import kmermatcher_torch
    from plass_tpu_torch.ops.rescore_kernel import rescore_e2e_plain

    _reset_launches()
    t0 = time.perf_counter()
    outs = [fixture_cli(os.path.join(work, "aln_p"), ALIGN_PROTEIN, device),
            nucl_cli(READS, os.path.join(work, "aln_n"), ALIGN_NUCL, device)]
    secs = time.perf_counter() - t0
    launches = _launches()
    cpu_outs = [fixture_cli(os.path.join(work, "aln_pcpu"), ALIGN_PROTEIN,
                            "cpu"),
                nucl_cli(READS, os.path.join(work, "aln_ncpu"), ALIGN_NUCL,
                         "cpu")]
    for name, flags, out, cpu_out, golden in zip(
            ("plass assemble", "penguin nuclassemble"),
            (ALIGN_PROTEIN, ALIGN_NUCL), outs, cpu_outs,
            (GOLDEN, GOLDEN_NUCL)):
        data = open(out, "rb").read()
        if data != open(cpu_out, "rb").read() or \
                data != open(golden, "rb").read():
            raise AssertionError(f"align: {name} {' '.join(flags)} on the "
                                 f"device differs from the run with --device "
                                 f"cpu or from "
                                 f"{os.path.relpath(golden, ROOT)}")
        say(f"[align] {name} {' '.join(flags)}: {data.count(b'>')} contigs, "
            f"byte-identical to the run with --device cpu and to "
            f"{os.path.relpath(golden, ROOT)}")
    say(f"[align] both device runs in {secs:.1f} s; launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    launched = (launches["seg_scan"] and launches["rescore_align"]
                and launches["rescore_align_rev"])
    if (device.type == "cuda" and not launched) or any(
            v for k, v in launches.items() if k.startswith("rescore_e2e")):
        raise AssertionError(f"the --rescore-mode 2 path must launch K1 and "
                             f"both B12 forms and no K2: {launches}")
    out = {}
    db = seqdb.SeqDB.open(protein_db)
    args, _, shape = launched_rescore(
        db, kmermatcher_torch(db, 14, device, **PROTEIN_MATCH), 2)
    sub = args[7]
    edge = _edge_case_rows(device) + (sub,)
    say(f"[align] the protein edge rows hold "
        f"{_check_star_windows(edge, rescore_e2e_plain(*edge))} windows that "
        f"begin and end with '*'")
    out["rescore_align"] = _check_align(
        "rescore_align", args, {}, edge, {},
        _wide_edge_rows(device, False) + (sub,), {},
        f"phase 4's iteration 0's {launch_text(shape)}", reps, device)
    out["rescore_align"].update(shape)
    db = seqdb.SeqDB.open(nucl_db)
    _, args, rkw, uniform, _, shape = _nucl_rescore_inputs(db, device, 2)
    edge = _nucl_edge_case_rows(device)
    edge_args, edge_kw = edge[:7] + (args[7],), dict(rkw, qrev=edge[7])
    wide = _wide_edge_rows(device, True)
    wide_args, wide_kw = wide[:7] + (args[7],), dict(rkw, qrev=wide[7])
    what = (f"phase 7's iteration 0's {launch_text(shape)} "
            f"({int(rkw['qrev'].sum())} reverse)")
    generic = _check_align("rescore_align_rev (generic matrix)", args, rkw,
                           edge_args, edge_kw, wide_args, wide_kw, what, reps,
                           device)
    out["rescore_align_rev"] = _check_align(
        "rescore_align_rev (uniform matrix)", args,
        dict(rkw, uniform=uniform), edge_args, dict(edge_kw, uniform=uniform),
        wide_args, dict(wide_kw, uniform=uniform), what, reps, device)
    out["rescore_align_rev"].update(shape, generic_ms=generic["ms"])
    return launches, out


# ---------------------------------------------------------------------------
# sharded: the k-mer matcher across ranks (--backend sharded), in a process
# of its own beside guided-scale (phase 10), whose linclust tail leaves the
# card idle; it starts the ranks, each a `--side-phase sharded-rank` process

# sha256 of protein x400's assembly at world 2, from `python3 chip_smoke.py
# --cpu-reference sharded` (two ranks with --device cpu)
SHARDED_SHA256 = \
    "1146b97379c236a4d5db7d03e6dcfe0f579ca2c1f12071c5281cffabc07c9461"
SHARDED_TIMEOUT = 900
RANK_TIMEOUT = 600
# a failing rank's group gives up after this many seconds at the latest
FAIL_GROUP_TIMEOUT = 60
SHARDED_FIXTURE_RUNS = (
    ("nuclassemble", ("--num-iterations", "2", "--min-contig-len", "150")),
    ("guided_nuclassemble", ("--min-contig-len", "150")))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, work, name, jobs, rehearsal, timeout=RANK_TIMEOUT,
              group_timeout=None):
    """`chip_smoke.py --side-phase sharded-rank` in `world` processes, the
    ranks of one process group (PLASS_COORDINATOR on a free local port),
    each running `jobs` and writing its results to a JSON file in work.
    Returns [(exit code, log path, results or None)] by rank; a rank still
    running at `timeout` is killed."""
    d = os.path.join(work, name)
    os.makedirs(d, exist_ok=True)
    jobs_path = os.path.join(d, "jobs.json")
    with open(jobs_path, "w") as fh:
        json.dump(jobs, fh)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PLASS_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK"))}
    # the ranks share the host's cores: OpenMP and torch, each rank's
    # share (more threads than cores make a rank's CPU sorts and scans
    # crawl)
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    port = _free_port()
    procs = []
    for rank in range(world):
        env.update(PLASS_COORDINATOR=f"127.0.0.1:{port}",
                   PLASS_NUM_PROCESSES=str(world), PLASS_PROCESS_ID=str(rank))
        if group_timeout:
            env["PLASS_DIST_TIMEOUT"] = str(group_timeout)
        log = os.path.join(d, f"rank{rank}.log")
        with open(log, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--side-phase",
                 "sharded-rank", d, jobs_path, "-",
                 *(["--cpu-rehearsal"] if rehearsal else [])],
                stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT,
                env=dict(env)), log))
    out = []
    t_end = time.perf_counter() + timeout
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(t_end - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                rc = None
            res = os.path.join(d, f"rank{rank}.json")
            out.append((rc, log, json.load(open(res))
                        if rc == 0 and os.path.exists(res) else None))
    finally:
        for proc, _ in procs:
            stop(proc)
    return out


def _need_ranks(name, results):
    """The ranks' results, or an AssertionError with a failed rank's log."""
    for rank, (rc, log, res) in enumerate(results):
        if rc != 0 or res is None:
            print("\n".join(open(log).read().splitlines()[-40:]),
                  file=sys.stderr)
            raise AssertionError(f"[sharded] {name}: rank {rank} exited with "
                                 f"{rc}")
    return [res for _, _, res in results]


def _rank_line(name, rank, r):
    """A rank's stage seconds, exchanges and peak memory."""
    ex = ", ".join(f"{k} {r['exchange_bytes'][k]} B in "
                   f"{r['exchange_seconds'][k]:.3f} s"
                   for k in r["exchange_bytes"])
    return (f"[sharded] {name} rank {rank}: {seconds_text(r['seconds'])}; "
            f"exchanges {ex}; peak device memory "
            f"{r['peak'] / 2**30:.2f} GiB; launches seg_scan "
            f"{r['launches']['seg_scan']}, rescore_e2e "
            f"{r['launches']['rescore_e2e']}, rescore_e2e_rev_uniform "
            f"{r['launches']['rescore_e2e_rev_uniform']}")


def rank_cli(job, device, d, rank):
    """One CLI run of a rank on `device`: the launches counted from 0
    around it, its stats, its output's sha256."""
    from plass_tpu_torch.cli import penguin, plass
    from plass_tpu_torch.parallel import distributed

    run = plass.run if job["binary"] == "plass" else penguin.run
    out = os.path.join(d, f"{job['id']}_r{rank}" + job["suffix"])
    inputs = [x.format(rank=rank) for x in job["inputs"]]
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    rc = run([job["command"], *inputs, out, os.path.join(
        d, f"{job['id']}_tmp{rank}"), "--device", str(device), "--backend",
        "sharded", *job["flags"]], stats=stats)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{job['command']} exit code {rc}")
    return {"sha256": hashlib.sha256(open(out, "rb").read()).hexdigest(),
            "wall": wall, "launches": _launches(),
            "seconds": stats["seconds"],
            "peak": max(stats["peak_bytes"].values(), default=0),
            "exchange_bytes": stats.get("exchange_bytes", {}),
            "exchange_seconds": stats.get("exchange_seconds", {}),
            "world": distributed.world(), "backend": distributed.backend(),
            "contigs": sum(1 for line in open(out) if line.startswith(">"))}


def rank_match(job, device):
    """The iteration-0 sharded matcher on the card and on the CPU, in this
    rank's group: equal hits and rescore columns, K1 and K2 launched."""
    import torch
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops.backend import kmermatcher_sharded_torch

    db = seqdb.SeqDB.open(job["db"])
    _reset_launches()
    t0 = time.perf_counter()
    dev = kmermatcher_sharded_torch(db, 14, device, **PROTEIN_MATCH)
    t_dev = time.perf_counter() - t0
    launches = _launches()
    t0 = time.perf_counter()
    cpu = kmermatcher_sharded_torch(db, 14, torch.device("cpu"),
                                    **PROTEIN_MATCH)
    t_cpu = time.perf_counter() - t0
    for name, a, b in zip(("qk", "tk", "score", "diag", "pre score",
                           "first", "last", "idents"),
                          (*dev, *dev.pre), (*cpu, *cpu.pre)):
        if not np.array_equal(a, b):
            raise AssertionError(f"iteration-0 sharded matcher: {name} on "
                                 f"the card differs from the CPU's")
    if device.type == "cuda" and not (launches["seg_scan"]
                                      and launches["rescore_e2e"]):
        raise AssertionError(f"K1 or K2 never launched: {launches}")
    return {"hits": len(dev.hit_slots), "table_entries": dev.table_entries,
            "seconds": t_dev, "cpu_seconds": t_cpu, "launches": launches,
            "exchange_bytes": dev.exchange.bytes,
            "exchange_seconds": dev.exchange.seconds}


def phase_sharded_rank(d, jobs_path, rehearsal):
    """A rank of run_ranks: its jobs, each on the rank's card (the CPU in
    the rehearsal) or, where it says so, on the CPU; its results to
    rank<r>.json."""
    from plass_tpu_torch.parallel import distributed

    rank = distributed.coordinator()[3]
    results = {}
    for job in json.load(open(jobs_path)):
        device = distributed.rank_device(
            "cpu" if rehearsal or job.get("device") == "cpu" else "cuda")
        if job["kind"] == "match":
            distributed.maybe_initialize(device)
            results[job["id"]] = rank_match(job, device)
        else:
            results[job["id"]] = rank_cli(job, device, d, rank)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as fh:
        json.dump(results, fh)


def _cli_job(job_id, binary, command, inputs, suffix, flags=(),
             device="default"):
    return {"id": job_id, "kind": "cli", "binary": binary,
            "command": command, "inputs": list(inputs), "suffix": suffix,
            "flags": list(flags), "device": device}


def sharded_assemble_job(reads, device="default"):
    return _cli_job("assemble", "plass", "assemble", [reads], ".fas",
                    device=device)


def phase_sharded(device, work, db_path, assembly, rehearsal):
    """World 1 (NCCL on a card), world 2 (two ranks on the one card, gloo)
    and a failing rank; see the module docstring. Returns {"launches":
    {kernel: launches}} of the protein x400 assemblies' ranks."""
    # beside guided-scale: at a lower priority (the ranks inherit it), the
    # ranks' host stages take no CPU from the main process's phases
    os.nice(10)
    t_phase = time.perf_counter()
    reads = os.path.join(work, "reads.fasta")
    want = hashlib.sha256(open(assembly, "rb").read()).hexdigest()
    total = {}

    def count(res):
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v

    # ---- world 1: one rank, its exchanges copies to itself
    (r,) = _need_ranks("world 1", run_ranks(
        1, work, "sharded1", [sharded_assemble_job(reads)], rehearsal))
    w1 = r["assemble"]
    say(f"[sharded] world 1 ({w1['backend']}): `plass assemble --backend "
        f"sharded` of protein x400 in {w1['wall']:.1f} s, {w1['contigs']} "
        f"contigs, sha256 {w1['sha256']}")
    say(_rank_line("world 1", 0, w1))
    if w1["sha256"] != want:
        raise AssertionError(f"[sharded] world 1: sha256 {w1['sha256']}, "
                             f"phase 4's is {want}")
    say("[sharded] world 1: byte-identical to phase 4's assembly")
    count(w1)

    # ---- world 2: two ranks sharing the card
    jobs = [{"id": "match", "kind": "match", "db": db_path},
            sharded_assemble_job(reads)]
    for command, flags in SHARDED_FIXTURE_RUNS:
        for dev in ("default", "cpu"):
            jobs.append(_cli_job(f"{command}_{dev}", "penguin", command,
                                 READS, ".fasta", flags, dev))
    res = _need_ranks("world 2", run_ranks(2, work, "sharded2", jobs,
                                           rehearsal))
    m = [r["match"] for r in res]
    say(f"[sharded] world 2 ({res[0]['assemble']['backend']}): the "
        f"iteration-0 sharded matcher on protein x400's DB "
        f"({m[0]['table_entries']} table entries, {m[0]['hits']} hits) on "
        f"the card equals it on the CPU in both ranks, hits and rescore "
        f"columns; " + "; ".join(
            f"rank {i} {x['seconds']:.2f} s (CPU {x['cpu_seconds']:.2f} s), "
            f"seg_scan {x['launches']['seg_scan']}, rescore_e2e "
            f"{x['launches']['rescore_e2e']}, exchanges " + ", ".join(
                f"{k} {x['exchange_bytes'][k]} B in "
                f"{x['exchange_seconds'][k]:.3f} s"
                for k in x["exchange_bytes"]) for i, x in enumerate(m)))
    runs = [r["assemble"] for r in res]
    digest = runs[0]["sha256"]
    say(f"[sharded] world 2: `plass assemble --backend sharded` of protein "
        f"x400 in {runs[0]['wall']:.1f} | {runs[1]['wall']:.1f} s, "
        f"{runs[0]['contigs']} contigs, sha256 {digest}")
    for i, a in enumerate(runs):
        say(_rank_line("world 2", i, a))
        count(a)
    if runs[1]["sha256"] != digest:
        raise AssertionError("[sharded] world 2: the ranks' FASTAs differ")
    if not rehearsal:
        if digest != SHARDED_SHA256:
            raise AssertionError(f"[sharded] world 2: sha256 {digest}, "
                                 f"--cpu-reference sharded's is "
                                 f"{SHARDED_SHA256}")
        say("[sharded] world 2: both ranks byte-identical, sha256 equal to "
            "--cpu-reference sharded's")
    for command, _ in SHARDED_FIXTURE_RUNS:
        shas = {(i, dev): r[f"{command}_{dev}"]["sha256"]
                for i, r in enumerate(res) for dev in ("default", "cpu")}
        if len(set(shas.values())) != 1:
            raise AssertionError(f"[sharded] world 2: {command} on the "
                                 f"fixture differs: {shas}")
        r0 = res[0][f"{command}_default"]
        if device.type == "cuda" and not (
                r0["launches"]["seg_scan"]
                and r0["launches"]["rescore_e2e_rev_uniform"]):
            raise AssertionError(f"[sharded] {command}: K1 or K2-fast never "
                                 f"launched: {r0['launches']}")
        say(f"[sharded] world 2: `penguin {command} --backend sharded` on "
            f"the fixture, card and --device cpu in both ranks: "
            f"{r0['contigs']} contigs, sha256 {r0['sha256']}, byte-identical;"
            f" rank 0 launches seg_scan {r0['launches']['seg_scan']}, "
            f"rescore_e2e {r0['launches']['rescore_e2e']}, "
            f"rescore_e2e_rev_uniform "
            f"{r0['launches']['rescore_e2e_rev_uniform']}")
    if device.type == "cuda" and not all(
            r["launches"][k] for r in [w1] + runs
            for k in ("seg_scan", "rescore_e2e")):
        raise AssertionError("[sharded] K1 or K2 never launched in a rank")

    # ---- a failing rank: rank 1's input is missing
    t0 = time.perf_counter()
    shutil.copy(READS[0], os.path.join(work, "sharded_fail_0.fastq.gz"))
    job = _cli_job("fail", "plass", "assemble", [os.path.join(
        work, "sharded_fail_{rank}.fastq.gz")], ".fas",
        ["--num-iterations", "2"])
    rcs = [rc for rc, _, _ in run_ranks(
        2, work, "sharded_fail", [job], rehearsal, timeout=180,
        group_timeout=FAIL_GROUP_TIMEOUT)]
    if any(rc in (0, None) for rc in rcs):
        raise AssertionError(f"[sharded] a failing rank: exit codes {rcs}")
    say(f"[sharded] a failing rank (rank 1's input missing): exit codes "
        f"{rcs}, both ranks done in {time.perf_counter() - t0:.1f} s")
    say(f"[sharded] phase in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total}


def phase_cards(n):
    """--cards n: phase 27's protein x400 assembly across n cards, one rank
    a card (NCCL), and the same n ranks with --device cpu: every rank's
    FASTA equal; each rank's stage seconds, exchanges and launches."""
    import torch
    if torch.cuda.device_count() < n:
        raise AssertionError(f"--cards {n}: {torch.cuda.device_count()} "
                             f"card(s) visible")
    phase_env(torch.device("cuda"), False)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as work:
        reads = os.path.join(work, "reads.fasta")
        make_reads(reads, 400)
        digests = set()
        for dev in ("default", "cpu"):
            res = _need_ranks(f"{n} cards", run_ranks(
                n, work, f"cards_{dev}", [sharded_assemble_job(reads, dev)],
                False, timeout=3 * RANK_TIMEOUT))
            for i, r in enumerate(res):
                a = r["assemble"]
                say(_rank_line(f"{n} cards, {'card' if dev == 'default' else 'CPU'}"
                               f" ({a['backend']})", i, a)
                    + f"; wall {a['wall']:.1f} s, sha256 {a['sha256']}")
                digests.add(a["sha256"])
        if len(digests) != 1:
            raise AssertionError(f"[sharded] {n} cards: FASTAs differ: "
                                 f"{digests}")
        say(f"[sharded] {n} cards: every rank's FASTA equal on the cards and "
            f"on the CPU, sha256 {digests.pop()}")


def kernels_summary(k1, k2, rev, launches, sw=None, hamming=None,
                    align=None):
    """The entries of the `kernels` line. k1, k2, rev[name], sw,
    hamming[name] and align[name] hold a kernel's measurements
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, bytes); launches maps
    each main path to its {kernel: launches}. Without sw, hamming or align
    their entries are left out;
    sw's measurements on the contigs', search-aa's and the edge rows'
    pairs and on the side process's (linsearch, rbh, multihit, taxonomy),
    where given under those names, go into B9's entry."""
    def entry(name, source, replaces, m, **extra):
        paths = {path: counts.get(name, 0)
                 for path, counts in launches.items()}
        # library_ms: no single PyTorch call computes a segmented scan with
        # these combine functions (torch.cummax is unsegmented), a gathered
        # diagonal rescore or identity count, a segmented maximum subarray
        # with its positions, or a batch of local alignment scores
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths, "max_abs_err": m["max_abs_err"],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None, "bytes": m["bytes"],
                **{k: m[k] for k in ("hits", "self_rows", "self_row_share")
                   if k in m}, **extra}

    k2_src = ("plass_tpu_torch/csrc/rescore.cu",
              "plass_tpu/ops/pallas_rescore.py:449")
    kernels = [
        entry("seg_scan", "plass_tpu_torch/csrc/seg_scan.cu",
              "plass_tpu/ops/pallas_scan.py:168", k1, copy_ms=k1["copy_ms"],
              elements=k1["elements"]),
        entry("rescore_e2e", *k2_src, k2)]
    for name in ("rescore_e2e_rev", "rescore_e2e_rev_uniform"):
        # the generic reverse variant serves non-uniform matrices; no
        # workflow has one, so no main path launches it
        kernels.append(entry(name, *k2_src, rev[name],
                             main_path=name == "rescore_e2e_rev_uniform"))
    if sw is not None:
        kernels.append(entry(
            "sw_score", "plass_tpu_torch/csrc/sw_score.cu",
            "plass_tpu/ops/device_align.py:32", sw,
            operations=sw["operations"], cells=sw["cells"],
            gcups=sw["gcups"], pairs=sw["pairs"],
            **{name: {k: v for k, v in sw[name].items() if k in (
                "ms", "plain_ms", "bound_ms", "cells", "gcups", "pairs",
                "rejected", "block_pairs")}
               for name in ("contigs", "search", "edge", "linsearch", "rbh",
                            "multihit", "taxonomy") if name in sw}))
    for name in ("rescore_hamming", "rescore_hamming_rev") \
            if hamming is not None else ():
        kernels.append(entry(name, k2_src[0],
                             "plass_tpu/ops/device_rescore.py:107",
                             hamming[name]))
    for name in ("rescore_align", "rescore_align_rev") \
            if align is not None else ():
        # the JAX package computes mode 2 on the host only
        kernels.append(entry(name, k2_src[0], "plass_tpu/ops/rescore.py:71",
                             align[name],
                             operations=align[name]["operations"],
                             **{k: align[name][k] for k in (
                                 "wide_hits", "wide_won") if k in align[name]}))
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at a tiny size; "
                         "prints no result, exits 2")
    ap.add_argument("--cpu-reference", nargs="?", const=",".join(SCALE_RUNS),
                    metavar="RUNS",
                    help="run the scale assemblies (phases 4, 7 and 10; or "
                         "those named, of " + ", ".join(REFERENCE_RUNS) + ")"
                         " at full size on the CPU and print their sha256; "
                         "prints no result, exits 2")
    ap.add_argument("--cards", type=int, metavar="N",
                    help="run phase 27's protein x400 assembly across N "
                         "cards, one rank a card, and with --device cpu; "
                         "prints no result, exits 2")
    ap.add_argument("--side-phase", nargs=4,
                    metavar=("NAME", "WORK", "FAMDB", "ARG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if args.side_phase:
        # the phases of a process start_side starts: profile-aa (ARG: the
        # query DB), the slice's (ARG: family_fasta's FASTA) or sharded's,
        # or a rank of the sharded phase
        from plass_tpu_torch.utils.device import pick_device
        name, work, famdb, arg = args.side_phase
        device = pick_device("cpu" if args.cpu_rehearsal else "cuda")
        if name == "sharded-rank":
            # a rank of run_ranks (WORK: its directory, FAMDB: its jobs)
            phase_sharded_rank(work, famdb, args.cpu_rehearsal)
            return 0
        if name == "sharded":
            # FAMDB: phase 4's iteration-0 DB, ARG: its assembly
            result = phase_sharded(device, work, famdb, arg,
                                   args.cpu_rehearsal)
        elif name == "align-scale":
            # FAMDB: phase 4's assembly, ARG: its reads. It fills the main
            # process's later phases: at a lower priority, it takes no CPU
            # from them or from profile-aa, the script's longest path
            os.nice(10)
            result = phase_align_scale(device, work, arg, famdb)
        elif name == "profile-aa":
            result = {"launches": phase_profile_aa(
                device, work, famdb, arg, check_sha=not args.cpu_rehearsal)}
        else:
            result = phase_slice(device, work, famdb, arg,
                                 args.cpu_rehearsal)
        say(side_result(name) + json.dumps(result))
        return 0
    if args.cards:
        phase_cards(args.cards)
        return 2
    if args.cpu_reference:
        runs = args.cpu_reference.split(",")
        if set(runs) - set(REFERENCE_RUNS):
            ap.error(f"--cpu-reference takes names of "
                     f"{', '.join(REFERENCE_RUNS)}")
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                         dir=ROOT) as work:
            device = torch.device("cpu")
            if "assemble" in runs:
                phase_scale(device, work, 400)
            if "nuclassemble" in runs:
                phase_nucl_scale(device, work, 50, 20000)
            if "guided_nuclassemble" in runs:
                phase_guided_scale(device, work, *GUIDED_GENOMES)
            fasta = os.path.join(work, "families.fasta")
            if {"profile", "taxonomy"} & set(runs):
                make_families(fasta, False)
            if "profile" in runs:
                phase_profile_aa(device, work, *search_dbs(work, fasta,
                                                           device))
            if "taxonomy" in runs:
                phase_taxonomy_aa(device, work, fasta)
            if "sharded" in runs:
                reads = os.path.join(work, "reads.fasta")
                make_reads(reads, 400)
                (r0, r1) = _need_ranks("cpu-reference", run_ranks(
                    2, work, "sharded2", [sharded_assemble_job(reads, "cpu")],
                    False, timeout=3 * RANK_TIMEOUT))
                digests = {r["assemble"]["sha256"] for r in (r0, r1)}
                say(f"[cpu-reference] sharded: `plass assemble --backend "
                    f"sharded --device cpu` of protein x400 at world 2 in "
                    f"{r0['assemble']['wall']:.1f} s: sha256 "
                    f"{' '.join(sorted(digests))}")
                if len(digests) != 1:
                    raise AssertionError("the ranks' FASTAs differ")
            if "align" in runs:
                reads = os.path.join(work, "reads.fasta")
                make_reads(reads, 400)
                phase_align_scale(device, work, reads)
        say(f"[cpu-reference] {', '.join(runs)} at full size on the CPU; no "
            f"result")
        return 2
    t_start = time.perf_counter()
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from plass_tpu_torch.utils.device import pick_device
    device = pick_device("cpu" if rehearsal else "cuda")

    phase_env(device, rehearsal)
    reps = 2 if rehearsal else 20
    # 4,096 is K1's tile: one either side of it, then the full size
    k1_err = phase_k1(
        device, [2**10 + 7, 4095, 4096, 4097,
                 3 * 2**12 + 5 if rehearsal else 24 * 2**20], reps,
        # the protein table of 409,600 reads (x800) in an earlier run
        timed_sizes=(5000,) if rehearsal else (14725883,))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as work:
        phase_fixture(device, work)
        phase_standalone(device, work)
        launches, db_path, assembly = phase_scale(
            device, work, 4 if rehearsal else 400)
        (k1_main_err, k1), k2 = phase_main_shapes(device, db_path, reps)
        phase_nucl_fixture(device, work)
        nlaunches, ndb_paths, nrun = phase_nucl_scale(
            device, work, *((3, 2000) if rehearsal else (50, 20000)))
        k1_nucl_err, rev = phase_nucl_main(device, *ndb_paths, reps)
        phase_guided_fixture(
            device, work, ("--num-iterations", "2") if rehearsal else ())
        # the sharded phase's ranks run beside guided-scale, whose linclust
        # tail leaves the card idle
        sharded = start_side("sharded", work, db_path, assembly, rehearsal)
        try:
            glaunches, gdb_paths = phase_guided_scale(
                device, work, *((2, 3000) if rehearsal else GUIDED_GENOMES))
            t0 = time.perf_counter()
            shlaunches = finish_side(*sharded, SHARDED_TIMEOUT)["launches"]
            say(f"[sharded] waited {time.perf_counter() - t0:.1f} s after "
                f"guided-scale")
        finally:
            stop(sharded[1])
        k1_guided_err, k2_guided_err = phase_guided_main(device, *gdb_paths,
                                                         reps)
        phase_split_main(device, [
            ("protein x400 iteration 0", db_path, 14, PROTEIN_MATCH, True),
            ("nucl-scale iteration 0", ndb_paths[0], 22, NUCL_MATCH, False),
            ("nucl-scale last iteration", ndb_paths[1], 22, NUCL_MATCH, True),
            ("guided-scale aa iteration 0", gdb_paths[0], 14, AA_MATCH,
             False)],
            rehearsal)
        slaunches = phase_nucl_split(device, work, nrun)
        llaunches, lcalls, fam_fasta = phase_linclust_aa(device, work,
                                                         assembly, rehearsal)
        famdb, search_qdb = search_dbs(work, fam_fasta, device)
        # profile-aa, the script's longest path, needs only search-aa's DBs
        profile = start_side("profile-aa", work, famdb, search_qdb,
                             rehearsal)
        side = align_side = None
        try:
            salaunches, lcalls["search"] = phase_search_aa(device, famdb,
                                                           search_qdb)
            side = start_side("slice", work, famdb, fam_fasta, rehearsal)
            align_side = start_side("align-scale", work, assembly,
                                    os.path.join(work, "reads.fasta"),
                                    rehearsal)
            calaunches = phase_cluster_aa(device, work, famdb)
            ealaunches = phase_easy_aa(device, work, fam_fasta)
            sw = phase_sw_main(device, lcalls, rehearsal)
            del lcalls
            hlaunches, hamming = phase_hamming(device, work, db_path,
                                               ndb_paths[0], reps)
            alaunches, align = phase_align(device, work, db_path,
                                           ndb_paths[0], reps)
            ascale = finish_side(*align_side, ALIGN_TIMEOUT)
            # the slice's process times B9 once the card is free of this
            # process's work and of align-scale's
            open(os.path.join(work, MAIN_IDLE), "w").close()
            slice_result = finish_side(*side, SLICE_TIMEOUT)
            plaunches = finish_side(*profile, PROFILE_TIMEOUT)["launches"]
        finally:
            for started in (profile, side, align_side):
                if started is not None:
                    stop(started[1])
    phase_nucl_large(device, rehearsal)
    k1_err = max(k1_err, k1_main_err, k1_nucl_err, k1_guided_err)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_guided_err)

    say(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    if rehearsal:
        say("[rehearsal] all phases ran on the CPU; no result")
        return 2

    kernels = kernels_summary(
        dict(k1, max_abs_err=k1_err), k2, rev,
        {"assemble": launches, "nuclassemble": nlaunches,
         "guided_nuclassemble": glaunches, "split": slaunches,
         "linclust": llaunches, "search": salaunches, "profile": plaunches,
         "cluster": calaunches,
         "easy": ealaunches, "rescore_mode_0": hlaunches,
         **slice_result["launches"], "sharded": shlaunches,
         "rescore_mode_2": alaunches, "rescore_mode_2_x400": ascale["launches"]},
        dict(sw, **slice_result["sw"]), hamming, align)
    say(json.dumps({"kernels": kernels}))
    say(smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
