"""Progress bars and memory tracking, mirroring the reference's
Debug::Progress (lib/mmseqs/src/commons/Debug.h:115-211) and
MemoryTracker/Util::getTotalSystemMemory (commons/MemoryTracker.h,
Util.cpp:480-530).

Progress renders a 65-column ``[====]`` bar on a TTY and batched ``=``
ticks otherwise; the completion line appends the item count (K/M/B
suffixed like Debug.h:125-158) and elapsed wall time. Vectorized callers
use ``update(n)`` to advance many items per call — the host pipeline
processes arrays, not records, so per-record updateProgress() calls would
themselves be the bottleneck."""
import sys
import time

BARWIDTH = 65


def _item_string(n):
    """K/M/B-suffixed count like Debug::Progress::buildItemString."""
    if n < 1000:
        return str(n)
    for base, suffix in ((1e9, "B"), (1e6, "M"), (1e3, "K")):
        if n >= base:
            return f"{n / base:.2f}{suffix}"
    return str(n)


def _time_string(seconds):
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    ms = int((seconds - int(seconds)) * 1000)
    return f"{h}h {m}m {s}s {ms}ms"


class Progress:
    """Debug::Progress equivalent; total=None mimics the unknown-size mode
    (a tick every 10K items, a count line every 1M)."""

    def __init__(self, total=None, out=None):
        self.out = out if out is not None else sys.stderr
        self.interactive = hasattr(self.out, "isatty") and self.out.isatty()
        self.reset(total)

    def reset(self, total):
        self.total = total
        self.pos = 0
        self.printed_cols = 0
        self.opened = False
        self.finished = False
        self.t0 = time.time()

    def update(self, n=1):
        if self.finished or n <= 0:
            return
        prev = self.pos
        self.pos += n
        if self.total is None:
            if not self.opened:
                self.out.write("[")
                self.opened = True
            ticks = self.pos // 10000 - prev // 10000
            if ticks:
                self.out.write("=" * ticks)
                self.out.flush()
            if self.pos // 1000000 > prev // 1000000:
                self.out.write(
                    f"\t{self.pos // 1000000} Mio. sequences processed\n")
                self.out.flush()
            return
        if not self.opened:
            self.out.write("[")
            self.opened = True
        frac = 1.0 if self.total <= 1 else \
            min(1.0, (self.pos - 1) / max(self.total - 1, 1))
        cols = int(BARWIDTH * frac)
        if cols > self.printed_cols:
            self.out.write("=" * (cols - self.printed_cols))
            self.printed_cols = cols
            self.out.flush()
        if self.pos >= self.total:
            self.finish()

    def finish(self):
        if self.finished:
            return
        self.finished = True
        if not self.opened:
            self.out.write("[")
        if self.printed_cols < BARWIDTH and self.total is not None:
            self.out.write("=" * (BARWIDTH - self.printed_cols))
        n = self.pos if self.total is None else max(self.pos, self.total)
        self.out.write(f"] {_item_string(max(n - 1, 0) + 1)} "
                       f"{_time_string(time.time() - self.t0)}\n")
        self.out.flush()


# ---------------------------------------------------------------------------
# memory tracking
# ---------------------------------------------------------------------------

def total_system_memory():
    """Usable memory in bytes: the tighter of MemTotal and any cgroup v1/v2
    limit (Util::getTotalSystemMemory + cgroup checks, Util.cpp:480-530)."""
    mem = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    mem = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                txt = f.read().strip()
            if txt and txt != "max":
                lim = int(txt)
                if lim > 0 and (mem is None or lim < mem):
                    mem = lim
        except (OSError, ValueError):
            continue
    return mem or (1 << 62)


def current_rss():
    """Resident set size in bytes (VmRSS of /proc/self/status)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class MemoryTracker:
    """Warn when planned allocations approach the memory budget —
    the counterpart of the reference's MemoryTracker + the
    "Process needs more than ... main memory" aborts (DBReader.cpp:57-63).

    check(n_bytes) logs one warning when the projected footprint crosses
    the limit and raises MemoryError instead when strict. The kmermatcher
    runs it before a monolithic table allocation as the swap guard for
    user-supplied --split-memory-limit values above physical memory.
    """

    def __init__(self, limit=None, strict=False):
        self.limit = limit or total_system_memory()
        self.strict = strict
        self.warned = False

    def check(self, n_bytes, what="allocation"):
        from .log import logger
        projected = current_rss() + n_bytes
        if projected > self.limit:
            msg = (f"{what} needs {projected / 1e9:.2f} GB; memory limit is "
                   f"{self.limit / 1e9:.2f} GB")
            if self.strict:
                raise MemoryError(msg)
            if not self.warned:
                logger.warning(msg + " — expect swapping; use "
                               "--split-memory-limit to bound the k-mer table")
                self.warned = True
        elif projected > 0.9 * self.limit and not self.warned:
            logger.warning(
                f"{what}: projected memory {projected / 1e9:.2f} GB is near "
                f"the {self.limit / 1e9:.2f} GB limit")
            self.warned = True
        return projected <= self.limit
