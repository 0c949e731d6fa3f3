"""Throughput measurement for a fit: walker-steps (likelihood evaluations)
per second of wall time, the set-up time before it, and the kernel
launches and spans made meanwhile, written beside the fit's artifacts;
the program's spans and per-span counts; the device time of a loop's
blocks from CUDA events; and an optional torch.profiler trace of a
region (port of cha1_mcmc_tpu/utils/metrics.py:trace_profile).

Spans. `with span("<layer>/<phase>") as s:` times a region on
`time.perf_counter()`, the host clock a caller stamps its own requests
with, and records as it closes its name, start and end, the enclosing
span (`parent`, so a layer's self time is its span less its children's),
its trace id and the counts attached to it (`s.add(syncs=1, ...)`).
Every span of one top-level call shares a trace id: that of the
enclosing `trace()` region (one `run_mcmc` call, one fit's `init_setup`
and `fit`), else of the outermost span. Closed spans go to a bounded
ring (`spans()`; the oldest are dropped first and counted,
`spans_dropped()`) and to per-name totals that are never dropped
(`span_totals()`). Spans and counts are always on.

A span made with `host=True` marks a region that enqueues nothing on the
card. While a torch.profiler window is open (a flag read: no profiler
call is made otherwise), such a span, and only such a span, is also
entered as `record_function(name)`, which puts it on the profiler's host
timeline beside the kernels. A range that launched device work would
also be mirrored onto the device's timeline, as an annotation from its
first to its last device op, which a reader of device time takes for
work.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

__all__ = ["BlockTimer", "SpanLog", "SpanRecord", "Throughput", "first_launch",
           "innermost_span", "kernel_launches", "launch_counters", "new_trace_id",
           "register_launches", "span", "span_totals", "spans", "spans_dropped", "trace",
           "trace_profile"]

#: The LAUNCHES dict of every kernel module imported so far, each
#: registered by its module (register_launches).
_LAUNCH_COUNTERS: list[dict] = []


def register_launches(counts: dict) -> dict:
    """Register a kernel module's launch counters (entry name -> count,
    which its wrappers add one to where they launch their kernel and
    nowhere else); returns them, as `LAUNCHES = register_launches({...})`."""
    _LAUNCH_COUNTERS.append(counts)
    return counts


def launch_counters() -> tuple:
    """The registered LAUNCHES dicts, one a kernel module imported."""
    return tuple(_LAUNCH_COUNTERS)


def kernel_launches() -> dict:
    """The launch count of every registered kernel entry, by entry name (a
    copy of launch_counters' dicts, merged)."""
    return {k: v for counts in _LAUNCH_COUNTERS for k, v in counts.items()}


# -- spans -------------------------------------------------------------------

#: Closed spans the ring keeps: 131,072, four times the ~33,000 of a 51-s
#: window of the flagship's 512-step blocks (~6,600 blocks of 4-5 spans).
SPAN_RING = 1 << 17


class SpanRecord(NamedTuple):
    """A closed span: host-clock seconds (time.perf_counter), the
    enclosing span's id (None at the top), the trace id and the counts
    attached to it."""
    id: int
    name: str
    t0: float
    t1: float
    parent: int | None
    trace: int
    counts: dict


class SpanLog:
    """Where closed spans go: a ring of the last `ring` (the oldest
    dropped first, `dropped` counting them) and, per name, [count,
    seconds, counts summed], never dropped."""

    def __init__(self, ring: int = SPAN_RING):
        self._ring = collections.deque(maxlen=ring)
        self._totals: dict[str, list] = {}
        self._lock = threading.Lock()
        self.dropped = 0

    def close(self, record: tuple):
        """Log a closed span, given as the tuple of SpanRecord's fields."""
        _, name, t0, t1, _, _, counts = record
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(record)
            total = self._totals.get(name)
            if total is None:
                total = self._totals[name] = [0, 0.0, {}]
            total[0] += 1
            total[1] += t1 - t0
            summed = total[2]
            for k, v in counts.items():
                summed[k] = summed.get(k, 0) + v

    def records(self) -> list[SpanRecord]:
        with self._lock:
            return [SpanRecord(*r[:6], dict(r[6])) for r in self._ring]

    def totals(self) -> dict:
        with self._lock:
            return {name: [n, s, dict(c)] for name, (n, s, c) in self._totals.items()}


_LOG = SpanLog()
_SPAN_IDS = itertools.count(1)
_TRACE_IDS = itertools.count(1)


class _ThreadSpans(threading.local):
    """A thread's open spans, innermost last, its active trace id and its
    active BlockTimer."""

    def __init__(self):
        self.open: list[span] = []
        self.trace: int | None = None
        self.timer: BlockTimer | None = None


_THREAD = _ThreadSpans()


#: span's default `parent`: the innermost span open on the thread.
_INNERMOST = object()


class span:
    """A span named `<layer>/<phase>`, entered with `with`; `host=True`
    where the region enqueues nothing on the card (then mirrored to an
    open profiler window). Its parent is the innermost span open on the
    thread, or `parent` where given (a span, or None for none): spans that
    overlap in time without nesting, such as the blocks of a pipelined
    loop, name theirs. See the module's docstring."""

    __slots__ = ("name", "host", "counts", "id", "parent", "trace", "t0", "_mirror",
                 "_outer")

    def __init__(self, name: str, *, host: bool = False, parent=_INNERMOST):
        self.name, self.host, self.counts = name, host, {}
        self._mirror = None
        self._outer = parent

    def add(self, **counts) -> span:
        """Add to the span's counts (summed into its name's totals when
        it closes)."""
        mine = self.counts
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v
        return self

    def __enter__(self) -> span:
        thread = _THREAD
        outer = self._outer
        if outer is _INNERMOST:
            outer = innermost_span()
        if outer is not None:
            self.parent, self.trace = outer.id, outer.trace
        else:
            self.parent = None
            self.trace = thread.trace if thread.trace is not None else next(_TRACE_IDS)
        self.id = next(_SPAN_IDS)
        thread.open.append(self)
        if self.host and _autograd_profiler._is_profiler_enabled:
            self._mirror = record_function(self.name)
            self._mirror.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
            self._mirror = None
        _THREAD.open.remove(self)
        _LOG.close((self.id, self.name, self.t0, t1, self.parent, self.trace, self.counts))
        return False


def innermost_span() -> span | None:
    """The innermost span open on this thread, or None."""
    return _THREAD.open[-1] if _THREAD.open else None


def new_trace_id() -> int:
    return next(_TRACE_IDS)


@contextlib.contextmanager
def trace(trace_id: int | None = None):
    """A region whose spans share one trace id: `trace_id`, or a new one;
    inside another trace region, that region's. Yields the id."""
    thread = _THREAD
    if thread.trace is not None:
        yield thread.trace
        return
    thread.trace = new_trace_id() if trace_id is None else trace_id
    try:
        yield thread.trace
    finally:
        thread.trace = None


def spans() -> list[SpanRecord]:
    """The closed spans the ring holds, oldest first (a copy)."""
    return _LOG.records()


def spans_dropped() -> int:
    """How many closed spans the ring has dropped."""
    return _LOG.dropped


def span_totals() -> dict:
    """Every span name's [count, seconds, counts summed] since the process
    started (a copy)."""
    return _LOG.totals()


class BlockTimer:
    """The device time of a loop's blocks, from reused CUDA events on the
    device's current stream. `with timer:` around a block's enqueue records
    its start before the first enqueue and its stop after its last kernel.
    A runner that works on the host before its first kernel launch
    (FusedEnsemble: drawing the block's randomness and laying it out, while
    the card idles) calls `first_launch()` just before that launch, which
    records the start there instead; once a runner has done so, the timer
    records no start at the enqueue. Each block queued keeps a start and a
    stop event of its own until it is read, so a loop may queue the next
    block before it waits on this one. Once a block's own host
    synchronisation has passed, `read()` (which adds none) gives, for the
    oldest block not yet read, `device_s`, its span on the device from
    start to stop, and `gap_s`, the device's time from the previous block's
    stop to this block's start (absent for the first block). So for such a
    runner the device work before its mark (the draws and their layout) and
    the copies to the host after the stop fall in `gap_s`, not in
    `device_s`. A block whose enqueue raised keeps no events; `drop()`
    forgets the queued blocks not yet read (a loop that throws them away).
    On a CPU device it records nothing and reads {}."""

    def __init__(self, device):
        device = torch.device(device)
        self._cuda = device.type == "cuda"
        self._queued = collections.deque()   # (start, stop) of each block not yet read
        self._free = []                       # event pairs to reuse
        self._last = None                     # the last block read's pair
        self._marked = False                  # the runner calls first_launch()
        if self._cuda:
            self._stream = torch.cuda.current_stream(device)

    def __enter__(self) -> BlockTimer:
        if self._cuda:
            pair = self._free.pop() if self._free else tuple(
                torch.cuda.Event(enable_timing=True) for _ in range(2))
            self._queued.append(pair)
            if not self._marked:
                pair[0].record(self._stream)
            _THREAD.timer = self
        return self

    def __exit__(self, *exc):
        _THREAD.timer = None
        if self._cuda:
            if exc[0] is None:
                self._queued[-1][1].record(self._stream)
            else:
                self._free.append(self._queued.pop())
        return False

    def _first_launch(self):
        self._queued[-1][0].record(self._stream)
        self._marked = True

    def read(self) -> dict:
        if not self._cuda:
            return {}
        start, stop = pair = self._queued.popleft()
        out = {"device_s": start.elapsed_time(stop) * 1e-3}
        if self._last is not None:
            out["gap_s"] = self._last[1].elapsed_time(start) * 1e-3
            self._free.append(self._last)
        self._last = pair
        return out

    def drop(self):
        """Forget the blocks queued and not yet read."""
        self._free.extend(self._queued)
        self._queued.clear()


def first_launch():
    """Called by a runner just before its first kernel launch of a block:
    the thread's active BlockTimer, if any, moves the block's start here."""
    timer = _THREAD.timer
    if timer is not None:
        timer._first_launch()


# -- the fit's measurement -----------------------------------------------------

class Throughput:
    """Measure walker-steps per second over the regions it wraps, and the
    kernel launches made in them (`launches`: entry name -> count, the
    entries launched at least once); set-up before the sampling is timed
    apart (`setup`). `span_counts()` sums by name the spans closed since it
    was made (a fit makes it as its set-up begins); `trace_id` is the id the
    fit's spans share (`trace(throughput.trace_id)`)."""

    def __init__(self):
        self._t0 = None
        self._launches0 = None
        self.elapsed = 0.0
        self.setup_s = 0.0
        self.walker_steps = 0
        self.launches = {}
        self.trace_id = new_trace_id()
        self._spans0 = span_totals()

    def __enter__(self):
        self._launches0 = kernel_launches()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        self._count(self._launches0)

    @contextlib.contextmanager
    def setup(self):
        """A region of one-time set-up before the sampling (a process's
        first kernel-library load and random-kernel launches, the starting
        lnprob: EnsembleSampler.prepare): its seconds go to `setup_s` and
        its launches into `launches`, its time not into the rate."""
        launches0 = kernel_launches()
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.setup_s += time.perf_counter() - t0
            self._count(launches0)

    def _count(self, launches0: dict):
        for name, count in kernel_launches().items():
            before = launches0.get(name, 0)   # a module imported meanwhile
            if count != before:
                self.launches[name] = self.launches.get(name, 0) + count - before

    def add(self, nsteps: int, nwalkers: int):
        self.walker_steps += nsteps * nwalkers

    @property
    def walker_steps_per_sec(self) -> float:
        return self.walker_steps / self.elapsed if self.elapsed else 0.0

    def span_counts(self) -> dict:
        """Span name -> {count, seconds, counts} of the spans closed since
        this Throughput was made."""
        out = {}
        for name, (n, s, counts) in span_totals().items():
            n0, s0, counts0 = self._spans0.get(name, (0, 0.0, {}))
            if n != n0:
                out[name] = {"count": n - n0, "seconds": s - s0,
                             "counts": {k: v - counts0.get(k, 0) for k, v in counts.items()
                                        if v != counts0.get(k, 0)}}
        return out

    def summary(self) -> dict:
        spans_ = self.span_counts()
        timed = [v["counts"]["device_s"] for v in spans_.values() if "device_s" in v["counts"]]
        return {"walker_steps": self.walker_steps,
                "elapsed_s": self.elapsed,
                "walker_steps_per_sec": self.walker_steps_per_sec,
                "setup_s": self.setup_s,
                "launches": dict(self.launches),
                "spans": spans_,
                "device_busy_s": sum(timed) if timed else None}

    def save(self, path: str, **extra):
        """Persist the measurement (plus `extra` keys, e.g. the device)
        alongside the fit artifacts."""
        with open(path, "w") as f:
            json.dump({**self.summary(), **extra}, f, indent=1)


@contextlib.contextmanager
def trace_profile(log_dir: str | None):
    """Optionally wrap a region in a torch.profiler trace: the host's ops
    and, where a CUDA device is present, the card's kernels and copies,
    written to `log_dir` as a Chrome trace (`*.pt.trace.json`, readable
    by TensorBoard's profiler plugin or chrome://tracing). None: no trace."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
