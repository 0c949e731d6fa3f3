"""Throughput measurement for a fit: walker-steps (likelihood evaluations)
per second of wall time, the set-up time before it and the kernel
launches made meanwhile, written beside the fit's artifacts; and an
optional torch.profiler trace of a region (port of
cha1_mcmc_tpu/utils/metrics.py:trace_profile)."""

from __future__ import annotations

import contextlib
import json
import time

import torch

__all__ = ["Throughput", "kernel_launches", "launch_counters", "register_launches",
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


class Throughput:
    """Measure walker-steps per second over the regions it wraps, and the
    kernel launches made in them (`launches`: entry name -> count, the
    entries launched at least once); set-up before the sampling is timed
    apart (`setup`)."""

    def __init__(self):
        self._t0 = None
        self._launches0 = None
        self.elapsed = 0.0
        self.setup_s = 0.0
        self.walker_steps = 0
        self.launches = {}

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

    def summary(self) -> dict:
        return {"walker_steps": self.walker_steps,
                "elapsed_s": self.elapsed,
                "walker_steps_per_sec": self.walker_steps_per_sec,
                "setup_s": self.setup_s,
                "launches": dict(self.launches)}

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
