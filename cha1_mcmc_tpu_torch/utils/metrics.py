"""Throughput measurement for a fit: walker-steps (likelihood evaluations)
per second of wall time, written beside the fit's artifacts; and an
optional torch.profiler trace of a region (port of
cha1_mcmc_tpu/utils/metrics.py:trace_profile)."""

from __future__ import annotations

import contextlib
import json
import time

import torch

__all__ = ["Throughput", "trace_profile"]


class Throughput:
    """Measure walker-steps per second over the regions it wraps."""

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0
        self.walker_steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None

    def add(self, nsteps: int, nwalkers: int):
        self.walker_steps += nsteps * nwalkers

    @property
    def walker_steps_per_sec(self) -> float:
        return self.walker_steps / self.elapsed if self.elapsed else 0.0

    def summary(self) -> dict:
        return {"walker_steps": self.walker_steps,
                "elapsed_s": self.elapsed,
                "walker_steps_per_sec": self.walker_steps_per_sec}

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
