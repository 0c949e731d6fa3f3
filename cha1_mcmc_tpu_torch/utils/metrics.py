"""Throughput measurement for a fit: walker-steps (likelihood evaluations)
per second of wall time, written beside the fit's artifacts."""

from __future__ import annotations

import json
import time

__all__ = ["Throughput"]


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
