"""The traced window of a `--trace 1` run: a torch.profiler window (host
ops and the card's kernels and copies) over the first requests of the
measured window, reduced to what the per-layer readers and the result's
`breakdown` take.

The window opens with a few small torch kernels, because the profiler
can drop a window's first kernel records, and its length is the span of
the harness's own `bench/traced` region on the profiler's clock. Device
time is the union of the intervals in which a kernel, copy or set ran.
An idle gap is a stretch of the window with nothing on the card; it is
named by the innermost of the harness's `bench/...` spans and the
innermost other host op that cover its middle, and the gaps are summed
by name. The harness's spans are mirrored on the device's timeline as
annotations; those are not device work.
"""

from __future__ import annotations

import collections
import warnings

import numpy as np
import torch

LEAD_KERNELS = 8
#: Gaps shorter than this (the card running back-to-back launches) are
#: summed under one name instead of being named one by one.
NAMED_GAP_US = 20.0


class Tracer:
    """Opens the profiler as the measured window starts (`open`) and
    closes it after `n_requests` requests (all if None), or when `close`
    is called."""

    def __init__(self, active: bool, n_requests: int | None, device):
        self.active, self.n_requests, self.device = active, n_requests, device
        self.prof = self.region = None
        self.result = None
        self.launches0 = self.launches = None
        self.requests = []

    def warm(self):
        """Open and close one profiler window in set-up: the first window
        of a process initialises the profiler's device tracing, which
        takes seconds."""
        if not self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device=self.device).add_(1.0)
            torch.cuda.synchronize(self.device)

    def open(self, launches: dict):
        """Open the traced window (before the measured window starts)."""
        if not self.active:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        lead = torch.zeros(1, device=self.device)
        for _ in range(LEAD_KERNELS):
            lead.add_(1.0)
        self.region = record_function("bench/traced")
        self.region.__enter__()
        self.launches0 = dict(launches)

    def request_end(self, record: dict, launches: dict):
        if self.prof is None or self.result is not None:
            return
        self.requests.append(record)
        if self.n_requests is not None and len(self.requests) >= self.n_requests:
            self.close(launches)

    def close(self, launches: dict):
        if self.prof is None or self.result is not None:
            return
        torch.cuda.synchronize(self.device)
        self.region.__exit__(None, None, None)
        with warnings.catch_warnings():   # a window's events are all it is read for
            warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
            self.prof.stop()
            events = self.prof.events()
        self.launches = {k: v - self.launches0.get(k, 0) for k, v in launches.items()
                         if v != self.launches0.get(k, 0)}
        self.result = reduce_events(events)
        self.prof = None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """{window_s, busy_s, kernels {name: [us, ...]}, device_ops [[name, s]],
    idle_gaps [[name, s]]} of a profiler window."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    window = [e for e in events if e.name == "bench/traced" and e.device_type == cpu]
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
           for e in events if e.device_type == cuda and not e.name.startswith("bench/")]
    dev = [d for d in dev if d[1] > d[0]]
    busy = _merge([(s, e) for s, e, _ in dev])
    kernels = collections.defaultdict(list)
    by_name = collections.Counter()
    for s, e, name in dev:
        kernels[name].append(e - s)
        by_name[name] += (e - s) * 1e-6
    host = [e for e in events if e.device_type == cpu and e.name != "bench/traced"]
    names = [e.name for e in host]
    hs = np.array([e.time_range.start for e in host], dtype=np.float64)
    he = np.array([e.time_range.end for e in host], dtype=np.float64)
    span = np.array([n.startswith("bench/") for n in names], dtype=bool)
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e - s < NAMED_GAP_US:
            if e > s:
                gaps[f"gaps under {NAMED_GAP_US} us"] += (e - s) * 1e-6
            continue
        mid = 0.5 * (s + e)
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = "bench/traced"
        for group, sep in ((cover[span[cover]], ""), (cover[~span[cover]], " > ")):
            if group.size:
                inner = group[np.argmin(he[group] - hs[group])]
                name = names[inner] if not sep else name + sep + names[inner]
        gaps[name] += (e - s) * 1e-6
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
                kernels=dict(kernels), device_ops=[[n, v] for n, v in by_name.most_common(10)],
                idle_gaps=[[n, v] for n, v in gaps.most_common(10)])
