"""The yardstick of the kernels' roofline shares: the H100's peaks and the
least work of one ensemble step of the single-component posterior,
counted from the benchmark's own problem data (the covered lines, the
reduced channels and the (line, channel) terms within 10 dV of the mask
center at the walkers' dV), so that the same work is counted whatever
kernel computes it.

A frozen copy of the counting of the program's utils/roofline.py
(`bound`, `k1_work`, `k3_work`): per evaluation of a theta, tau per
active line (2 exp + 4 divides, ~20 flops), one exp2 per in-window term
(~6 flops), per channel J(Tex) (an exp + 2 divides), 1 - exp(-opac) and,
with a free source size, the dilution's divide (~20 flops); once per
launch the theta-independent per-channel constants ((8 - free) special-
function results, ~12 flops). Bytes: each input read once, the active
lines' five constants, three per channel, and per in-window-at-dV_max
term its float32 velocity and a 16-bit line index.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, at the 700 W limit: device memory 3.35 TB/s,
#: float32 outside the tensor cores 67 TFLOP/s (132 SMs x 128 lanes x 2 x
#: 1.98 GHz), the special-function units' 16 results per clock per SM at
#: that clock (exp, exp2, log, the reciprocal that starts an IEEE divide).
MEM_RATE, FLOP_RATE, SFU_RATE = 3.35e12, 67e12, 132 * 16 * 1.98e9


def bound_s(n_sfu, n_flop, n_bytes):
    """(seconds, "operations" | "bytes"): the least time for the work."""
    ops = max(n_sfu / SFU_RATE, n_flop / FLOP_RATE)
    mem = n_bytes / MEM_RATE
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def in_window(dist, dv):
    """How many (theta, term) pairs have |v - center| < 10 dV, summed over
    the thetas' dV; `dist` the terms' |v - center|."""
    dist = np.sort(np.asarray(dist, dtype=np.float64).ravel())
    return int(np.searchsorted(dist, 10.0 * np.asarray(dv, dtype=np.float64),
                               side="left").sum())


def step_work(n_active_lines, n_channels, n_terms, dist, dv, k_steps, free=0):
    """(special-function results, flops, bytes) of one launch of k_steps
    ensemble steps of the walkers whose dV are `dv` (each evaluated once a
    step)."""
    La, C, rows = n_active_lines, n_channels, len(dv)
    win = in_window(dist, dv)
    sfu = 6 * rows * La + win + rows * C * (4 + free)
    flop = 20 * rows * La + 6 * win + 20 * rows * C
    return (k_steps * sfu + (8 - free) * C, k_steps * flop + 12 * C,
            4 * (5 * La + 3 * C) + 6 * n_terms)


def step_bound_s(post, dv, k_steps):
    """(seconds per ensemble step, bound by) of a reference Posterior's
    problem at the walkers' dV, in launches of k_steps steps."""
    dist = post.pair_dist.double().cpu().numpy()
    La = int(np.unique(post.pair_line.cpu().numpy()).size)
    s, by = bound_s(*step_work(La, post.n_channels, dist.size, dist, dv, k_steps))
    return s / k_steps, by


def kernel_roofline_pct(run, counter: str, event: str, others=()) -> float | None:
    """A step kernel's share of its roofline in a traced run: the bound of
    an ensemble step (the mean over the traced requests, each at its
    ensemble's last dV) over the kernel's device time a step (its profiler
    events' mean over the steps a launch runs, from the launch counter). None where the traced window holds no
    launch of it, or a launch of `others` (another entry of the same
    kernel) that its events cannot be told from."""
    launched = run.traced_launches
    if run.trace is None or not launched.get(counter) or any(launched.get(o) for o in others):
        return None
    us = [d for name, ds in run.trace["kernels"].items() if event in name for d in ds]
    if not us or not run.traced_dv:
        return None
    k = run.traced_steps / launched[counter]
    step_s = sum(us) / len(us) * 1e-6 / k
    bound = np.mean([step_bound_s(run.ref.post, dv, k)[0] for dv in run.traced_dv])
    return 100.0 * float(bound) / step_s


def device_idle_pct(run) -> float | None:
    """The share of the traced window in which nothing ran on the card."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
