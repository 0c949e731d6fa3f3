"""The least work of one ensemble step of the N-component posterior, the
yardstick of `k2_roofline` (K2, csrc/multi_step.cu), counted from the
benchmark's own problem data: the multi-component reference's covered
lines, reduced channels and (line, channel) terms within 10 dv_bound of
the mask center, at the walkers' dV, so that the same work is counted
whatever kernel computes it. roofline.py's count is the single-component
one; its peaks (`bound_s`) and window count (`in_window`) serve here too.

A frozen copy of the counting of the program's utils/roofline.py
(`k2_work`): per evaluation of a theta, tau per (component, active line)
(2 exp + 4 divides, ~20 flops), one exp2 per (component, in-window term)
(~6 flops), per channel J(Tex) (an exp + 2 divides) and per component the
dilution's divide and 1 - exp(-opac) (~10 + 10 K flops); once per launch
the theta-independent per-channel constants (7 special-function results,
~12 flops). Bytes: the float32 tables once: the active lines' five
constants, three per channel, and per slot of the channel-major table
(M slots a channel, M the most terms any channel has) its velocity, line
index and hfs group.
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import bound_s, in_window

#: The launch counter of K2's step entry and the name of its kernel.
COUNTER, EVENT = "multi_steps", "multi_cluster_steps_kernel"


def step_work(n_active_lines, n_channels, n_slots, ncomp, dist, dv, k_steps):
    """(special-function results, flops, bytes) of one launch of k_steps
    ensemble steps of the walkers whose dV are `dv` (each evaluated once a
    step), `dist` the terms' |v - center|."""
    La, C, K, rows = n_active_lines, n_channels, ncomp, len(dv)
    win = in_window(dist, dv)
    sfu = 6 * rows * K * La + K * win + rows * C * (3 + 2 * K)
    flop = 20 * rows * K * La + 6 * K * win + rows * C * (10 + 10 * K)
    return (k_steps * sfu + 7 * C, k_steps * flop + 12 * C,
            4 * (5 * La + 3 * n_slots * C + 3 * C))


def problem_work(post, dv, k_steps):
    """step_work of a reference MultiPosterior's problem at the walkers'
    dV, in launches of k_steps steps."""
    line = post.pair_line.cpu().numpy()
    chan = post.pair_chan.cpu().numpy()
    C = post.n_channels
    slots = max(int(np.bincount(chan, minlength=C).max()), 1) if chan.size else 1
    return step_work(int(np.unique(line).size), C, slots, post.ncomp,
                     post.pair_dist.double().cpu().numpy(), dv, k_steps)


def roofline_pct(run) -> float | None:
    """K2's share of its roofline in a traced run: the bound of an
    ensemble step (the mean over the traced requests, each at its
    ensemble's last dV) over K2's device time a step (its kernel events'
    mean over the steps a launch runs, from the launch counter). None
    where the traced window holds no K2 step launch."""
    launched = run.traced_launches
    if run.trace is None or not launched.get(COUNTER):
        return None
    us = [d for name, ds in run.trace["kernels"].items() if EVENT in name for d in ds]
    if not us or not run.traced_dv:
        return None
    k = run.traced_steps / launched[COUNTER]
    step_s = sum(us) / len(us) * 1e-6 / k
    bound = np.mean([bound_s(*problem_work(run.ref.post, dv, k))[0] / k
                     for dv in run.traced_dv])
    return 100.0 * float(bound) / step_s
