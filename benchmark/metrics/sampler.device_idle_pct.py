"""sampler.device_idle_pct (%): the share of the untraced requests' wall
time (t1 - t0, the requests after a --trace 1 run's profiled ones) in
which the card ran no block of `run_mcmc`: 100 x (1 - the `device_s` of
their `sampler/block` spans / their wall time). `device_s` is the
program's CUDA-event span of a block: from its first step-kernel launch
(the fused runners mark it with `first_launch()`; other runners from the
block's first enqueue) to its last kernel. So the block's random draws
and their layout on the card, and the fetch's copies to the host, count
as idle here (the profiler's `chain.device_idle_pct` counts them busy).
No profiler is open, so none of its host cost is in it. None on the CPU
(no events)."""

from benchmark.program_spans import blocks, untraced


def read(run):
    requests = untraced(run)
    spans = blocks(requests)
    if not spans or any("device_s" not in s.counts for s in spans):
        return None
    wall = sum(r["t1"] - r["t0"] for r in requests)
    return 100.0 * (1.0 - sum(s.counts["device_s"] for s in spans) / wall)
