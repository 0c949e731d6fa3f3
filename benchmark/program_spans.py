"""The program's spans and per-span counts (cha1_mcmc_tpu_torch.utils.metrics:
`spans`, `spans_dropped`, `span_totals`) as the per-layer readers take
them. Each helper returns None where the program keeps no spans (a
checkout from before them), where the ring has dropped part of what is
asked for, or where there is nothing to read.

The window's requests are back-to-back `run_mcmc` calls, each stamped
with `t0` / `t1` on `time.perf_counter()`, the clock the program's spans
are on, so a request's spans are those inside its interval."""

from __future__ import annotations


def _program_metrics():
    from cha1_mcmc_tpu_torch.utils import metrics

    return metrics if hasattr(metrics, "span_totals") else None


def untraced(run) -> list[dict]:
    """The requests after the traced ones: a `--trace 1` run's profiler
    closes after its first `trace_requests` requests (none is traced on
    the CPU)."""
    return run.records[len(run.traced_dv):]


def blocks(records: list[dict]) -> list | None:
    """The `sampler/block` spans of the requests `records` (from the first
    one's t0 to the last one's t1); None where the program keeps no spans,
    `records` is empty or the ring no longer holds the first of them."""
    program = _program_metrics()
    if program is None or not records:
        return None
    t0, t1 = records[0]["t0"], records[-1]["t1"]
    ring = program.spans()
    if program.spans_dropped() and (not ring or ring[0].t0 > t0):
        return None
    return [s for s in ring if s.name == "sampler/block" and s.t0 >= t0 and s.t1 <= t1]


def total_seconds(*names: str) -> float | None:
    """The seconds of every span of `names` since the process started (the
    never-dropped totals); None where the program recorded none of them."""
    program = _program_metrics()
    if program is None:
        return None
    totals = program.span_totals()
    found = [totals[name][1] for name in names if name in totals]
    return sum(found) if found else None
