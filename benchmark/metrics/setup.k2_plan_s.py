"""setup.k2_plan_s (s): the set-up fit's K2 statics, tables and cluster
plan, the program's `pipeline/k2_plan` span (inside `pipeline/model`).
Read from the never-dropped per-name totals: no pipeline span runs in a
chain cell's window, so the totals are the set-up's. None on a checkout
without the span."""

from benchmark.program_spans import total_seconds


def read(run):
    return total_seconds("pipeline/k2_plan")
