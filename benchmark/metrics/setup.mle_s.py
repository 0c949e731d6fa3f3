"""setup.mle_s (s): the set-up fit's maximum-likelihood Ncol, the
program's `pipeline/mle` span. Read from the never-dropped per-name
totals: no pipeline span runs in a chain cell's window, so the totals
are the set-up's."""

from benchmark.program_spans import total_seconds


def read(run):
    return total_seconds("pipeline/mle")
