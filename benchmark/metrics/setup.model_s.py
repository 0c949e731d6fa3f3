"""setup.model_s (s): the set-up fit's model assembly, the program's
`pipeline/model` spans (SpectralModel.build with Q's Chebyshev fit, the
lnprob / lnlike builders, the gather plan, the kernel ensemble's
tables). Read from the never-dropped per-name totals: no pipeline span
runs in a chain cell's window, so the totals are the set-up's."""

from benchmark.program_spans import total_seconds


def read(run):
    return total_seconds("pipeline/model")
