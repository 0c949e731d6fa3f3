"""k2_roofline (%): K2 (csrc/multi_step.cu, `multi_cluster_steps_kernel`)
against the least time of an ensemble step of the N-component posterior
on the H100 (benchmark/roofline_k2.py), from the traced window's kernel
events and the `multi_steps` launch count."""

from benchmark.roofline_k2 import roofline_pct


def read(run):
    return roofline_pct(run)
