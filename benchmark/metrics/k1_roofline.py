"""k1_roofline (%): K1 (csrc/fused_step.cu, `k1_cluster_steps_kernel`)
against the least time of an ensemble step on the H100
(benchmark/roofline.py), from the traced window's kernel events and the
`fused_steps` launch count."""

from benchmark.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "fused_steps", "k1_cluster_steps_kernel")
