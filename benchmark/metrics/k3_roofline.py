"""k3_roofline (%): K3 (csrc/gather_step.cu, `gather_kernel`, which
also serves the lnprob entry: a traced window with a `gather_lnprob`
launch gives no reading) against the least time of an ensemble step on
the H100 (benchmark/roofline.py), from the traced window's kernel events
and the `gather_steps` launch count."""

from benchmark.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "gather_steps", "gather_kernel", others=("gather_lnprob",))
