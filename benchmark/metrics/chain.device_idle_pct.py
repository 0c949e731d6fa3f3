"""chain.device_idle_pct (%): the share of the traced window of a chain cell in
which no kernel, copy or set ran on the card (torch.profiler)."""

from benchmark.roofline import device_idle_pct


def read(run):
    return device_idle_pct(run)
