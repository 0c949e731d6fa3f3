"""sampler.block_gap_us (us/block): the mean `gap_s` of the untraced
requests' `sampler/block` spans: the card's time from one block's last
kernel to the next block's first step-kernel launch in the same
`run_mcmc` call (CUDA events; a call's first block has none). It holds
the fetch's copies to the host, the host's record, and the next block's
draws and their layout. None on the CPU."""

from benchmark.program_spans import blocks, untraced


def read(run):
    spans = blocks(untraced(run))
    gaps = [s.counts["gap_s"] for s in spans or () if "gap_s" in s.counts]
    if not gaps:
        return None
    return 1e6 * sum(gaps) / len(gaps)
