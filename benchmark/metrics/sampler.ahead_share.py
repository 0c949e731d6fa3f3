"""sampler.ahead_share (%): the share of the window's `sampler/block` spans
whose `ahead` count is 1, that is, whose successor `run_mcmc` had queued on
the device before the host waited on the block's copies (a call's last
block, and a retried one, count 0). None on a checkout whose blocks carry
no `ahead` count."""

from benchmark.program_spans import blocks


def read(run):
    spans = [s for s in blocks(run.records) or () if "ahead" in s.counts]
    if not spans:
        return None
    return 100.0 * sum(s.counts["ahead"] == 1 for s in spans) / len(spans)
