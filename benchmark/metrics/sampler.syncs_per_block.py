"""sampler.syncs_per_block (syncs/block): the host synchronisations
`run_mcmc` counts at its call sites (`syncs` of its `sampler/block`
spans) over the window's requests, per block."""

from benchmark.program_spans import blocks


def read(run):
    spans = blocks(run.records)
    if not spans:
        return None
    return sum(s.counts.get("syncs", 0) for s in spans) / len(spans)
