"""The port's spans and per-span counts (cha1_mcmc_tpu_torch/utils/metrics.py)
on the CPU: nesting, parents and trace ids, the ring's bound and drop
count, the mirroring of host-only spans to an open torch.profiler window
(and no profiler call without one), run_mcmc's spans and counts a block,
its syncs counted where each copy to the host happens, a split and
resumed run bitwise equal to an unsplit one with the spans on, a
fit's throughput.json holding every span name it ran, and the multifit's
`pipeline/k2_plan` span counting the cluster plan of K2's launch."""

import collections
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from cha1_mcmc_tpu_torch.utils import metrics
from tests.torch_parity import problem  # noqa: F401  (fixture)

torch.set_num_threads(1)

W, D = 16, 2


@pytest.fixture
def log(monkeypatch):
    """A fresh span log in the module's place."""
    fresh = metrics.SpanLog()
    monkeypatch.setattr(metrics, "_LOG", fresh)
    return fresh


def _gaussian_sampler():
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler

    cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)

    def lnprob(theta):
        return -0.5 * torch.einsum("wi,ij,wj->w", theta, prec, theta)

    return EnsembleSampler(lnprob_fn=lnprob, nwalkers=W, ndim=D, a=2.0,
                           dtype=torch.float64, device=torch.device("cpu"))


def _pos():
    return torch.as_tensor(np.random.default_rng(0).standard_normal((W, D)))


def test_spans_nest_with_parents_and_share_a_trace_id(log):
    with metrics.span("a/outer") as outer:
        with metrics.span("a/inner") as inner:
            inner.add(syncs=1, bytes=8)
            inner.add(syncs=2)
        with metrics.span("a/inner"):
            pass
    with metrics.span("a/other") as other:
        pass
    with metrics.trace(1234) as tid:
        with metrics.trace() as nested:
            with metrics.span("b/one") as one:
                pass
        with metrics.span("b/two") as two:
            pass
    recs = {r.id: r for r in metrics.spans()}
    assert recs[inner.id].parent == outer.id and recs[outer.id].parent is None
    assert recs[inner.id].trace == recs[outer.id].trace != recs[other.id].trace
    assert tid == nested == 1234 and recs[one.id].trace == recs[two.id].trace == 1234
    assert recs[one.id].parent is None
    assert recs[inner.id].counts == {"syncs": 3, "bytes": 8}
    r = recs[outer.id]
    assert r.t0 <= recs[inner.id].t0 <= recs[inner.id].t1 <= r.t1
    assert [x.name for x in metrics.spans()][:3] == ["a/inner", "a/inner", "a/outer"]
    totals = metrics.span_totals()
    assert totals["a/inner"][0] == 2 and totals["a/inner"][2] == {"syncs": 3, "bytes": 8}
    assert totals["a/outer"][1] >= totals["a/inner"][1] >= 0.0
    # the accessors copy: editing what they return changes nothing
    metrics.spans()[0].counts["syncs"] = 99
    metrics.span_totals()["a/inner"][2]["syncs"] = 99
    assert recs[inner.id].counts["syncs"] == 3
    assert metrics.span_totals()["a/inner"][2]["syncs"] == 3


def test_ring_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(metrics, "_LOG", metrics.SpanLog(ring=4))
    for i in range(10):
        with metrics.span("ring/s") as s:
            s.add(n=i)
    kept = metrics.spans()
    assert [r.counts["n"] for r in kept] == [6, 7, 8, 9]
    assert metrics.spans_dropped() == 6
    assert metrics.span_totals()["ring/s"][0] == 10          # totals drop nothing
    assert metrics.span_totals()["ring/s"][2]["n"] == sum(range(10))
    assert metrics.SPAN_RING >= 2 * 6_600 * 5


def test_host_spans_mirror_only_to_an_open_profiler(log, monkeypatch):
    """Only the host-only spans (sampler/record, sampler/checkpoint) reach
    a profiler window; spans that enclose device work (sampler/block,
    enqueue, fetch) do not. With no window open no profiler call is made."""
    from torch.profiler import ProfilerActivity, profile

    calls = collections.Counter()
    real = metrics.record_function

    def counting(name):
        calls[name] += 1
        return real(name)

    monkeypatch.setattr(metrics, "record_function", counting)
    sampler = _gaussian_sampler()
    sampler.run_mcmc(_pos(), 32, torch.Generator().manual_seed(1), checkpoint_every=16)
    assert not calls

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _gaussian_sampler().run_mcmc(_pos(), 32, torch.Generator().manual_seed(1),
                                     checkpoint_every=16)
    names = collections.Counter(e.name for e in prof.events())
    assert names["sampler/record"] == 2 == calls["sampler/record"]
    for name in ("sampler/block", "sampler/enqueue", "sampler/fetch"):
        assert names[name] == 0 and calls[name] == 0
    assert set(calls) == {"sampler/record"}


def test_run_mcmc_records_each_block_with_its_counts(log, tmp_path):
    sampler = _gaussian_sampler()
    sampler.run_mcmc(_pos(), 64, torch.Generator().manual_seed(2), checkpoint_every=16)
    recs = metrics.spans()
    blocks = [r for r in recs if r.name == "sampler/block"]
    assert len(blocks) == 4
    per_block = 16 * W * D * 8 + 16 * W * 8 + 8    # chain, lnps (f64), the int64 sum
    for b in blocks:   # no device_s on the CPU; the last block has no successor queued
        assert b.counts == {"syncs": 3, "d2h_bytes": per_block, "ahead": int(b != blocks[-1])}
        kids = [r.name for r in recs if r.parent == b.id]
        assert kids == ["sampler/enqueue", "sampler/fetch", "sampler/record"]
    assert len({r.trace for r in recs}) == 1
    assert {r.name for r in recs} == {"sampler/block", "sampler/enqueue",
                                      "sampler/fetch", "sampler/record"}

    # a second call is a trace of its own; a chain file adds the checkpoint
    chain_file = str(tmp_path / "chain.npy")
    _gaussian_sampler().run_mcmc(_pos(), 32, torch.Generator().manual_seed(2),
                                 checkpoint_every=32, chain_file=chain_file)
    new = [r for r in metrics.spans() if r.id > max(x.id for x in recs)]
    assert len({r.trace for r in new}) == 1 and new[0].trace != recs[0].trace
    (block,) = [r for r in new if r.name == "sampler/block"]
    assert block.counts["syncs"] == 5
    assert block.counts["d2h_bytes"] == 32 * W * D * 8 + 32 * W * 8 + 8 + W * D * 8 + W * 8
    (ckpt,) = [r for r in new if r.name == "sampler/checkpoint"]
    assert ckpt.parent == block.id
    assert ckpt.counts["bytes"] == (os.path.getsize(chain_file)
                                    + os.path.getsize(str(tmp_path / "chain.state.npz")))


def test_each_block_but_the_last_runs_with_its_successor_queued(log, tmp_path):
    """run_mcmc queues block b + 1 before it waits on block b: every block's
    span but the last counts `ahead` 1, the next block's enqueue ends before
    this block's fetch begins, and each block's enqueue, fetch, record and
    checkpoint are children of its own span, though the blocks' spans
    overlap; the blocks are children of the span run_mcmc was called in."""
    with metrics.span("test/caller") as caller:
        _gaussian_sampler().run_mcmc(_pos(), 64, torch.Generator().manual_seed(4),
                                     checkpoint_every=16,
                                     chain_file=str(tmp_path / "chain.npy"))
    recs = metrics.spans()
    blocks = [r for r in recs if r.name == "sampler/block"]
    assert [b.counts["ahead"] for b in blocks] == [1, 1, 1, 0]
    assert all(b.parent == caller.id and b.trace == caller.trace for b in blocks)
    kids = {b.id: {r.name: r for r in recs if r.parent == b.id} for b in blocks}
    for b in blocks:
        assert list(kids[b.id]) == ["sampler/enqueue", "sampler/fetch", "sampler/record",
                                    "sampler/checkpoint"]
        assert all(b.t0 <= r.t0 <= r.t1 <= b.t1 for r in kids[b.id].values())
    for b, after in zip(blocks, blocks[1:]):
        assert kids[after.id]["sampler/enqueue"].t1 <= kids[b.id]["sampler/fetch"].t0
        assert after.t0 < b.t1


def test_syncs_are_the_copies_to_the_host_a_block_makes(log, monkeypatch, tmp_path):
    """A block's `syncs` is counted where each copy to the host happens: it
    equals the Tensor calls that wait for the device (cpu, item, tolist and
    the scalar conversions) made while the block's span is open, sidecar
    included, so a copy added to or taken from the loop moves it."""
    waits = collections.Counter()

    def counting(name):
        real = getattr(torch.Tensor, name)

        def call(self, *args, **kwargs):
            if any(s.name == "sampler/block" for s in metrics._THREAD.open):
                waits[name] += 1
            return real(self, *args, **kwargs)
        return call

    for name in ("cpu", "item", "tolist", "__int__", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    _gaussian_sampler().run_mcmc(_pos(), 48, torch.Generator().manual_seed(3),
                                 checkpoint_every=16, chain_file=str(tmp_path / "c.npy"))
    blocks = [r for r in metrics.spans() if r.name == "sampler/block"]
    assert len(blocks) == 3
    assert sum(b.counts["syncs"] for b in blocks) == sum(waits.values()) == 3 * 5
    assert waits["cpu"] == 3 * 5


def test_split_and_resumed_run_is_bitwise_the_unsplit_one(log, tmp_path):
    whole = _gaussian_sampler()
    whole.run_mcmc(_pos(), 64, torch.Generator().manual_seed(5), checkpoint_every=16)

    chain_file = str(tmp_path / "chain.npy")
    first = _gaussian_sampler()
    first.run_mcmc(_pos(), 32, torch.Generator().manual_seed(5), checkpoint_every=16,
                   chain_file=chain_file)
    second = _gaussian_sampler()
    pos = second.preload(np.load(chain_file))
    pos, lnp0, rng_state = second.load_state(chain_file)
    gen = torch.Generator()
    gen.set_state(rng_state)
    second.run_mcmc(pos, 32, gen, checkpoint_every=16, lnp0=lnp0, chain_file=chain_file)
    np.testing.assert_array_equal(second.chain, whole.chain)
    np.testing.assert_array_equal(np.load(chain_file), whole.chain)
    assert second.accepted == whole.accepted
    assert sum(r.name == "sampler/block" for r in metrics.spans()) == 8


PIPELINE = ("pipeline/catalog", "pipeline/reduce", "pipeline/model", "pipeline/mle",
            "pipeline/walkers")
SAMPLER = ("sampler/prepare", "sampler/block", "sampler/enqueue", "sampler/fetch",
           "sampler/record", "sampler/checkpoint")


def test_fit_throughput_json_holds_every_span(problem, tmp_path, log):  # noqa: F811
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

    cfg = FitConfig(mol_name="hc5n_hfs", cat_folder=problem["cat_folder"],
                    data_path=problem["data_path"], fit_folder=str(tmp_path / "fit"),
                    nwalkers=16, nruns=24, checkpoint_every=24, seed=0, device="cpu")
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    with open(os.path.join(cfg.mol_folder, "throughput.json")) as fh:
        tp = json.load(fh)
    spans = tp["spans"]
    assert set(spans) == set(PIPELINE) | set(SAMPLER)
    assert spans["sampler/block"]["count"] == 1
    assert spans["sampler/block"]["counts"]["syncs"] == 5
    assert spans["pipeline/model"]["count"] == 3   # the model, the lnprobs, the sampler
    assert all(v["seconds"] >= 0.0 for v in spans.values())
    # one checkpoint: its bytes are the chain's and the sidecar's sizes
    assert spans["sampler/checkpoint"]["counts"]["bytes"] == (
        os.path.getsize(cfg.chain_path) + os.path.getsize(cfg.chain_path[:-4] + ".state.npz"))
    assert tp["device_busy_s"] is None          # no CUDA events on the CPU
    assert tp["walker_steps"] == 16 * 24 and tp["launches"] == {}
    # init_setup and fit are one trace
    ours = [r for r in metrics.spans() if r.trace == fit.throughput.trace_id]
    assert {r.name for r in ours} == set(PIPELINE) | set(SAMPLER)


def test_multifit_throughput_json_holds_its_spans(tmp_path, log):
    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig
    from tests.port_problems import write_hc9n_problem

    p = write_hc9n_problem(str(tmp_path), n_multiplets=4)
    cfg = MultiFitConfig(mol_name="hc9n_hfs", template_run=True,
                         cat_folder=p["cat_folder"], data_path=p["data_path"],
                         fit_folder=str(tmp_path / "fit"), nwalkers=32, nruns=8,
                         checkpoint_every=8, device="cpu")
    fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    with open(os.path.join(cfg.mol_folder, "throughput.json")) as fh:
        spans = json.load(fh)["spans"]
    assert set(spans) == (set(PIPELINE) - {"pipeline/mle"}) | set(SAMPLER)


@pytest.mark.parametrize("n_chains", [1, 2])
def test_multifit_k2_plan_span_counts_the_plan_of_its_launch(tmp_path, log, monkeypatch,
                                                             n_chains):
    """K2's set-up on the CPU, its eligibility forced (its runner's tables
    and its plain steps run there): one `pipeline/k2_plan` inside a
    `pipeline/model`, counting the plan of a launch of n_chains ensembles
    of 128 walkers, on the one-ensemble path and the K-chain path: off the
    card, where nothing is launched, the cluster plan and `wide` 0."""
    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig
    from cha1_mcmc_tpu_torch.pipeline import multifit
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi
    from tests.port_problems import write_hc9n_problem

    p = write_hc9n_problem(str(tmp_path), n_multiplets=2)
    cfg = MultiFitConfig(mol_name="hc9n_hfs", template_run=True,
                         cat_folder=p["cat_folder"], data_path=p["data_path"],
                         fit_folder=str(tmp_path / "fit"), nwalkers=128 * n_chains,
                         n_chains=n_chains, nruns=4, checkpoint_every=4, device="cpu")
    fit = MultiComponentFit(cfg)
    monkeypatch.setattr(fit, "_fused_eligible", lambda model: True)
    made = []
    real = multifit.make_fused_ensemble_multi
    monkeypatch.setattr(multifit, "make_fused_ensemble_multi",
                        lambda *args, **kw: made.append(real(*args, **kw)) or made[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    (runner,) = made
    lines, vel = runner.tables[:2]
    plan = cluster.plan_cluster(fused_multi.FAMILY, 128, 4, 14, lines.shape[1], vel.shape[1],
                                vel.shape[0], torch.float32, cluster=16)
    want = dict(components=4, ctas=16, wide=0, staged=1, smem_bytes=plan.smem_bytes,
                table_bytes=sum(t.numel() * t.element_size() for t in runner.tables))
    assert plan.fits and plan.staged
    ours = [r for r in metrics.spans() if r.trace == fit.throughput.trace_id]
    (k2,) = [r for r in ours if r.name == "pipeline/k2_plan"]
    parent = next(r for r in ours if r.id == k2.parent)
    assert parent.name == "pipeline/model" and parent.t0 <= k2.t0 <= k2.t1 <= parent.t1
    assert k2.counts == want
    with open(os.path.join(cfg.mol_folder, "throughput.json")) as fh:
        spans = json.load(fh)["spans"]
    assert spans["pipeline/k2_plan"]["count"] == 1
    # throughput.json's counts leave out what stayed 0 (`wide` off the card)
    assert spans["pipeline/k2_plan"]["counts"] == {k: v for k, v in want.items() if v}
