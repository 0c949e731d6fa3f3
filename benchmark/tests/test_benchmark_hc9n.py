"""The cell `hc9n-chain` on the CPU: its configuration file, the metrics
BENCHMARK.json gives it, and its two readers of what no other cell has:
`k2_roofline` (benchmark/roofline_k2.py, a frozen copy of the program's
K2 count, held to the program's on the same problem) on a hand-made
traced run, and `setup.k2_plan_s` (the program's `pipeline/k2_plan`
span).

    python -m pytest benchmark/tests -q"""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, roofline, roofline_k2  # noqa: E402
from benchmark import run as harness  # noqa: E402
from benchmark.tests.small_cells import HC9N_CONFIG  # noqa: E402

CONFIG = ROOT / "benchmark" / "configs" / "hc9n-gotham.json"


def small_problem(tmp_path, n_multiplets=2):
    """(config, fit fields, reference) of the HC9N configuration on
    `n_multiplets` of its multiplets."""
    config = json.loads(CONFIG.read_text())
    config["problem"]["args"]["n_multiplets"] = n_multiplets
    fitkw = harness.problem_fitkw(config, str(tmp_path / "problem"))
    return config, fitkw, check.Reference(fitkw, config, "cpu")


def traced(nsteps, launches, kernels, dv):
    class Traced:
        requests = [dict(nsteps=nsteps, final_pos=np.column_stack(
            [np.full((len(dv), 13), 1.0), dv]))]
        result = dict(kernels=kernels, busy_s=1.0, window_s=1.0)

    Traced.launches = launches
    return Traced


def test_the_configuration_is_the_tested_one_with_its_limits_and_cut():
    listed, tested = json.loads(CONFIG.read_text()), json.loads(HC9N_CONFIG.read_text())
    assert set(listed) - set(tested) == {"cut"} and set(tested) <= set(listed)
    for key in tested:
        if key != "limits":
            assert listed[key] == tested[key], key
    assert set(listed["limits"]) == set(tested["limits"])
    assert listed["reduced"] == ["spectrum", "catalog"] and "synthetic" in listed["cut"]


def test_the_cell_reports_its_metrics_and_not_the_single_component_ones():
    bench = harness.Bench()
    cell = bench.cell("hc9n-chain")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hc9n-gotham", "chains-64k", 1)
    assert bench.config(cell) == json.loads(CONFIG.read_text())
    assert {m["name"] for m in bench.metrics(cell, "end_to_end")} == {
        "setup_s", "chain.walker_steps_per_s"}
    assert {m["name"] for m in bench.metrics(cell, "per_layer")} == {
        "chain.launches_per_kstep", "k2_roofline", "chain.device_idle_pct",
        "sampler.device_idle_pct", "sampler.block_gap_us", "sampler.syncs_per_block",
        "setup.catalog_s", "setup.model_s", "sampler.ahead_share", "setup.k2_plan_s"}
    others = {m["name"] for w in ("hc5n-chain", "dense-chain")
              for m in bench.metrics(bench.cell(w), "per_layer")}
    assert not {"k2_roofline", "setup.k2_plan_s"} & others


def test_k2_roofline_reads_the_hand_counted_share(tmp_path):
    _, _, ref = small_problem(tmp_path)
    post = ref.post
    dv = np.array([0.05, 0.117, 0.2, 0.29] * 32)
    # 512 steps in 32 launches: 16 steps a launch, 40 us each, 2.5 us a step
    run = harness.Run([], {}, traced(512, {"multi_steps": 32},
                                     {"multi_cluster_steps_kernel": [30.0, 50.0],
                                      "k1_cluster_steps_kernel": [1.0]}, dv), ref)
    # the hand count: 4 components, 128 rows, 16 evaluations a launch
    La = int(np.unique(post.pair_line.numpy()).size)
    C = post.n_channels
    M = int(np.bincount(post.pair_chan.numpy(), minlength=C).max())
    dist = post.pair_dist.numpy()
    win = sum(int((dist < 10.0 * d).sum()) for d in dv)
    sfu = 16 * (6 * 128 * 4 * La + 4 * win + 128 * C * 11) + 7 * C
    flop = 16 * (20 * 128 * 4 * La + 24 * win + 128 * C * 50) + 12 * C
    nbytes = 4 * (5 * La + 3 * M * C + 3 * C)
    least = max(sfu / roofline.SFU_RATE, flop / roofline.FLOP_RATE,
                nbytes / roofline.MEM_RATE) / 16
    assert La > 0 and M > 0 and 0 < win < 128 * dist.size
    got = harness.Bench().reader("k2_roofline")(run)
    assert got == pytest.approx(100.0 * least / 2.5e-6, rel=1e-12)
    assert 0.0 < got < 100.0


@pytest.mark.parametrize("launches,trace", [({}, True), ({"fused_steps": 32}, True),
                                            ({"multi_steps": 32}, False)])
def test_k2_roofline_reads_nothing_without_a_traced_k2_launch(launches, trace, tmp_path):
    _, _, ref = small_problem(tmp_path)
    T = traced(512, launches, {"multi_cluster_steps_kernel": [40.0],
                               "k1_cluster_steps_kernel": [40.0]}, np.full(128, 0.117))
    if not trace:
        T.result = None
    assert harness.Bench().reader("k2_roofline")(harness.Run([], {}, T, ref)) is None


@pytest.mark.parametrize("n_multiplets", [2, 22])
def test_the_frozen_count_is_the_programs_k2_work(n_multiplets, tmp_path):
    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig
    from cha1_mcmc_tpu_torch.sampler.fused_multi import multi_statics_tables
    from cha1_mcmc_tpu_torch.utils.roofline import k2_work

    config, fitkw, ref = small_problem(tmp_path, n_multiplets)
    f = config["fit"]
    fit = MultiComponentFit(MultiFitConfig(**dict(fitkw, dtype="float64"), device="cpu",
                                           fit_folder=str(tmp_path / "fit")))
    with contextlib.redirect_stdout(io.StringIO()):
        grid = fit.init_setup()
        model = fit.build_model(grid)
    _, tables = multi_statics_tables(model, fit.spec, grid.ints, grid.yerrs,
                                     f["template_means"], f["template_stds"],
                                     dv_max=f["dv_bound"])
    dv = np.random.default_rng(n_multiplets).uniform(0.02, 0.3, 128)
    for k in (1, 16):
        want = k2_work(tables, 4, torch.as_tensor(dv), model.mask_center, evaluations=k)
        assert roofline_k2.problem_work(ref.post, dv, k) == tuple(want)


def test_setup_k2_plan_s_reads_the_span_or_nothing(monkeypatch):
    from cha1_mcmc_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "_LOG", metrics.SpanLog())
    read = harness.Bench().reader("setup.k2_plan_s")
    with metrics.span("pipeline/model"):
        pass
    assert read(None) is None
    with metrics.span("pipeline/model"):
        with metrics.span("pipeline/k2_plan") as s:
            s.add(ctas=16)
    assert read(None) == pytest.approx(metrics.span_totals()["pipeline/k2_plan"][1])
    assert read(None) > 0.0
