"""The benchmark's plain reference against the program on the CPU, on the
flagship problem and the small dense band: the catalog, the reduction
(bitwise), the float64 posterior, and the frozen roofline counts against
the program's utils/roofline.py at this commit (the same operations; the
frozen count's bytes, each in-window term read once, no more than the
program's padded tables)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import roofline  # noqa: E402
from benchmark.check import Reference  # noqa: E402
from benchmark.run import Bench, problem_fitkw  # noqa: E402


def problem(name, tmp_path):
    """(config, fit fields) of a configuration on the CPU, the dense one
    on its small band."""
    bench = Bench()
    config = next(bench.config(w) for w in bench.spec["workloads"]
                  if w["config"] == name)
    if name == "dense-rotor":
        config["problem"]["args"]["scale"] = "small"
        config["fit"]["lower_limit"], config["fit"]["upper_limit"] = 9700.0, 10500.0
    return config, problem_fitkw(config, str(tmp_path))


def program_model(fitkw, dtype=torch.float64):
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.models.forward import SpectralModel
    from cha1_mcmc_tpu_torch.reduce.datagrid import reduce_spectrum

    cat = load_catalog(f"{fitkw['cat_folder']}/{fitkw['mol_name']}.cat",
                       name=fitkw["mol_name"])
    grid = reduce_spectrum(cat, fitkw["data_path"], ll=fitkw["lower_limit"],
                           ul=fitkw["upper_limit"], aligned_velocity=fitkw["aligned_velocity"],
                           dish_size=fitkw["dish_size"], source_size=fitkw["fixed_source_size"],
                           verbose=False)
    model = SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                                ll=fitkw["lower_limit"], ul=fitkw["upper_limit"],
                                dish_size=fitkw["dish_size"],
                                vel_offset=fitkw["aligned_velocity"],
                                mask_center=fitkw["aligned_velocity"], device="cpu",
                                dtype=dtype)
    return cat, grid, model, ParamSpec(ncomp=1, fixed_source_size=fitkw["fixed_source_size"])


def thetas(fitkw, n, seed):
    """n thetas around the template, some outside the prior box."""
    rng = np.random.default_rng(seed)
    means = np.asarray(fitkw["template_means"][1:], np.float64)
    stds = np.asarray(fitkw["template_stds"][1:], np.float64)
    th = means + rng.normal(size=(n, 4)) * stds * np.array([1.0, 0.5, 2.0, 1.0])
    th[:, 0] = np.abs(th[:, 0]) + 1e9
    return th


@pytest.mark.parametrize("name", ["hc5n-cha1", "dense-rotor"])
def test_reference_catalog_and_reduction_equal_the_programs(name, tmp_path):
    config, fitkw = problem(name, tmp_path)
    cat, grid, _, _ = program_model(fitkw)
    ref = Reference(fitkw, config["partition"], "cpu")
    np.testing.assert_array_equal(ref.cat.frequency, cat.frequency)
    np.testing.assert_array_equal(ref.cat.glow, cat.glow)
    np.testing.assert_allclose(ref.cat.aij, cat.aij, rtol=1e-13)
    for got, want in zip(ref.grid, (grid.freqs, grid.ints, grid.yerrs, grid.covered_trans)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["hc5n-cha1", "dense-rotor"])
def test_reference_posterior_equals_the_programs_in_float64(name, tmp_path):
    from cha1_mcmc_tpu_torch.inference import build_lnprob, single_component_lnprior

    config, fitkw = problem(name, tmp_path)
    _, grid, model, spec = program_model(fitkw)
    means, stds = fitkw["template_means"][1:], fitkw["template_stds"][1:]
    lnprior = single_component_lnprior(spec, {k: tuple(v) for k, v in fitkw["bounds"].items()},
                                       means, stds, dtype=torch.float64)
    lnprob = build_lnprob(model, spec, grid.ints, grid.yerrs, lnprior)
    th = thetas(fitkw, 64, 1)
    want = lnprob(torch.as_tensor(th)).numpy()
    got, scale = Reference(fitkw, config["partition"], "cpu").post.lnprob(th)
    assert np.isfinite(want).sum() > 16 and np.array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    assert np.max(np.abs(got[ok] - want[ok]) / scale[ok]) < 1e-12


def test_frozen_k1_count_equals_the_programs(tmp_path):
    from cha1_mcmc_tpu_torch.sampler import make_fused_ensemble
    from cha1_mcmc_tpu_torch.utils import roofline as program

    config, fitkw = problem("hc5n-cha1", tmp_path)
    _, grid, model, spec = program_model(fitkw, torch.float32)
    bounds = {k: tuple(v) for k, v in fitkw["bounds"].items()}
    run = make_fused_ensemble(model, spec, grid.ints, grid.yerrs, bounds,
                              fitkw["template_means"][1:], fitkw["template_stds"][1:])
    post = Reference(fitkw, config["partition"], "cpu").post
    dv = thetas(fitkw, 128, 2)[:, 3].clip(0.45, 1.45)
    want = program.k1_work(run.tables, run.statics, torch.as_tensor(dv, dtype=torch.float32),
                           evaluations=16)
    got = _frozen(post, dv)
    assert got[:2] == tuple(want[:2]) and got[2] <= want[2]
    assert roofline.bound_s(*got)[0] * 1e3 == pytest.approx(program.bound(*want)[0])


def test_frozen_k3_count_equals_the_programs(tmp_path):
    from cha1_mcmc_tpu_torch.catalogs.partition import fit_device_cheb
    from cha1_mcmc_tpu_torch.sampler.fused_gather import make_fused_ensemble_gather
    from cha1_mcmc_tpu_torch.utils import roofline as program

    config, fitkw = problem("dense-rotor", tmp_path)
    _, grid, model, spec = program_model(fitkw, torch.float32)
    bounds = {k: tuple(v) for k, v in fitkw["bounds"].items()}
    model = model.with_q_model(fit_device_cheb(model.q_model, *bounds["Tex"]))
    run = make_fused_ensemble_gather(model, spec, grid.ints, grid.yerrs, bounds,
                                     fitkw["template_means"][1:], fitkw["template_stds"][1:],
                                     dv_max=bounds["dV"][1])
    post = Reference(fitkw, config["partition"], "cpu").post
    dv = thetas(fitkw, 128, 3)[:, 3].clip(0.45, 1.45)
    want = program.k3_work(run.geometry, run.tables, run.statics,
                           torch.as_tensor(dv, dtype=torch.float32), evaluations=16)
    got = _frozen(post, dv)
    assert got[:2] == tuple(want[:2]) and got[2] <= want[2]


def _frozen(post, dv):
    dist = post.pair_dist.double().numpy()
    La = int(np.unique(post.pair_line.numpy()).size)
    dv32 = np.asarray(dv, np.float32).astype(np.float64)
    return roofline.step_work(La, post.n_channels, dist.size, dist, dv32, 16)
