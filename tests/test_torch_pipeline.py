"""The flagship slice of the torch port against the JAX package, stage by
stage on the synthetic files (datagrid, model constants, MLE Ncol, walker
ball, lnp0), then the port's SpectralFit(..., device="cpu").run() end to
end, its refusals, and the import boundary of the port package.

Tolerances: datagrid and model arrays equal; MLE (f64) rel 1e-4; walker
ball equal given the same initial vector; lnp0 (f64) rtol 1e-12."""

import ast
import contextlib
import io
import json
import os
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import model_arrays, problem

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "cha1_mcmc_tpu_torch"


def _configs(problem, tmp_path, **kw):
    from cha1_mcmc_tpu import FitConfig as JaxConfig
    from cha1_mcmc_tpu_torch import FitConfig

    common = dict(mol_name="hc5n_hfs", cat_folder=problem["cat_folder"],
                  data_path=problem["data_path"], nwalkers=16, seed=0, **kw)
    return (JaxConfig(fit_folder=str(tmp_path / "jax"), **common),
            FitConfig(fit_folder=str(tmp_path / "port"), device="cpu", **common))


def test_slice_stage_by_stage_matches_jax(problem, tmp_path):
    from cha1_mcmc_tpu import SpectralFit as JaxFit
    from cha1_mcmc_tpu.inference import build_lnlike, build_lnprob, estimate_ncol_mle
    from cha1_mcmc_tpu.inference import single_component_lnprior
    from cha1_mcmc_tpu_torch import SpectralFit
    from cha1_mcmc_tpu_torch import inference as pinf
    from cha1_mcmc_tpu_torch.sampler import initialize_walkers

    jcfg, pcfg = _configs(problem, tmp_path, dtype="float64")
    jfit, pfit = JaxFit(jcfg), SpectralFit(pcfg)
    with contextlib.redirect_stdout(io.StringIO()):
        jgrid, pgrid = jfit.init_setup(), pfit.init_setup()
    for f in ("freqs", "ints", "yerrs", "covered_trans"):
        np.testing.assert_array_equal(getattr(pgrid, f), getattr(jgrid, f))
    assert os.path.exists(pcfg.datagrid_path)

    with jax.enable_x64():
        jm = jfit.build_model(jgrid)
        jarrays = model_arrays(jm)
        jspec = jfit.spec
        means, stds = np.asarray(jcfg.template_means), np.asarray(jcfg.template_stds)
        jlnprior = single_component_lnprior(jspec, jcfg.bounds, means, stds)
        j_ncol = estimate_ncol_mle(build_lnlike(jm, jspec, jgrid.ints, jgrid.yerrs),
                                   jspec, means, jcfg.bounds["Ncol"])
        jlnprob = jax.vmap(build_lnprob(jm, jspec, jgrid.ints, jgrid.yerrs, jlnprior))
    pm = pfit.build_model(pgrid)
    for name, a in jarrays.items():
        np.testing.assert_array_equal(getattr(pm, name).numpy(), a)
    assert pm.q_model.kind == "analytic" and pm.dtype == torch.float64

    pspec = pfit.spec
    p_ncol = pinf.estimate_ncol_mle(
        pinf.build_lnlike(pm, pspec, pgrid.ints, pgrid.yerrs), pspec, means,
        pcfg.bounds["Ncol"], device="cpu", dtype=torch.float64)
    assert p_ncol == pytest.approx(j_ncol, rel=1e-4)

    from cha1_mcmc_tpu.sampler import initialize_walkers as jax_init

    initial = means.copy()
    initial[0] = p_ncol
    pos_p = initialize_walkers(initial, stds, 16, pfit._is_within_bounds,
                               rng=np.random.default_rng(pcfg.seed))
    pos_j = jax_init(initial, stds, 16, jfit._is_within_bounds,
                     rng=np.random.default_rng(jcfg.seed))
    np.testing.assert_array_equal(pos_p, pos_j)

    plnprior = pinf.single_component_lnprior(pspec, pcfg.bounds, means, stds,
                                             dtype=torch.float64)
    lnp0_p = pinf.build_lnprob(pm, pspec, pgrid.ints, pgrid.yerrs, plnprior)(
        torch.as_tensor(pos_p)).numpy()
    with jax.enable_x64():
        lnp0_j = np.asarray(jlnprob(jnp.asarray(pos_p)))
    assert np.isfinite(lnp0_p).all()
    np.testing.assert_allclose(lnp0_p, lnp0_j, rtol=1e-12)


def test_spectral_fit_runs_end_to_end_on_cpu(problem, tmp_path):
    from cha1_mcmc_tpu_torch import EnsembleSampler, SpectralFit

    _, cfg = _configs(problem, tmp_path, nruns=32, checkpoint_every=16)
    fit = SpectralFit(cfg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chain = fit.run()
    log = out.getvalue()
    assert type(fit.sampler) is EnsembleSampler     # the CPU selection rule
    assert chain.shape == (16, 32, 4) and np.isfinite(chain).all()
    assert 0.05 < fit.sampler.acceptance_fraction < 0.95
    np.testing.assert_array_equal(np.load(cfg.chain_path), chain)
    state = np.load(cfg.chain_path[:-4] + ".state.npz")
    assert str(state["package"]) == "cha1_mcmc_tpu_torch"
    with open(os.path.join(cfg.mol_folder, "config.json")) as fh:
        saved = json.load(fh)
    assert saved["device"] == "cpu" and saved["nruns"] == 32
    with open(os.path.join(cfg.mol_folder, "throughput.json")) as fh:
        tp = json.load(fh)
    assert tp["walker_steps"] == 16 * 32 and tp["device"] == "cpu"
    assert tp["sampler"] == "EnsembleSampler"
    assert "Successful MLE fit" in log and "MCMC sampling: 32/32" in log
    # the summary table is always printed; the corner plot where matplotlib is
    assert "Median Estimate" in log or "Ncol [cm⁻²]:" in log
    try:
        import matplotlib  # noqa: F401
        assert os.path.exists(cfg.chain_path[:-4] + "_corner.png")
    except ImportError:
        assert "no corner plot" in log


def test_resume_continues_the_stream(problem, tmp_path):
    """resume=True continues from the tagged sidecar: a 16 + 16 step fit
    equals a 32-step fit bitwise (same checkpoint blocks)."""
    from cha1_mcmc_tpu_torch import SpectralFit

    _, full = _configs(problem, tmp_path / "full", nruns=32, checkpoint_every=16,
                       MLE_for_Ncol=False)
    _, part = _configs(problem, tmp_path / "part", nruns=16, checkpoint_every=16,
                       MLE_for_Ncol=False)
    with contextlib.redirect_stdout(io.StringIO()):
        ref = SpectralFit(full).fit(SpectralFit(full).init_setup())
        fit = SpectralFit(part)
        grid = fit.init_setup()
        fit.fit(grid)
        part.resume = True
        resumed = SpectralFit(part)
        chain = resumed.fit(grid)
    assert chain.shape == (16, 32, 4)
    np.testing.assert_array_equal(chain, ref)


def test_cuda_device_without_cuda_raises(problem, tmp_path):
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal applies without one")
    cfg = FitConfig(mol_name="hc5n_hfs", cat_folder=problem["cat_folder"],
                    data_path=problem["data_path"], fit_folder=str(tmp_path))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpectralFit(cfg)


@pytest.mark.parametrize("kw,item", [
    (dict(n_devices=2), "P14"), (dict(n_chains=2), "P15"),
    (dict(profile_dir="trace"), "P13")])
def test_branches_outside_the_slice_raise(problem, tmp_path, kw, item):
    from cha1_mcmc_tpu_torch import SpectralFit

    _, cfg = _configs(problem, tmp_path, **kw)
    if item == "P14":
        # ported: a sharded fit needs a torch.distributed world of
        # n_devices ranks (tests/test_torch_parallel.py runs one)
        fit = SpectralFit(cfg)
        assert fit.sharded
        with pytest.raises(ValueError, match="world holds 1 ranks"), \
                contextlib.redirect_stdout(io.StringIO()):
            fit.run()
        return
    # P15 and P13 are ported: n_chains and profile_dir are taken (their
    # fits run in tests/test_torch_multichain.py)
    fit = SpectralFit(cfg)
    assert (fit.config.n_chains, fit.config.profile_dir) == (
        kw.get("n_chains", 1), kw.get("profile_dir"))


def test_selection_rule(problem, tmp_path):
    """K1 is chosen only on a CUDA device, for float32, with use_fused_step
    and a working set that fits a CTA (JAX fit.py:319-339)."""
    from cha1_mcmc_tpu_torch import SpectralFit

    _, cfg = _configs(problem, tmp_path)
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        model = fit.build_model(fit.init_setup())
    assert not fit._use_fused(model)            # CPU: the general sampler
    fit.device = torch.device("cuda")           # the rule alone, no card used
    assert fit._use_fused(model)
    fit.config.use_fused_step = False
    assert not fit._use_fused(model)
    fit.config.use_fused_step = True
    fit.dtype = torch.float64
    assert not fit._use_fused(model)


def test_fit_config_roundtrip(tmp_path):
    from cha1_mcmc_tpu_torch import FitConfig

    cfg = FitConfig.from_dict({"mol_name": "hc5n_hfs", "parallelize": True,
                               "data_paths": {"hc5n_hfs": "x.npy"},
                               "device": "cpu", "unknown": 1})
    assert (cfg.data_path, cfg.device, cfg.ndim) == ("x.npy", "cpu", 4)
    assert cfg.template_means == (3.4e10, 8.0, 4.3, 0.7575)
    path = str(tmp_path / "c.json")
    cfg.to_json(path)
    with open(path) as fh:
        assert json.load(fh)["device"] == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "cha1_mcmc_tpu")]
    assert bad == []
    smoke = PORT.parent / "chip_smoke.py"
    assert not [m for m in _imports(smoke)
                if m.split(".")[0] in ("jax", "jaxlib", "cha1_mcmc_tpu")]
    assert (PORT / "csrc" / "fused_step.cu").exists()
