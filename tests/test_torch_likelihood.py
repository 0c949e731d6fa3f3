"""Model, likelihood, prior and MLE of the torch port against the JAX
package, on the synthetic flagship problem with identical constants
(model_from_arrays).

Tolerances: lnprior / lnlike / lnprob f32 rtol 1e-5, f64 rtol 1e-12; the
device MLE (f64) rel 1e-4 — its final bracket is below
1e-2 cm^-2 wide (11 rounds: a log round over [1e8, 1e14], then ten linear
rounds each contracting by 32), so the two packages differ only where
their lnlike values (equal to ~1e-12) order the grid points differently
near the flat maximum."""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import (TRUTH_4, TRUTH_5, jax_model, jax_reduce,
                                model_arrays, port_model, problem,
                                spec_and_prior, walker_ball)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reduced(problem):
    return jax_reduce(problem)


def _scope(dtype):
    return jax.enable_x64() if dtype == "float64" else contextlib.nullcontext()


def _thetas(ndim, seed=3, n=64):
    """64 thetas: a walker ball around the truth plus wider draws, some
    outside the prior box (their lnprob is -inf in both packages)."""
    center = TRUTH_4 if ndim == 4 else TRUTH_5
    th = walker_ball(center, n, seed, scale=0.05)
    th[::8, -2] = 6.0          # vlsr outside (3.0, 5.5)
    th[1::16, -4] = 1e15       # Ncol outside (1e8, 1e14)
    return th


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_model_from_arrays_carries_the_jax_constants(reduced, dtype):
    cat, grid = reduced
    with _scope(dtype):
        jm = jax_model(cat, grid, dtype)
        arrays = model_arrays(jm)
    pm = port_model(jm, getattr(torch, dtype))
    for name, a in arrays.items():
        assert getattr(pm, name).dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(getattr(pm, name).numpy(), a)
    assert (pm.mask_center, pm.dish_size, pm.Tbg, pm.vel_offset) == (
        jm.mask_center, jm.dish_size, jm.Tbg, jm.vel_offset)
    assert (pm.n_lines, pm.n_channels) == (jm.n_lines, jm.n_channels) == (9, 561)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spectral_model_build_matches_jax(reduced, problem, dtype):
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.models import SpectralModel

    cat, grid = reduced
    with _scope(dtype):
        arrays = model_arrays(jax_model(cat, grid, dtype))
    pm = SpectralModel.build(load_catalog(problem["cat_path"]), grid.covered_trans,
                             grid.freqs, ll=18000.0, ul=25000.0, dish_size=70.0,
                             vel_offset=4.10, mask_center=4.10, device="cpu",
                             dtype=getattr(torch, dtype))
    for name, a in arrays.items():
        np.testing.assert_array_equal(getattr(pm, name).numpy(), a)


def _build_both(reduced, ndim, dtype, q_model=None):
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnlike, build_lnprob,
                                         single_component_lnprior)
    from cha1_mcmc_tpu_torch import inference as pinf

    cat, grid = reduced
    ss, means, stds, bounds = spec_and_prior(ndim)
    with _scope(dtype):
        jm = jax_model(cat, grid, dtype, q_model=q_model)
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        jprior = single_component_lnprior(spec, bounds, means, stds)
        jfns = (jprior, build_lnlike(jm, spec, grid.ints, grid.yerrs),
                build_lnprob(jm, spec, grid.ints, grid.yerrs, jprior))
    pspec = pinf.ParamSpec(ncomp=1, fixed_source_size=ss)
    pm = port_model(jm, getattr(torch, dtype))
    pprior = pinf.single_component_lnprior(pspec, bounds, means, stds,
                                           dtype=getattr(torch, dtype))
    pfns = (pprior, pinf.build_lnlike(pm, pspec, grid.ints, grid.yerrs),
            pinf.build_lnprob(pm, pspec, grid.ints, grid.yerrs, pprior))
    return jfns, pfns


@pytest.mark.parametrize("ndim,dtype", [(4, "float32"), (4, "float64"),
                                        (5, "float32"), (5, "float64")])
def test_lnlike_and_lnprob_match_jax(reduced, ndim, dtype):
    (jprior, jlike, jprob), (pprior, plike, pprob) = _build_both(reduced, ndim, dtype)
    th = _thetas(ndim)
    rtol = 1e-5 if dtype == "float32" else 1e-12
    with _scope(dtype):
        tj = jnp.asarray(th, dtype)
        refs = [np.asarray(jax.vmap(f)(tj)) for f in (jprior, jlike, jprob)]
    tp = torch.as_tensor(np.array(tj), dtype=getattr(torch, dtype))
    for ref, fn in zip(refs, (pprior, plike, pprob)):
        out = fn(tp).numpy()
        assert out.shape == (64,) and out.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(out[fin], ref[fin], rtol=rtol)
    lnprob = pprob(tp).numpy()
    assert np.isfinite(lnprob).sum() >= 48 and not np.isfinite(lnprob[::8]).any()


@pytest.mark.parametrize("q_kind", ["states", "cheb"])
def test_lnprob_with_state_sum_and_chebyshev_q(reduced, q_kind):
    from cha1_mcmc_tpu.catalogs.partition import _state_sum_model, fit_device_cheb

    cat, _ = reduced
    q = _state_sum_model(cat)
    if q_kind == "cheb":
        q = fit_device_cheb(q, 3.5, 12.0)
    (_, _, jprob), (_, _, pprob) = _build_both(reduced, 4, "float64", q_model=q)
    th = _thetas(4, seed=4)
    with jax.enable_x64():
        ref = np.asarray(jax.vmap(jprob)(jnp.asarray(th)))
    out = pprob(torch.as_tensor(th)).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-12)


def test_forward_model_is_walker_batched(reduced):
    """(N, C) forward over N walkers equals N single-walker calls, and the
    JAX per-walker forward, in f64."""
    cat, grid = reduced
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
        th = _thetas(4, seed=5, n=8)[:, :]
        refs = np.stack([np.asarray(jm.forward(52.0, t[0], t[1], t[2], t[3]))
                         for t in th])
    pm = port_model(jm, torch.float64)
    t = torch.as_tensor(th)
    ss = torch.full((8, 1), 52.0, dtype=torch.float64)
    batched = pm(ss, t[:, 0:1], t[:, 1], t[:, 2:3], t[:, 3])
    assert batched.shape == (8, 561)
    # atol: in the far line wings opac ~ 1e-16 and 1 - exp(-opac) keeps
    # only a few bits in f64 (values ~1e-15 K against peaks ~2e-2 K)
    np.testing.assert_allclose(batched.numpy(), refs, rtol=1e-12, atol=1e-15)
    one = pm(ss[:1], t[:1, 0:1], t[:1, 1], t[:1, 2:3], t[:1, 3])
    np.testing.assert_allclose(one.numpy()[0], batched.numpy()[0], rtol=1e-14)


@pytest.mark.parametrize("ndim", [4, 5])
def test_mle_device_search_matches_jax(reduced, ndim):
    from cha1_mcmc_tpu.inference import ParamSpec, build_lnlike, estimate_ncol_mle
    from cha1_mcmc_tpu.inference.mle import _GRID_K
    from cha1_mcmc_tpu_torch import inference as pinf
    from cha1_mcmc_tpu_torch.inference.mle import mle_rounds

    cat, grid = reduced
    ss, means, _, bounds = spec_and_prior(ndim)
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        ref = estimate_ncol_mle(build_lnlike(jm, spec, grid.ints, grid.yerrs),
                                spec, means, bounds["Ncol"])
    pspec = pinf.ParamSpec(ncomp=1, fixed_source_size=ss)
    plike = pinf.build_lnlike(port_model(jm, torch.float64), pspec, grid.ints,
                              grid.yerrs)
    est = pinf.estimate_ncol_mle(plike, pspec, means, bounds["Ncol"],
                                 device="cpu", dtype=torch.float64)
    assert _GRID_K == 65 and mle_rounds(bounds["Ncol"], torch.float64) == 11
    assert mle_rounds(bounds["Ncol"], torch.float32) == 6
    assert est == pytest.approx(ref, rel=1e-4)
    assert 1e12 < est < 1e13       # near the injected 3.2e12


def test_mle_scipy_method_agrees_with_device_search(reduced):
    from cha1_mcmc_tpu_torch import inference as pinf

    (_, jlike, _), (_, plike, _) = _build_both(reduced, 4, "float64")
    pspec = pinf.ParamSpec(ncomp=1, fixed_source_size=52.0)
    dev = pinf.estimate_ncol_mle(plike, pspec, spec_and_prior(4)[1], (1e8, 1e14),
                                 device="cpu", dtype=torch.float64)
    sci = pinf.estimate_ncol_mle(plike, pspec, spec_and_prior(4)[1], (1e8, 1e14),
                                 method="scipy", device="cpu", dtype=torch.float64)
    assert sci == pytest.approx(dev, rel=1e-3)
