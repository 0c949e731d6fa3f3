"""K1 (cha1_mcmc_tpu_torch/sampler/fused.py): the plain PyTorch version of
the fused whole-step kernel against the JAX package's Pallas kernel
(cha1_mcmc_tpu/sampler/fused.py:make_fused_ensemble) run in interpret mode,
as tests/test_pallas.py runs it, on the synthetic flagship problem with the
same randomness.

Tolerances: float64 chains and acceptances bitwise, lnps rtol 1e-12
(reduction order differs); float32 lnps rtol 1e-5. The CUDA kernel itself
is compared with this plain version on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import contextlib
import ctypes
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import (TRUTH_4, TRUTH_5, jax_model, jax_randomness,
                                jax_reduce, port_model, problem, spec_and_prior,
                                to_torch, walker_ball)

torch.set_num_threads(1)

W, NSTEPS, K = 16, 8, 4


@pytest.fixture(scope="module")
def reduced(problem):
    return jax_reduce(problem)


def _q_model(cat, q_kind):
    from cha1_mcmc_tpu.catalogs.partition import _state_sum_model, fit_device_cheb

    if q_kind == "analytic":
        return None
    states = _state_sum_model(cat)
    return states if q_kind == "states" else fit_device_cheb(states, 3.5, 12.0)


def _run_both(reduced, ndim, q_kind, dtype, key_seed, pos_edit=None,
              bounds=None, center=None):
    """JAX fused kernel (interpret) and the port's plain K1 on the same
    model constants, start and randomness. Returns ((chain, lnps, acc,
    (pos, lnp)) JAX as numpy, the same for the port, lnp0)."""
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnprob,
                                         single_component_lnprior)
    from cha1_mcmc_tpu.sampler.fused import make_fused_ensemble
    from cha1_mcmc_tpu_torch.inference import ParamSpec as PortSpec
    from cha1_mcmc_tpu_torch.sampler.fused import make_fused_ensemble as port_make

    cat, grid = reduced
    ss, means, stds, default_bounds = spec_and_prior(ndim)
    bounds = bounds or default_bounds
    scope = jax.enable_x64() if dtype == "float64" else contextlib.nullcontext()
    with scope:
        jm = jax_model(cat, grid, dtype, q_model=_q_model(cat, q_kind))
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        lnprob = build_lnprob(jm, spec, grid.ints, grid.yerrs,
                              single_component_lnprior(spec, bounds, means, stds))
        run = make_fused_ensemble(jm, spec, grid.ints, grid.yerrs, bounds,
                                  means, stds, interpret=True)
        pos0 = walker_ball(center if center is not None else
                           (TRUTH_4 if ndim == 4 else TRUTH_5), W, key_seed)
        if pos_edit is not None:
            pos_edit(pos0)
        pos0 = jnp.asarray(pos0, dtype)
        lnp0 = jax.vmap(lnprob)(pos0)
        key = jax.random.PRNGKey(key_seed)
        cj, lj, aj, (pj, lpj) = run(pos0, lnp0, key, NSTEPS, K)
        out_j = tuple(np.asarray(t) for t in (cj, lj, aj, pj, lpj))
        rnd = jax_randomness(key, NSTEPS, W, dtype)
        pos0, lnp0 = np.array(pos0), np.array(lnp0)
    pm = port_model(jm, getattr(torch, dtype))
    prun = port_make(pm, PortSpec(ncomp=1, fixed_source_size=ss), grid.ints,
                     grid.yerrs, bounds, means, stds)
    cp, lp, ap, (pp, lpp) = prun(torch.from_numpy(pos0), torch.from_numpy(lnp0),
                                 NSTEPS, K, randomness=to_torch(rnd))
    out_p = tuple(t.numpy() for t in (cp, lp, ap, pp, lpp))
    return out_j, out_p, lnp0


@pytest.mark.parametrize("ndim,q_kind", [(4, "analytic"), (5, "analytic"),
                                         (4, "states"), (5, "cheb")])
def test_plain_k1_matches_jax_fused_kernel_f64(reduced, ndim, q_kind):
    (cj, lj, aj, pj, lpj), (cp, lp, ap, pp, lpp), _ = _run_both(
        reduced, ndim, q_kind, "float64", key_seed=9)
    assert cp.shape == (NSTEPS, W, ndim) and cp.dtype == np.float64
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(pp, pj)
    np.testing.assert_allclose(lp, lj, rtol=1e-12)
    np.testing.assert_allclose(lpp, lpj, rtol=1e-12)
    assert 0 < ap.sum() < NSTEPS * W       # moves were both taken and refused


def test_plain_k1_matches_jax_fused_kernel_f32(reduced):
    (cj, lj, aj, _, _), (cp, lp, ap, _, _), _ = _run_both(
        reduced, 4, "analytic", "float32", key_seed=3)
    assert cp.dtype == np.float32
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    # with no marginal acceptance on this stream the f32 chains agree too
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ap, aj)


def test_never_accepting_walker_reports_minus_inf(reduced):
    """F4: a walker that starts outside the prior (lnp0 = -inf) and never
    accepts is recorded as -inf, exactly where the JAX kernel records it
    (the port needs no finfo.min clamp: it has no one-hot products)."""
    def edit(pos0):
        pos0[3, 2] = 9.0       # vlsr far outside the box
        pos0[3, 3] = 0.05

    bounds = {"Ncol": (1e8, 1e14), "Tex": (7.0, 8.0),
              "vlsr": (4.05, 4.17), "dV": (0.75, 0.81)}
    (cj, lj, aj, pj, lpj), (cp, lp, ap, pp, lpp), lnp0 = _run_both(
        reduced, 4, "analytic", "float64", key_seed=1, pos_edit=edit,
        bounds=bounds, center=np.array([3.24e12, 7.5, 4.11, 0.78]))
    assert not np.isfinite(lnp0[3])
    np.testing.assert_array_equal(cp, cj)
    stuck = ~np.isfinite(lj)
    assert stuck.any()
    np.testing.assert_array_equal(np.isfinite(lp), np.isfinite(lj))
    assert np.all(lp[stuck] == -np.inf)
    assert lpp[3] == -np.inf and lpj[3] == -np.inf
    np.testing.assert_allclose(lp[~stuck], lj[~stuck], rtol=1e-12)


@pytest.fixture(scope="module")
def port_problem(reduced):
    """The port's float64 K1 runner on the synthetic problem."""
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.models import SpectralModel
    from cha1_mcmc_tpu_torch.sampler.fused import make_fused_ensemble
    from tests.torch_parity import BOUNDS, MEANS_4, STDS_4

    cat_j, grid = reduced
    cat = load_catalog(cat_j.catalog_file)
    model = SpectralModel.build(cat, grid.covered_trans, grid.freqs, ll=18000.0,
                                ul=25000.0, dish_size=70.0, vel_offset=4.10,
                                mask_center=4.10, device="cpu", dtype=torch.float64)
    spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
    run = make_fused_ensemble(model, spec, grid.ints, grid.yerrs, BOUNDS,
                              MEANS_4, STDS_4)
    return run, spec


def test_fused_sampler_thinning_is_exact(port_problem, tmp_path):
    """FusedEnsembleSampler(thin=2) records every 2nd raw state of the same
    stream: bitwise the raw run subsampled, acceptances summed in pairs."""
    from cha1_mcmc_tpu_torch.sampler import FusedEnsembleSampler

    run, spec = port_problem
    pos0 = torch.as_tensor(walker_ball(TRUTH_4, W, 5), dtype=torch.float64)
    lnp0 = run.lnprob(pos0)
    raw = run(pos0, lnp0, 8, 4, generator=torch.Generator().manual_seed(7))
    sampler = FusedEnsembleSampler(lnprob_fn=None, nwalkers=W, ndim=4,
                                   dtype=torch.float64, run_fn=run, k_steps=4,
                                   device="cpu")
    sampler.run_mcmc(pos0, 4, torch.Generator().manual_seed(7),
                     checkpoint_every=4, thin=2, lnp0=lnp0)
    np.testing.assert_array_equal(sampler.chain,
                                  raw[0][1::2].numpy().transpose(1, 0, 2))
    np.testing.assert_array_equal(sampler.lnprobability, raw[1][1::2].numpy().T)
    assert sampler.accepted == int(raw[2].sum())
    assert sampler.total_proposals == 8 * W


def test_k_step_blocking_consumes_randomness_identically(port_problem):
    run, _ = port_problem
    pos0 = torch.as_tensor(walker_ball(TRUTH_4, W, 6), dtype=torch.float64)
    lnp0 = run.lnprob(pos0)
    a = run(pos0, lnp0, 8, 4, generator=torch.Generator().manual_seed(2))
    b = run(pos0, lnp0, 8, 8, generator=torch.Generator().manual_seed(2))
    c = run(pos0, lnp0, 8, 3, generator=torch.Generator().manual_seed(2))  # k -> 2
    for x, y in ((a, b), (a, c)):
        for t, u in zip(x[:3], y[:3]):
            assert torch.equal(t, u)


def test_launch_counter_stays_zero_on_cpu(port_problem):
    from cha1_mcmc_tpu_torch.sampler import fused

    run, _ = port_problem
    before = dict(fused.LAUNCHES)
    pos0 = torch.as_tensor(walker_ball(TRUTH_4, W, 8), dtype=torch.float64)
    run(pos0, run.lnprob(pos0), 4, 4, generator=torch.Generator().manual_seed(0))
    assert fused.LAUNCHES == before


def test_wrapper_refuses_other_devices(port_problem):
    from cha1_mcmc_tpu_torch.sampler.fused import fused_lnprob

    run, _ = port_problem
    with pytest.raises(ValueError, match="CUDA"):
        fused_lnprob(torch.empty((4, 4), device="meta"), run.tables, run.statics)


@pytest.mark.parametrize("dtype,size", [(torch.float32, 464), (torch.float64, 896)])
def test_statics_struct_rounds_constants_once(port_problem, dtype, size):
    """The kernel's by-value Statics: C layout size, and every f64
    constant rounded to the kernel's type (the Gaussian normalisations
    computed on the host in f64 first)."""
    from cha1_mcmc_tpu_torch.sampler.fused import _pack_statics

    run, _ = port_problem
    st = run.statics
    s = _pack_statics(st, dtype)
    assert ctypes.sizeof(s) == size
    npt = np.float32 if dtype == torch.float32 else np.float64
    norm = np.log(1.0 / (np.sqrt(2.0 * np.pi) * st.prior_std[1]))
    assert s.norm[1] == npt(norm)
    assert list(s.lo)[:4] == [npt(v) for v in st.bounds_lo]
    assert (s.ndim, s.free_ss, s.ncol_idx, s.q_kind, s.n_poly) == (4, 0, 0, 0, 2)
    assert s.poly[1] == npt(15.65419) and s.q_scale == npt(3.0)
    assert st.prior_std[2] == pytest.approx(0.8 * 0.7575)   # vlsr override
    assert st.prior_std[3] == pytest.approx(0.3 * 0.7575)   # dV override


def test_statics_pack_cheb_and_limits(port_problem):
    from cha1_mcmc_tpu_torch.sampler.fused import _pack_statics

    run, _ = port_problem
    cheb = dataclasses.replace(run.statics, q_kind="cheb",
                               q_coeffs=(1.0, 2.0, 3.0), q_power=(3.5, 12.0))
    s = _pack_statics(cheb, torch.float64)
    assert (s.q_kind, s.n_cheb, s.n_poly) == (1, 3, 0)
    assert s.cheb_lo == 3.5 and s.cheb_scale == 2.0 / 8.5
    with pytest.raises(ValueError):
        _pack_statics(dataclasses.replace(run.statics, q_coeffs=(1.0,) * 9),
                      torch.float32)


def test_shared_memory_plan():
    from cha1_mcmc_tpu_torch.sampler.fused import fused_fits, step_smem_bytes

    # flagship: 128 walkers x 4 dims, 9 lines, f32
    assert step_smem_bytes(128, 4, 9, torch.float32) == 4 * (640 + 320 + 64 + 144) + 4 * 65
    assert fused_fits(128, 4, 9, torch.float32)
    assert not fused_fits(8192, 5, 9, torch.float64)
