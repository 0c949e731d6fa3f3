"""The GOTHAM multifit slice of the torch port against the JAX package, on
the small synthetic GOTHAM problem (tests/port_problems.py:
write_hc9n_problem, 4 multiplets = 12 lines x ~200 channels): the
reduction, the channel-major gather tables and opacity
(models/sparse_opacity.py), ordered_velocity_lnprior, the batched gather
lnprob, run_ensemble over it, the plain version of K2
(sampler/fused_multi.py) against the JAX package's Pallas kernel
(cha1_mcmc_tpu/sampler/fused_multi.py:make_fused_ensemble_multi) run in
interpret mode as tests/test_pallas.py runs it, and MultiComponentFit
end to end on the CPU.

Tolerances: equal arrays for the host-side NumPy stages and tables;
lnprob f64 rtol 1e-12 (reduction order differs), f32 rtol 1e-5; float64
chains, acceptances and final positions bitwise, lnps rtol 1e-12. The
CUDA kernel itself is compared with the plain version on the card
(chip_smoke.py and tests/test_torch_cuda.py)."""

import contextlib
import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import (gotham_problem, jax_gotham_model,
                                jax_gotham_reduce, jax_randomness, port_model,
                                to_torch)

torch.set_num_threads(1)

W, NSTEPS, K_STEPS = 16, 8, 4
DV_BOUND = 0.3


def _k2_plan(nwalkers, ncomp, n_lines, n_channels, n_entries, dtype, **kw):
    """K2's cluster plan (cluster.plan_cluster of fused_multi.FAMILY)."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi

    return cluster.plan_cluster(fused_multi.FAMILY, nwalkers, ncomp, 3 * ncomp + 2, n_lines,
                                n_channels, n_entries, dtype, **kw)


def _k2_wide(nwalkers, ncomp, n_lines, n_channels, n_entries, dtype, **kw):
    """K2's wide plan (cluster.plan_wide of fused_multi.FAMILY)."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi

    return cluster.plan_wide(fused_multi.FAMILY, nwalkers, ncomp, 3 * ncomp + 2, n_lines,
                             n_channels, n_entries, dtype, **kw)


@pytest.fixture
def card_capacity(monkeypatch):
    """Stand in for the card's answer of how many wide K2 CTAs it keeps
    resident: card_capacity(n) makes cluster.wide_capacity answer n;
    cluster.steps_plan's cache is emptied before and after."""
    from cha1_mcmc_tpu_torch.sampler import cluster

    cluster.steps_plan.cache_clear()
    yield lambda n: monkeypatch.setattr(cluster, "wide_capacity", lambda *args: n)
    cluster.steps_plan.cache_clear()
STUCK = 3   # walker started at dV = 0.5 > DV_BOUND: -inf, never accepts


@pytest.fixture(scope="module")
def reduced(gotham_problem):
    return jax_gotham_reduce(gotham_problem)


def _template(ncomp):
    """(means, stds, walker-ball perturbation): the multifit's HC9N
    template for 4 components, the K=1 ordered family of
    tests/test_pallas.py:453-466 (at the central velocity) for 1."""
    from cha1_mcmc_tpu_torch.pipeline.multifit import (_HC9N_MEANS, _HC9N_STDS,
                                                        _PERTURBATION)
    if ncomp == 4:
        return np.array(_HC9N_MEANS), np.array(_HC9N_STDS), np.array(_PERTURBATION)
    return (np.array([37.0, 2.47e12, 6.7, 5.79, 0.117]),
            np.array([2.5, 0.30e12, 0.1, 0.0015, 0.002]),
            np.array([1e-1, 1e10, 1e-3, 1e-3, 1e-3]))


def _thetas(ncomp, n, seed, spread=3.0):
    """n thetas around the template, `spread` x the walker-ball
    perturbation: most inside the prior, some outside (ordering, dV)."""
    means, _, pert = _template(ncomp)
    rng = np.random.default_rng(seed)
    return means + spread * pert * rng.standard_normal((n, means.size))


def _with_outliers(th):
    """Every 8th theta with dV above the bound, every 8th (offset 1) with
    a negative source size: -inf under the prior."""
    th[::8, -1] = 0.35
    th[1::8, 0] = -1.0
    return th


def _jax_q_model(cat, q_kind):
    from cha1_mcmc_tpu.catalogs.partition import _state_sum_model, fit_device_cheb

    if q_kind == "analytic":
        return None
    states = _state_sum_model(cat)
    return states if q_kind == "states" else fit_device_cheb(states, 2.7, 60.0)


def _scope(dtype):
    return jax.enable_x64() if dtype == "float64" else contextlib.nullcontext()


# -- host-side stages ----------------------------------------------------------

def test_gotham_datagrid_matches_jax(gotham_problem, reduced):
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.models.forward import simulate_sticks_host
    from cha1_mcmc_tpu_torch.pipeline import MultiFitConfig
    from cha1_mcmc_tpu_torch.reduce.datagrid import read_spectrum_gotham

    _, jgrid = reduced
    cfg = MultiFitConfig(mol_name="hc9n_hfs")
    cat = load_catalog(gotham_problem["cat_path"], name="hc9n_hfs")
    C, dV, T, ss = cfg.fiducial
    freq_sim, int_sim, _ = simulate_sticks_host(
        cat, C=[C], dV=[dV], T=[T], ll=[cfg.lower_limit], ul=[cfg.upper_limit],
        source_size=ss, dish_size=cfg.dish_size)
    grid = read_spectrum_gotham(np.load(gotham_problem["data_path"]), freq_sim,
                                int_sim, verbose=False)
    for name in ("freqs", "ints", "yerrs", "covered_trans"):
        np.testing.assert_array_equal(getattr(grid, name), getattr(jgrid, name))
    assert grid.covered_trans.size == gotham_problem["n_lines"] == 12


def test_gather_tables_match_jax(reduced):
    """build_opacity_gather and window_extents on the GOTHAM grid: equal
    to the JAX arrays; hfs triplets share one window start, 3 lines per
    channel, as on the real GOTHAM datagrids."""
    from cha1_mcmc_tpu.models.pallas_kernels import (build_opacity_gather as jb,
                                                     build_opacity_gather_split as jbs)
    from cha1_mcmc_tpu.sampler.fused_multi import window_extents as jwe
    from cha1_mcmc_tpu_torch.models.sparse_opacity import (build_opacity_gather,
                                                           build_opacity_gather_split)
    from cha1_mcmc_tpu_torch.sampler.fused_multi import window_extents

    cat, grid = reduced
    with jax.enable_x64():
        vg = np.asarray(jax_gotham_model(cat, grid, "float64").vel_grid)
    for got, want in zip(build_opacity_gather(vg, 5.8, DV_BOUND), jb(vg, 5.8, DV_BOUND)):
        np.testing.assert_array_equal(got, want)
    active, first, last, C = window_extents(vg, 5.8, DV_BOUND)
    for got, want in zip((active, first, last, C), jwe(vg, 5.8, DV_BOUND)):
        np.testing.assert_array_equal(got, want)
    assert np.all(first.reshape(-1, 3) == first[::3, None])
    assert build_opacity_gather(vg, 5.8, DV_BOUND)[0].shape[0] == 3
    assert build_opacity_gather_split(vg, 5.8, DV_BOUND) is None
    assert jbs(vg, 5.8, DV_BOUND) is None


def _skewed_vel_grid(seed=0):
    """(L, C) velocities whose per-channel in-window line counts are
    skewed (a few heavy channels), so the split gather is worthwhile."""
    rng = np.random.default_rng(seed)
    L, C = 40, 64
    vg = np.full((L, C), 100.0)
    vg[:, :] = rng.uniform(-20.0, 20.0, (L, C)) + 5.8
    vg[:, :60] = np.where(rng.random((L, 60)) < 0.06,
                          rng.uniform(4.0, 7.6, (L, 60)), 50.0)
    vg[:, 60:] = rng.uniform(3.4, 8.2, (L, 4))        # heavy: every line
    return vg


def test_gather_split_tables_match_jax():
    from cha1_mcmc_tpu.models.pallas_kernels import build_opacity_gather_split as jbs
    from cha1_mcmc_tpu_torch.models.sparse_opacity import build_opacity_gather_split

    vg = _skewed_vel_grid()
    got, want = build_opacity_gather_split(vg, 5.8, DV_BOUND), jbs(vg, 5.8, DV_BOUND)
    assert got is not None and want is not None
    assert got[4].size < vg.shape[1]                  # a heavy subset
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_opacity_gather_split_matches_jax():
    """The split gather's opacity (heavy overflow scattered with
    index_add) against the JAX one-hot version, and the plain gather."""
    from cha1_mcmc_tpu.models.pallas_kernels import (heavy_scatter_onehot,
                                                     opacity_gather_split as jos)
    from cha1_mcmc_tpu_torch.models.sparse_opacity import (
        build_opacity_gather, build_opacity_gather_split, opacity_gather,
        opacity_gather_split)

    vg = _skewed_vel_grid()
    t1, v1, t2, v2, heavy, active = build_opacity_gather_split(vg, 5.8, DV_BOUND)
    rng = np.random.default_rng(1)
    taus = rng.uniform(0.0, 2.0, (6, active.size))
    vlsr, dV = rng.uniform(5.6, 6.0, 6), rng.uniform(0.1, 0.29, 6)
    with jax.enable_x64():
        want = np.asarray(jos(jnp.asarray(taus), jnp.asarray(vlsr), jnp.asarray(dV),
                              jnp.asarray(t1), jnp.asarray(v1), jnp.asarray(t2),
                              jnp.asarray(v2),
                              jnp.asarray(heavy_scatter_onehot(heavy, vg.shape[1]),
                                          jnp.float64),
                              mask_center=5.8))
    T = torch.from_numpy
    got = opacity_gather_split(T(taus), T(vlsr), T(dV), T(t1).long(), T(v1),
                               T(t2).long(), T(v2), T(heavy).long(),
                               mask_center=5.8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    table, vel_t, _ = build_opacity_gather(vg, 5.8, DV_BOUND)
    plain = opacity_gather(T(taus), T(vlsr), T(dV), T(table).long(), T(vel_t),
                           mask_center=5.8).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("ncomp", [4, 1])
def test_ordered_velocity_lnprior_matches_jax(ncomp):
    from cha1_mcmc_tpu.inference import ParamSpec as JSpec
    from cha1_mcmc_tpu.inference import ordered_velocity_lnprior as jprior
    from cha1_mcmc_tpu_torch.inference import ParamSpec, ordered_velocity_lnprior

    means, stds, _ = _template(ncomp)
    th = _with_outliers(_thetas(ncomp, 64, seed=ncomp, spread=40.0))
    with jax.enable_x64():
        want = np.asarray(jax.vmap(jprior(JSpec(ncomp=ncomp), means, stds,
                                          dv_max=DV_BOUND))(jnp.asarray(th)))
    got = ordered_velocity_lnprior(ParamSpec(ncomp=ncomp), means, stds,
                                   dv_max=DV_BOUND, dtype=torch.float64)(
        torch.from_numpy(th)).numpy()
    fin = np.isfinite(want)
    assert 0 < fin.sum() < fin.size
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)


def _port_gather_lnprob(jm, dtype, ncomp, grid, **kwargs):
    from cha1_mcmc_tpu_torch.inference import (ParamSpec, build_lnprob_batched,
                                               ordered_velocity_lnprior)

    means, stds, _ = _template(ncomp)
    spec = ParamSpec(ncomp=ncomp)
    prior = ordered_velocity_lnprior(spec, means, stds, dv_max=DV_BOUND, dtype=dtype)
    kwargs = kwargs or dict(use_pallas=True, pallas_kernel="gather", dv_max=DV_BOUND)
    return build_lnprob_batched(port_model(jm, dtype), spec, grid.ints,
                                grid.yerrs, prior, **kwargs)


def _jax_gather_lnprob(jm, ncomp, grid):
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnprob_batched,
                                         ordered_velocity_lnprior)

    means, stds, _ = _template(ncomp)
    spec = ParamSpec(ncomp=ncomp)
    return build_lnprob_batched(
        jm, spec, grid.ints, grid.yerrs,
        ordered_velocity_lnprior(spec, means, stds, dv_max=DV_BOUND),
        use_pallas=True, pallas_kernel="gather", dv_max=DV_BOUND)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-5)])
def test_gather_lnprob_matches_jax(reduced, dtype, rtol):
    cat, grid = reduced
    th = _with_outliers(_thetas(4, 48, seed=5))
    with _scope(dtype):
        jm = jax_gotham_model(cat, grid, dtype)
        want = np.asarray(_jax_gather_lnprob(jm, 4, grid)(jnp.asarray(th, dtype)))
    got = _port_gather_lnprob(jm, getattr(torch, dtype), 4, grid)(
        torch.as_tensor(th, dtype=getattr(torch, dtype))).numpy()
    fin = np.isfinite(want)
    assert 0 < fin.sum() < fin.size
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def test_dense_and_gather_lnprob_agree(reduced):
    """use_pallas=False (the dense model over the full (L, C) grid) and the
    gather tables give one lnprob for in-bounds walkers (f64)."""
    cat, grid = reduced
    with jax.enable_x64():
        jm = jax_gotham_model(cat, grid, "float64")
    th = torch.from_numpy(_with_outliers(_thetas(4, 48, seed=6)))
    gather = _port_gather_lnprob(jm, torch.float64, 4, grid)(th).numpy()
    dense = _port_gather_lnprob(jm, torch.float64, 4, grid, use_pallas=False)(th).numpy()
    fin = np.isfinite(gather)
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(dense), fin)
    np.testing.assert_allclose(dense[fin], gather[fin], rtol=1e-12)


def test_run_ensemble_over_gather_matches_jax(reduced):
    from cha1_mcmc_tpu.sampler import run_ensemble as jrun
    from cha1_mcmc_tpu_torch.sampler import run_ensemble

    cat, grid = reduced
    key = jax.random.PRNGKey(4)
    with jax.enable_x64():
        jm = jax_gotham_model(cat, grid, "float64")
        lnprob_j = _jax_gather_lnprob(jm, 4, grid)
        pos0 = jnp.asarray(_thetas(4, W, seed=7, spread=1.0))
        lnp0 = lnprob_j(pos0)
        cj, lj, aj, (pj, lpj) = jrun(lnprob_j, pos0, lnp0, key, nsteps=NSTEPS,
                                     batched=True)
        rnd = jax_randomness(key, NSTEPS, W, "float64")
        pos0, lnp0 = np.array(pos0), np.array(lnp0)
    lnprob = _port_gather_lnprob(jm, torch.float64, 4, grid)
    cp, lp, ap, (pp, lpp) = run_ensemble(lnprob, torch.from_numpy(pos0),
                                         torch.from_numpy(lnp0), None, NSTEPS,
                                         randomness=to_torch(rnd))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-12)
    assert 0 < int(ap.sum()) < NSTEPS * W


# -- K2: the plain version against the JAX Pallas kernel ----------------------

def _run_k2(reduced, ncomp, q_kind, dtype, key_seed, stuck):
    """The JAX K2 (interpret mode) and the port's plain K2 on the same
    model constants, start (lnp0 from the JAX gather lnprob, as the JAX
    multifit starts K2) and randomness. Returns (JAX (chain, lnps, acc,
    pos, lnp) as numpy, the same for the port, lnp0)."""
    from cha1_mcmc_tpu.inference import ParamSpec
    from cha1_mcmc_tpu.sampler.fused_multi import make_fused_ensemble_multi
    from cha1_mcmc_tpu_torch.inference import ParamSpec as PortSpec
    from cha1_mcmc_tpu_torch.sampler.fused_multi import (
        make_fused_ensemble_multi as port_make)

    cat, grid = reduced
    means, stds, _ = _template(ncomp)
    with _scope(dtype):
        jm = jax_gotham_model(cat, grid, dtype, q_model=_jax_q_model(cat, q_kind))
        run = make_fused_ensemble_multi(jm, ParamSpec(ncomp=ncomp), grid.ints,
                                        grid.yerrs, means, stds, dv_max=DV_BOUND,
                                        nwalkers=W, interpret=True)
        pos0 = _thetas(ncomp, W, key_seed, spread=1.0)
        if stuck:
            pos0[STUCK, -1] = 0.5
        pos0 = jnp.asarray(pos0, dtype)
        lnp0 = _jax_gather_lnprob(jm, ncomp, grid)(pos0)
        key = jax.random.PRNGKey(key_seed)
        cj, lj, aj, (pj, lpj) = run(pos0, lnp0, key, NSTEPS, K_STEPS)
        out_j = tuple(np.asarray(t) for t in (cj, lj, aj, pj, lpj))
        rnd = jax_randomness(key, NSTEPS, W, dtype)
        pos0, lnp0 = np.array(pos0), np.array(lnp0)
    prun = port_make(port_model(jm, getattr(torch, dtype)), PortSpec(ncomp=ncomp),
                     grid.ints, grid.yerrs, means, stds, dv_max=DV_BOUND)
    cp, lp, ap, (pp, lpp) = prun(torch.from_numpy(pos0), torch.from_numpy(lnp0),
                                 NSTEPS, K_STEPS, randomness=to_torch(rnd))
    out_p = tuple(t.numpy() for t in (cp, lp, ap, pp, lpp))
    return out_j, out_p, lnp0


@pytest.fixture(scope="module")
def k2_runs(reduced):
    """_run_k2, computed once per case for the module (each JAX interpret
    compile takes seconds)."""
    cache = {}

    def run(ncomp, q_kind, dtype, key_seed=3, stuck=False):
        case = (ncomp, q_kind, dtype, key_seed, stuck)
        if case not in cache:
            cache[case] = _run_k2(reduced, *case)
        return cache[case]

    return run


@pytest.mark.parametrize("ncomp,q_kind,stuck", [(4, "analytic", True),
                                                (4, "cheb", False),
                                                (4, "states", False),
                                                (1, "analytic", False)])
def test_plain_k2_matches_jax_kernel_f64(k2_runs, ncomp, q_kind, stuck):
    (cj, lj, aj, pj, lpj), (cp, lp, ap, pp, lpp), _ = k2_runs(
        ncomp, q_kind, "float64", stuck=stuck)
    assert cp.shape == (NSTEPS, W, 3 * ncomp + 2) and cp.dtype == np.float64
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(pp, pj)
    np.testing.assert_allclose(lp, lj, rtol=1e-12)
    np.testing.assert_allclose(lpp, lpj, rtol=1e-12)
    assert 0 < ap.sum() < NSTEPS * W       # moves were both taken and refused


def test_never_accepting_walker_reports_minus_inf(k2_runs):
    """F4: a walker that starts outside the prior (dV above the bound, so
    lnp0 = -inf) and never accepts is recorded as -inf, exactly where the
    JAX kernel records it after restoring its finfo.min clamp."""
    (cj, lj, _, pj, lpj), (cp, lp, _, pp, lpp), lnp0 = k2_runs(
        4, "analytic", "float64", stuck=True)
    assert lnp0[STUCK] == -np.inf
    stuck = ~np.isfinite(lj)
    assert stuck[:, STUCK].all()
    np.testing.assert_array_equal(np.isfinite(lp), np.isfinite(lj))
    assert np.all(lp[stuck] == -np.inf)
    assert lpp[STUCK] == -np.inf and lpj[STUCK] == -np.inf
    np.testing.assert_array_equal(cp[:, STUCK], np.broadcast_to(pp[STUCK], cp[:, STUCK].shape))


def test_plain_k2_matches_jax_kernel_f32(k2_runs):
    (cj, lj, aj, _, _), (cp, lp, ap, _, _), _ = k2_runs(
        4, "analytic", "float32", key_seed=5)
    assert cp.dtype == np.float32
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    # with no marginal acceptance on this stream the f32 chains agree too
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ap, aj)


@pytest.fixture(scope="module")
def port_k2(reduced):
    """The port's float64 K2 runner on the GOTHAM problem."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler.fused_multi import make_fused_ensemble_multi

    cat, grid = reduced
    with jax.enable_x64():
        jm = jax_gotham_model(cat, grid, "float64")
    means, stds, _ = _template(4)
    return make_fused_ensemble_multi(port_model(jm, torch.float64),
                                     ParamSpec(ncomp=4), grid.ints, grid.yerrs,
                                     means, stds, dv_max=DV_BOUND)


def test_k2_blocking_consumes_randomness_identically(port_k2):
    pos0 = torch.from_numpy(_thetas(4, W, seed=8, spread=1.0))
    lnp0 = port_k2.lnprob(pos0)
    a = port_k2(pos0, lnp0, 8, 4, generator=torch.Generator().manual_seed(2))
    b = port_k2(pos0, lnp0, 8, 8, generator=torch.Generator().manual_seed(2))
    c = port_k2(pos0, lnp0, 8, 3, generator=torch.Generator().manual_seed(2))  # k -> 2
    for x, y in ((a, b), (a, c)):
        for t, u in zip(x[:3], y[:3]):
            assert torch.equal(t, u)


def test_k2_launch_counter_stays_zero_on_cpu(port_k2):
    from cha1_mcmc_tpu_torch.sampler import fused_multi

    before = dict(fused_multi.LAUNCHES)
    pos0 = torch.from_numpy(_thetas(4, W, seed=9, spread=1.0))
    port_k2(pos0, port_k2.lnprob(pos0), 4, 4,
            generator=torch.Generator().manual_seed(0))
    assert fused_multi.LAUNCHES == before


def test_k2_wrapper_refuses_other_devices(port_k2):
    from cha1_mcmc_tpu_torch.sampler.fused_multi import multi_lnprob

    with pytest.raises(ValueError, match="CUDA"):
        multi_lnprob(torch.empty((4, 14), device="meta"), port_k2.tables,
                     port_k2.statics)


@pytest.mark.parametrize("dtype,size", [(torch.float32, 504), (torch.float64, 984)])
def test_k2_statics_struct_rounds_constants_once(port_k2, dtype, size):
    """The kernel's by-value MultiStatics: C layout size, every f64
    constant rounded to the kernel's type once, the prior sigma
    overrides, and the component cap."""
    from cha1_mcmc_tpu_torch.sampler.fused_multi import _pack_statics

    st = port_k2.statics
    s = _pack_statics(st, dtype)
    assert ctypes.sizeof(s) == size
    npt = np.float32 if dtype == torch.float32 else np.float64
    assert s.norm_ss[2] == npt(np.log(1.0 / (np.sqrt(2.0 * np.pi) * 6.5)))
    assert list(s.mean_vlsr) == [npt(v) for v in (5.624, 5.790, 5.910, 6.033)]
    assert s.sd_vlsr[0] == npt(0.8 * 0.117) and s.sd_dv == npt(0.3 * 0.117)
    assert (s.ncomp, s.ndim, s.q_kind, s.n_poly) == (4, 14, 0, 2)
    assert s.q_scale == npt(3.0) and s.poly[1] == npt(71.7308577)
    assert (s.ss_lo, s.ss_hi, s.dv_bound) == (0.0, 200.0, npt(DV_BOUND))
    with pytest.raises(ValueError, match="components"):
        _pack_statics(dataclasses.replace(st, ncomp=5), dtype)


def test_k2_shared_memory_gate(reduced, port_k2):
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler.fused_multi import fused_multi_supported

    # GOTHAM full size: 128 walkers x 14 dims, 66 lines, 1,138 channels, 3
    # entries a channel, f32, 16 CTAs: per CTA the state, the staged chans
    # (3 rows), 4 constants a channel, the entry velocities (3, 1138) and the
    # lines (5, 66), 4 groups' (4, 66) tau and 16 partials each (the lnprob's
    # 512 lanes as 16 warps' sums), 4 owned proposals and stretch factors;
    # the entry indices and groups (2, 3, 1138), 4 flags and 2 counters
    plan = _k2_plan(128, 4, 66, 1138, 3, torch.float32)
    assert (plan.cluster, plan.per_cta, plan.warps_per_proposal) == (16, 4, 4)
    assert plan.staged and not plan.wide
    assert plan.smem_bytes == (4 * (128 * 15 + 7 * 1138 + 3 * 1138 + 5 * 66 + 4 * 4 * 66
                                    + 4 * 16 + 4 * 15 + 4) + 4 * (2 * 3 * 1138 + 4 + 2))
    # unstaged: no table, no per-channel constant
    unstaged = _k2_plan(128, 4, 66, 1138, 3, torch.float32, stage=False)
    assert unstaged.smem_bytes == (4 * (128 * 15 + 4 * 4 * 66 + 4 * 16 + 4 * 15 + 4)
                                   + 4 * (4 + 2))
    model = port_model(jax_gotham_model(*reduced, "float32"), torch.float32)
    assert fused_multi_supported(model, ParamSpec(ncomp=4), DV_BOUND)
    assert fused_multi_supported(model, ParamSpec(ncomp=1), DV_BOUND)
    assert not fused_multi_supported(model, ParamSpec(ncomp=5), DV_BOUND)
    assert not fused_multi_supported(model, ParamSpec(ncomp=1, fixed_source_size=40.0),
                                     DV_BOUND)
    assert not fused_multi_supported(model, ParamSpec(ncomp=4), DV_BOUND,
                                     nwalkers=8192)
    # with the channels out of frequency order the line windows split:
    # not K2's (nor the JAX kernel's)
    from cha1_mcmc_tpu_torch.models.forward import model_from_arrays
    from tests.torch_parity import model_arrays, q_dict

    jm = jax_gotham_model(*reduced, "float32")
    arrays = model_arrays(jm)
    perm = np.random.default_rng(0).permutation(arrays["grid_freq"].size)
    arrays["grid_freq"], arrays["vel_grid"] = (arrays["grid_freq"][perm],
                                               arrays["vel_grid"][:, perm])
    shuffled = model_from_arrays(arrays, q_dict(jm.q_model), mask_center=5.8,
                                 dish_size=100.0, device="cpu")
    assert not fused_multi_supported(shuffled, ParamSpec(ncomp=4), DV_BOUND)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", [16, 8])
def test_k2_cluster_plan_fits_gotham(dtype, cluster):
    """At the GOTHAM size (128 walkers, K = 4, 66 lines x 1,138 channels x
    3 entries) both plans fit a Hopper CTA's 232,448 bytes; K5c's leaves
    the state in device memory, so it needs exactly the state's bytes
    less."""
    item = torch.empty((), dtype=dtype).element_size()
    k2 = _k2_plan(128, 4, 66, 1138, 3, dtype, cluster=cluster)
    k5c = _k2_plan(128, 4, 66, 1138, 3, dtype, cluster=cluster, resident_state=False)
    assert k2.fits and k5c.fits and k2.smem_bytes <= 232_448
    assert k2.staged and k5c.staged
    assert k2.smem_bytes - k5c.smem_bytes == item * 128 * 15
    P = 64 // cluster
    tables = 7 * 1138 + 3 * 1138 + 5 * 66
    assert k5c.smem_bytes == (item * (tables + 4 * 4 * 66 + 4 * 16 + P * 15 + P)
                              + 4 * (2 * 3 * 1138 + P + 2))


@pytest.mark.parametrize("nwalkers", [64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_wide_plan_gives_each_proposal_a_cta(dtype, nwalkers):
    """K2's wide plan: h = W / 2 CTAs a chain, CTA j owning proposal j of
    every half-update with all 16 warps, one lnprob group, no copy of the
    state in shared memory — the K5c layout of one proposal a CTA at one
    group — the tables staged at the GOTHAM size."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi

    h = nwalkers // 2
    wide = _k2_wide(nwalkers, 4, 66, 1138, 3, dtype)
    assert wide.wide and (wide.cluster, wide.proposals, wide.per_cta) == (h, h, 1)
    assert wide.warps_per_proposal == 16 and wide.fits and wide.staged
    assert [j for r in range(h) for j in wide.owned(r)] == list(range(h))
    assert wide.shape == _k2_plan(nwalkers, 4, 66, 1138, 3, dtype).shape
    assert wide.layout == cluster.smem_layout(fused_multi.FAMILY, dtype, 4, 66, 1138, 3,
                                              ndim=14, per_cta=1, groups=1)
    one_a_cta = _k2_plan(2, 4, 66, 1138, 3, dtype, cluster=1, resident_state=False)
    item = torch.empty((), dtype=dtype).element_size()
    assert one_a_cta.smem_bytes - wide.smem_bytes == item * 3 * (4 * 66 + 16)


@pytest.mark.parametrize("nwalkers,chains,capacity,wide", [
    (128, 1, 132, True), (128, 2, 132, True), (128, 3, 132, False), (128, 4, 132, False),
    (128, 4, 264, True), (128, 5, 264, False), (100, 2, 100, True), (100, 2, 99, False),
    (256, 1, 132, True), (256, 2, 132, False), (2048, 1, 132, False), (128, 1, 0, False)])
def test_k2_wide_path_is_taken_exactly_when_the_chains_fit(card_capacity, nwalkers, chains,
                                                            capacity, wide):
    """cluster.steps_plan takes the wide plan exactly where the launch's
    chains x h CTAs fit the co-resident CTAs the card answers (0: a card
    with no cooperative launch), else the cluster plan (16 CTAs here, where
    no card is asked whether it places them)."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi

    card_capacity(capacity)
    chosen = cluster.steps_plan(fused_multi.FAMILY, nwalkers, chains, 4, 14, 66, 1138, 3,
                                torch.float32, torch.device("cpu"))
    want = (_k2_wide(nwalkers, 4, 66, 1138, 3, torch.float32) if wide
            else _k2_plan(nwalkers, 4, 66, 1138, 3, torch.float32))
    assert chosen == want and chosen.wide == wide
    assert wide == (chains * (nwalkers // 2) <= capacity)


def test_k2_wide_path_needs_a_plan_that_fits(card_capacity):
    """Past what a CTA's shared memory holds the wide plan is not taken,
    whatever the card's capacity: 20,000 active lines' tau fit neither the
    wide CTA nor a cluster's, so no geometry runs the launch."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi

    assert not _k2_wide(128, 4, 20_000, 1138, 3, torch.float32).fits
    assert _k2_wide(128, 4, 66, 113_800, 3, torch.float32).fits     # unstaged
    assert not _k2_wide(128, 4, 66, 113_800, 3, torch.float32, stage=True).fits
    card_capacity(10_000)
    with pytest.raises(ValueError, match="no cluster geometry runs it"):
        cluster.steps_plan(fused_multi.FAMILY, 128, 1, 4, 14, 20_000, 1138, 3,
                           torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("n_chains,capacity,want", [
    (1, 132, (64, 1)), (2, 132, (64, 1)), (4, 132, (16, 0)), (4, 264, (64, 1)),
    (1, None, (16, 0))])
def test_k2_plan_counts_report_the_path(port_k2, card_capacity, n_chains, capacity, want):
    """MultiFusedEnsemble.plan_counts (the `pipeline/k2_plan` span's counts)
    at 128 walkers a chain: the CTAs a chain and `wide` 1 where the chains
    fit the capacity the card answers, else the 16-CTA cluster and 0; on
    CPU tables with no card to answer (None), where no launch is made, the
    cluster plan."""
    if capacity is not None:
        card_capacity(capacity)
    counts = port_k2.plan_counts(128, n_chains)
    lines, vel = port_k2.tables[:2]
    sizes = (4, lines.shape[1], vel.shape[1], vel.shape[0], vel.dtype)
    plan = _k2_wide(128, *sizes) if want[1] else _k2_plan(128, *sizes, cluster=16)
    assert (counts["ctas"], counts["wide"]) == want
    assert counts["smem_bytes"] == plan.smem_bytes and counts["staged"] == int(plan.staged)
    assert counts["components"] == 4


@pytest.mark.parametrize("n_chains", [1, 4])
def test_k2_plan_counts_and_the_step_launch_take_one_plan(port_k2, monkeypatch, n_chains):
    """One chooser: on the CPU, the plan plan_counts reports is the object
    that the step launch's own choice (checked_plan with no plan handed in,
    cluster.steps_plan) returns for the same chains, sizes and device."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused, fused_multi

    asked = []
    real = fused.steps_plan       # FusedEnsemble.plan_counts, K2's runner's too
    monkeypatch.setattr(fused, "steps_plan",
                        lambda *args: asked.append(real(*args)) or asked[-1])
    counts = port_k2.plan_counts(128, n_chains)
    (plan,) = asked
    lines, vel, _, _, _, qst = port_k2.tables
    launched = cluster.checked_plan(fused_multi.FAMILY, "steps", None, 128, n_chains, 4, 14,
                                    lines.shape[1], vel.shape[1], vel.shape[0], vel.dtype,
                                    vel.device)
    assert launched is plan
    assert (counts["ctas"], counts["wide"], counts["smem_bytes"]) == (
        plan.cluster, int(plan.wide), plan.smem_bytes)


def test_k1_geometry_and_layout_are_unchanged():
    """K1 keeps its four 4-warp groups a CTA (sampler/cluster.py's
    constants, which K1's library is checked against) and its cluster
    layout at the flagship size, each group now with the 16 chi^2 partials
    of its lnprob's 512 lanes; K2's cluster plans take four groups of four
    warps too, each with 16 chi^2 partials (its lnprob's 512 lanes)."""
    from cha1_mcmc_tpu_torch.sampler import cluster, fused, fused_multi

    assert (cluster.THREADS, cluster.GROUPS, cluster.GROUP_WARPS) == (512, 4, 4)
    assert fused_multi.K2_LANE_WARPS == fused_multi.FAMILY.partials == 16
    assert fused.FAMILY.partials == cluster.LANE_WARPS == 16
    assert _k2_plan(128, 4, 66, 1138, 3, torch.float32).warps_per_proposal == 4
    plan = cluster.plan_cluster(fused.FAMILY, 128, 1, 4, 9, 561, 2, torch.float32)
    assert (plan.cluster, plan.per_cta, plan.warps_per_proposal) == (16, 4, 4)
    assert not plan.wide and plan.staged
    # the state (128, 5), the staged chans (3, 561), 4 constants a channel,
    # the entry velocities (2, 561), the lines (5, 9), 4 groups' (9,) tau and
    # 4 x 16 partials, 4 proposals (4, 5) and stretch factors; the entry
    # indices (2, 561), 4 flags and 2 counters
    assert plan.smem_bytes == (4 * (128 * 5 + 7 * 561 + 2 * 561 + 5 * 9 + 4 * 9 + 4 * 16
                                    + 4 * 5 + 4) + 4 * (2 * 561 + 4 + 2)) == 27_944


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_gate_accepts_thousands_of_channels(reduced, dtype):
    """A GOTHAM-shaped problem of ~6,000 channels — copies of the reduced
    problem side by side, each copy's lines far from the other copies'
    channels — is past what a CTA can stage, yet K2's and K5c's gates
    accept it at 128 walkers: the plan reads the tables from device memory,
    and that layout does not grow with the channels."""
    import types

    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler import cluster
    from cha1_mcmc_tpu_torch.sampler.fused_multi import (FAMILY, fused_multi_supported,
                                                         window_extents)

    model = port_model(jax_gotham_model(*reduced, "float32"), dtype)
    vg = model.vel_grid.cpu().numpy()
    L, C = vg.shape
    n = -(-6000 // C)
    wide = np.full((n * L, n * C), 1e4)
    for i in range(n):
        wide[i * L:(i + 1) * L, i * C:(i + 1) * C] = vg
    big = types.SimpleNamespace(vel_grid=torch.as_tensor(wide), mask_center=model.mask_center,
                                n_channels=n * C, dtype=dtype)
    spec = ParamSpec(ncomp=4)
    assert fused_multi_supported(big, spec, DV_BOUND)
    assert fused_multi_supported(big, spec, DV_BOUND, resident_state=False)
    active, _, _, _ = window_extents(wide, model.mask_center, DV_BOUND)
    M = int((np.abs(wide - model.mask_center) < 10 * DV_BOUND).sum(axis=0).max())
    assert n * C >= 6000
    assert active.size == n * window_extents(vg, model.mask_center, DV_BOUND)[0].size
    for n_ctas in (16, 8):
        plan = _k2_plan(128, 4, active.size, n * C, M, dtype, cluster=n_ctas)
        assert plan.fits and not plan.staged
        assert not _k2_plan(128, 4, active.size, n * C, M, dtype, cluster=n_ctas,
                            stage=True).fits
    assert cluster.smem_layout(FAMILY, dtype, 4, active.size, n * C, M).fits


@pytest.mark.parametrize("w_local", [32, 64, 128])
def test_k2_gate_agrees_with_the_sharded_gate(reduced, w_local):
    """fused_multi_sharded_supported is fused_multi_supported at the rank's
    walker count with K5c's plan, for one and for two walker shards."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.parallel import Mesh
    from cha1_mcmc_tpu_torch.parallel.sharded_fused import fused_multi_sharded_supported
    from cha1_mcmc_tpu_torch.sampler.fused_multi import fused_multi_supported

    model = port_model(jax_gotham_model(*reduced, "float32"), torch.float32)
    spec = ParamSpec(ncomp=4)
    want = fused_multi_supported(model, spec, DV_BOUND, nwalkers=w_local,
                                 resident_state=False)
    assert want and fused_multi_supported(model, spec, DV_BOUND, nwalkers=w_local)
    for n_w in (1, 2):
        mesh = Mesh(shape={"chains": 1, "walkers": n_w, "lines": 1}, rank=0,
                    coords=(0, 0, 0), device=torch.device("cpu"), walker_group=None,
                    line_group=None, ensemble_group=None)
        assert fused_multi_sharded_supported(model, spec, DV_BOUND, mesh,
                                             n_w * w_local) == want
    # above the resident state's limit K2 stops; K5c's plan still fits
    assert not fused_multi_supported(model, spec, DV_BOUND, nwalkers=8192)
    assert fused_multi_supported(model, spec, DV_BOUND, nwalkers=8192,
                                 resident_state=False)


def test_k2_work_counts_the_constants_once(port_k2):
    """chip_smoke.k2_work on the small problem against a count by hand:
    per evaluation tau per (component, line), one exp2 per (component,
    in-window entry), J(Tex) and per component two per channel; the seven
    per-channel constants once per call."""
    import chip_smoke

    lines, vel = port_k2.tables[0], port_k2.tables[1]
    La, (M, C) = lines.shape[1], vel.shape
    K, mc = 4, port_k2.statics.mask_center
    dv = torch.tensor([0.002, 0.01, 0.117, 0.29], dtype=torch.float64)
    v = vel.numpy()
    win = sum(int(abs(v[m, c] - mc) < 10.0 * d) for d in dv.tolist()
              for m in range(M) for c in range(C))
    assert 0 < win < 4 * M * C     # the narrow windows leave entries out
    per = 4 * (6 * K * La) + K * win + 4 * C * (3 + 2 * K)
    sfu, flops, nbytes = chip_smoke.k2_work(port_k2.tables, K, dv, mc)
    assert sfu == per + 7 * C
    assert nbytes == 4 * (5 * La + 3 * M * C + 3 * C)
    assert chip_smoke.k2_work(port_k2.tables, K, dv, mc, evaluations=16)[0] == 16 * per + 7 * C
    assert chip_smoke.k2_work(port_k2.tables, K, dv, mc, evaluations=0.5)[0] == per / 2 + 7 * C
    assert flops > sfu


# -- the pipeline ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_fit(gotham_problem, tmp_path_factory):
    """MultiComponentFit(device='cpu') at 32 walkers x 40 steps."""
    from cha1_mcmc_tpu_torch import MultiFitConfig, MultiComponentFit

    folder = str(tmp_path_factory.mktemp("gotham_fit"))
    cfg = MultiFitConfig(mol_name="hc9n_hfs", template_run=True,
                         cat_folder=gotham_problem["cat_folder"],
                         data_path=gotham_problem["data_path"], fit_folder=folder,
                         nwalkers=32, nruns=40, checkpoint_every=20, seed=0,
                         device="cpu")
    fit = MultiComponentFit(cfg)
    return fit, fit.run()


def test_multicomponent_fit_cpu_end_to_end(cpu_fit):
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler

    fit, chain = cpu_fit
    cfg = fit.config
    assert type(fit.sampler) is EnsembleSampler
    assert chain.shape == (32, 40, 14) and np.isfinite(chain).all()
    for path in (cfg.chain_path, cfg.chain_path[:-4] + ".state.npz",
                 cfg.datagrid_path, os.path.join(cfg.mol_folder, "throughput.json")):
        assert os.path.exists(path), path
    assert 0.05 < fit.sampler.acceptance_fraction < 0.95
    # the velocity ordering holds on every sample with a finite lnp
    finite = np.isfinite(fit.sampler.lnprobability)
    assert finite.any()
    assert (np.diff(chain[..., 9:13][finite], axis=-1) > 0.05 - 1e-9).all()


def test_multicomponent_continue_from_chain(cpu_fit):
    """template_run=False, restart=False: priors from the previous chain,
    walkers from the median of its last 200 steps (reference
    TMC1_four_component.py:325-327)."""
    from cha1_mcmc_tpu_torch import MultiFitConfig, MultiComponentFit

    fit, chain = cpu_fit
    cfg2 = dataclasses.replace(fit.config, nruns=10, template_run=False,
                               restart=False, prior_path=fit.config.chain_path)
    fit2 = MultiComponentFit(cfg2)
    chain2 = fit2.fit(fit2.init_setup())    # run() less the corner plot
    assert chain2.shape == (32, 10, 14) and np.isfinite(chain2).all()
    center = np.median(chain[:, -200:, :].reshape(-1, 14), axis=0)
    np.testing.assert_allclose(np.median(chain2[:, 0, :], axis=0), center,
                               rtol=0.05)


def test_multifit_cuda_without_cuda_raises(gotham_problem):
    from cha1_mcmc_tpu_torch import MultiFitConfig, MultiComponentFit

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiComponentFit(MultiFitConfig(mol_name="hc9n_hfs", device="cuda"))


@pytest.mark.parametrize("what,match", [("n_devices", "P14"), ("n_chains", "P15"),
                                        ("workbench", "P12")])
def test_out_of_slice_branches_raise(reduced, what, match):
    from cha1_mcmc_tpu_torch import MultiFitConfig, MultiComponentFit
    from cha1_mcmc_tpu_torch.pipeline.presets import load_workbench_preset

    if match == "P14":
        # ported: the sharded multifit runs on a torch.distributed world
        # (tests/test_torch_parallel.py)
        assert MultiComponentFit(MultiFitConfig(mol_name="hc9n_hfs", device="cpu",
                                                n_devices=2)).sharded
        return
    if match == "P15":
        # ported: the multi-chain multifit runs in tests/test_torch_multichain.py
        fit = MultiComponentFit(MultiFitConfig(mol_name="hc9n_hfs", device="cpu",
                                               n_chains=2))
        assert fit.config.n_chains == 2 and not fit.sharded
        return
    # ported: the quickload builds its workbench session (held to JAX's in
    # tests/test_torch_workbench.py)
    wb = load_workbench_preset("tmc1")
    assert (wb.T, wb.dV, wb.vlsr, wb.source_size) == (8.0, 0.15, 5.82, 30.0)


@pytest.mark.parametrize("kernel", ["csr", "block"])
def test_multifit_lnprob_through_opacity_kernels(reduced, kernel):
    """The "csr" and "block" formulations (K4b / K4a's plain versions on
    the CPU) give the 4-component gather lnprob (f64)."""
    cat, grid = reduced
    with jax.enable_x64():
        jm = jax_gotham_model(cat, grid, "float64")
    th = torch.from_numpy(_with_outliers(_thetas(4, 24, seed=8)))
    gather = _port_gather_lnprob(jm, torch.float64, 4, grid)(th).numpy()
    got = _port_gather_lnprob(jm, torch.float64, 4, grid, use_pallas=True,
                              dv_max=DV_BOUND, pallas_kernel=kernel)(th).numpy()
    fin = np.isfinite(gather)
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], gather[fin], rtol=1e-12)


def test_presets_match_jax(tmp_path):
    from cha1_mcmc_tpu.pipeline import presets as jpresets
    from cha1_mcmc_tpu_torch import MultiFitConfig, load_preset
    from cha1_mcmc_tpu_torch.pipeline import presets

    assert presets.WORKBENCH_PRESETS == jpresets.WORKBENCH_PRESETS
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)
    os.makedirs(tmp_path / "GOTHAM")
    np.save(tmp_path / "GOTHAM" / "hc9n_hfs_chunks.npy", np.zeros((2, 4)))
    cfg = load_preset("gotham_tmc1_hc9n", str(tmp_path), "cat")
    assert isinstance(cfg, MultiFitConfig) and cfg.template_run
    assert cfg.catfile_path == os.path.join("cat", "hc9n_hfs.cat")
    with pytest.raises(FileNotFoundError, match="hc11n_chunks"):
        load_preset("gotham_tmc1_hc11n", str(tmp_path), "cat")
    with pytest.raises(KeyError):
        load_preset("nope", str(tmp_path), "cat")
