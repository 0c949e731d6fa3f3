"""The dense single-component slice of the torch port against the JAX
package, on the small synthetic dense problem (tests/port_problems.py:
write_dense_problem(scale="small"): an asymmetric-top catalog whose
228 covered lines x 858 channels give a split gather table and a
state-sum Q): the reduction, the sparsity tables (block mask, CSR,
gather, the dense K3 tables), the plain versions of K3
(sampler/fused_gather.py) and of K4a / K4b (models/opacity_kernels.py)
against the JAX package's functions and Pallas kernels (interpret mode,
as tests/test_pallas.py runs them), the "gather", "csr" and "block"
lnprobs, the dense MLE and SpectralFit on the sparse path on the CPU.

Tolerances: equal arrays for the host-side tables; lnprob f64 rtol 1e-12,
f32 rtol 1e-5 (the reductions run in another order); float64 chains,
acceptances and final positions bitwise, lnps rtol 1e-12; float32
chains bitwise on the tested stream. The CUDA kernels themselves are
compared with the plain versions on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import contextlib
import io

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.port_problems import (DENSE_BOUNDS, DENSE_CENTER, DENSE_DISH,
                                 DENSE_NAME, DENSE_SOURCE_SIZE)
from tests.torch_parity import (dense_problem, jax_dense_model, jax_dense_reduce,
                                jax_gather_plan, jax_randomness, port_model,
                                to_torch)

torch.set_num_threads(1)

W, NSTEPS, K_STEPS = 16, 8, 4
DV_MAX = 1.5
STUCK = 3   # walker started at vlsr 12: -inf, and every proposal it makes has
            # vlsr >= c + (12 - c) / 2 > 7.5, outside the box: it never accepts


@pytest.fixture(scope="module")
def reduced(dense_problem):
    with contextlib.redirect_stdout(io.StringIO()):
        return jax_dense_reduce(dense_problem)


def _scope(dtype):
    return jax.enable_x64() if dtype == "float64" else contextlib.nullcontext()


def _jax_q(cat, q_kind):
    from cha1_mcmc_tpu.catalogs.partition import QModel, _state_sum_model, fit_device_cheb

    if q_kind == "analytic":   # the 1-cyanonaphthalene power law
        return QModel(kind="analytic", coeffs=(0.0,), power=(560.39, 1.4984))
    states = _state_sum_model(cat)
    return states if q_kind == "states" else fit_device_cheb(states, 3.5, 12.0)


def _prior(problem, ndim):
    """(spec args, means, stds) of the dense fit's template prior."""
    ncol = problem["truth"][0]
    means = np.array([DENSE_SOURCE_SIZE, 1.2 * ncol, 8.0, DENSE_CENTER, 0.7575])
    stds = np.array([6.5, 0.5 * ncol, 3.0, 0.06, 0.22])
    ss = DENSE_SOURCE_SIZE if ndim == 4 else None
    return ss, means[5 - ndim:], stds[5 - ndim:]


def _thetas(problem, ndim, n, seed, spread=0.01):
    """n thetas around the injected truth; every 8th with dV above the
    bound (-inf under the prior)."""
    _, means, _ = _prior(problem, ndim)
    center = means.copy()
    center[ndim - 4] = problem["truth"][0]
    rng = np.random.default_rng(seed)
    th = center * (1 + spread * rng.standard_normal((n, ndim)))
    th[::8, -1] = 1.7
    return th


# -- host-side stages ---------------------------------------------------------

def test_dense_datagrid_matches_jax(dense_problem, reduced):
    """The port's reduction equals the JAX package's, and the small
    problem has the geometry the tests rely on."""
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.catalogs.partition import q_model_for_catalog
    from cha1_mcmc_tpu_torch.reduce import reduce_spectrum

    jcat, jgrid = reduced
    cat = load_catalog(dense_problem["cat_path"])
    grid = reduce_spectrum(cat, dense_problem["data_path"], ll=dense_problem["ll"],
                           ul=dense_problem["ul"], aligned_velocity=DENSE_CENTER,
                           dish_size=DENSE_DISH, source_size=DENSE_SOURCE_SIZE,
                           verbose=False)
    for name in ("freqs", "ints", "yerrs", "covered_trans"):
        np.testing.assert_array_equal(getattr(grid, name), getattr(jgrid, name))
    assert 150 <= grid.covered_trans.size <= 300
    assert 600 <= grid.freqs.size <= 1200
    qm = q_model_for_catalog(cat)
    assert qm.kind == "states" and qm.g.size >= 10_000


@pytest.mark.parametrize("min_saving", [1e9, 0.0], ids=["rect", "split"])
def test_dense_tables_match_jax(dense_problem, reduced, min_saving):
    """build_dense_tables: rectangular (min_saving 1e9) and split
    (min_saving 0), every array and scalar equal to the JAX package's."""
    from cha1_mcmc_tpu.sampler.fused_gather import build_dense_tables as jbuild
    from cha1_mcmc_tpu_torch.sampler.fused_gather import build_dense_tables

    jm = jax_dense_model(dense_problem, *reduced, "float32")
    want = jbuild(jm, DV_MAX, min_saving=min_saving)
    got = build_dense_tables(port_model(jm, torch.float32), DV_MAX, min_saving=min_saving)
    assert sorted(got) == sorted(want)
    assert got["has_overflow"] == (min_saving == 0.0)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


def test_sparsity_tables_match_jax(dense_problem, reduced):
    """block_activity_mask, build_opacity_csr, build_opacity_gather(_split)
    and window_is_exact equal the JAX package's."""
    from cha1_mcmc_tpu.models import pallas_kernels as jk
    from cha1_mcmc_tpu_torch.models import sparse_opacity as so

    jm = jax_dense_model(dense_problem, *reduced, "float32")
    vg = np.asarray(jm.vel_grid)
    for name in ("block_activity_mask", "build_opacity_csr", "build_opacity_gather",
                 "build_opacity_gather_split"):
        got, want = getattr(so, name)(vg, DENSE_CENTER, DV_MAX), getattr(jk, name)(
            vg, DENSE_CENTER, DV_MAX)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert so.build_opacity_gather_split(vg, DENSE_CENTER, DV_MAX) is not None
    for args in ((0.4, 1.4), (0.5, 0.5), (0.5, 0.2), (0.6, 4.1), (0.0, 0.1),
                 (1.5, 0.0), (0.7, 2.3)):
        assert so.window_is_exact(*args) == jk.window_is_exact(*args), args


@pytest.mark.parametrize("n_channels,cb0,cblock", [(858, 256, 128), (858, 0, 128),
                                                   (10924, 1536, 128),
                                                   (10924, 1536, 512), (300, 300, 256)])
def test_gather_geometry_matches_jax(n_channels, cb0, cblock):
    """K3's channel blocks are the JAX kernel's walk (_geom): n_bo
    overflow-region blocks, then n_br rest-region blocks."""
    from cha1_mcmc_tpu.sampler.fused_gather import _geom
    from cha1_mcmc_tpu_torch.sampler.fused_gather import gather_geometry

    g = _geom({"has_overflow": cb0 > 0, "cb0": cb0}, n_channels, 0, cblock)
    geom = gather_geometry(n_channels, cb0, cblock)
    assert geom.n_blk == g["n_bo"] + g["n_br"]
    assert geom.n_blk * cblock == g["Cp"] >= n_channels


# -- K3: the plain version against the JAX package ----------------------------

def _k3_pair(problem, reduced, dtype, q_kind, ndim, min_saving):
    """(JAX model, JAX statics/tables of _make_gather_lnprob, port runner)."""
    from cha1_mcmc_tpu.inference import ParamSpec
    from cha1_mcmc_tpu.sampler.fused_gather import gather_statics_tables
    from cha1_mcmc_tpu_torch.inference import ParamSpec as PortSpec
    from cha1_mcmc_tpu_torch.sampler.fused_gather import make_fused_ensemble_gather

    cat, grid = reduced
    ss, means, stds = _prior(problem, ndim)
    jm = jax_dense_model(problem, cat, grid, dtype, q_model=_jax_q(cat, q_kind))
    spec = ParamSpec(ncomp=1, fixed_source_size=ss)
    plan = jax_gather_plan(jm, spec, W, min_saving=min_saving)
    statics, dev = gather_statics_tables(jm, spec, grid.ints, grid.yerrs,
                                         dict(DENSE_BOUNDS), means, stds, plan)
    run = make_fused_ensemble_gather(
        port_model(jm, getattr(torch, dtype)), PortSpec(ncomp=1, fixed_source_size=ss),
        grid.ints, grid.yerrs, dict(DENSE_BOUNDS), means, stds, dv_max=DV_MAX,
        nwalkers=W, min_saving=min_saving)
    return jm, (statics, dev), run


@pytest.mark.parametrize("q_kind,ndim,min_saving", [
    ("analytic", 4, 1.3), ("cheb", 4, 1.3), ("states", 4, 1.3),
    ("analytic", 5, 1e9), ("cheb", 5, 1e9), ("states", 5, 1e9)])
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-5)])
def test_k3_lnprob_plain_matches_jax(dense_problem, reduced, q_kind, ndim, min_saving,
                                     dtype, rtol):
    """gather_lnprob_plain against the JAX _make_gather_lnprob on plain
    arrays (out_scratch=None): analytic / Chebyshev / state-sum Q, 4 and 5
    dims, the split and the rectangular tables."""
    from cha1_mcmc_tpu.sampler.fused_gather import _make_gather_lnprob

    th = _thetas(dense_problem, ndim, 24, seed=ndim)
    with _scope(dtype):
        _, (statics, dev), run = _k3_pair(dense_problem, reduced, dtype, q_kind, ndim,
                                          min_saving)
        want = np.asarray(_make_gather_lnprob(*dev, **statics)(
            jnp.asarray(th, dtype)))[:, 0]
    assert run.geometry.cb0 == (0 if min_saving > 1e3 else 256)
    got = run.lnprob(torch.as_tensor(th, dtype=getattr(torch, dtype))).numpy()
    fin = np.isfinite(want)
    assert 0 < fin.sum() < fin.size
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def _run_k3(problem, reduced, dtype, min_saving, key_seed):
    """The JAX K3 (interpret mode) and the port's plain K3 on the same
    constants, start (lnp0 from the JAX gather lnprob, as the JAX pipeline
    starts it) and randomness; walker STUCK starts outside the box."""
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnprob_batched,
                                         single_component_lnprior)
    from cha1_mcmc_tpu.sampler.fused_gather import make_fused_ensemble_gather

    cat, grid = reduced
    ss, means, stds = _prior(problem, 4)
    with _scope(dtype):
        jm, _, prun = _k3_pair(problem, reduced, dtype, "cheb", 4, min_saving)
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        jrun = make_fused_ensemble_gather(
            jm, spec, grid.ints, grid.yerrs, dict(DENSE_BOUNDS), means, stds,
            dv_max=DV_MAX, nwalkers=W, min_saving=min_saving,
            plan=jax_gather_plan(jm, spec, W, min_saving=min_saving), interpret=True)
        lnprob = build_lnprob_batched(
            jm, spec, grid.ints, grid.yerrs,
            single_component_lnprior(spec, dict(DENSE_BOUNDS), means, stds),
            use_pallas=True, dv_max=DV_MAX, pallas_kernel="gather")
        pos0 = _thetas(problem, 4, W, seed=key_seed)
        pos0[:, -1] = 0.7575 * (1 + 0.01 * np.random.default_rng(9).standard_normal(W))
        pos0[STUCK, 2] = 12.0
        pos0 = jnp.asarray(pos0, dtype)
        lnp0 = lnprob(pos0)
        key = jax.random.PRNGKey(key_seed)
        out_j = tuple(np.asarray(t) for t in (lambda c, l, a, f: (c, l, a, *f))(
            *jrun(pos0, lnp0, key, NSTEPS, K_STEPS)))
        rnd = jax_randomness(key, NSTEPS, W, dtype)
        pos0, lnp0 = np.array(pos0), np.array(lnp0)
    assert not np.isfinite(lnp0[STUCK])
    cp, lp, ap, (pp, lpp) = prun(torch.from_numpy(pos0), torch.from_numpy(lnp0),
                                 NSTEPS, K_STEPS, randomness=to_torch(rnd))
    return out_j, tuple(t.numpy() for t in (cp, lp, ap, pp, lpp))


@pytest.mark.parametrize("dtype,min_saving", [("float64", 1.3), ("float64", 1e9),
                                              ("float32", 1.3), ("float32", 1e9)],
                         ids=["f64-split", "f64-rect", "f32-split", "f32-rect"])
def test_k3_steps_plain_matches_jax(dense_problem, reduced, dtype, min_saving):
    """gather_steps_plain against the JAX K3 (Pallas, interpret mode) on
    one injected stream: chains, acceptances and final positions bitwise
    (float64, and float32 on this stream), lnps rtol 1e-12 / 1e-5; the
    walker started outside the box stays -inf."""
    (cj, lj, aj, pj, lpj), (cp, lp, ap, pp, lpp) = _run_k3(
        dense_problem, reduced, dtype, min_saving, key_seed=4)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(pp, pj)
    np.testing.assert_array_equal(np.isfinite(lp), np.isfinite(lj))
    fin = np.isfinite(lj)
    np.testing.assert_allclose(lp[fin], lj[fin], rtol=rtol)
    assert not np.isfinite(lp[:, STUCK]).any()
    assert 0 < int(ap.sum()) < NSTEPS * W


# -- K4a / K4b: the plain versions against the JAX Pallas kernels ---------------

def _random_problem(W=12, L=700, C=300, seed=0, center=4.10, dtype=np.float64):
    """Ragged tiles: 700 lines (two 512-line tiles), 300 channels (three
    128-channel tiles), 12 walkers."""
    rng = np.random.default_rng(seed)
    line_freq = np.sort(rng.uniform(18e3, 25e3, L))
    grid_freq = np.sort(rng.uniform(18e3, 25e3, C))
    vel = ((line_freq[:, None] - grid_freq[None, :]) / line_freq[:, None]
           * 2.998e5 + center).astype(dtype)
    taus = rng.uniform(0, 0.1, (W, L)).astype(dtype)
    vlsr = rng.uniform(center - 0.1, center + 0.2, W).astype(dtype)
    dV = rng.uniform(0.5, 1.2, W).astype(dtype)
    return vel, taus, vlsr, dV


def _dense_reference(vel, taus, vlsr, dV, center):
    sigma = dV[:, None, None] / 2.355
    window = np.abs(vel[None] - center) < 10 * dV[:, None, None]
    z = (vel[None].astype(np.float64) - vlsr[:, None, None]) / sigma
    return np.einsum("wl,wlc->wc", taus.astype(np.float64),
                     np.where(window, np.exp(-0.5 * z * z), 0.0))


_RTOL = {"float64": 1e-12, "float32": 1e-5}
#: float32 values below the smallest normal number: the JAX package's CPU
#: backend flushes subnormals to 0, torch keeps them (as the card does).
_ATOL = {"float64": 0.0, "float32": float(np.finfo(np.float32).tiny)}


def _jax_block(entry, dtype, taus, vlsr, dV, vel, mask):
    """The JAX block-sparse kernel of `entry` (interpret mode). Its exp2
    kernels accumulate the MXU dot in float32 even for float64 inputs
    (preferred_element_type=jnp.float32, models/pallas_kernels.py:168-170),
    so in float64 the masked exp2 form is held to the exp-form
    opacity_pallas, which computes in float64 (the two forms agree to
    rounding), and the unmasked form to the same sum in NumPy float64 over
    the active tiles with no window."""
    from cha1_mcmc_tpu.models import pallas_kernels as jk

    if entry.endswith("unmasked") and dtype == "float64":
        sigma = dV[:, None, None] / 2.355
        z = (vel[None] - vlsr[:, None, None]) / sigma
        active = np.kron(mask, np.ones((512, 128)))[:vel.shape[0], :vel.shape[1]]
        return np.einsum("wl,wlc->wc", taus, np.exp(-0.5 * z * z) * active)
    with _scope(dtype):
        args = [jnp.asarray(x) for x in (taus, vlsr, dV, vel, mask)]
        if entry.startswith("mxu") and dtype == "float32":
            out = jk.opacity_pallas_mxu(*args, mask_center=4.10, interpret=True,
                                        unmasked=entry == "mxu-unmasked")
        elif entry.startswith("mxu"):
            out = jk.opacity_pallas(*args, mask_center=4.10, interpret=True)
        else:
            out = getattr(jk, entry)(*args, mask_center=4.10, interpret=True)
        return np.asarray(out)


@pytest.mark.parametrize("entry", ["opacity_pallas", "opacity_pallas_fused",
                                   "mxu-masked", "mxu-unmasked"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_block_opacity_plain_matches_jax(entry, dtype):
    """K4a's plain version in the exp form against the JAX opacity_pallas
    and opacity_pallas_fused, in the exp2 form against opacity_pallas_mxu
    masked and unmasked (all interpret mode; float64 exp2 as _jax_block
    says). The unmasked case is window_is_exact's regime (dV >= 0.5,
    |vlsr - center| <= 0.2)."""
    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok
    from cha1_mcmc_tpu_torch.models.sparse_opacity import block_activity_mask

    vel, taus, vlsr, dV = _random_problem(dtype=np.dtype(dtype))
    mask = block_activity_mask(vel, 4.10, dv_max=1.5)
    want = _jax_block(entry, dtype, taus, vlsr, dV, vel, mask)
    t = [torch.from_numpy(x) for x in (taus, vlsr, dV, vel, mask)]
    if entry.startswith("mxu"):
        got = ok.opacity_pallas_mxu(*t, mask_center=4.10,
                                    unmasked=entry == "mxu-unmasked")
    else:
        got = getattr(ok, entry)(*t, mask_center=4.10)
    assert got.dtype == getattr(torch, dtype) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=_RTOL[dtype], atol=_ATOL[dtype])


@pytest.mark.parametrize("unmasked", [False, True], ids=["masked", "unmasked"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_csr_opacity_plain_matches_jax(unmasked, dtype):
    """K4b's plain version against the JAX opacity_pallas_csr (interpret
    mode), masked and unmasked; in float64, as the JAX CSR kernel also
    accumulates in float32, masked against the float64 opacity_pallas and
    unmasked against the same sum over each tile's CSR lines in NumPy
    (float64 keeps the tails of the lines the CSR table leaves out, so
    the unmasked sum depends on the line list)."""
    from cha1_mcmc_tpu.models import pallas_kernels as jk
    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok
    from cha1_mcmc_tpu_torch.models.sparse_opacity import (block_activity_mask,
                                                           build_opacity_csr)

    vel, taus, vlsr, dV = _random_problem(dtype=np.dtype(dtype))
    lt, vc, tc = build_opacity_csr(vel, 4.10, dv_max=1.5)
    if dtype == "float64" and unmasked:    # the same sum in NumPy, CSR lines
        want = np.zeros((12, 384))
        for j, n in enumerate(tc):
            z = (vc[j * lt.shape[1]:j * lt.shape[1] + n][None] - vlsr[:, None, None]) / (
                dV[:, None, None] / 2.355)
            want[:, j * 128:(j + 1) * 128] = np.einsum(
                "wl,wlc->wc", taus[:, lt[j, :n]], np.exp(-0.5 * z * z))
        want = want[:, :300]
    elif dtype == "float64":
        want = _jax_block("opacity_pallas", dtype, taus, vlsr, dV, vel,
                          block_activity_mask(vel, 4.10, dv_max=1.5))
    else:
        want = np.asarray(jk.opacity_pallas_csr(
            *(jnp.asarray(x) for x in (taus, vlsr, dV, lt, vc, tc)), mask_center=4.10,
            n_channels=300, interpret=True, unmasked=unmasked))
    got = ok.opacity_pallas_csr(*(torch.from_numpy(x) for x in (taus, vlsr, dV, lt, vc, tc)),
                                mask_center=4.10, n_channels=300, unmasked=unmasked)
    assert got.shape == (12, 300) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=_RTOL[dtype], atol=_ATOL[dtype])


def test_window_masking_at_extreme_vlsr():
    """Far from the aligned velocity the window select is not a no-op: the
    masked forms stay exact there, the unmasked exp2 form diverges, and
    neither window_is_exact nor unmasked_is_exact admits the regime. In a
    provably safe box the unmasked form is exact in float32; float64
    keeps the Gaussian's tail down to z = 38.6, so unmasked_is_exact
    admits only float32 (the JAX package's analogue:
    tests/test_pallas.py:test_window_masking_at_extreme_vlsr)."""
    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok
    from cha1_mcmc_tpu_torch.models.sparse_opacity import (block_activity_mask,
                                                           build_opacity_csr,
                                                           window_is_exact)

    center = 4.10
    vel, taus, vlsr, dV = _random_problem(dtype=np.float32)
    vlsr = np.full_like(vlsr, 9.9)
    dV = np.full_like(dV, 0.6)
    expected = _dense_reference(vel, taus, vlsr, dV, center)
    mask = torch.from_numpy(block_activity_mask(vel, center, dv_max=1.5))
    T = [torch.from_numpy(x) for x in (taus, vlsr, dV, vel)]
    assert not window_is_exact(0.6, 9.9 - center)
    assert not ok.unmasked_is_exact(0.6, 9.9 - center, torch.float32)
    assert not ok.unmasked_is_exact(0.4, 1.4, torch.float32)
    for form in ("exp", "exp2"):
        masked = ok.opacity_block_plain(*T, mask, mask_center=center, form=form)
        np.testing.assert_allclose(masked.numpy(), expected, rtol=2e-4,
                                   atol=1e-6 * max(1.0, expected.max()))
    unmasked = ok.opacity_pallas_mxu(*T, mask, mask_center=center, unmasked=True)
    assert np.abs(unmasked.numpy() - expected).max() > 1e-3
    lt, vc, tc = (torch.from_numpy(x) for x in build_opacity_csr(vel, center, 1.5))
    csr = ok.opacity_pallas_csr(*T[:3], lt, vc, tc, mask_center=center, n_channels=300)
    np.testing.assert_allclose(csr.numpy(), expected, rtol=2e-4,
                               atol=1e-6 * max(1.0, expected.max()))

    vel, taus, vlsr, dV = _random_problem(dtype=np.float32)
    assert ok.unmasked_is_exact(0.5, 0.2, torch.float32)
    assert not ok.unmasked_is_exact(0.5, 0.2, torch.float64)
    T = [torch.from_numpy(x) for x in (taus, vlsr, dV, vel)]
    mask = torch.from_numpy(block_activity_mask(vel, center, dv_max=1.5))
    np.testing.assert_array_equal(
        ok.opacity_pallas_mxu(*T, mask, mask_center=center, unmasked=True).numpy(),
        ok.opacity_pallas_mxu(*T, mask, mask_center=center).numpy())


def test_unmasked_threshold_rederived_for_subnormals():
    """Without a flush to zero, float32 exp2(aa d^2) is a subnormal, not 0,
    just past the TPU threshold z = 14.37, and rounds to 0 only past
    z = 14.4205; float64 only past 38.6."""
    from cha1_mcmc_tpu_torch.models.opacity_kernels import _Z_UNDERFLOW

    def gauss(z, dtype):
        aa = torch.tensor(-0.5 * 1.4426950408889634, dtype=dtype)   # sigma = 1
        return float(torch.exp2(aa * torch.tensor(z, dtype=dtype) ** 2))

    assert abs(_Z_UNDERFLOW[torch.float32] - 14.4205) < 1e-3
    assert abs(_Z_UNDERFLOW[torch.float64] - 38.6) < 0.05
    assert 0.0 < gauss(14.38, torch.float32) < 2.0 ** -126      # subnormal
    assert gauss(14.43, torch.float32) == 0.0
    assert gauss(30.0, torch.float64) > 0.0
    assert gauss(38.7, torch.float64) == 0.0


# -- the likelihood formulations ------------------------------------------------

@pytest.mark.parametrize("kernel", ["gather", "csr", "block"])
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-5)])
def test_lnprob_formulations_match_jax(dense_problem, reduced, kernel, dtype, rtol):
    """build_lnprob_batched for "gather", "csr" and "block" against the
    JAX package's (interpret=True). Its "block" runs opacity_pallas (the
    exp form) under the interpreter while the port keeps the exp2 form on
    every device: the two forms agree to rounding, within the same
    tolerances. In float64 "csr" is held to the JAX "gather" (the JAX
    CSR kernel accumulates in float32)."""
    from cha1_mcmc_tpu.inference import ParamSpec as JSpec
    from cha1_mcmc_tpu.inference import build_lnprob_batched as jbuild
    from cha1_mcmc_tpu.inference import single_component_lnprior as jprior
    from cha1_mcmc_tpu_torch.inference import (ParamSpec, build_lnprob_batched,
                                               single_component_lnprior)

    cat, grid = reduced
    ss, means, stds = _prior(dense_problem, 4)
    th = _thetas(dense_problem, 4, 24, seed=11)
    kw = dict(use_pallas=True, dv_max=DV_MAX, pallas_kernel=kernel,
              dv_min=DENSE_BOUNDS["dV"][0], vlsr_bounds=DENSE_BOUNDS["vlsr"])
    # The JAX CSR kernel accumulates in float32 even for float64 inputs
    # (see _jax_block): in float64 "csr" is held to the JAX "gather".
    jkw = dict(kw, pallas_kernel="gather") if (kernel, dtype) == ("csr", "float64") else kw
    with _scope(dtype):
        jm = jax_dense_model(dense_problem, cat, grid, dtype)
        spec = JSpec(ncomp=1, fixed_source_size=ss)
        want = np.asarray(jbuild(jm, spec, grid.ints, grid.yerrs,
                                 jprior(spec, dict(DENSE_BOUNDS), means, stds),
                                 interpret=True, **jkw)(jnp.asarray(th, dtype)))
    tdt = getattr(torch, dtype)
    spec = ParamSpec(ncomp=1, fixed_source_size=ss)
    got = build_lnprob_batched(
        port_model(jm, tdt), spec, grid.ints, grid.yerrs,
        single_component_lnprior(spec, dict(DENSE_BOUNDS), means, stds, dtype=tdt),
        **kw)(torch.as_tensor(th, dtype=tdt)).numpy()
    fin = np.isfinite(want)
    assert 0 < fin.sum() < fin.size
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def test_dense_mle_matches_jax(dense_problem, reduced):
    """The dense MLE (the device search over build_lnlike_batched's gather
    lnlike) against the JAX package's batched MLE, rel 1e-4 (f64)."""
    from cha1_mcmc_tpu.inference import ParamSpec as JSpec
    from cha1_mcmc_tpu.inference import estimate_ncol_mle as jmle
    from cha1_mcmc_tpu.inference.likelihood import build_lnlike_batched as jlike
    from cha1_mcmc_tpu_torch.inference import (ParamSpec, build_lnlike_batched,
                                               estimate_ncol_mle)

    cat, grid = reduced
    ss, means, _ = _prior(dense_problem, 4)
    kw = dict(use_pallas=True, dv_max=DV_MAX)
    with jax.enable_x64():
        jm = jax_dense_model(dense_problem, cat, grid, "float64")
        want = jmle(jlike(jm, JSpec(ncomp=1, fixed_source_size=ss), grid.ints,
                          grid.yerrs, **kw),
                    JSpec(ncomp=1, fixed_source_size=ss), means, DENSE_BOUNDS["Ncol"],
                    batched=True)
    spec = ParamSpec(ncomp=1, fixed_source_size=ss)
    got = estimate_ncol_mle(build_lnlike_batched(port_model(jm, torch.float64), spec,
                                                 grid.ints, grid.yerrs, **kw),
                            spec, means, DENSE_BOUNDS["Ncol"], device="cpu",
                            dtype=torch.float64)
    assert abs(got / want - 1) < 1e-4
    assert abs(got / dense_problem["truth"][0] - 1) < 0.5


# -- the pipeline on the CPU ----------------------------------------------------

def _config(problem, tmp, **kw):
    from cha1_mcmc_tpu_torch import FitConfig

    ncol = problem["truth"][0]
    base = dict(mol_name=DENSE_NAME, cat_folder=problem["cat_folder"],
                data_path=problem["data_path"], fit_folder=str(tmp), nwalkers=W,
                nruns=12, checkpoint_every=6, seed=11, device="cpu",
                lower_limit=problem["ll"], upper_limit=problem["ul"],
                dish_size=DENSE_DISH, aligned_velocity=DENSE_CENTER,
                fixed_source_size=DENSE_SOURCE_SIZE, bounds=dict(DENSE_BOUNDS),
                template_means=(DENSE_SOURCE_SIZE, 1.2 * ncol, 8.0, DENSE_CENTER, 0.7575),
                template_stds=(6.5, 0.5 * ncol, 3.0, 0.06, 0.22))
    base.update(kw)
    return FitConfig(**base)


def test_dense_fit_on_cpu(dense_problem, tmp_path):
    """SpectralFit(use_pallas=True, device="cpu").run() takes the general
    sampler over the gather lnprob and returns a finite (W, S, D) chain."""
    from cha1_mcmc_tpu_torch import EnsembleSampler, SpectralFit

    fit = SpectralFit(_config(dense_problem, tmp_path, use_pallas=True))
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    assert type(fit.sampler) is EnsembleSampler
    assert chain.shape == (W, 12, 4) and np.isfinite(chain).all()
    assert 0.0 < fit.sampler.acceptance_fraction < 1.0


def test_dense_auto_selection(dense_problem, tmp_path, monkeypatch):
    """use_pallas=None takes the sparse path above the JAX package's
    n_lines x n_channels threshold (lowered here to the small problem's
    size) and no longer raises; below it, the dense model."""
    from cha1_mcmc_tpu_torch import SpectralFit
    from cha1_mcmc_tpu_torch.pipeline import fit as fit_mod

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        SpectralFit(_config(dense_problem, tmp_path / "below", nruns=6)).run()
    assert "sparse opacity path" not in out.getvalue()
    monkeypatch.setattr(fit_mod, "DENSE_AUTO_THRESHOLD", 100_000)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chain = SpectralFit(_config(dense_problem, tmp_path / "above", nruns=6)).run()
    assert "auto-selected the sparse opacity path" in out.getvalue()
    assert chain.shape == (W, 6, 4) and np.isfinite(chain).all()


def test_k3_selection_rule(dense_problem, tmp_path):
    """K3 is chosen on a CUDA device for float32 with use_fused_step and a
    plan within its limits (JAX fit.py:292-296); the plan is kept."""
    from cha1_mcmc_tpu_torch import SpectralFit

    fit = SpectralFit(_config(dense_problem, tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        model = fit.build_model(fit.init_setup())
    assert not fit._use_fused_gather(model)      # CPU: the general sampler
    fit.device = torch.device("cuda")            # the rule alone, no card used
    assert fit._use_fused_gather(model)
    assert fit._gather_plan["geometry"].cb0 == 256
    fit.config.use_fused_step = False
    assert not fit._use_fused_gather(model)
    fit.config.use_fused_step = True
    fit.dtype = torch.float64
    assert not fit._use_fused_gather(model)


def test_k3_limits(dense_problem, reduced):
    """plan_fused_gather refuses what K3 does not take; the runner raises
    on it, and the wrappers refuse a device that is neither CUDA nor the
    CPU."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler.fused_gather import (
        fused_gather_supported, make_fused_ensemble_gather, plan_fused_gather)

    jm = jax_dense_model(dense_problem, *reduced, "float32")
    model = port_model(jm, torch.float32)
    spec = ParamSpec(ncomp=1, fixed_source_size=DENSE_SOURCE_SIZE)
    assert fused_gather_supported(model, spec, DV_MAX, nwalkers=128)
    assert not fused_gather_supported(model, ParamSpec(ncomp=2), DV_MAX)
    assert not fused_gather_supported(model, spec, DV_MAX, nwalkers=4096)
    assert plan_fused_gather(model, spec, DV_MAX, cblock=100) is None
    assert plan_fused_gather(model, spec, DV_MAX, cblock=1024) is None
    with pytest.raises(ValueError, match="K3 does not take"):
        make_fused_ensemble_gather(model, ParamSpec(ncomp=2), [], [], {}, [], [],
                                   dv_max=DV_MAX)
    _, means, stds = _prior(dense_problem, 4)
    run = make_fused_ensemble_gather(model, spec, reduced[1].ints, reduced[1].yerrs,
                                     dict(DENSE_BOUNDS), means, stds, dv_max=DV_MAX,
                                     nwalkers=W)
    with pytest.raises(ValueError, match="K3 runs on CUDA"):
        run.lnprob(torch.zeros((2, 4), device="meta"))


def test_k3_checkpoint_resume_exact(dense_problem, reduced, tmp_path):
    """FusedEnsembleSampler over the K3 runner (the plain version on the
    CPU): a run interrupted at a checkpoint and resumed from its
    .state.npz continues bit for bit (the analogue of
    tests/test_pallas.py:test_fused_gather_checkpoint_resume_exact)."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler import FusedEnsembleSampler
    from cha1_mcmc_tpu_torch.sampler.fused_gather import (LAUNCHES,
                                                          make_fused_ensemble_gather)

    jm = jax_dense_model(dense_problem, *reduced, "float32")
    spec = ParamSpec(ncomp=1, fixed_source_size=DENSE_SOURCE_SIZE)
    _, means, stds = _prior(dense_problem, 4)
    run = make_fused_ensemble_gather(port_model(jm, torch.float32), spec,
                                     reduced[1].ints, reduced[1].yerrs,
                                     dict(DENSE_BOUNDS), means, stds, dv_max=DV_MAX,
                                     nwalkers=W)
    pos0 = _thetas(dense_problem, 4, W, seed=5)
    pos0[:, -1] = 0.7575

    def sampler():
        return FusedEnsembleSampler(lnprob_fn=None, nwalkers=W, ndim=4, run_fn=run,
                                    k_steps=4, device="cpu")

    before = dict(LAUNCHES)
    full = sampler()
    full.run_mcmc(pos0, 16, torch.Generator().manual_seed(3), checkpoint_every=8)
    path = str(tmp_path / "chain.npy")
    first = sampler()
    first.run_mcmc(pos0, 8, torch.Generator().manual_seed(3), checkpoint_every=8,
                   chain_file=path)
    second = sampler()
    second.preload(np.load(path))
    pos, lnp, state = second.load_state(path)
    gen = torch.Generator()
    gen.set_state(state)
    second.run_mcmc(pos, 8, gen, checkpoint_every=8, lnp0=lnp)
    np.testing.assert_array_equal(second.chain, full.chain)
    assert second.accepted == full.accepted > 0
    assert LAUNCHES == before      # the plain version launches nothing
