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
    """K1's cluster plan at the flagship size, and the gate (fused_fits:
    the plan at 8 CTAs, unstaged where the staged layout does not fit)."""
    from cha1_mcmc_tpu_torch.sampler.fused import fused_fits, plan_fused_cluster

    # flagship: 128 walkers x 4 dims, 9 lines x 561 channels x 3 entries,
    # f32, 16 CTAs: 4 proposals a CTA, the tables staged
    plan = plan_fused_cluster(128, 4, 9, 561, 3, torch.float32)
    assert (plan.cluster, plan.proposals, plan.per_cta, plan.staged) == (16, 64, 4, True)
    values = 128 * 5 + 10 * 561 + 5 * 9 + 4 * 9 + 16 + 4 * 5 + 4
    assert plan.smem_bytes == 4 * values + 4 * (3 * 561 + 4 + 2)
    assert fused_fits(128, 4, 9, torch.float32)
    # 8,192 walkers: 164 KB of f32 state fits a CTA now; 393 KB of f64 does not
    assert fused_fits(8192, 4, 9, torch.float32) and fused_fits(8192, 5, 9, torch.float32)
    assert not fused_fits(8192, 5, 9, torch.float64)


def _one_cta_bytes(nwalkers, ndim, n_lines, item):
    """The shared memory of the one-CTA K1 this cluster kernel replaced
    (state, proposals, stretch factors, 16 warps' (L,) opacities, flags)."""
    h = nwalkers // 2
    return item * (nwalkers * (ndim + 1) + h * (ndim + 1) + h + 16 * n_lines) + 4 * (h + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_layout_regions_tile(dtype):
    """Every region of K1's layouts (steps, K5a's half-step, the lnprob
    entry; staged and not) starts where the last ends, aligned to its
    type, with the sizes the kernel carves; K2's hfs group table is
    empty."""
    from cha1_mcmc_tpu_torch.sampler.cluster import REGIONS, T_REGIONS
    from cha1_mcmc_tpu_torch.sampler.fused import plan_fused_cluster, smem_layout

    item = torch.empty((), dtype=dtype).element_size()
    W, D, La, C, M = 100, 5, 9, 561, 3
    layouts = [(plan_fused_cluster(W, D, La, C, M, dtype).layout, W, D, 4, True),
               (plan_fused_cluster(W, D, La, C, M, dtype, cluster=8, stage=False).layout,
                W, D, 7, False),
               (plan_fused_cluster(W, D, La, C, M, dtype, resident_state=False).layout,
                0, D, 4, True),
               (smem_layout(dtype, La, C, M), 0, -1, 0, True)]
    for layout, rows, ndim, per_cta, staged in layouts:
        t = int(staged)
        sizes = dict(state=rows * (ndim + 1), chans=t * 3 * C, cc=t * 4 * C, vel=t * M * C,
                     lines=t * 5 * La, tau=4 * La, part=16, prop=per_cta * (ndim + 1),
                     zz=per_cta, line_idx=t * M * C, group=0, flag=per_cta, acc=2)
        at = 0
        for name, off in zip(REGIONS, layout.offsets):
            size = item if name in T_REGIONS else 4
            assert off == at and off % size == 0, name
            at += size * sizes[name]
        assert layout.bytes == at and layout.staged == staged and layout.fits


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_takes_every_shape_the_one_cta_gate_took(dtype):
    """fused_fits accepts, for K1 and for K5a, every (walkers, dims, lines)
    whose one-CTA working set fit a CTA, and more walkers besides."""
    from cha1_mcmc_tpu_torch.sampler.fused import fused_fits

    item = torch.empty((), dtype=dtype).element_size()
    took = 0
    for W in (2, 8, 64, 100, 128, 256, 1024, 2048, 4096, 6000, 8192):
        for D in (4, 5):
            for L in (1, 9, 63, 500, 2000, 3600):
                if _one_cta_bytes(W, D, L, item) <= 232_448:
                    took += 1
                    assert fused_fits(W, D, L, dtype), (W, D, L)
                    assert fused_fits(W, D, L, dtype, resident_state=False), (W, D, L)
    assert took > 50
    assert _one_cta_bytes(8192, 4, 9, 4) > 232_448 and fused_fits(8192, 4, 9, torch.float32)


def test_gate_has_no_channel_limit():
    """A wide single-component problem (9 lines x 200,000 channels) runs
    with its tables in device memory: the unstaged plan fits a CTA at 8
    and 16 CTAs; the tables are staged only where they fit."""
    from cha1_mcmc_tpu_torch.sampler.fused import plan_fused_cluster

    for n in (8, 16):
        plan = plan_fused_cluster(128, 4, 9, 200_000, 3, torch.float32, cluster=n)
        assert plan.fits and not plan.staged
        assert plan.layout == plan_fused_cluster(128, 4, 9, 561, 3, torch.float32,
                                                 cluster=n, stage=False).layout
    assert plan_fused_cluster(128, 4, 9, 4_000, 3, torch.float32).staged


def test_entry_tables_list_the_lines_in_window(port_problem):
    """K1's entry tables give, for each channel, exactly the lines whose
    window at the widened dV bound reaches it, in ascending line order:
    their velocities and (through the active-line table) their constants;
    padding at velocity 1e30."""
    from cha1_mcmc_tpu_torch.sampler.fused import DV_MARGIN

    run, _ = port_problem
    lines, vel, lines_a, vel_e, line_idx, chans, qst = run.tables
    st = run.statics
    inside = (vel - st.mask_center).abs() < 10.0 * st.bounds_hi[-1] * (1.0 + DV_MARGIN)
    M, C = vel_e.shape
    assert M == int(inside.sum(dim=0).max()) and C == vel.shape[1]
    assert line_idx.dtype == torch.int32 and lines_a.shape[1] == int(inside.any(dim=1).sum())
    for c in range(C):
        want = torch.nonzero(inside[:, c]).flatten()
        n = want.numel()
        assert torch.equal(vel_e[:n, c], vel[want, c])
        assert torch.equal(lines_a[:, line_idx[:n, c].long()], lines[:, want])
        assert bool((vel_e[n:, c] == 1e30).all()) and bool((line_idx[n:, c] == 0).all())


def _entry_order_lnprob(theta, tables, st):
    """K1's lnprob as the kernel sums it — per channel over its entries in
    table order, each term only where the proposal's window holds it —
    with the plain version's torch ops otherwise (4-dim)."""
    from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
    from cha1_mcmc_tpu_torch.ops.lte import beam_dilution, planck_J, tau_sticks
    from cha1_mcmc_tpu_torch.sampler.fused import _AA, prior_box

    _, _, lines_a, vel_e, line_idx, (gf, y, isig), qst = tables
    dt = theta.dtype
    Ncol, Tex, vlsr, dV = theta.unbind(1)
    Q = st.q_model()(Tex, states=(qst[0], qst[1]))
    taus = tau_sticks(torch, *lines_a, Q[:, None], Ncol[:, None], Tex[:, None], dV[:, None])
    sigma = dV / FWHM_TO_SIGMA_MODEL
    aa = (_AA / (sigma * sigma))[:, None]
    opac = torch.zeros((theta.shape[0], vel_e.shape[1]), dtype=dt)
    for m in range(vel_e.shape[0]):
        window = torch.abs(vel_e[m] - st.mask_center) < VELOCITY_WINDOW_DV * dV[:, None]
        d = vel_e[m] - vlsr[:, None]
        opac = torch.where(window, opac + taus[:, line_idx[m].long()] * torch.exp2(aa * (d * d)),
                           opac)
    J_T = planck_J(torch, gf, Tex[:, None], guard=1e-10)
    J_Tbg = planck_J(torch, gf, torch.tensor(st.Tbg, dtype=dt), guard=1e-10)
    dil = beam_dilution(torch, gf, torch.tensor(st.ss, dtype=dt), st.dish_size)
    resid = y - dil * (J_T - J_Tbg) * (1.0 - torch.exp(-opac))
    ll = -0.5 * torch.sum(resid * resid * isig - torch.log(isig), dim=-1)
    ok, lp = prior_box(theta, st)
    val = lp + ll
    return torch.where(ok & torch.isfinite(val), val, -torch.inf)


def test_entry_order_sum_equals_plain_bitwise(port_problem):
    """On the CPU in f64, the opacity summed over K1's entry tables in
    table order gives fused_lnprob_plain's lnprob bitwise: the lines the
    tables leave out, and the entries out of a proposal's window, are
    exact zeros of the plain version's line-order sum. Thetas over the
    whole dV box, so the windows range from narrow to the widest."""
    from cha1_mcmc_tpu_torch.sampler.fused import fused_lnprob_plain
    from tests.torch_parity import BOUNDS

    run, _ = port_problem
    rng = np.random.default_rng(4)
    n = 256
    lo, hi = BOUNDS["dV"]
    theta = torch.as_tensor(np.stack([10.0 ** rng.uniform(11.5, 13.0, n),
                                      rng.uniform(4.0, 11.0, n), rng.uniform(3.9, 4.3, n),
                                      lo + (hi - lo) * rng.uniform(0.0, 1.0, n)], axis=1))
    want = fused_lnprob_plain(theta, run.tables, run.statics)
    got = _entry_order_lnprob(theta, run.tables, run.statics)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want)


def test_k1_explicit_plan_is_checked_against_the_launch():
    """A plan handed to the K1 / K5a wrappers must have been made for the
    launch's sizes and entry and fit a CTA; else the wrapper raises before
    it launches anything."""
    from cha1_mcmc_tpu_torch.sampler.fused import checked_plan, plan_fused_cluster

    args = (64, 4, 9, 561, 3, torch.float32, torch.device("cpu"))
    k1 = plan_fused_cluster(64, 4, 9, 561, 3, torch.float32, cluster=8)
    k5a = plan_fused_cluster(64, 4, 9, 561, 3, torch.float32, cluster=8, resident_state=False)
    assert checked_plan("steps", k1, *args) is k1
    assert checked_plan("half", k5a, *args) is k5a
    with pytest.raises(ValueError, match="K5a half: a plan .* cannot launch"):
        checked_plan("half", k1, *args)
    with pytest.raises(ValueError, match="cannot launch"):
        checked_plan("steps", k1, 64, 5, *args[2:])
    with pytest.raises(ValueError, match="cannot launch"):
        checked_plan("steps", k1, 64, 4, 9, 561, 3, torch.float64, torch.device("cpu"))
    too_big = plan_fused_cluster(64, 4, 9, 200_000, 3, torch.float32, cluster=8, stage=True)
    with pytest.raises(ValueError, match="cannot launch"):
        checked_plan("steps", too_big, 64, 4, 9, 200_000, 3, torch.float32,
                     torch.device("cpu"))


@pytest.mark.parametrize("nwalkers,cluster", [(128, 16), (128, 8), (100, 16), (2048, 16),
                                              (40, 8), (8, 16)])
def test_k1_cluster_plan_owns_each_proposal_once(nwalkers, cluster):
    """K1's split of a half-update's h = W / 2 proposals over the cluster
    (csrc/cluster_step.cuh:owned_slice): each proposal has one owner, at
    most per_cta = ceil(h / n) a CTA, and the layout holds per_cta owned
    proposals."""
    from cha1_mcmc_tpu_torch.sampler.cluster import REGIONS
    from cha1_mcmc_tpu_torch.sampler.fused import plan_fused_cluster

    plan = plan_fused_cluster(nwalkers, 5, 9, 561, 3, torch.float64, cluster=cluster)
    h = nwalkers // 2
    slices = [plan.owned(r) for r in range(cluster)]
    assert [j for sl in slices for j in sl] == list(range(h))
    assert max(len(sl) for sl in slices) == plan.per_cta == -(-h // cluster)
    offsets = dict(zip(REGIONS, plan.layout.offsets))
    assert offsets["zz"] - offsets["prop"] == 8 * plan.per_cta * 6
