"""K2: the fused whole-ensemble-step kernel for K-component fits and its
plain PyTorch version.

Port of cha1_mcmc_tpu/sampler/fused_multi.py. One launch of the CUDA
kernel (csrc/multi_step.cu) runs k emcee-v3 stretch-move steps of one
K-component ensemble (theta = [ss x K | Ncol x K | Tex | vlsr x K | dV],
the GOTHAM / TMC-1 family, reference TMC1_four_component.py): both
sequential half-updates of every step, each with its walker gathers, the
K-component LTE model, the ordered-velocity prior and the acceptance
write-back. A launch takes one of two paths (sampler/cluster.py:
steps_plan): the wide path, where the K chains' h = W / 2 CTAs each fit
the card at once — one cooperative launch, CTA j of a chain owning
proposal j of every half-update with the whole CTA — else one
thread-block cluster a chain (csrc/cluster_step.cuh: 16 CTAs, or 8 where
the card cannot place 16, each owning a slice of every half-update's
proposals). `FAMILY` declares what K2 and its sharded half-step K5c need
of the cluster binding, which plans, checks and launches them. It reads the
channel-major tables of the gather formulation (models/sparse_opacity.py):
for each channel, the few lines whose ±10·dv_max window can touch it,
with the hfs group of each, so the opacity sums run in the TPU kernel's
group-then-scatter order.

Beside the kernel, `multi_lnprob_plain` / `multi_steps_plain` compute the
same function with torch ops, in the same formulation (channel-major
tables, exp2 Gaussians, the same statics, the randomness layout of
run_ensemble). The wrappers `multi_lnprob` / `multi_step_block` launch the
kernel for CUDA tensors and take the plain version only for CPU tensors;
`LAUNCHES` counts kernel launches.

The TPU kernel's layout machinery (_chunk_plan, _build_velc,
_default_line_chunk, the transposed (D+1, W) state) has no counterpart
here; `window_extents` stays, so the port selects K2 exactly where the
JAX package selects its kernel, with a Hopper shared-memory gate.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import numpy as np
import torch

from cha1_mcmc_tpu_torch.catalogs.partition import QModel
from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
from cha1_mcmc_tpu_torch.models.sparse_opacity import build_opacity_gather
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu_torch.sampler import cluster
from cha1_mcmc_tpu_torch.sampler.cluster import (ClusterPlan, check_tensor, launch_lnprob,
                                                 launch_steps, route)
from cha1_mcmc_tpu_torch.sampler.fused import (_AA, _MAX_CHEB, _MAX_POLY, FusedEnsemble,
                                               gauss_norm, pack_q, q_statics,
                                               statics_q_model, steps_plain)
from cha1_mcmc_tpu_torch.utils.metrics import register_launches

__all__ = ["window_extents", "fused_multi_supported", "MultiStatics",
           "multi_statics_tables", "multi_lnprob_plain", "multi_prior_plain",
           "multi_steps_plain", "multi_lnprob", "multi_step_block", "MultiFusedEnsemble",
           "make_fused_ensemble_multi", "K2_LANE_WARPS", "kernel_tables", "FAMILY",
           "LAUNCHES"]

_MAX_COMP = 4   # kMaxComp of the kernel's MultiStatics (csrc/multi_step.cu)

#: K2's lnprob (csrc/multi_step.cu: MultiGroupLnProb) is one function over
#: 512 lanes, each warp of lanes' sum a chi^2 partial: K2_LANE_WARPS
#: partials a proposal (checked against k2_geometry when the library
#: loads). The cluster path, the lnprob entry and K5c run it in
#: cluster.GROUPS groups of four warps a CTA, four lanes a thread; the wide
#: path in one group of all 16 warps.
K2_LANE_WARPS = cluster.LANE_WARPS

#: Kernel launches per K2 entry, counted where each kernel is launched and
#: nowhere else (plain-version calls do not count).
LAUNCHES = register_launches({"multi_steps": 0, "multi_lnprob": 0})


def window_extents(vel_grid: np.ndarray, mask_center: float, dv_max: float):
    """Per-line window extents (verbatim from the JAX package).

    For each catalog line whose widest-possible velocity window
    (±10·dv_max around mask_center, reference inference.py:52 /
    TMC1_four_component.py:160) touches any channel, find the covering
    contiguous channel extent. Returns (active (La,), first (La,) int,
    last (La,) int, C). Raises ValueError if any line's window is
    non-contiguous in the stored channel order (callers fall back to the
    general sampler)."""
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    inside = np.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    active = np.flatnonzero(inside.any(axis=1))
    if active.size == 0:
        active = np.array([0])
        inside[0, 0] = True
    first = inside[active].argmax(axis=1)
    last = C - 1 - inside[active][:, ::-1].argmax(axis=1)
    for l, f, t in zip(active, first, last):
        if not inside[l, f:t + 1].all():
            raise ValueError(
                f"line {l}: velocity window is not contiguous in the "
                "stored channel order")
    return active, first, last, C


def fused_multi_supported(model, spec, dv_max: float, *, nwalkers: int = 128,
                          resident_state: bool = True) -> bool:
    """Can this (model, spec) run through K2 (K5c with resident_state
    False)? The ordered-velocity family (free source sizes) with at most 4
    components, every line window contiguous in channel order
    (window_extents, the JAX package's condition), and the cluster
    binding's gate at `nwalkers` (cluster.admits: the 8-CTA plan within a
    Hopper CTA's shared memory, with the tables read from device memory,
    a layout that grows with the walkers and the active lines but not
    with the channels)."""
    if not spec.free_source_size or spec.ncomp > _MAX_COMP:
        return False
    try:
        active, _, _, _ = window_extents(model.vel_grid.cpu().numpy(), model.mask_center,
                                         dv_max)
    except ValueError:
        return False
    return cluster.admits(FAMILY, nwalkers, spec.ncomp, 3 * spec.ncomp + 2, active.size,
                          model.dtype, resident_state=resident_state)


@dataclasses.dataclass(frozen=True)
class MultiStatics:
    """Scalar constants of K2's lnprob and step (the JAX package's
    multi_statics_tables statics, plus the stretch scale a). Prior
    vocabulary of ordered_velocity_lnprior: Gaussian ss / Tex / vlsr / dV
    with sigma_vlsr = 0.8 mean_dV and sigma_dV = 0.3 mean_dV, flat Ncol,
    hard bounds and velocity-ordering constraints. q_kind 'cheb' carries
    the Chebyshev coefficients in q_coeffs and the fit interval in
    q_power."""

    ncomp: int
    dish_size: float
    Tbg: float
    mask_center: float
    q_kind: str                      # 'analytic' | 'cheb' | 'states'
    q_coeffs: tuple
    q_power: tuple | None
    q_scale: float
    ss_bounds: tuple
    ncol_bounds: tuple
    tex_min: float
    dv_bound: float
    vlsr_min_sep: float
    vlsr_max_sep: float
    mean_ss: tuple
    std_ss: tuple
    mean_tex: float
    std_tex: float
    mean_vlsr: tuple
    std_vlsr: tuple
    mean_dv: float
    std_dv: float
    a: float = 2.0

    def q_model(self) -> QModel:
        return statics_q_model(self)

    @property
    def ndim(self) -> int:
        return 3 * self.ncomp + 2


def multi_statics_tables(model, spec, grid_ints, grid_yerrs, prior_means,
                         prior_stds, *, dv_max: float, ss_bounds=(0.0, 200.0),
                         ncol_bounds=(0.0, 1e16), tex_min: float = 2.7,
                         vlsr_min_sep: float = 0.05, vlsr_max_sep: float = 0.3,
                         a: float = 2.0):
    """(MultiStatics, tables) for K2's lnprob. Tables are tensors on the
    model's device: lines (5, La) = freq, elower, aij, gup, glow of the
    active lines (those a ±10·dv_max window reaches); the channel-major
    gather tables of
    build_opacity_gather, vel (M, C) in the model's dtype (1e30 on
    padding) and line_idx (M, C) int32, plus group (M, C) int32, the hfs
    group of each entry's line (consecutive active lines sharing one
    window start, as the JAX kernel's _chunk_plan groups them); chans
    (3, C) = freq, y, 1/sigma^2; qst (2, S) = state-sum g, E (a dummy
    (2, 8) for the other Q kinds)."""
    if not spec.free_source_size:
        raise ValueError("K2 needs a free source size (the ordered-velocity "
                         "prior family)")
    K = spec.ncomp
    dev, dt = model.device, model.dtype
    means = np.asarray(prior_means, dtype=np.float64)
    stds = np.asarray(prior_stds, dtype=np.float64)
    mean_dv = float(means[3 * K + 1])
    vg = model.vel_grid.cpu().numpy()
    _, first, _, _ = window_extents(vg, model.mask_center, dv_max)
    line_table, vel_t, active = build_opacity_gather(vg, model.mask_center, dv_max)
    group_of = np.concatenate([[0], np.cumsum(first[1:] != first[:-1])])
    idx = torch.as_tensor(active, dtype=torch.long, device=dev)
    lines = torch.stack([getattr(model, name)[idx] for name in
                         ("line_freq", "line_elower", "line_aij", "line_gup",
                          "line_glow")])
    chans = torch.stack([model.grid_freq,
                         torch.as_tensor(grid_ints, dtype=dt, device=dev),
                         1.0 / torch.as_tensor(grid_yerrs, dtype=dt, device=dev) ** 2])
    q, qst = q_statics(model)
    statics = MultiStatics(
        ncomp=K, dish_size=float(model.dish_size), Tbg=float(model.Tbg),
        mask_center=float(model.mask_center), **q,
        ss_bounds=tuple(map(float, ss_bounds)),
        ncol_bounds=tuple(map(float, ncol_bounds)), tex_min=float(tex_min),
        dv_bound=float(dv_max), vlsr_min_sep=float(vlsr_min_sep),
        vlsr_max_sep=float(vlsr_max_sep),
        mean_ss=tuple(map(float, means[0:K])), std_ss=tuple(map(float, stds[0:K])),
        mean_tex=float(means[2 * K]), std_tex=float(stds[2 * K]),
        mean_vlsr=tuple(map(float, means[2 * K + 1:3 * K + 1])),
        std_vlsr=(0.8 * mean_dv,) * K,      # reference :244-248
        mean_dv=mean_dv, std_dv=0.3 * mean_dv, a=float(a))
    tables = (lines,
              torch.as_tensor(vel_t, dtype=dt, device=dev),
              torch.as_tensor(line_table, dtype=torch.int32, device=dev),
              torch.as_tensor(group_of[line_table], dtype=torch.int32, device=dev),
              chans, qst)
    return statics, tables


# -- plain PyTorch version ---------------------------------------------------

def multi_lnprob_plain(theta, tables, st: MultiStatics):
    """K2's lnprob with torch ops, (N, D) -> (N,): the K-component LTE
    model from the channel-major tables — per channel, each hfs group's
    in-window lines summed in line order, the group sums added in group
    order, as the kernel (and the TPU kernel) sums them — its chi^2, and
    the ordered-velocity prior in _make_multi_lnprob's order."""
    lines, vel_t, line_idx, group, chans, qst = tables
    lf, le, la, lgu, lgl = lines
    gf, y, isig = chans
    K = st.ncomp
    N, M = theta.shape[0], vel_t.shape[0]
    dt, dev = theta.dtype, theta.device
    ss, Ncol = theta[:, :K], theta[:, K:2 * K]
    Tex, vlsr, dV = theta[:, 2 * K], theta[:, 2 * K + 1:3 * K + 1], theta[:, 3 * K + 1]
    Q = st.q_model()(Tex, states=(qst[0], qst[1]))
    taus = tau_sticks(torch, lf, le, la, lgu, lgl, Q[:, None, None],
                      Ncol[..., None], Tex[:, None, None],
                      dV[:, None, None])                      # (N, K, La)
    sigma = dV / FWHM_TO_SIGMA_MODEL
    aa = (_AA / (sigma * sigma))[:, None, None]
    window = (torch.abs(vel_t - st.mask_center)
              < VELOCITY_WINDOW_DV * dV[:, None, None])       # (N, M, C)
    opac = torch.zeros((N, K, vel_t.shape[1]), dtype=dt, device=dev)
    gacc = torch.zeros_like(opac)
    cur = torch.full((N, vel_t.shape[1]), -1, dtype=torch.int32, device=dev)
    idx = line_idx.long()
    for m in range(M):
        w = window[:, m]
        new = (w & (group[m] != cur))[:, None]                # a new hfs group
        opac = torch.where(new, opac + gacc, opac)
        gacc = torch.where(new, torch.zeros((), dtype=dt, device=dev), gacc)
        cur = torch.where(w, group[m], cur)
        d = vel_t[m] - vlsr[:, :, None]                       # (N, K, C)
        contrib = taus[:, :, idx[m]] * torch.exp2(aa * (d * d))
        gacc = torch.where(w[:, None], gacc + contrib, gacc)
    opac = opac + gacc
    J_T = planck_J(torch, gf, Tex[:, None], guard=1e-10)
    J_Tbg = planck_J(torch, gf, torch.tensor(st.Tbg, dtype=dt, device=dev),
                     guard=1e-10)
    model = torch.zeros((N, vel_t.shape[1]), dtype=dt, device=dev)
    for k in range(K):
        dil = beam_dilution(torch, gf, ss[:, k:k + 1], st.dish_size)
        model = model + dil * (J_T - J_Tbg) * (1.0 - torch.exp(-opac[:, k]))
    resid = y - model
    ll = -0.5 * torch.sum(resid * resid * isig - torch.log(isig), dim=-1)
    ok, lp = multi_prior_plain(theta, st)
    val = lp + ll
    return torch.where(ok & torch.isfinite(val), val, -torch.inf)


def multi_prior_plain(theta, st: MultiStatics):
    """The ordered-velocity prior of K2's lnprob, (N, D) -> (ok (N,) bool,
    ln prior (N,)), in _make_multi_lnprob's order: the kernel refuses a
    theta whose `ok` is False before its likelihood runs."""
    K = st.ncomp
    ss, Ncol = theta[:, :K], theta[:, K:2 * K]
    Tex, vlsr, dV = theta[:, 2 * K], theta[:, 2 * K + 1:3 * K + 1], theta[:, 3 * K + 1]
    ok = torch.ones(theta.shape[0], dtype=torch.bool, device=theta.device)
    lp = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
    lo_ss, hi_ss = st.ss_bounds
    lo_n, hi_n = st.ncol_bounds
    for k in range(K):
        ok = ok & (ss[:, k] > lo_ss) & (ss[:, k] < hi_ss)
        ok = ok & (Ncol[:, k] > lo_n) & (Ncol[:, k] < hi_n)
        for x, mu, sd in ((ss[:, k], st.mean_ss[k], st.std_ss[k]),
                          (vlsr[:, k], st.mean_vlsr[k], st.std_vlsr[k])):
            u = (x - mu) / sd
            lp = lp + (gauss_norm(sd) - 0.5 * (u * u))
    for k in range(K - 1):
        ok = ok & (vlsr[:, k] < vlsr[:, k + 1] - st.vlsr_min_sep)
        ok = ok & (vlsr[:, k + 1] < vlsr[:, k] + st.vlsr_max_sep)
    ok = ok & (dV < st.dv_bound) & (Tex > st.tex_min)
    for x, mu, sd in ((Tex, st.mean_tex, st.std_tex), (dV, st.mean_dv, st.std_dv)):
        u = (x - mu) / sd
        lp = lp + (gauss_norm(sd) - 0.5 * (u * u))
    return ok, lp


def multi_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables,
                      st: MultiStatics):
    """K2's k whole steps with torch ops (layout as in fused.steps_plain;
    with a leading chain axis, chain by chain)."""
    lnprob = functools.partial(multi_lnprob_plain, tables=tables, st=st)
    return steps_plain(lnprob, st.a, coords, lnp, perm, z_u, pair, acc_u)


# -- the CUDA kernel ---------------------------------------------------------

def _statics_type(real):
    class MultiStaticsC(ctypes.Structure):
        _fields_ = [(n, real * _MAX_COMP) for n in ("mean_ss", "sd_ss", "norm_ss",
                                                     "mean_vlsr", "sd_vlsr",
                                                     "norm_vlsr")]
        _fields_ += [("poly", real * _MAX_POLY), ("cheb", real * _MAX_CHEB)]
        _fields_ += [(n, real) for n in (
            "mean_tex", "sd_tex", "norm_tex", "mean_dv", "sd_dv", "norm_dv",
            "ss_lo", "ss_hi", "ncol_lo", "ncol_hi", "tex_min", "dv_bound",
            "vlsr_min_sep", "vlsr_max_sep", "dish_size", "Tbg", "mask_center",
            "a", "q_scale", "q_pa", "q_pb", "cheb_lo", "cheb_scale")]
        _fields_ += [(n, ctypes.c_int32) for n in ("ncomp", "ndim", "q_kind",
                                                   "n_poly", "has_power", "n_cheb")]
    return MultiStaticsC


_STATICS = {torch.float32: _statics_type(ctypes.c_float),
            torch.float64: _statics_type(ctypes.c_double)}


@functools.lru_cache(maxsize=16)
def _pack_statics(st: MultiStatics, dtype):
    """The kernel's MultiStatics struct for `st`, each f64 constant
    rounded to `dtype` once."""
    K = st.ncomp
    if K > _MAX_COMP:
        raise ValueError(f"K2 takes <= {_MAX_COMP} components, not {K} "
                         "(raise kMaxComp in csrc/multi_step.cu and the binding)")
    s = _STATICS[dtype]()
    for name, vals in (("mean_ss", st.mean_ss), ("sd_ss", st.std_ss),
                       ("norm_ss", [gauss_norm(x) for x in st.std_ss]),
                       ("mean_vlsr", st.mean_vlsr), ("sd_vlsr", st.std_vlsr),
                       ("norm_vlsr", [gauss_norm(x) for x in st.std_vlsr])):
        getattr(s, name)[:K] = vals
    pack_q(s, st, "K2")
    s.mean_tex, s.sd_tex, s.norm_tex = st.mean_tex, st.std_tex, gauss_norm(st.std_tex)
    s.mean_dv, s.sd_dv, s.norm_dv = st.mean_dv, st.std_dv, gauss_norm(st.std_dv)
    (s.ss_lo, s.ss_hi), (s.ncol_lo, s.ncol_hi) = st.ss_bounds, st.ncol_bounds
    s.tex_min, s.dv_bound = st.tex_min, st.dv_bound
    s.vlsr_min_sep, s.vlsr_max_sep = st.vlsr_min_sep, st.vlsr_max_sep
    s.dish_size, s.Tbg, s.mask_center, s.a = st.dish_size, st.Tbg, st.mask_center, st.a
    s.ncomp, s.ndim = K, st.ndim
    return s


def kernel_tables(tables, dtype, device, kernel: str = "K2"):
    """The tables K2 / K5c read — multi_statics_tables' (lines, vel,
    line_idx, group, chans, qst) — after checking them, and (La, M, C,
    S)."""
    lines, vel, line_idx, group, chans, qst = tables
    (M, C), La = vel.shape, lines.shape[1]
    check_tensor(lines, "lines", dtype, (5, La), device, kernel)
    check_tensor(vel, "vel", dtype, (M, C), device, kernel)
    check_tensor(line_idx, "line_idx", torch.int32, (M, C), device, kernel)
    check_tensor(group, "group", torch.int32, (M, C), device, kernel)
    check_tensor(chans, "chans", dtype, (3, C), device, kernel)
    check_tensor(qst, "qst", dtype, (2, qst.shape[1]), device, kernel)
    return tables, (La, M, C, qst.shape[1])


#: K2 and K5c as the cluster binding (sampler/cluster.py) sees them: K2_LANE_WARPS
#: chi^2 partials a group, the hfs group table, and the wide step entry.
FAMILY = cluster.Family(
    steps="K2", half="K5c", source="multi_step.cu", args=((17, 9), (10, 6), (15, 7)),
    statics=_STATICS, pack=_pack_statics, tables=kernel_tables, partials=K2_LANE_WARPS,
    group_table=True, launches=LAUNCHES,
    counters=("multi_steps", "multi_lnprob", "sharded_multi_half"), wide=(17, 8))


def multi_lnprob(theta, tables, st: MultiStatics):
    """K2's lnprob, (N, D) -> (N,): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if route(theta, "K2") == "cuda":
        return launch_lnprob(FAMILY, theta, tables, st)
    return multi_lnprob_plain(theta, tables, st)


def multi_step_block(coords, lnp, perm, z_u, pair, acc_u, tables,
                     st: MultiStatics, plan: ClusterPlan | None = None):
    """k whole steps (layout as in fused.steps_plain) of one ensemble, or
    of K with a leading chain axis: one CUDA kernel launch for CUDA
    tensors — on cluster.steps_plan's path, or `plan`'s — the plain
    version for CPU tensors."""
    if route(coords, "K2") == "cuda":
        return launch_steps(FAMILY, coords, lnp, perm, z_u, pair, acc_u, tables, st, plan)
    return multi_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables, st)


@dataclasses.dataclass(frozen=True)
class MultiFusedEnsemble(FusedEnsemble):
    """K2's runner: FusedEnsemble's run(pos0, lnp0, nsteps, k_steps)
    contract, each k steps one K2 launch (`make_fused_ensemble_multi`), for
    one ensemble or K (a leading chain axis); `plan_counts` reports the
    plan its step launches take."""

    family: typing.ClassVar[cluster.Family | None] = FAMILY

    def lnprob(self, theta):
        return multi_lnprob(theta, self.tables, self.statics)

    def step_block(self, coords, lnp, perm, z_u, pair, acc_u):
        return multi_step_block(coords, lnp, perm, z_u, pair, acc_u, self.tables,
                                self.statics)


def make_fused_ensemble_multi(model, spec, grid_ints, grid_yerrs, prior_means,
                              prior_stds, *, dv_max: float, a: float = 2.0,
                              ss_bounds=(0.0, 200.0), ncol_bounds=(0.0, 1e16),
                              tex_min: float = 2.7, vlsr_min_sep: float = 0.05,
                              vlsr_max_sep: float = 0.3) -> MultiFusedEnsemble:
    """K2 runner for a K-component problem, prior vocabulary of
    ordered_velocity_lnprior (reference TMC1_four_component.py:224-268).
    `dv_max` bounds both the prior box and the static window tables,
    exactly like MultiFitConfig.dv_bound on the general gather path."""
    statics, tables = multi_statics_tables(
        model, spec, grid_ints, grid_yerrs, prior_means, prior_stds,
        dv_max=dv_max, ss_bounds=ss_bounds, ncol_bounds=ncol_bounds,
        tex_min=tex_min, vlsr_min_sep=vlsr_min_sep, vlsr_max_sep=vlsr_max_sep,
        a=a)
    return MultiFusedEnsemble(tables, statics)
