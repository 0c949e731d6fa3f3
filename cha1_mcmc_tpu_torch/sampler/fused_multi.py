"""K2: the fused whole-ensemble-step kernel for K-component fits and its
plain PyTorch version.

Port of cha1_mcmc_tpu/sampler/fused_multi.py. One launch of the CUDA
kernel (csrc/multi_step.cu) runs k emcee-v3 stretch-move steps of one
K-component ensemble (theta = [ss x K | Ncol x K | Tex | vlsr x K | dV],
the GOTHAM / TMC-1 family, reference TMC1_four_component.py): both
sequential half-updates of every step, each with its walker gathers, the
K-component LTE model, the ordered-velocity prior and the acceptance
write-back. The ensemble is spread over one thread-block cluster
(csrc/cluster_step.cuh: 16 CTAs, or 8 where the card cannot place 16,
each owning a slice of every half-update's proposals, four warps a
proposal); `plan_multi_cluster` is its geometry. It reads the
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

import numpy as np
import torch

from cha1_mcmc_tpu_torch.catalogs.partition import QModel
from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
from cha1_mcmc_tpu_torch.models.sparse_opacity import build_opacity_gather
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu_torch.sampler import cluster
from cha1_mcmc_tpu_torch.sampler.cluster import (CLUSTER_SIZES, SMEM_LIMIT, ClusterPlan,
                                                 SmemLayout, itemsize, make_plan)
from cha1_mcmc_tpu_torch.sampler.fused import (
    _AA, _MAX_CHEB, _MAX_POLY, _SUFFIX, FusedEnsemble,
    bind_kernel_library, chain_batched, check_step_block, check_tensor, gauss_norm,
    pack_q, q_statics, raise_on, route, statics_q_model, steps_plain)
from cha1_mcmc_tpu_torch.utils.metrics import register_launches

__all__ = ["window_extents", "fused_multi_supported", "MultiStatics",
           "multi_statics_tables", "multi_lnprob_plain", "multi_steps_plain",
           "multi_lnprob", "multi_step_block", "MultiFusedEnsemble",
           "make_fused_ensemble_multi", "smem_layout", "plan_multi_cluster", "cluster_occupancy", "cluster_plan", "checked_plan",
           "load_kernel_library", "LAUNCHES"]

_MAX_COMP = 4   # kMaxComp of the kernel's MultiStatics (csrc/multi_step.cu)

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


def smem_layout(dtype, ncomp: int, n_lines: int, n_channels: int, n_entries: int, *,
                state_rows: int = 0, ndim: int = 0, per_cta: int = 0,
                stage: bool | None = None) -> SmemLayout:
    """The shared memory of a K2 / K5c / lnprob launch (cluster.smem_layout
    with the entries' hfs group table): [the (state_rows, D+1) state,]
    [the staged tables,] each warp group's (K, La) tau and chi^2 partials,
    the owned proposals and their stretch factors, [the entry line indices
    and groups,] flags and counters. `stage` None stages the tables where
    the staged layout fits a CTA, else not."""
    return cluster.smem_layout(dtype, ncomp, n_lines, n_channels, n_entries,
                               state_rows=state_rows, ndim=ndim, per_cta=per_cta, stage=stage)


def plan_multi_cluster(nwalkers: int, ncomp: int, n_lines: int, n_channels: int,
                       n_entries: int, dtype, cluster: int = 16,
                       resident_state: bool = True, stage: bool | None = None) -> ClusterPlan:
    """The cluster geometry of a K2 step launch (`resident_state`: each CTA
    holds the (W, D+1) state) or a K5c half-step launch (the state stays in
    device memory), for La = n_lines active lines, C = n_channels and M =
    n_entries table entries a channel: P = ceil(h / cluster) proposals a
    CTA at most, and its smem_layout — the tables staged where that fits
    (`stage` None), so the channel count sets only how fast it runs."""
    D = 3 * ncomp + 2
    shape = (nwalkers, ncomp, n_lines, n_channels, n_entries, itemsize(dtype),
             resident_state)
    return make_plan(nwalkers, cluster, lambda per_cta: smem_layout(
        dtype, ncomp, n_lines, n_channels, n_entries,
        state_rows=nwalkers if resident_state else 0, ndim=D, per_cta=per_cta,
        stage=stage), shape)


def fused_multi_supported(model, spec, dv_max: float, nwalkers: int = 128, *,
                          resident_state: bool = True) -> bool:
    """Can this (model, spec) run through K2 (K5c with resident_state
    False)? The ordered-velocity family (free source sizes) with at most 4
    components, every line window contiguous in channel order
    (window_extents, the JAX package's condition), and the cluster plan at
    the portable size of 8 CTAs — the larger share per CTA — within a
    Hopper CTA's 232,448 bytes of shared memory: with the tables staged
    where they fit, else read from device memory, whose layout grows with
    the walkers and the active lines but not with the channels."""
    if not spec.free_source_size or spec.ncomp > _MAX_COMP:
        return False
    vg = model.vel_grid.cpu().numpy()
    try:
        active, _, _, _ = window_extents(vg, model.mask_center, dv_max)
    except ValueError:
        return False
    # M of build_opacity_gather: the most in-window lines of any channel
    inside = np.abs(vg - model.mask_center) < VELOCITY_WINDOW_DV * dv_max
    n_entries = max(int(inside.sum(axis=0).max()), 1)
    return plan_multi_cluster(nwalkers, spec.ncomp, active.size, model.n_channels,
                              n_entries, model.dtype, cluster=min(CLUSTER_SIZES),
                              resident_state=resident_state).fits


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

    ok = torch.ones(N, dtype=torch.bool, device=dev)
    lp = torch.zeros_like(ll)
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
    val = lp + ll
    return torch.where(ok & torch.isfinite(val), val, -torch.inf)


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

_library = None


def load_kernel_library():
    """Build K2 and K5c (at first use) and load them: returns (ctypes
    library, nvcc build log, empty when a cached build was loaded)."""
    global _library
    if _library is None:
        lib, log = bind_kernel_library("multi_step.cu", "k2", (17, 9), (10, 6),
                                       _STATICS, "k5c_half", (15, 7))
        cluster.bind_cluster_entries(lib, "k2", "multi_step.cu")
        _library = lib, log
    return _library


def cluster_occupancy(entry: str, plan: ClusterPlan, dtype, device) -> int:
    """How many clusters of `plan` the card holds at once for the K2
    ("steps") or K5c ("half") kernel (cudaOccupancyMaxActiveClusters; 0:
    the card cannot place a cluster of that size)."""
    lib, _ = load_kernel_library()
    return cluster.occupancy(getattr(lib, f"k2_cluster_occupancy_{_SUFFIX[dtype]}"),
                             lib.k2_error_string, f"K2 {entry}", int(entry != "steps"),
                             plan, device)


@functools.lru_cache(maxsize=64)
def cluster_plan(entry: str, nwalkers: int, ncomp: int, n_lines: int, n_channels: int,
                 n_entries: int, dtype, device: torch.device) -> tuple[ClusterPlan, int]:
    """The geometry a K2 ("steps") or K5c ("half") launch takes on this
    card (cluster.cluster_plan: the largest cluster size that fits shared
    memory and that the card can place), with cudaOccupancyMaxActiveClusters
    for it. Raises where no size can run."""
    return cluster.cluster_plan(
        f"K2 {entry}: {nwalkers} walkers x {ncomp} components x {n_lines} lines x "
        f"{n_channels} channels x {n_entries} entries",
        lambda n: plan_multi_cluster(nwalkers, ncomp, n_lines, n_channels, n_entries, dtype,
                                     cluster=n, resident_state=entry == "steps"),
        lambda plan: cluster_occupancy(entry, plan, dtype, device))


def checked_plan(entry: str, plan: ClusterPlan | None, nwalkers: int, ncomp: int,
                 n_lines: int, n_channels: int, n_entries: int, dtype, device) -> ClusterPlan:
    """The plan a K2 ("steps") or K5c ("half") launch runs: cluster_plan's,
    or the caller's `plan` (a geometry chosen with plan_multi_cluster, as
    the card tests choose 8 CTAs or unstaged tables) after checking it was
    made for these sizes and fits a CTA."""
    shape = (nwalkers, ncomp, n_lines, n_channels, n_entries, itemsize(dtype),
             entry == "steps")
    return cluster.checked_plan(f"K2 {entry}", plan, shape, lambda: cluster_plan(
        entry, nwalkers, ncomp, n_lines, n_channels, n_entries, dtype, device)[0])


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


def _check_tables(tables, dtype, device):
    lines, vel, line_idx, group, chans, qst = tables
    M, C = vel.shape
    La = lines.shape[1]
    check_tensor(lines, "lines", dtype, (5, La), device, "K2")
    check_tensor(vel, "vel", dtype, (M, C), device, "K2")
    check_tensor(line_idx, "line_idx", torch.int32, (M, C), device, "K2")
    check_tensor(group, "group", torch.int32, (M, C), device, "K2")
    check_tensor(chans, "chans", dtype, (3, C), device, "K2")
    check_tensor(qst, "qst", dtype, (2, qst.shape[1]), device, "K2")
    return La, M, C, qst.shape[1]


def _check_dims(D, st: MultiStatics, dtype):
    if dtype not in _SUFFIX:
        raise ValueError(f"K2 takes float32 or float64 walkers, not {dtype}")
    if D != st.ndim:
        raise ValueError(f"K2: {D}-dim thetas for a {st.ncomp}-component "
                         f"({st.ndim}-dim) problem")


def _launch_steps(coords, lnp, perm, z_u, pair, acc_u, tables, st, plan):
    """One K2 launch of K chains, one cluster each (fused.check_step_block's
    layout): chain (K, k*W, D), lnps (K, k*W), acc (K, k)."""
    lib, _ = load_kernel_library()
    dtype, dev = coords.dtype, coords.device
    K, W, D, k = check_step_block(coords, lnp, perm, z_u, pair, acc_u, "K2")
    _check_dims(D, st, dtype)
    La, M, C, S = _check_tables(tables, dtype, dev)
    plan = checked_plan("steps", plan, W, st.ncomp, La, C, M, dtype, dev)
    packed = _pack_statics(st, dtype)
    out_chain = torch.empty((K, k * W, D), dtype=dtype, device=dev)
    out_lnps = torch.empty((K, k * W), dtype=dtype, device=dev)
    out_acc = torch.empty((K, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k2_fused_steps_{_SUFFIX[dtype]}")(
            coords.data_ptr(), lnp.data_ptr(), perm.data_ptr(), z_u.data_ptr(),
            pair.data_ptr(), acc_u.data_ptr(),
            *(t.data_ptr() for t in tables),
            out_chain.data_ptr(), out_lnps.data_ptr(), out_acc.data_ptr(),
            ctypes.addressof(packed), ctypes.addressof(plan.layout.packed),
            W, D, La, M, C, S, k, K, plan.cluster,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k2_error_string, "multi_steps", "K2")
    LAUNCHES["multi_steps"] += 1
    return out_chain, out_lnps, out_acc


def _launch_lnprob(theta, tables, st):
    lib, _ = load_kernel_library()
    dtype, dev = theta.dtype, theta.device
    N, D = theta.shape
    _check_dims(D, st, dtype)
    check_tensor(theta, "theta", dtype, (N, D), dev, "K2")
    La, M, C, S = _check_tables(tables, dtype, dev)
    layout = smem_layout(dtype, st.ncomp, La, C, M)
    if not layout.fits:
        raise ValueError(f"K2 lnprob: {st.ncomp} components x {La} lines need "
                         f"{layout.bytes} B of shared memory (> {SMEM_LIMIT})")
    packed = _pack_statics(st, dtype)
    out = torch.empty(N, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k2_lnprob_{_SUFFIX[dtype]}")(
            theta.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tables),
            ctypes.addressof(packed), ctypes.addressof(layout.packed), N, D, La, M, C, S,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k2_error_string, "multi_lnprob", "K2")
    LAUNCHES["multi_lnprob"] += 1
    return out


def multi_lnprob(theta, tables, st: MultiStatics):
    """K2's lnprob, (N, D) -> (N,): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if route(theta, "K2") == "cuda":
        return _launch_lnprob(theta, tables, st)
    return multi_lnprob_plain(theta, tables, st)


def multi_step_block(coords, lnp, perm, z_u, pair, acc_u, tables,
                     st: MultiStatics, plan: ClusterPlan | None = None):
    """k whole steps (layout as in fused.steps_plain) of one ensemble, or
    of K with a leading chain axis: one CUDA kernel launch for CUDA
    tensors, one cluster a chain — with cluster_plan's geometry, or `plan`
    — the plain version for CPU tensors."""
    if route(coords, "K2") == "cuda":
        return chain_batched(_launch_steps, coords, lnp, perm, z_u, pair, acc_u,
                             tables, st, plan)
    return multi_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables, st)


@dataclasses.dataclass(frozen=True)
class MultiFusedEnsemble(FusedEnsemble):
    """K2's runner: FusedEnsemble's run(pos0, lnp0, nsteps, k_steps)
    contract, each k steps one K2 launch (`make_fused_ensemble_multi`), for
    one ensemble or K (a leading chain axis)."""

    def lnprob(self, theta):
        return multi_lnprob(theta, self.tables, self.statics)

    def step_block(self, coords, lnp, perm, z_u, pair, acc_u):
        return multi_step_block(coords, lnp, perm, z_u, pair, acc_u,
                                self.tables, self.statics)


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
