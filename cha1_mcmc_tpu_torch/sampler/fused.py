"""K1: the fused whole-ensemble-step kernel and its plain PyTorch version.

Port of cha1_mcmc_tpu/sampler/fused.py. One launch of the CUDA kernel
(csrc/fused_step.cu) runs k emcee-v3 stretch-move steps of one
single-component ensemble — both sequential half-updates of every step,
each with its walker gathers, the LTE forward model, the priors and the
acceptance write-back — so a fit at the flagship size (128 walkers, ~9
lines x 561 channels) pays one launch per k steps instead of hundreds of
small ones per step. A launch takes one of two paths (sampler/cluster.py:
steps_plan): the wide path, where the K chains' h = W / 2 CTAs each fit
the card at once — one cooperative launch, CTA j of a chain owning
proposal j of every half-update with the whole CTA — else one
thread-block cluster a chain (csrc/cluster_step.cuh: 16 CTAs, or 8 where
the card cannot place 16, four warps a proposal). `FAMILY` declares what
K1 and its sharded half-step K5a need of the cluster binding, which
plans, checks and launches them; this module keeps the mathematics. The
kernel walks, per channel, only the lines whose window at the prior's dV
bound can reach it (the channel-major entry tables of
models/sparse_opacity.py: build_opacity_gather), in line order.

Beside the kernel, `fused_lnprob_plain` / `fused_steps_plain` compute the
same function with torch ops, in the same formulation (exp2 Gaussians,
the same statics, the JAX package's randomness layout). The wrappers
`fused_lnprob` / `fused_step_block` launch the kernel for CUDA tensors and
take the plain version only for CPU tensors; `LAUNCHES` counts kernel
launches.

Scope: single-component problems, 4-dim fixed- or 5-dim free-source-size,
with analytic, Chebyshev or state-sum Q(T).
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
from cha1_mcmc_tpu_torch.sampler.cluster import (LANE_WARPS, ClusterPlan, check_tensor,
                                                 launch_lnprob, launch_steps, route,
                                                 steps_plan)
from cha1_mcmc_tpu_torch.sampler.stretch import (EnsembleSampler, draw_chain_randomness,
                                                 draw_randomness, half_step)
from cha1_mcmc_tpu_torch.utils.metrics import first_launch, register_launches

__all__ = ["FusedStatics", "single_statics_tables", "fused_lnprob_plain", "prior_box",
           "steps_plain", "fused_steps_plain", "fused_lnprob", "fused_step_block",
           "FusedEnsemble", "make_fused_ensemble", "FusedEnsembleSampler",
           "kernel_tables", "FAMILY", "block_randomness", "LAUNCHES"]

# Limits of the kernel's Statics struct (csrc/single_statics.cuh).
_MAX_DIM, _MAX_POLY, _MAX_CHEB = 5, 8, 65
_AA = -0.5 * 1.4426950408889634  # -log2(e) / 2: exp(-x^2/2s^2) = exp2(AA x^2/s^2)
#: The entry tables are built at the prior's dV bound widened by this
#: relative margin, so no rounding of the kernel's 10 dV window can reach
#: a line the tables leave out.
DV_MARGIN = 1e-4

#: Kernel launches per K1 entry, counted where each kernel is launched and
#: nowhere else (plain-version calls do not count).
LAUNCHES = register_launches({"fused_steps": 0, "fused_lnprob": 0})


@dataclasses.dataclass(frozen=True)
class FusedStatics:
    """Scalar constants of the in-kernel lnprob and step (the JAX
    package's single_statics_tables statics, plus the stretch scale a).
    q_kind 'cheb' carries the Chebyshev coefficients in q_coeffs and the
    fit interval in q_power."""

    ss: float | None                 # fixed source size; None = free (5-dim)
    dish_size: float
    Tbg: float
    mask_center: float
    q_kind: str                      # 'analytic' | 'cheb' | 'states'
    q_coeffs: tuple
    q_power: tuple | None
    q_scale: float
    bounds_lo: tuple
    bounds_hi: tuple
    prior_mean: tuple
    prior_std: tuple
    a: float = 2.0

    def q_model(self) -> QModel:
        return statics_q_model(self)

    #: K1's one component; with `ndim`, what the cluster binding sizes a
    #: launch by (as MultiStatics has them).
    ncomp = 1

    @property
    def ndim(self) -> int:
        return len(self.bounds_lo)

    @property
    def ncol_idx(self) -> int:
        return 0 if self.ss is not None else 1

    def gauss_norms(self) -> tuple:
        """log(1/(sqrt(2 pi) sd)) per dimension, in f64 on the host."""
        return tuple(gauss_norm(sd) for sd in self.prior_std)


def gauss_norm(sd: float) -> float:
    """log(1/(sqrt(2 pi) sd)) in f64 on the host, as the JAX kernels
    compute their Gaussian normalisations from Python-float statics."""
    return float(np.log(1.0 / (np.sqrt(2.0 * np.pi) * sd)))


def statics_q_model(st) -> QModel:
    """The torch QModel of a kernel statics' Q fields (q_kind, q_coeffs,
    q_power, q_scale); a state sum takes its (g, E) from the tables."""
    if st.q_kind == "cheb":
        return QModel(kind="states", cheb_interval=st.q_power,
                      cheb_coeffs=st.q_coeffs)
    if st.q_kind == "states":
        return QModel(kind="states")
    return QModel(kind="analytic", coeffs=st.q_coeffs, power=st.q_power,
                  scale=st.q_scale)


def q_statics(model):
    """(Q fields of a kernel statics, qst table) for the model's Q(T):
    the Chebyshev surrogate when one is attached (q_power carries its fit
    interval), else the state sum (qst = (2, S) g, E) or the analytic
    form (qst a dummy (2, 8))."""
    qm = model.q_model
    qst = torch.zeros((2, 8), dtype=model.dtype, device=model.device)
    if qm.cheb_coeffs is not None:
        return dict(q_kind="cheb", q_coeffs=tuple(qm.cheb_coeffs),
                    q_power=tuple(qm.cheb_interval), q_scale=1.0), qst
    if qm.kind == "states":
        return (dict(q_kind="states", q_coeffs=(), q_power=None, q_scale=1.0),
                torch.stack([model.q_g, model.q_E]))
    return dict(q_kind="analytic", q_coeffs=tuple(qm.coeffs),
                q_power=None if qm.power is None else tuple(qm.power),
                q_scale=float(qm.scale)), qst


def single_statics_tables(model, spec, grid_ints, grid_yerrs, bounds,
                          prior_means, prior_stds, *, a: float = 2.0,
                          entries: bool = True):
    """(FusedStatics, tables) for the single-component K1 lnprob. Tables
    are tensors on the model's device and dtype: lines (5, L) = freq,
    elower, aij, gup, glow and vel (L, C), the dense tables the plain
    version reads; with `entries`, the kernel's channel-major entry tables
    of build_opacity_gather at the prior's dV bound widened by DV_MARGIN:
    the lines (5, La) of the La active lines (those a window reaches),
    entry velocities (M, C) (1e30 on padding) and active-line indices (M,
    C) int32, in ascending line order per channel; then chans (3, C) =
    freq, y, 1/sigma^2 and qst (2, S) = state-sum g, E (a dummy (2, 8)
    for the other Q kinds). So: (lines, vel, [lines_a, vel_e, line_idx,]
    chans, qst). Prior sigmas carry the overrides sigma_vlsr = 0.8
    mean_dV, sigma_dV = 0.3 mean_dV (reference inference.py:200-201)."""
    if spec.ncomp != 1:
        raise ValueError("K1 supports single-component layouts only")
    free_ss = spec.fixed_source_size is None
    means = np.asarray(prior_means, dtype=np.float64)
    stds = np.asarray(prior_stds, dtype=np.float64).copy()
    dv_mean = means[4] if free_ss else means[3]
    stds[-2] = dv_mean * 0.8   # sigma_vlsr override
    stds[-1] = dv_mean * 0.3   # sigma_dV override
    names = (["source_size"] if free_ss else []) + ["Ncol", "Tex", "vlsr", "dV"]
    dev, dt = model.device, model.dtype
    lines = torch.stack([model.line_freq, model.line_elower, model.line_aij,
                         model.line_gup, model.line_glow])
    chans = torch.stack([model.grid_freq,
                         torch.as_tensor(grid_ints, dtype=dt, device=dev),
                         1.0 / torch.as_tensor(grid_yerrs, dtype=dt, device=dev) ** 2])
    vel = model.vel_grid.contiguous()
    q, qst = q_statics(model)
    statics = FusedStatics(
        ss=None if free_ss else float(spec.fixed_source_size),
        dish_size=float(model.dish_size), Tbg=float(model.Tbg),
        mask_center=float(model.mask_center), **q,
        bounds_lo=tuple(float(bounds[k][0]) for k in names),
        bounds_hi=tuple(float(bounds[k][1]) for k in names),
        prior_mean=tuple(float(m) for m in means),
        prior_std=tuple(float(s) for s in stds), a=float(a))
    if not entries:
        return statics, (lines, vel, chans, qst)
    line_idx, vel_e, active = build_opacity_gather(
        vel.cpu().numpy(), statics.mask_center, statics.bounds_hi[-1] * (1.0 + DV_MARGIN))
    lines_a = lines[:, torch.as_tensor(active, dtype=torch.long, device=dev)].contiguous()
    return statics, (lines, vel, lines_a, torch.as_tensor(vel_e, dtype=dt, device=dev),
                     torch.as_tensor(line_idx, dtype=torch.int32, device=dev), chans, qst)


# -- plain PyTorch version ---------------------------------------------------

def fused_lnprob_plain(theta, tables, st: FusedStatics):
    """K1's lnprob with torch ops, (N, D) -> (N,): box + Gaussian priors
    (flat Ncol) + chi^2 of the windowed-exp2 LTE model (the JAX package's
    _make_dense_lnprob), summing the lines in line order as the kernel
    does. Reads the dense tables (single_statics_tables)."""
    (lines, vel), (chans, qst) = tables[:2], tables[-2:]
    lf, le, la, lgu, lgl = lines
    gf, y, isig = chans
    dt, dev = theta.dtype, theta.device
    if st.ss is None:
        ss_w, Ncol, Tex, vlsr, dV = (theta[:, i] for i in range(5))
        ss_w = ss_w[:, None]
    else:
        ss_w = torch.tensor(st.ss, dtype=dt, device=dev)
        Ncol, Tex, vlsr, dV = (theta[:, i] for i in range(4))
    Q = st.q_model()(Tex, states=(qst[0], qst[1]))
    taus = tau_sticks(torch, lf, le, la, lgu, lgl, Q[:, None], Ncol[:, None],
                      Tex[:, None], dV[:, None])                  # (N, L)
    sigma = dV / FWHM_TO_SIGMA_MODEL
    aa = (_AA / (sigma * sigma))[:, None, None]
    window = (torch.abs(vel - st.mask_center)
              < VELOCITY_WINDOW_DV * dV[:, None, None])             # (N, L, C)
    d = vel - vlsr[:, None, None]
    gauss = torch.where(window, torch.exp2(aa * (d * d)), 0.0)
    opac = torch.zeros((theta.shape[0], vel.shape[1]), dtype=dt, device=dev)
    for l in range(vel.shape[0]):
        opac = opac + taus[:, l:l + 1] * gauss[:, l]
    J_T = planck_J(torch, gf, Tex[:, None], guard=1e-10)
    J_Tbg = planck_J(torch, gf, torch.tensor(st.Tbg, dtype=dt, device=dev),
                     guard=1e-10)
    dil = beam_dilution(torch, gf, ss_w, st.dish_size)
    m = dil * (J_T - J_Tbg) * (1.0 - torch.exp(-opac))
    resid = y - m
    ll = -0.5 * torch.sum(resid * resid * isig - torch.log(isig), dim=-1)

    ok, lp = prior_box(theta, st)
    val = lp + ll
    return torch.where(ok & torch.isfinite(val), val, -torch.inf)


def prior_box(theta, st: FusedStatics):
    """(ok, lp) of the single-component prior, (N, D) -> (N,) each: the
    strict box bounds and the Gaussian priors with Ncol flat (the JAX
    package's _prior_box)."""
    ok = torch.ones(theta.shape[0], dtype=torch.bool, device=theta.device)
    for i, (lo, hi) in enumerate(zip(st.bounds_lo, st.bounds_hi)):
        ok = ok & (theta[:, i] > lo) & (theta[:, i] < hi)
    lp = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
    for i, norm in enumerate(st.gauss_norms()):
        if i != st.ncol_idx:   # Ncol flat
            lp = lp + (norm - 0.5 * ((theta[:, i] - st.prior_mean[i])
                                     / st.prior_std[i]) ** 2)
    return ok, lp


def steps_plain(lnprob, a: float, coords, lnp, perm, z_u, pair, acc_u):
    """k = z_u.shape[-2] // 2 whole stretch-move steps of a step kernel's
    plain version, around the batched `lnprob` (N, D) -> (N,).

    coords (W, D), lnp (W,); per block randomness in the kernels' layout:
    perm (k*W,) the per-step permutations, z_u / pair / acc_u (2k, h) with
    row r = 2*step + half. Returns chain (k*W, D), lnps (k*W,) and the
    accepted count per step, acc (k,) float32. With a leading chain axis
    (coords (K, W, D), ..., as the kernels take K ensembles) each chain
    runs on its own, and the results are stacked on that axis."""
    if coords.dim() == 3:
        runs = [steps_plain(lnprob, a, *args)
                for args in zip(coords, lnp, perm, z_u, pair, acc_u)]
        return tuple(torch.stack(t) for t in zip(*runs))
    W, D = coords.shape
    h = W // 2
    k = z_u.shape[0] // 2
    coords, lnp = coords.clone(), lnp.clone()
    chain = torch.empty((k, W, D), dtype=coords.dtype, device=coords.device)
    lnps = torch.empty((k, W), dtype=lnp.dtype, device=coords.device)
    acc = torch.zeros(k, dtype=torch.float32, device=coords.device)
    with torch.no_grad():
        for step in range(k):
            pm = perm[step * W:(step + 1) * W].long()
            for half in range(2):
                r = 2 * step + half
                active, comp = (pm[:h], pm[h:]) if half == 0 else (pm[h:], pm[:h])
                acc[step] += half_step(lnprob, D, a, coords, lnp, active,
                                       coords[comp], z_u[r], pair[r].long(), acc_u[r])
            chain[step] = coords
            lnps[step] = lnp
    return chain.reshape(k * W, D), lnps.reshape(k * W), acc


def fused_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables,
                      st: FusedStatics):
    """K1's k whole steps with torch ops (layout as in steps_plain; with a
    leading chain axis, chain by chain)."""
    lnprob = functools.partial(fused_lnprob_plain, tables=tables, st=st)
    return steps_plain(lnprob, st.a, coords, lnp, perm, z_u, pair, acc_u)


# -- the CUDA kernel ---------------------------------------------------------

def _statics_type(real):
    class Statics(ctypes.Structure):
        _fields_ = [("lo", real * _MAX_DIM), ("hi", real * _MAX_DIM),
                    ("mean", real * _MAX_DIM), ("sd", real * _MAX_DIM),
                    ("norm", real * _MAX_DIM), ("poly", real * _MAX_POLY),
                    ("cheb", real * _MAX_CHEB)]
        _fields_ += [(n, real) for n in ("ss", "dish_size", "Tbg", "mask_center",
                                         "a", "q_scale", "q_pa", "q_pb",
                                         "cheb_lo", "cheb_scale")]
        _fields_ += [(n, ctypes.c_int32) for n in ("ndim", "free_ss", "ncol_idx",
                                                   "q_kind", "n_poly", "has_power",
                                                   "n_cheb", "pad")]
    return Statics


_STATICS = {torch.float32: _statics_type(ctypes.c_float),
            torch.float64: _statics_type(ctypes.c_double)}
_Q_KIND = {"analytic": 0, "cheb": 1, "states": 2}


def pack_q(s, st, kernel: str = "K1"):
    """Fill the Q(T) fields of a kernel's statics struct `s` (poly /
    n_poly / has_power / q_pa / q_pb / q_scale, cheb / n_cheb / cheb_lo /
    cheb_scale, q_kind) from the statics `st`."""
    n_poly = len(st.q_coeffs) if st.q_kind == "analytic" else 0
    n_cheb = len(st.q_coeffs) if st.q_kind == "cheb" else 0
    if n_poly > _MAX_POLY or n_cheb > _MAX_CHEB:
        raise ValueError(f"{kernel} takes <= {_MAX_POLY} polynomial and "
                         f"<= {_MAX_CHEB} Chebyshev terms of Q(T)")
    if n_poly:
        s.poly[:n_poly] = st.q_coeffs
        s.q_scale = st.q_scale
        if st.q_power is not None:
            s.has_power, (s.q_pa, s.q_pb) = 1, st.q_power
    if n_cheb:
        s.cheb[:n_cheb] = st.q_coeffs
        t_lo, t_hi = st.q_power
        s.cheb_lo, s.cheb_scale = t_lo, 2.0 / (t_hi - t_lo)
    s.q_kind, s.n_poly, s.n_cheb = _Q_KIND[st.q_kind], n_poly, n_cheb


@functools.lru_cache(maxsize=16)
def _pack_statics(st: FusedStatics, dtype):
    """The kernel's Statics struct for `st`, each f64 constant rounded to
    `dtype` once."""
    D = len(st.bounds_lo)
    if D > _MAX_DIM:
        raise ValueError(f"K1 takes <= {_MAX_DIM} dims")
    s = _STATICS[dtype]()
    for name, vals in (("lo", st.bounds_lo), ("hi", st.bounds_hi),
                       ("mean", st.prior_mean), ("sd", st.prior_std),
                       ("norm", st.gauss_norms())):
        getattr(s, name)[:D] = vals
    pack_q(s, st)
    s.ss = 0.0 if st.ss is None else st.ss
    s.dish_size, s.Tbg, s.mask_center, s.a = st.dish_size, st.Tbg, st.mask_center, st.a
    s.ndim, s.free_ss, s.ncol_idx = D, int(st.ss is None), st.ncol_idx
    return s


def kernel_tables(tables, dtype, device, kernel: str = "K1"):
    """The tables K1 / K5a read — (lines (5, La), vel (M, C), line_idx (M,
    C), chans (3, C), qst (2, S)), the entries of single_statics_tables —
    after checking them, and (La, M, C, S)."""
    if len(tables) != 7:
        raise ValueError(f"{kernel} needs single_statics_tables' entry tables "
                         "(entries=True)")
    lines, vel, line_idx, chans, qst = tables[2:]
    (M, C), La = vel.shape, lines.shape[1]
    check_tensor(lines, "lines", dtype, (5, La), device, kernel)
    check_tensor(vel, "vel", dtype, (M, C), device, kernel)
    check_tensor(line_idx, "line_idx", torch.int32, (M, C), device, kernel)
    check_tensor(chans, "chans", dtype, (3, C), device, kernel)
    check_tensor(qst, "qst", dtype, (2, qst.shape[1]), device, kernel)
    return tables[2:], (La, M, C, qst.shape[1])


#: K1 and K5a as the cluster binding (sampler/cluster.py) sees them: one
#: component, a chi^2 partial for each of the LANE_WARPS warps of lanes of
#: its lnprob (csrc/fused_step.cu: K1GroupLnProb), no hfs group table, and
#: the wide step entry.
FAMILY = cluster.Family(
    steps="K1", half="K5a", source="fused_step.cu", args=((16, 9), (9, 6), (14, 7)),
    statics=_STATICS, pack=_pack_statics, tables=kernel_tables, partials=LANE_WARPS,
    group_table=False, launches=LAUNCHES,
    counters=("fused_steps", "fused_lnprob", "sharded_half"), wide=(16, 8))


def fused_lnprob(theta, tables, st: FusedStatics, plan: ClusterPlan | None = None):
    """K1's lnprob, (N, D) -> (N,): the CUDA kernel for CUDA tensors — its
    tables staged where they fit, or as `plan` stages them — the plain
    version for CPU tensors."""
    if route(theta) == "cuda":
        return launch_lnprob(FAMILY, theta, tables, st, plan)
    return fused_lnprob_plain(theta, tables, st)


def fused_step_block(coords, lnp, perm, z_u, pair, acc_u, tables,
                     st: FusedStatics, plan: ClusterPlan | None = None):
    """k whole steps (see fused_steps_plain for the layout) of one
    ensemble, or of K with a leading chain axis: one CUDA kernel launch for
    CUDA tensors — on cluster.steps_plan's path, or `plan`'s — the plain
    version for CPU tensors."""
    if route(coords) == "cuda":
        return launch_steps(FAMILY, coords, lnp, perm, z_u, pair, acc_u, tables, st, plan)
    return fused_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables, st)


@dataclasses.dataclass(frozen=True)
class FusedEnsemble:
    """run(pos0, lnp0, nsteps, k_steps) with run_ensemble's contract and
    randomness layout, each k steps one K1 launch (`make_fused_ensemble`);
    with a leading chain axis, K independent ensembles in one launch per k
    steps (MultiChainSampler's run_fn); `plan_counts` reports the plan
    its step launches take. K2's runner (sampler/fused_multi.py) and K3's
    (sampler/fused_gather.py, one ensemble only) subclass it with their own
    `lnprob`, `step_block` and `family` (K3's None: no cluster binding)."""

    tables: tuple
    statics: FusedStatics
    #: The cluster binding's declaration of the runner's kernels.
    family: typing.ClassVar[cluster.Family | None] = FAMILY

    def lnprob(self, theta):
        return fused_lnprob(theta, self.tables, self.statics)

    def step_block(self, coords, lnp, perm, z_u, pair, acc_u):
        """k whole steps from one block of randomness (fused_step_block)."""
        return fused_step_block(coords, lnp, perm, z_u, pair, acc_u,
                                self.tables, self.statics)

    def plan_counts(self, nwalkers: int, n_chains: int = 1) -> dict:
        """What a step launch of `n_chains` ensembles of `nwalkers` walkers
        takes (cluster.steps_plan, the plan the launch itself takes, on the
        tables' device): the components, the CTAs a chain, whether it takes
        the wide path (1) or a cluster (0), whether the tables are staged in
        shared memory (1) or read from device memory (0), the shared memory
        of a CTA and the bytes of the tables the kernel reads. Off the card,
        where nothing is launched, the cluster plan of the largest size that
        fits a CTA."""
        fam, st, qst = self.family, self.statics, self.tables[-1]
        tables, (La, M, C, _) = fam.tables(self.tables, qst.dtype, qst.device, fam.steps)
        plan = steps_plan(fam, nwalkers, n_chains, st.ncomp, st.ndim, La, C, M, qst.dtype,
                          qst.device)
        return dict(components=st.ncomp, ctas=plan.cluster, wide=int(plan.wide),
                    staged=int(plan.staged), smem_bytes=plan.smem_bytes,
                    table_bytes=sum(t.numel() * t.element_size() for t in tables))

    def __call__(self, pos0, lnp0, nsteps: int, k_steps: int = 16, *,
                 generator: torch.Generator | None = None, randomness=None):
        """Returns (chain (nsteps, W, D), lnps (nsteps, W), accepted
        (nsteps,) float32, (pos, lnp)). Randomness as in run_ensemble:
        `randomness=(perms, z_u, pair, acc_u)` for nsteps raw steps, or
        drawn from `generator`. With pos0 (K, W, D) and lnp0 (K, W), K
        chains in each launch: the randomness has a leading chain axis, or
        is drawn chain by chain (draw_chain_randomness), and every output
        gains a leading chain axis; each chain equals the call on its own
        randomness alone, bitwise."""
        *lead, W, D = pos0.shape
        if W % 2:
            raise ValueError(f"nwalkers={W} must be even")
        while nsteps % k_steps:       # largest divisor <= k_steps
            k_steps -= 1
        nblocks = nsteps // k_steps
        if randomness is None:
            if generator is None:
                raise ValueError("FusedEnsemble needs a generator or randomness")
            kw = dict(device=pos0.device, dtype=pos0.dtype)
            randomness = (draw_chain_randomness(lead[0], nsteps, W, generator, **kw)
                          if lead else draw_randomness(nsteps, W, generator, **kw))
        perm_b, z_b, pair_b, acc_b = block_randomness(randomness, k_steps)
        coords, lnp = pos0.contiguous(), lnp0.contiguous()
        chains, lnpss, accs = [], [], []
        # A block's device time (BlockTimer's device_s) starts here, after the
        # draws and their layout; moving this call moves what the benchmark's
        # sampler.device_idle_pct and sampler.block_gap_us read.
        first_launch()
        for b in range(nblocks):
            chain_blk, lnps_blk, acc = self.step_block(
                coords, lnp, perm_b[b], z_b[b], pair_b[b], acc_b[b])
            coords = chain_blk[..., (k_steps - 1) * W:, :].contiguous()
            lnp = lnps_blk[..., (k_steps - 1) * W:].contiguous()
            chains.append(chain_blk)
            lnpss.append(lnps_blk)
            accs.append(acc)
        return (torch.cat(chains, dim=-2).reshape(*lead, nsteps, W, D),
                torch.cat(lnpss, dim=-1).reshape(*lead, nsteps, W),
                torch.cat(accs, dim=-1), (coords, lnp))


def block_randomness(randomness, k_steps: int):
    """(perm, z_u, pair, acc_u) of run_ensemble's layout — perms (..., n,
    W), the rest (..., n, 2, h), with an optional leading chain axis — in
    the step kernels' block layout, the block first: perm (nb, ..., k*W)
    int32, z_u / pair (int32) / acc_u (nb, ..., 2k, h), nb = n / k. The
    kernel's inner row r = 2*step + half indexes the (2k, h) slices in
    (step, half) order; block b of each array is contiguous."""
    perms, z_u, pair, acc_u = randomness
    *lead, n, W = perms.shape
    nb, h = n // k_steps, W // 2

    def layout(t, dtype, *tail):
        return t.to(dtype).reshape(*lead, nb, *tail).movedim(len(lead), 0).contiguous()

    return (layout(perms, torch.int32, k_steps * W), layout(z_u, z_u.dtype, 2 * k_steps, h),
            layout(pair, torch.int32, 2 * k_steps, h),
            layout(acc_u, acc_u.dtype, 2 * k_steps, h))


def make_fused_ensemble(model, spec, grid_ints, grid_yerrs, bounds,
                        prior_means, prior_stds, *, a: float = 2.0) -> FusedEnsemble:
    """K1 runner for a single-component problem (bounds / prior_means /
    prior_stds in single_component_lnprior's vocabulary)."""
    statics, tables = single_statics_tables(model, spec, grid_ints, grid_yerrs,
                                            bounds, prior_means, prior_stds, a=a)
    return FusedEnsemble(tables, statics)


@dataclasses.dataclass
class FusedEnsembleSampler(EnsembleSampler):
    """EnsembleSampler whose blocks run through a whole-step kernel,
    k_steps steps per launch: K1 (`run_fn` from make_fused_ensemble), K2
    (from fused_multi.make_fused_ensemble_multi) or K3 (from
    fused_gather.make_fused_ensemble_gather).

    The starting lnp comes from the kernel's own lnprob entry
    (`run_fn.lnprob`), so a run's acceptance tests compare values of one
    lnprob formulation. (The JAX multifit starts K2 from the gather
    path's lnprob instead, which differs from K2's by rounding.)
    Thinning is exact: the run draws the raw stream for nsteps * thin
    moves and keeps every thin-th state — bitwise what a thinned
    run_ensemble records from the same stream.
    """

    _: dataclasses.KW_ONLY
    run_fn: FusedEnsemble | None = None
    k_steps: int = 16

    def __post_init__(self):
        super().__post_init__()
        if self.run_fn is None:
            raise ValueError("FusedEnsembleSampler requires run_fn from "
                             "make_fused_ensemble, make_fused_ensemble_multi or "
                             "make_fused_ensemble_gather")

    def lnp0(self, pos):
        with torch.no_grad():
            return self.run_fn.lnprob(pos)

    def _run_block(self, pos, lnp, generator, nsteps: int, thin: int):
        chain, lnps, acc, final = self.run_fn(pos, lnp, nsteps * thin,
                                              self.k_steps, generator=generator)
        chain, lnps, acc = self.thin(chain, lnps, acc, thin)
        return chain, lnps, acc, final
