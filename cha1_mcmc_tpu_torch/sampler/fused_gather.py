"""K3: the whole-ensemble-step kernel for dense catalogs over the
channel-major gather tables, and its plain PyTorch version.

Port of cha1_mcmc_tpu/sampler/fused_gather.py. A dense catalog (the
aromatics: thousands of lines over ~10^4 channels) cannot take K1's dense
(L, C) velocity grid per proposal; the gather tables list, per channel,
the few lines whose ±10·dv_max window can reach it (models/
sparse_opacity.py), and `build_dense_tables` expands each entry's five
line constants so tau is recomputed per entry, with the channel axis
permuted heavy-first so the overflow table of the few crowded channels
adds in place on the leading channels.

One call of the CUDA kernel (csrc/gather_step.cu) runs k emcee-v3
stretch-move steps, spread over the whole card: per half-step a prepare,
an evaluate and an accept kernel (see the source). Beside it
`gather_lnprob_plain` / `gather_steps_plain` compute the same function
with torch ops, in the same order (per channel the main entries in m
order plus the overflow sum; chi^2 per channel block, blocks in order).
The wrappers `gather_lnprob` / `gather_step_block` launch the kernel for
CUDA tensors and take the plain version only for CPU tensors; `LAUNCHES`
counts kernel launches.

The TPU kernel's VMEM planning (_vmem_estimate, _pick_chunks' probe tier,
_make_prober, the verdict cache, sampler/vmem_probe.py) and its
block-stacked table layout (_stack_bands) have no counterpart: the tables
stay channel-major, and `plan_fused_gather` is the channel-block geometry
of the CUDA grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
from cha1_mcmc_tpu_torch.models.sparse_opacity import (build_opacity_gather,
                                                       build_opacity_gather_split)
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu_torch.sampler.fused import (
    _AA, _MAX_CHEB, _MAX_POLY, _STATICS, _SUFFIX, FusedEnsemble, FusedStatics,
    _pack_statics, bind_kernel_library, check_tensor, prior_box, raise_on, route,
    single_statics_tables, steps_plain)

__all__ = ["build_dense_tables", "GatherGeometry", "gather_geometry",
           "plan_fused_gather", "fused_gather_supported", "gather_statics_tables",
           "gather_lnprob_plain", "gather_steps_plain", "gather_lnprob",
           "gather_step_block", "GatherFusedEnsemble", "make_fused_ensemble_gather",
           "load_kernel_library", "LAUNCHES", "ROWS"]

#: velocity value marking padding entries — Gaussian exactly 0 (matches
#: models/sparse_opacity.py's gather-table padding convention)
_PAD_VEL = 1e30

#: Proposals per evaluation CTA (kRows of csrc/gather_step.cu), and
#: scalars per proposal row (kScal: ss, Ncol, Tex, vlsr, dV, Q, lp, ok).
ROWS, _SCALARS = 8, 8
_MAX_BLOCK = 512          # channels per evaluation CTA, at most
_MAX_WALKERS = 2048       # the accept kernel is one CTA of h <= 1024 threads

#: Kernel launches per K3 entry (one per C call, which launches the
#: prepare / evaluate / accept kernels of every half-step it runs),
#: counted where the call is made and nowhere else (plain-version calls
#: do not count).
LAUNCHES = {"gather_steps": 0, "gather_lnprob": 0}


def build_dense_tables(model, dv_max: float, min_saving: float = 1.3):
    """Host-side channel-major line-constant tables for the fused kernel
    (verbatim from the JAX package).

    Reuses build_opacity_gather(_split)'s window analysis, then expands
    the five line constants (freq, elower, aij, gup, glow) into the table
    layout so the kernel needs no in-kernel gather. Padding entries carry
    the active subset's line-0 constants (tau finite) and velocity 1e30
    (Gaussian exactly 0), so they contribute exactly nothing.

    Returns a dict with host arrays in the model's dtype:
      lines1 (5*M1, C), vel1 (M1, C)          — main table (channel axis
                                                 heavy-first permuted when
                                                 the split is worthwhile)
      lines2 (5*M2, cb0), vel2 (M2, cb0)       — heavy-channel overflow at
                                                 permuted positions
                                                 [0, C2), lane-padded to
                                                 cb0 (M2 == 1 row of
                                                 padding and cb0 == 0
                                                 when the split isn't
                                                 worthwhile)
      perm ((C,) int or None)                  — the channel permutation
                                                 (apply to the obs rows)
      has_overflow (bool), cb0 (int),
      n_elems (int), active ((La,) int)
    """
    vg = model.vel_grid.cpu().numpy()
    C = vg.shape[1]
    dtype = np.float32 if model.dtype == torch.float32 else np.float64
    consts = np.stack([getattr(model, name).cpu().numpy() for name in
                       ("line_freq", "line_elower", "line_aij", "line_gup",
                        "line_glow")]).astype(dtype)                    # (5, L)
    split = build_opacity_gather_split(vg, model.mask_center, dv_max,
                                       min_saving=min_saving)
    if split is not None:
        t1, v1, t2, v2, heavy, active = split
        # Heavy-first channel permutation: overflow becomes a same-position
        # ADD on the leading channels.
        perm = np.concatenate([heavy, np.setdiff1d(np.arange(C), heavy)])
        t1, v1 = t1[:, perm], v1[:, perm]
        # Overflow columns are already in heavy-channel order == permuted
        # positions [0, C2). Pad to the lane-tile boundary cb0.
        C2 = t2.shape[1]
        cb0 = min(-(-C2 // 128) * 128, C)
        if cb0 > C2:
            t2 = np.pad(t2, ((0, 0), (0, cb0 - C2)))
            v2 = np.pad(v2, ((0, 0), (0, cb0 - C2)), constant_values=_PAD_VEL)
        has_overflow = True
    else:
        t1, v1, active = build_opacity_gather(vg, model.mask_center, dv_max)
        t2 = np.zeros((1, 1), np.int32)
        v2 = np.full((1, 1), _PAD_VEL, vg.dtype)
        perm = None
        cb0 = 0
        has_overflow = False
    sub = consts[:, active]                                  # (5, La)
    lines1 = sub[:, t1].reshape(5 * t1.shape[0], C)
    lines2 = sub[:, t2].reshape(5 * t2.shape[0], t2.shape[1])
    n_elems = t1.size + (t2.size if has_overflow else 0)
    return dict(lines1=lines1, vel1=v1.astype(dtype),
                lines2=lines2, vel2=v2.astype(dtype),
                has_overflow=has_overflow, n_elems=int(n_elems),
                active=active, perm=perm, cb0=int(cb0))


@dataclasses.dataclass(frozen=True)
class GatherGeometry:
    """The channel-block geometry of K3's evaluation grid: `cblock`
    channels per block (one CTA's threads, one chi^2 partial per proposal),
    the first `cb0` (heavy-first) channels carrying overflow entries, and
    `n_blk` blocks — the TPU kernel's n_bo overflow-region blocks followed
    by its n_br rest-region blocks."""

    cblock: int
    cb0: int
    n_blk: int


def gather_geometry(n_channels: int, cb0: int, cblock: int = 128) -> GatherGeometry:
    """Blocks of the JAX package's channel walk (_geom) at width cblock:
    ceil(cb0 / cblock) blocks over the overflow region, then the rest."""
    n_bo = -(-cb0 // cblock) if cb0 else 0
    rest = max(n_channels - n_bo * cblock, 0)
    return GatherGeometry(cblock=cblock, cb0=cb0, n_blk=n_bo + -(-rest // cblock))


def _q_fits(qm) -> bool:
    if qm.cheb_coeffs is not None:
        return len(qm.cheb_coeffs) <= _MAX_CHEB
    return qm.kind == "states" or len(qm.coeffs) <= _MAX_POLY


def plan_fused_gather(model, spec, dv_max: float, nwalkers: int = 128,
                      min_saving: float = 1.3, cblock: int = 128):
    """Build the channel-major tables and K3's grid geometry, or return
    None when (model, spec) is outside the kernel's limits (more than one
    component, a Q(T) with more coefficients than the statics hold, a
    dtype other than float32 / float64, an odd or too large ensemble).
    Returns {tables, geometry}.

    Table construction on a large catalog costs seconds of host time, so
    a caller that checks support and then builds the kernel does both
    through this one plan (pipeline/fit.py passes it to
    make_fused_ensemble_gather)."""
    if (spec.ncomp != 1 or model.dtype not in _SUFFIX or nwalkers % 2
            or nwalkers > _MAX_WALKERS or not _q_fits(model.q_model)
            or cblock % 32 or not 32 <= cblock <= _MAX_BLOCK):
        return None
    tables = build_dense_tables(model, dv_max, min_saving=min_saving)
    return dict(tables=tables,
                geometry=gather_geometry(model.n_channels, tables["cb0"], cblock))


def fused_gather_supported(model, spec, dv_max: float, nwalkers: int = 128) -> bool:
    """Can (model, spec) run through K3? Single-component layouts only
    (the K-component family has K2, sampler/fused_multi.py)."""
    return plan_fused_gather(model, spec, dv_max, nwalkers) is not None


def gather_statics_tables(model, spec, grid_ints, grid_yerrs, bounds, prior_means,
                          prior_stds, plan, *, a: float = 2.0):
    """(FusedStatics, tables, GatherGeometry) for K3's lnprob — K1's
    statics (sampler/fused.py:single_statics_tables) over the plan's
    tables, kept channel-major. Tables are tensors on the model's device
    and dtype: lines1 (5, M1, C), vel1 (M1, C), lines2 (5, M2, w2), vel2
    (M2, w2) with w2 = max(cb0, 1), chans (3, C) = freq, y, 1/sigma^2 in
    the tables' heavy-first channel order, qst (2, S) = state-sum g, E (a
    dummy (2, 8) for the other Q kinds)."""
    statics, (_, _, chans, qst) = single_statics_tables(
        model, spec, grid_ints, grid_yerrs, bounds, prior_means, prior_stds, a=a,
        entries=False)
    tb = plan["tables"]
    dev, dt = model.device, model.dtype
    if tb["perm"] is not None:
        chans = chans[:, torch.as_tensor(tb["perm"], device=dev)]

    def t(x, rows=None):   # the permuted tables may come strided from NumPy
        x = torch.as_tensor(x, dtype=dt, device=dev).contiguous()
        return x if rows is None else x.reshape(5, rows, x.shape[1])

    M1, M2 = tb["vel1"].shape[0], tb["vel2"].shape[0]
    tables = (t(tb["lines1"], M1), t(tb["vel1"]), t(tb["lines2"], M2), t(tb["vel2"]),
              chans.contiguous(), qst.contiguous())
    return statics, tables, plan["geometry"]


# -- plain PyTorch version ---------------------------------------------------

def _opacity_plain(lines, vel, Q, Ncol, Tex, vlsr, dV, aa, mask_center):
    """sum over the table's entries, in m order, of tau * windowed exp2
    Gaussian: (5, M, c) constants, (M, c) velocities -> (N, c)."""
    N = Q.shape[0]
    out = torch.zeros((N, vel.shape[1]), dtype=vel.dtype, device=vel.device)
    col = (Q[:, None], Ncol[:, None], Tex[:, None], dV[:, None])
    for m in range(vel.shape[0]):
        tau = tau_sticks(torch, *(lines[i, m] for i in range(5)), *col)
        window = torch.abs(vel[m] - mask_center) < VELOCITY_WINDOW_DV * dV[:, None]
        d = vel[m] - vlsr[:, None]
        gauss = torch.where(window, torch.exp2(aa * (d * d)), 0.0)
        out = out + tau * gauss
    return out


def gather_lnprob_plain(theta, tables, st: FusedStatics, geom: GatherGeometry):
    """K3's lnprob with torch ops, (N, D) -> (N,): the opacity from the
    channel-major tables (main entries in m order, plus the overflow sum
    on the first cb0 channels), the chi^2 per channel block of
    geom.cblock channels times -1/2, the blocks summed in order, and K1's
    box + Gaussian prior (the JAX package's _make_gather_lnprob)."""
    lines1, vel1, lines2, vel2, chans, qst = tables
    gf, y, isig = chans
    dt, dev = theta.dtype, theta.device
    N, C = theta.shape[0], vel1.shape[1]
    if st.ss is None:
        ss_w, Ncol, Tex, vlsr, dV = (theta[:, i] for i in range(5))
        ss_w = ss_w[:, None]
    else:
        ss_w = torch.tensor(st.ss, dtype=dt, device=dev)
        Ncol, Tex, vlsr, dV = (theta[:, i] for i in range(4))
    Q = st.q_model()(Tex, states=(qst[0], qst[1]))
    sigma = dV / FWHM_TO_SIGMA_MODEL
    aa = (_AA / (sigma * sigma))[:, None]
    opac = _opacity_plain(lines1, vel1, Q, Ncol, Tex, vlsr, dV, aa, st.mask_center)
    if geom.cb0:
        over = _opacity_plain(lines2, vel2, Q, Ncol, Tex, vlsr, dV, aa, st.mask_center)
        opac = torch.cat([opac[:, :geom.cb0] + over, opac[:, geom.cb0:]], dim=1)
    J_T = planck_J(torch, gf, Tex[:, None], guard=1e-10)
    J_Tbg = planck_J(torch, gf, torch.tensor(st.Tbg, dtype=dt, device=dev), guard=1e-10)
    dil = beam_dilution(torch, gf, ss_w, st.dish_size)
    m = dil * (J_T - J_Tbg) * (1.0 - torch.exp(-opac))
    resid = y - m
    term = resid * resid * isig - torch.log(isig)                 # (N, C)
    pad = geom.n_blk * geom.cblock - C
    blocks = torch.nn.functional.pad(term, (0, pad)).reshape(N, geom.n_blk, geom.cblock)
    part = -0.5 * torch.sum(blocks, dim=-1)
    ll = torch.zeros(N, dtype=dt, device=dev)
    for b in range(geom.n_blk):
        ll = ll + part[:, b]
    ok, lp = prior_box(theta, st)
    val = lp + ll
    return torch.where(ok & torch.isfinite(val), val, -torch.inf)


def gather_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables, st: FusedStatics,
                       geom: GatherGeometry):
    """K3's k whole steps with torch ops (layout as in fused.steps_plain)."""
    lnprob = functools.partial(gather_lnprob_plain, tables=tables, st=st, geom=geom)
    return steps_plain(lnprob, st.a, coords, lnp, perm, z_u, pair, acc_u)


# -- the CUDA kernel ---------------------------------------------------------

_library = None


def load_kernel_library():
    """Build K3 and K5b (at first use) and load them: returns (ctypes
    library, nvcc build log, empty when a cached build was loaded)."""
    global _library
    if _library is None:
        _library = bind_kernel_library("gather_step.cu", "k3", (20, 10), (11, 9),
                                       _STATICS, "k5b_half", (18, 9))
    return _library


def _check_tables(tables, geom: GatherGeometry, dtype, device):
    lines1, vel1, lines2, vel2, chans, qst = tables
    M1, C = vel1.shape
    M2, w2 = vel2.shape
    check_tensor(lines1, "lines1", dtype, (5, M1, C), device, "K3")
    check_tensor(vel1, "vel1", dtype, (M1, C), device, "K3")
    check_tensor(lines2, "lines2", dtype, (5, M2, w2), device, "K3")
    check_tensor(vel2, "vel2", dtype, (M2, w2), device, "K3")
    check_tensor(chans, "chans", dtype, (3, C), device, "K3")
    check_tensor(qst, "qst", dtype, (2, qst.shape[1]), device, "K3")
    if geom.cb0 not in (0, w2) or geom.n_blk * geom.cblock < C:
        raise ValueError(f"K3: geometry {geom} does not fit tables of {C} "
                         f"channels with {w2} overflow columns")
    if geom.cblock % 32 or not 32 <= geom.cblock <= _MAX_BLOCK:
        raise ValueError(f"K3: a channel block of {geom.cblock} (takes a multiple "
                         f"of 32 up to {_MAX_BLOCK})")
    return M1, M2, C, qst.shape[1]


def _check_dims(D, st: FusedStatics, dtype):
    if dtype not in _SUFFIX:
        raise ValueError(f"K3 takes float32 or float64 walkers, not {dtype}")
    if D != len(st.bounds_lo):
        raise ValueError(f"K3: {D}-dim thetas for a {len(st.bounds_lo)}-dim problem")


def _launch_steps(coords, lnp, perm, z_u, pair, acc_u, tables, st, geom):
    lib, _ = load_kernel_library()
    dtype, dev = coords.dtype, coords.device
    W, D = coords.shape
    _check_dims(D, st, dtype)
    h, k = W // 2, z_u.shape[0] // 2
    if W % 2 or W > _MAX_WALKERS:
        raise ValueError(f"K3: nwalkers={W} (takes an even count up to {_MAX_WALKERS})")
    check_tensor(coords, "coords", dtype, (W, D), dev, "K3")
    check_tensor(lnp, "lnp", dtype, (W,), dev, "K3")
    check_tensor(perm, "perm", torch.int32, (k * W,), dev, "K3")
    check_tensor(z_u, "z_u", dtype, (2 * k, h), dev, "K3")
    check_tensor(pair, "pair", torch.int32, (2 * k, h), dev, "K3")
    check_tensor(acc_u, "acc_u", dtype, (2 * k, h), dev, "K3")
    M1, M2, C, S = _check_tables(tables, geom, dtype, dev)
    packed = _pack_statics(st, dtype)
    state = torch.cat([coords, lnp[:, None]], dim=1).contiguous()   # updated in place
    scratch = (torch.empty((h, D), dtype=dtype, device=dev),       # proposals
               torch.empty(h, dtype=dtype, device=dev),            # stretch factors
               torch.empty((h, _SCALARS), dtype=dtype, device=dev),   # row scalars
               torch.empty((h, geom.n_blk), dtype=dtype, device=dev),   # chi^2 partials
               torch.empty(1, dtype=torch.int32, device=dev))      # first-half accepts
    out_chain = torch.empty((k * W, D), dtype=dtype, device=dev)
    out_lnps = torch.empty(k * W, dtype=dtype, device=dev)
    out_acc = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k3_fused_steps_{_SUFFIX[dtype]}")(
            state.data_ptr(), perm.data_ptr(), z_u.data_ptr(), pair.data_ptr(),
            acc_u.data_ptr(), *(t.data_ptr() for t in tables),
            *(t.data_ptr() for t in scratch),
            out_chain.data_ptr(), out_lnps.data_ptr(), out_acc.data_ptr(),
            ctypes.addressof(packed), W, D, M1, M2, C, geom.cb0, S, geom.cblock,
            geom.n_blk, k, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k3_error_string, "gather_steps", "K3")
    LAUNCHES["gather_steps"] += 1
    return out_chain, out_lnps, out_acc


def _launch_lnprob(theta, tables, st, geom):
    lib, _ = load_kernel_library()
    dtype, dev = theta.dtype, theta.device
    N, D = theta.shape
    _check_dims(D, st, dtype)
    check_tensor(theta, "theta", dtype, (N, D), dev, "K3")
    M1, M2, C, S = _check_tables(tables, geom, dtype, dev)
    packed = _pack_statics(st, dtype)
    out = torch.empty(N, dtype=dtype, device=dev)
    scal = torch.empty((N, _SCALARS), dtype=dtype, device=dev)
    partial = torch.empty((N, geom.n_blk), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k3_lnprob_{_SUFFIX[dtype]}")(
            theta.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tables),
            scal.data_ptr(), partial.data_ptr(), ctypes.addressof(packed), N, D, M1, M2,
            C, geom.cb0, S, geom.cblock, geom.n_blk,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k3_error_string, "gather_lnprob", "K3")
    LAUNCHES["gather_lnprob"] += 1
    return out


def gather_lnprob(theta, tables, st: FusedStatics, geom: GatherGeometry):
    """K3's lnprob, (N, D) -> (N,): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if route(theta, "K3") == "cuda":
        return _launch_lnprob(theta, tables, st, geom)
    return gather_lnprob_plain(theta, tables, st, geom)


def gather_step_block(coords, lnp, perm, z_u, pair, acc_u, tables, st: FusedStatics,
                      geom: GatherGeometry):
    """k whole steps (layout as in fused.steps_plain): one call of the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if route(coords, "K3") == "cuda":
        return _launch_steps(coords, lnp, perm, z_u, pair, acc_u, tables, st, geom)
    return gather_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables, st, geom)


@dataclasses.dataclass(frozen=True)
class GatherFusedEnsemble(FusedEnsemble):
    """K3's runner: FusedEnsemble's run(pos0, lnp0, nsteps, k_steps)
    contract, each k steps one K3 call (`make_fused_ensemble_gather`)."""

    geometry: GatherGeometry

    def lnprob(self, theta):
        return gather_lnprob(theta, self.tables, self.statics, self.geometry)

    def step_block(self, coords, lnp, perm, z_u, pair, acc_u):
        return gather_step_block(coords, lnp, perm, z_u, pair, acc_u, self.tables,
                                 self.statics, self.geometry)


def make_fused_ensemble_gather(model, spec, grid_ints, grid_yerrs, bounds, prior_means,
                               prior_stds, *, dv_max: float, a: float = 2.0,
                               nwalkers: int = 128, min_saving: float = 1.3,
                               plan=None) -> GatherFusedEnsemble:
    """K3 runner for a dense single-component problem. bounds /
    prior_means / prior_stds follow single_component_lnprior's vocabulary
    (sigma_vlsr / sigma_dV overridden to 0.8 / 0.3 mean_dV, reference
    inference.py:200-201); dv_max is the prior's dV upper bound, the
    static-window parameter of the gather tables. Pass the `plan` of
    plan_fused_gather to reuse its tables; raises ValueError outside the
    kernel's limits."""
    if plan is None:
        plan = plan_fused_gather(model, spec, dv_max, nwalkers, min_saving=min_saving)
    if plan is None:
        raise ValueError("K3 does not take this problem (one component, analytic "
                         "/ Chebyshev / state-sum Q, float32 / float64, an even "
                         f"ensemble of <= {_MAX_WALKERS} walkers)")
    statics, tables, geom = gather_statics_tables(
        model, spec, grid_ints, grid_yerrs, bounds, prior_means, prior_stds, plan, a=a)
    return GatherFusedEnsemble(tables, statics, geom)
