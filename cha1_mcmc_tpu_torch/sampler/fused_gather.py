"""K3: the whole-ensemble-step kernel for dense catalogs over the
channel-major gather tables, and its plain PyTorch version.

Port of cha1_mcmc_tpu/sampler/fused_gather.py. A dense catalog (the
aromatics: thousands of lines over ~10^4 channels) cannot take K1's dense
(L, C) velocity grid per proposal; the gather tables list, per channel,
the few lines whose ±10·dv_max window can reach it (models/
sparse_opacity.py), and `build_dense_tables` expands each entry's five
line constants (the JAX package's tables, which the plain version reads),
with the channel axis permuted heavy-first so the overflow table of the
few crowded channels adds in place on the leading channels.

One call of the CUDA kernel (csrc/gather_step.cu) runs k emcee-v3
stretch-move steps as one persistent cooperative launch spread over the
whole card (see the source). It reads tables derived from the same
gather analysis (`block_line_tables`): per channel block the distinct
active lines its entries reference and per entry its slot among them, so
it computes tau once per (block line, proposal); `GatherPlan` carries them
with the channel-block geometry, where the taus live and the grid. Beside
it `gather_lnprob_plain` / `gather_steps_plain` compute the same function
with torch ops, in the same order (per channel the main entries in m
order plus the overflow sum; chi^2 per channel block, blocks in order).
The wrappers `gather_lnprob` / `gather_step_block` launch the kernel for
CUDA tensors and take the plain version only for CPU tensors; `LAUNCHES`
counts kernel launches.

The TPU kernel's VMEM planning (_vmem_estimate, _pick_chunks' probe tier,
_make_prober, the verdict cache, sampler/vmem_probe.py) and its
block-stacked table layout (_stack_bands) have no counterpart: the tables
stay channel-major, and `plan_fused_gather` is the channel-block geometry
of the CUDA grid and the kernel's derived tables.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import typing

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
from cha1_mcmc_tpu_torch.models.sparse_opacity import (build_opacity_gather,
                                                       build_opacity_gather_split)
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu_torch.sampler.cluster import (CHAN_CONSTS, SMEM_LIMIT, _SUFFIX,
                                                 bind_kernel_library, check_tensor, raise_on,
                                                 route)
from cha1_mcmc_tpu_torch.sampler.fused import (
    _AA, _MAX_CHEB, _MAX_POLY, _STATICS, FusedEnsemble, FusedStatics, _pack_statics,
    prior_box, single_statics_tables, steps_plain)
from cha1_mcmc_tpu_torch.utils.metrics import register_launches

__all__ = ["build_dense_tables", "GatherGeometry", "gather_geometry",
           "block_line_tables", "GatherPlan", "resident_ctas", "launch_grid",
           "plan_fused_gather",
           "fused_gather_supported", "gather_statics_tables",
           "gather_lnprob_plain", "gather_steps_plain", "gather_lnprob",
           "gather_step_block", "GatherFusedEnsemble", "make_fused_ensemble_gather",
           "kernel_operands", "load_kernel_library", "LAUNCHES", "ROWS"]

#: velocity value marking padding entries — Gaussian exactly 0 (matches
#: models/sparse_opacity.py's gather-table padding convention)
_PAD_VEL = 1e30

#: Proposals per tile (kRows of csrc/gather_step.cu), and scalars per
#: proposal row (kScal: ss, Ncol, Tex, vlsr, dV, Q, lp, ok).
ROWS, _SCALARS = 8, 8
_MAX_BLOCK = 512          # channels per tile (threads a CTA), at most
#: The largest ensemble the gate takes. The kernel strides its rows over
#: the grid and sets no limit of its own; this one keeps the gate's shapes.
_MAX_WALKERS = 2048
#: Shared memory a CTA gives its tau tile: a Hopper CTA's 232,448 bytes
#: less the kernel's static shared memory (1,568 bytes in float64). Past
#: it the taus go to device memory (GatherPlan.tau_shared False).
_TAU_SMEM_BYTES = SMEM_LIMIT - 2048
_SLOT_MAX = 32767         # slots are int16

#: Kernel launches per K3 entry (one per C call: one cooperative kernel
#: launch that runs every half-step of the call), counted where the call
#: is made and nowhere else (plain-version calls do not count).
LAUNCHES = register_launches({"gather_steps": 0, "gather_lnprob": 0})


def _dense_tables(model, dv_max: float, min_saving: float):
    """build_dense_tables' dict, the active lines' constants (5, La) and
    the active-line index tables it expands, idx1 (M1, C) and idx2 (M2,
    w2) int32 (padding entries index line 0)."""
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
    tables = dict(lines1=lines1, vel1=v1.astype(dtype),
                  lines2=lines2, vel2=v2.astype(dtype),
                  has_overflow=has_overflow, n_elems=int(n_elems),
                  active=active, perm=perm, cb0=int(cb0))
    return tables, sub, t1.astype(np.int32), t2.astype(np.int32)


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
    return _dense_tables(model, dv_max, min_saving)[0]


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


@dataclasses.dataclass(frozen=True, eq=False)
class GatherPlan(GatherGeometry):
    """What a K3 / K5b launch needs beyond the JAX package's tables: the
    channel-block geometry; the derived tables on the model's device —
    `lines` (5, La) the active lines' constants, `block_lines` (n_blk,
    u_max) int32 each block's active lines (-1 past them), `slot1` /
    `slot2` int16 each entry's slot in its block's list, `idx1` / `idx2`
    int32 its active-line index; `tau_shared`: the taus of a tile in
    shared memory (else an (n, La) scratch in device memory, read through
    idx1 / idx2); and `grid`, the CTAs of a launch (0: launch_grid's
    choice). Chains do not depend on `grid` or `tau_shared`. The derived
    tables are checked once, here; a launch checks only what it is given
    per call."""

    u_max: int = 0
    tau_shared: bool = True
    grid: int = 0
    lines: torch.Tensor | None = None
    block_lines: torch.Tensor | None = None
    slot1: torch.Tensor | None = None
    slot2: torch.Tensor | None = None
    idx1: torch.Tensor | None = None
    idx2: torch.Tensor | None = None

    def __post_init__(self):
        if self.cblock % 32 or not 32 <= self.cblock <= _MAX_BLOCK:
            raise ValueError(f"K3: a channel block of {self.cblock} (takes a multiple "
                             f"of 32 up to {_MAX_BLOCK})")
        if self.lines is None:
            return
        dtype, dev = self.lines.dtype, self.lines.device
        (M1, C), (M2, w2) = self.idx1.shape, self.idx2.shape
        check_tensor(self.lines, "lines", dtype, (5, self.lines.shape[1]), dev, "K3")
        check_tensor(self.block_lines, "block_lines", torch.int32,
                     (self.n_blk, self.u_max), dev, "K3")
        check_tensor(self.idx1, "idx1", torch.int32, (M1, C), dev, "K3")
        check_tensor(self.idx2, "idx2", torch.int32, (M2, w2), dev, "K3")
        if self.cb0 not in (0, w2) or self.n_blk * self.cblock < C:
            raise ValueError(f"K3: geometry ({self.cblock}, {self.cb0}, {self.n_blk}) "
                             f"does not fit tables of {C} channels with {w2} overflow "
                             "columns")
        if self.tau_shared:
            if self.slot1 is None or self.tau_smem_bytes(dtype) > _TAU_SMEM_BYTES:
                raise ValueError(f"K3: {self.u_max} lines a block do not take shared "
                                 "taus")
            check_tensor(self.slot1, "slot1", torch.int16, (M1, C), dev, "K3")
            check_tensor(self.slot2, "slot2", torch.int16, (M2, w2), dev, "K3")

    def tau_smem_bytes(self, dtype) -> int:
        """The tau tile's shared memory at `dtype`: u_max x ROWS values."""
        return self.u_max * ROWS * dtype.itemsize


def gather_geometry(n_channels: int, cb0: int, cblock: int = 128) -> GatherGeometry:
    """Blocks of the JAX package's channel walk (_geom) at width cblock:
    ceil(cb0 / cblock) blocks over the overflow region, then the rest."""
    n_bo = -(-cb0 // cblock) if cb0 else 0
    rest = max(n_channels - n_bo * cblock, 0)
    return GatherGeometry(cblock=cblock, cb0=cb0, n_blk=n_bo + -(-rest // cblock))


def block_line_tables(idx1, idx2, geom: GatherGeometry) -> dict:
    """The kernel's view of the index tables (idx1 (M1, C), idx2 (M2, w2)
    active-line indices, as _dense_tables gives them) at `geom`'s channel
    blocks: per block the sorted distinct active lines its main entries
    and (on channels < cb0) its overflow entries reference, padding
    entries included, in `block_lines` (n_blk, u_max) int32, -1 past a
    block's count; per entry its slot in its block's list, `slot1` /
    `slot2` int16 (None where u_max exceeds int16); and `u_max`."""
    C, cb, cb0 = idx1.shape[1], geom.cblock, geom.cb0
    lists = []
    for b in range(geom.n_blk):
        parts = [idx1[:, b * cb:(b + 1) * cb].ravel()]
        if cb0:
            parts.append(idx2[:, b * cb:min((b + 1) * cb, cb0)].ravel())
        lists.append(np.unique(np.concatenate(parts)))
    u_max = max(len(x) for x in lists)
    block_lines = np.full((geom.n_blk, u_max), -1, np.int32)
    slot1 = np.zeros(idx1.shape, np.int32)
    slot2 = np.zeros(idx2.shape, np.int32)
    for b, lines in enumerate(lists):
        block_lines[b, :len(lines)] = lines
        cols = slice(b * cb, min((b + 1) * cb, C))
        slot1[:, cols] = np.searchsorted(lines, idx1[:, cols])
        if cb0 and b * cb < cb0:
            cols = slice(b * cb, min((b + 1) * cb, cb0))
            slot2[:, cols] = np.searchsorted(lines, idx2[:, cols])
    small = u_max <= _SLOT_MAX
    return dict(block_lines=block_lines, u_max=int(u_max),
                slot1=slot1.astype(np.int16) if small else None,
                slot2=slot2.astype(np.int16) if small else None)


def _q_fits(qm) -> bool:
    if qm.cheb_coeffs is not None:
        return len(qm.cheb_coeffs) <= _MAX_CHEB
    return qm.kind == "states" or len(qm.coeffs) <= _MAX_POLY


def plan_fused_gather(model, spec, dv_max: float, nwalkers: int = 128, *,
                      min_saving: float = 1.3, cblock: int = 128):
    """Build the channel-major tables, K3's channel-block geometry and
    the kernel's derived tables, or return None when (model, spec) is
    outside the kernel's limits (more than one component, a Q(T) with more
    coefficients than the statics hold, a dtype other than float32 /
    float64, an odd or too large ensemble). Returns {tables, geometry,
    kernel}: kernel = block_line_tables' dict with the active lines'
    constants `lines` (5, La) and the index tables idx1 / idx2.

    Table construction on a large catalog costs seconds of host time, so
    a caller that checks support and then builds the kernel does both
    through this one plan (pipeline/fit.py passes it to
    make_fused_ensemble_gather)."""
    if (spec.ncomp != 1 or model.dtype not in _SUFFIX or nwalkers % 2
            or nwalkers > _MAX_WALKERS or not _q_fits(model.q_model)
            or cblock % 32 or not 32 <= cblock <= _MAX_BLOCK):
        return None
    tables, lines, idx1, idx2 = _dense_tables(model, dv_max, min_saving)
    geometry = gather_geometry(model.n_channels, tables["cb0"], cblock)
    kernel = dict(block_line_tables(idx1, idx2, geometry), lines=lines, idx1=idx1,
                  idx2=idx2)
    return dict(tables=tables, geometry=geometry, kernel=kernel)


def fused_gather_supported(model, spec, dv_max: float, nwalkers: int = 128) -> bool:
    """Can (model, spec) run through K3? Single-component layouts only
    (the K-component family has K2, sampler/fused_multi.py)."""
    return plan_fused_gather(model, spec, dv_max, nwalkers) is not None


def gather_statics_tables(model, spec, grid_ints, grid_yerrs, bounds, prior_means,
                          prior_stds, plan, *, a: float = 2.0):
    """(FusedStatics, tables, GatherPlan) for K3's lnprob — K1's statics
    (sampler/fused.py:single_statics_tables) over the plan's tables, kept
    channel-major. Tables are tensors on the model's device and dtype:
    lines1 (5, M1, C), vel1 (M1, C), lines2 (5, M2, w2), vel2 (M2, w2)
    with w2 = max(cb0, 1), chans (3, C) = freq, y, 1/sigma^2 in the
    tables' heavy-first channel order, qst (2, S) = state-sum g, E (a
    dummy (2, 8) for the other Q kinds). The GatherPlan holds the plan's
    geometry and the kernel's derived tables on the same device, its taus
    in shared memory where u_max x ROWS of them fit a CTA."""
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
    kn = plan["kernel"]

    def ints(x):
        return None if x is None else torch.as_tensor(x, device=dev).contiguous()

    geom = plan["geometry"]
    tau_shared = (kn["slot1"] is not None
                  and kn["u_max"] * ROWS * dt.itemsize <= _TAU_SMEM_BYTES)
    kplan = GatherPlan(geom.cblock, geom.cb0, geom.n_blk, u_max=kn["u_max"],
                       tau_shared=tau_shared, lines=t(kn["lines"]),
                       block_lines=ints(kn["block_lines"]), slot1=ints(kn["slot1"]),
                       slot2=ints(kn["slot2"]), idx1=ints(kn["idx1"]), idx2=ints(kn["idx2"]))
    return statics, tables, kplan


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
        lib, log = bind_kernel_library("gather_step.cu", "k3", (24, 14), (15, 13),
                                       _STATICS, "k5b_half", (23, 13))
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"k3_max_grid_{sfx}")
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _library = lib, log
    return _library


@functools.lru_cache(maxsize=64)
def _resident(device_index: int, dtype, cblock: int, smem: int, shared: bool) -> int:
    """CTAs of one launch the card keeps resident (occupancy per SM x SMs;
    0 without cooperative launch)."""
    lib, _ = load_kernel_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"k3_max_grid_{_SUFFIX[dtype]}")(cblock, smem, int(shared),
                                                            ctypes.byref(out))
    raise_on(err, lib.k3_error_string, "max_grid", "K3")
    return out.value


def resident_ctas(geom: GatherPlan, dtype, device) -> int:
    """The CTAs of a K3 / K5b launch at `geom` that the card keeps
    resident at once: occupancy per SM x SMs (0 where not one fits or the
    card has no cooperative launch)."""
    smem = geom.tau_smem_bytes(dtype) if geom.tau_shared else 0
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _resident(index, dtype, geom.cblock, smem, geom.tau_shared)


def launch_grid(geom: GatherPlan, n_rows: int, dtype, device) -> int:
    """The CTAs of a launch over `n_rows` proposals or thetas: geom.grid
    where set (it must be resident at once), else every CTA the card keeps
    resident, spread evenly over the (channel block, 8 rows) tiles (fewer
    CTAs where that takes no more rounds). Raises where not one CTA fits
    an SM."""
    resident = resident_ctas(geom, dtype, device)
    if resident < 1:
        smem = geom.tau_smem_bytes(dtype) if geom.tau_shared else 0
        raise ValueError(f"K3: not one CTA of {geom.cblock} threads with {smem} B of "
                         "shared memory fits an SM (or no cooperative launch)")
    if geom.grid:
        if geom.grid > resident:
            raise ValueError(f"K3: a grid of {geom.grid} CTAs; the card keeps "
                             f"{resident} resident")
        return geom.grid
    tiles = geom.n_blk * -(-n_rows // ROWS)
    return -(-tiles // -(-tiles // resident))


def kernel_operands(tables, geom, dtype, device, n_rows: int, ndim: int, n_acc: int):
    """Check the tables a K3 / K5b launch over `n_rows` proposals or
    thetas of `ndim` dims with `n_acc` accepted counts reads (the
    velocities, chans and qst of gather_statics_tables against the plan's
    checked derived tables), and allocate its scratch as one buffer.
    Returns (table pointers, the buffer, scratch pointers (proposals,
    stretch factors, row scalars, chi^2 partials, per-channel constants,
    taus, int32 counts), ints (La, M1, M2, C, cb0, S, U, cblock, n_blk,
    grid, tau_shared)) in the C entries' order; keep the buffer until the
    launch is enqueued."""
    if not isinstance(geom, GatherPlan) or geom.lines is None:
        raise ValueError("K3 needs the GatherPlan of gather_statics_tables (the "
                         "kernel's derived tables), not a bare geometry")
    _, vel1, _, vel2, chans, qst = tables
    (M1, C), (M2, w2), (_, La), S = geom.idx1.shape, geom.idx2.shape, geom.lines.shape, \
        qst.shape[1]
    if geom.lines.dtype != dtype or geom.lines.device != device:
        raise ValueError(f"K3: a plan of {geom.lines.dtype} on {geom.lines.device} for "
                         f"{dtype} on {device}")
    check_tensor(vel1, "vel1", dtype, (M1, C), device, "K3")
    check_tensor(vel2, "vel2", dtype, (M2, w2), device, "K3")
    check_tensor(chans, "chans", dtype, (3, C), device, "K3")
    check_tensor(qst, "qst", dtype, (2, S), device, "K3")
    grid = launch_grid(geom, n_rows, dtype, device)
    keys = (geom.slot1, geom.slot2) if geom.tau_shared else (geom.idx1, geom.idx2)
    ptrs = [t.data_ptr() for t in (geom.lines, vel1, vel2, *keys, geom.block_lines, chans,
                                   qst)]
    sizes = [n_rows * ndim, n_rows, n_rows * _SCALARS, n_rows * geom.n_blk,
             CHAN_CONSTS * C, 1 if geom.tau_shared else n_rows * La]
    sizes = [n * dtype.itemsize for n in sizes] + [4 * max(n_acc, 1)]
    offsets = [0, *itertools.accumulate(-(-n // 16) * 16 for n in sizes)]
    buf = torch.empty(offsets[-1], dtype=torch.uint8, device=device)
    scratch = [buf.data_ptr() + o for o in offsets[:-1]]
    ints = (La, M1, M2, C, geom.cb0, S, geom.u_max, geom.cblock, geom.n_blk, grid,
            int(geom.tau_shared))
    return ptrs, buf, scratch, ints


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
    ptrs, buf, scratch, ints = kernel_operands(tables, geom, dtype, dev, h, D, k)
    packed = _pack_statics(st, dtype)
    state = torch.cat([coords, lnp[:, None]], dim=1).contiguous()   # updated in place
    out_chain = torch.empty((k * W, D), dtype=dtype, device=dev)
    out_lnps = torch.empty(k * W, dtype=dtype, device=dev)
    out_acc = torch.empty(k, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k3_fused_steps_{_SUFFIX[dtype]}")(
            state.data_ptr(), perm.data_ptr(), z_u.data_ptr(), pair.data_ptr(),
            acc_u.data_ptr(), *ptrs, *scratch,
            *(t.data_ptr() for t in (out_chain, out_lnps, out_acc)),
            ctypes.addressof(packed), W, D, *ints, k,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k3_error_string, "gather_steps", "K3")
    LAUNCHES["gather_steps"] += 1
    return out_chain, out_lnps, out_acc


def _launch_lnprob(theta, tables, st, geom):
    lib, _ = load_kernel_library()
    dtype, dev = theta.dtype, theta.device
    N, D = theta.shape
    _check_dims(D, st, dtype)
    check_tensor(theta, "theta", dtype, (N, D), dev, "K3")
    ptrs, buf, scratch, ints = kernel_operands(tables, geom, dtype, dev, N, D, 0)
    packed = _pack_statics(st, dtype)
    out = torch.empty(N, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k3_lnprob_{_SUFFIX[dtype]}")(
            theta.data_ptr(), out.data_ptr(), *ptrs, *scratch[2:6],
            ctypes.addressof(packed), N, D, *ints,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k3_error_string, "gather_lnprob", "K3")
    LAUNCHES["gather_lnprob"] += 1
    return out


def gather_lnprob(theta, tables, st: FusedStatics, geom: GatherGeometry):
    """K3's lnprob, (N, D) -> (N,): the CUDA kernel for CUDA tensors (one
    launch; `geom` the GatherPlan of gather_statics_tables), the plain
    version for CPU tensors."""
    if route(theta, "K3") == "cuda":
        return _launch_lnprob(theta, tables, st, geom)
    return gather_lnprob_plain(theta, tables, st, geom)


def gather_step_block(coords, lnp, perm, z_u, pair, acc_u, tables, st: FusedStatics,
                      geom: GatherGeometry):
    """k whole steps (layout as in fused.steps_plain): one launch of the
    CUDA kernel for CUDA tensors (`geom` the GatherPlan of
    gather_statics_tables), the plain version for CPU tensors."""
    if route(coords, "K3") == "cuda":
        return _launch_steps(coords, lnp, perm, z_u, pair, acc_u, tables, st, geom)
    return gather_steps_plain(coords, lnp, perm, z_u, pair, acc_u, tables, st, geom)


@dataclasses.dataclass(frozen=True)
class GatherFusedEnsemble(FusedEnsemble):
    """K3's runner: FusedEnsemble's run(pos0, lnp0, nsteps, k_steps)
    contract for one ensemble, each k steps one K3 call
    (`make_fused_ensemble_gather`)."""

    geometry: GatherGeometry
    family: typing.ClassVar[None] = None   # its own binding, not the cluster one

    def lnprob(self, theta):
        return gather_lnprob(theta, self.tables, self.statics, self.geometry)

    def step_block(self, coords, lnp, perm, z_u, pair, acc_u):
        if coords.dim() != 2:
            raise ValueError("K3 runs one ensemble a call, not a chain axis")
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
