"""K4a / K4b: the block-sparse and CSR Gaussian-opacity kernels and their
plain PyTorch versions.

Port of the Pallas opacity kernels of cha1_mcmc_tpu/models/
pallas_kernels.py. Both compute, for W walkers,

    opac[w, c] = sum_l tau[w, l] * g(vel[l, c]; vlsr_w, dV_w)

over the lines the ±10·dV window can reach, listed two ways
(models/sparse_opacity.py builds the tables):

* K4a, the block mask: (512-line tile, 128-channel tile) activity bits
  over the dense (L, C) velocity grid (`opacity_pallas`,
  `opacity_pallas_fused`: the exp form; `opacity_pallas_mxu`: the exp2
  form, masked or unmasked);
* K4b, CSR: per 128-channel tile the compacted list of lines it can see
  (`opacity_pallas_csr`: the exp2 form, masked or unmasked).

The two forms are exp(-0.5 ((v - vlsr) / sigma)^2) and exp2(aa (v -
vlsr)^2), aa = -log2(e) / (2 sigma^2), sigma = dV / 2.355; each keeps one
formula on both devices (the JAX package runs the exp kernel under its
interpreter and the exp2 one compiled, inference/likelihood.py:87-90).

The wrappers launch the CUDA kernel (csrc/opacity.cu) for CUDA tensors and
take the plain version only for CPU tensors; `LAUNCHES` counts kernel
launches. A caller that evaluates the same tables many times builds an
`OpacityPlan` once (`plan_opacity_block` / `plan_opacity_csr`: the tables
checked and packed for the kernel, the velocity rows copied to a 16-byte
pitch where they lack one: `kernel_rows`) and calls `opacity_planned`,
which checks only the call's taus, vlsr and dV; the public wrappers build
a plan per call, so they check everything. `walker_radius` and
`candidates` state the kernels' prefilter in torch ops (each walker's
test radius, and the elements inside the widest one). `unmasked_is_exact`
re-derives window_is_exact's underflow argument for a card that keeps
subnormals.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
from cha1_mcmc_tpu_torch.models.sparse_opacity import TC, TL, window_is_exact
from cha1_mcmc_tpu_torch.sampler.fused import _AA, check_tensor, raise_on, route
from cha1_mcmc_tpu_torch.utils.cuda_build import build_library
from cha1_mcmc_tpu_torch.utils.metrics import register_launches

__all__ = ["opacity_block_plain", "opacity_csr_plain", "opacity_pallas",
           "opacity_pallas_fused", "opacity_pallas_mxu", "opacity_pallas_csr",
           "OpacityPlan", "plan_opacity_block", "plan_opacity_csr", "opacity_planned",
           "kernel_rows",
           "walker_radius", "candidates", "unmasked_is_exact", "load_kernel_library",
           "LAUNCHES"]

_FORMS = {"exp": 0, "exp2": 1}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: Kernel launches per K4 entry, counted where each kernel is launched and
#: nowhere else (plain-version calls do not count).
LAUNCHES = register_launches({"opacity_block": 0, "opacity_csr": 0})

#: Below this z = |v - vlsr| / sigma the Gaussian does not round to exactly
#: 0 on a card that keeps subnormals: exp(-z^2 / 2) < 2^-150 (half the
#: smallest float32 subnormal), and < 2^-1075 in float64.
_Z_UNDERFLOW = {torch.float32: float(np.sqrt(2 * 150 * np.log(2))),
                torch.float64: float(np.sqrt(2 * 1075 * np.log(2)))}

#: csrc/opacity.cu:Reach — the z past which the kernels drop an unmasked
#: term (above _Z_UNDERFLOW, with margin) and the slack for the rounding
#: of |v - mc|, |vlsr - mc| and v - vlsr.
_REACH = {torch.float32: (16.0, 2.0 ** -18), torch.float64: (40.0, 2.0 ** -46)}

def unmasked_is_exact(dv_min: float, max_vlsr_offset: float, dtype) -> bool:
    """May the exp2 kernels drop the window select for every in-bounds
    (vlsr, dV) on this card? The JAX package's window_is_exact assumes
    the TPU's flush of subnormals (edge z >= 14.37 x 1.1); without a
    flush, float32 rounds to 0 only past z = 14.42, which 15.81 clears,
    while float64 keeps values down to z = 38.6 — so only float32 under
    window_is_exact qualifies."""
    if dtype != torch.float32 or not window_is_exact(dv_min, max_vlsr_offset):
        return False
    z_edge = ((VELOCITY_WINDOW_DV * dv_min - max_vlsr_offset)
              * FWHM_TO_SIGMA_MODEL / dv_min)
    return z_edge > _Z_UNDERFLOW[dtype]


def walker_radius(vlsr, dV, mask_center: float, *, masked: bool):
    """Each walker's test radius as the kernels compute it, in the
    walkers' dtype: the kernels evaluate term (v, w) only where |v -
    mask_center| < radius[w]. Masked: the window 10 dV itself. Unmasked:
    |vlsr - mc| + |sigma| kZ + slack (2 |vlsr - mc| + |sigma| kZ), past
    which exp2(aa (v - vlsr)^2) is exactly 0 (csrc/opacity.cu's note), and
    inf where that bound cannot be trusted (sigma 0 or not finite, sigma^2
    or the radius infinite)."""
    if masked:
        return VELOCITY_WINDOW_DV * dV
    kz, slack = _REACH[dV.dtype]
    mc = torch.tensor(mask_center, dtype=dV.dtype, device=dV.device)
    off = torch.abs(vlsr - mc)
    s = torch.abs(dV / FWHM_TO_SIGMA_MODEL)
    reach = s * kz
    r = (off + reach) + slack * (2.0 * off + reach)
    trusted = (s > 0) & (s * s < torch.inf) & (r < torch.inf)
    return torch.where(trusted, r, torch.full_like(r, torch.inf))


def candidates(vel, vlsr, dV, mask_center: float, *, masked: bool):
    """The kernels' prefilter: the elements of `vel` (any shape) inside
    the widest walker radius, |v - mc| < max(0, max_w radius[w]) (NaN
    radii ignored) — a superset of every term any walker's own test
    keeps."""
    r = walker_radius(vlsr, dV, mask_center, masked=masked)
    rmax = torch.clamp(torch.nan_to_num(r, nan=0.0, posinf=torch.inf).max(), min=0.0)
    mc = torch.tensor(mask_center, dtype=vel.dtype, device=vel.device)
    return torch.abs(vel - mc) < rmax


# -- plain PyTorch versions --------------------------------------------------

def _gauss(vel, vlsr, dV, mask_center, form, masked):
    """(W, n, c) Gaussians of (n, c) velocities for (W,) walkers."""
    sigma = (dV / FWHM_TO_SIGMA_MODEL)[:, None, None]
    if form == "exp":
        z = (vel - vlsr[:, None, None]) / sigma
        g = torch.exp(-0.5 * z * z)
    else:
        aa = _AA / (sigma * sigma)
        d = vel - vlsr[:, None, None]
        g = torch.exp2(aa * (d * d))
    if masked:
        window = torch.abs(vel - mask_center) < VELOCITY_WINDOW_DV * dV[:, None, None]
        g = torch.where(window, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g


def opacity_block_plain(taus, vlsr, dV, vel_grid, block_mask, *,
                        mask_center: float, form: str = "exp",
                        masked: bool = True):
    """K4a with torch ops: (W, L) taus, (W,) vlsr / dV, (L, C) velocities,
    (nL, nC) activity mask -> (W, C), one 128-channel tile at a time over
    the lines of its active 512-line tiles, in line order."""
    W, L = taus.shape
    C = vel_grid.shape[1]
    mask = block_mask.cpu().numpy()
    out = torch.zeros((W, C), dtype=taus.dtype, device=taus.device)
    for ct in range(mask.shape[1]):
        c0, c1 = ct * TC, min((ct + 1) * TC, C)
        tiles = np.flatnonzero(mask[:, ct])
        if tiles.size == 0:
            continue
        lines = torch.cat([torch.arange(t * TL, min((t + 1) * TL, L),
                                        device=taus.device) for t in tiles])
        g = _gauss(vel_grid[lines, c0:c1], vlsr, dV, mask_center, form, masked)
        out[:, c0:c1] = torch.sum(taus[:, lines, None] * g, dim=1)
    return out


def opacity_csr_plain(taus, vlsr, dV, line_table, vel_compact, tile_counts, *,
                      mask_center: float, n_channels: int, masked: bool = True):
    """K4b with torch ops: per 128-channel tile j, the exp2 Gaussians of
    its tile_counts[j] compacted lines, summed in their order -> (W,
    n_channels)."""
    W = taus.shape[0]
    nC, K = line_table.shape
    out = torch.zeros((W, nC * TC), dtype=taus.dtype, device=taus.device)
    for j, count in enumerate(tile_counts.tolist()):
        if count == 0:
            continue
        idx = line_table[j, :count].long()
        vel = vel_compact[j * K:j * K + count]
        g = _gauss(vel, vlsr, dV, mask_center, "exp2", masked)
        out[:, j * TC:(j + 1) * TC] = torch.sum(taus[:, idx, None] * g, dim=1)
    return out[:, :n_channels]


# -- the CUDA kernels --------------------------------------------------------

_library = None
_PREPARED: set = set()


def load_kernel_library():
    """Build K4a/K4b (at first use) and load them: returns (ctypes
    library, nvcc build log, empty when a cached build was loaded)."""
    global _library
    if _library is None:
        path, log = build_library("opacity.cu")
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"k4_opacity_{sfx}")
            fn.argtypes, fn.restype = [P] * 5 + [I] * 4 + [P], I
        lib.k4_prepare.argtypes, lib.k4_prepare.restype = [], I
        lib.k4_error_string.argtypes, lib.k4_error_string.restype = [I], ctypes.c_char_p
        _library = lib, log
    return _library


def _device_library(dev):
    """The library, its kernels opened to the opt-in shared memory of
    `dev` once per device (k4_prepare), before their first launch there."""
    lib, _ = load_kernel_library()
    if dev.index not in _PREPARED:
        with torch.cuda.device(dev):
            raise_on(lib.k4_prepare(), lib.k4_error_string, "prepare", "K4")
        _PREPARED.add(dev.index)
    return lib


class _K4Tables(ctypes.Structure):
    """csrc/opacity.cu:K4Tables — a plan's tables as the kernel reads them."""
    _fields_ = [("vel", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("line_table", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("L", ctypes.c_int32), ("C", ctypes.c_int32), ("nL", ctypes.c_int32),
                ("nC", ctypes.c_int32), ("K", ctypes.c_int32), ("csr", ctypes.c_int32),
                ("pitch", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("mask_center", ctypes.c_double)]


@dataclasses.dataclass(frozen=True, eq=False)
class OpacityPlan:
    """The static side of a K4a ("block") or K4b ("csr") evaluation,
    checked once by plan_opacity_block / plan_opacity_csr: the tables
    (block: (vel_grid, block_mask); csr: (line_table, vel_compact,
    tile_counts)), their dtype and device, the mask centre, the output's
    channels, the lines a call's taus must have (block; None for csr), the
    velocity rows the kernel reads (`rows`: kernel_rows of vel_grid or
    vel_compact) and the tables packed for the kernel (the plan keeps the
    tensors alive)."""

    kind: str
    tables: tuple
    mask_center: float
    n_channels: int
    n_lines: int | None
    dtype: torch.dtype
    device: torch.device
    rows: torch.Tensor
    packed: _K4Tables

    @property
    def kernel(self) -> str:
        return "K4a" if self.kind == "block" else "K4b"


def kernel_rows(vel):
    """(rows, pitch): a 2-D velocity table as the kernels copy it, 16 bytes
    at a time — `vel` itself where its base and row pitch are multiples of
    16 bytes, else a copy whose rows are padded with NaN to such a pitch
    (NaN never passes the window's compare)."""
    n, C = vel.shape
    per = 16 // vel.element_size()
    pitch = -(-C // per) * per
    if pitch == C and vel.data_ptr() % 16 == 0:
        return vel, pitch
    rows = torch.full((n, pitch), torch.nan, dtype=vel.dtype, device=vel.device)
    rows[:, :C] = vel
    return rows, pitch


def _table_dtype(t, name, kernel):
    if t.dtype not in _SUFFIX or t.dim() != 2:
        raise ValueError(f"{kernel}: {name} is {t.dtype} {tuple(t.shape)}; the kernel "
                         "takes a 2-D float32 or float64 table")
    return t.dtype, t.device


def plan_opacity_block(vel_grid, block_mask, *, mask_center: float) -> OpacityPlan:
    """K4a's plan over the (L, C) velocity grid and its (ceil(L/512),
    ceil(C/128)) int32 activity mask (block_activity_mask), both
    contiguous on one device; raises on any other shape, type or device."""
    dtype, dev = _table_dtype(vel_grid, "vel_grid", "K4a")
    L, C = vel_grid.shape
    nL, nC = -(-L // TL), -(-C // TC)
    check_tensor(vel_grid, "vel_grid", dtype, (L, C), dev, "K4a")
    check_tensor(block_mask, "block_mask", torch.int32, (nL, nC), dev, "K4a")
    rows, pitch = kernel_rows(vel_grid)
    packed = _K4Tables(rows.data_ptr(), block_mask.data_ptr(), None, None, L, C, nL,
                       nC, 0, 0, pitch, 0, float(mask_center))
    return OpacityPlan("block", (vel_grid, block_mask), float(mask_center), C, L, dtype,
                       dev, rows, packed)


def plan_opacity_csr(line_table, vel_compact, tile_counts, *, mask_center: float,
                     n_channels: int) -> OpacityPlan:
    """K4b's plan over build_opacity_csr's tables: line_table (nC, K)
    int32, vel_compact (nC * K, 128) float, tile_counts (nC,) int32, all
    contiguous on one device, for an output of n_channels <= nC * 128
    channels; raises on any other shape, type or device. The kernel
    bounds the data-dependent entries itself (a count past K, a line
    outside the call's taus: no term)."""
    dtype, dev = _table_dtype(vel_compact, "vel_compact", "K4b")
    if line_table.dim() != 2:
        raise ValueError(f"K4b: line_table is {tuple(line_table.shape)}; the kernel "
                         "takes (nC, K)")
    nC, K = line_table.shape
    check_tensor(line_table, "line_table", torch.int32, (nC, K), dev, "K4b")
    check_tensor(vel_compact, "vel_compact", dtype, (nC * K, TC), dev, "K4b")
    check_tensor(tile_counts, "tile_counts", torch.int32, (nC,), dev, "K4b")
    if not 0 < n_channels <= nC * TC:
        raise ValueError(f"K4b: {nC} channel tiles cannot hold {n_channels} channels")
    rows, pitch = kernel_rows(vel_compact)
    packed = _K4Tables(rows.data_ptr(), None, line_table.data_ptr(),
                       tile_counts.data_ptr(), 0, n_channels, 0, nC, K, 1, pitch, 0,
                       float(mask_center))
    return OpacityPlan("csr", (line_table, vel_compact, tile_counts), float(mask_center),
                       n_channels, None, dtype, dev, rows, packed)


def _launch(plan: OpacityPlan, taus, vlsr, dV, form: str, masked: bool):
    kernel = plan.kernel
    if taus.dim() != 2:
        raise ValueError(f"{kernel}: taus must be (W, L), not {tuple(taus.shape)}")
    W, L = taus.shape
    dev = plan.device
    check_tensor(taus, "taus", plan.dtype, (W, plan.n_lines or L), dev, kernel)
    check_tensor(vlsr, "vlsr", plan.dtype, (W,), dev, kernel)
    check_tensor(dV, "dV", plan.dtype, (W,), dev, kernel)
    lib = _device_library(dev)
    out = torch.empty((W, plan.n_channels), dtype=plan.dtype, device=dev)
    fn = getattr(lib, f"k4_opacity_{_SUFFIX[plan.dtype]}")
    args = (ctypes.addressof(plan.packed), taus.data_ptr(), vlsr.data_ptr(), dV.data_ptr(),
            out.data_ptr(), W, L, _FORMS[form], int(masked))
    if torch.cuda.current_device() == dev.index:
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k4_error_string, f"opacity_{plan.kind}", kernel)
    LAUNCHES[f"opacity_{plan.kind}"] += 1
    return out


def opacity_planned(plan: OpacityPlan, taus, vlsr, dV, *, form: str = "exp2",
                    masked: bool = True):
    """(W, C) opacity over a plan's tables: the kernel for CUDA tensors
    (checking only taus (W, L), vlsr and dV (W,)), the plain version for
    CPU tensors. form "exp" (always masked; K4a only) or "exp2"; masked=
    False only where unmasked_is_exact holds for the parameter box."""
    if form not in _FORMS or (form == "exp" and (not masked or plan.kind == "csr")):
        raise ValueError(f"{plan.kernel}: form={form!r}, masked={masked}: the exp form "
                         "is masked and K4a's alone")
    if route(taus, plan.kernel) == "cuda":
        return _launch(plan, taus, vlsr, dV, form, masked)
    if plan.kind == "block":
        return opacity_block_plain(taus, vlsr, dV, *plan.tables,
                                   mask_center=plan.mask_center, form=form, masked=masked)
    return opacity_csr_plain(taus, vlsr, dV, *plan.tables, mask_center=plan.mask_center,
                             n_channels=plan.n_channels, masked=masked)


def _block(taus, vlsr, dV, vel_grid, block_mask, mask_center, form, masked):
    if route(taus, "K4a") == "cuda":
        return opacity_planned(plan_opacity_block(vel_grid, block_mask,
                                                  mask_center=mask_center),
                               taus, vlsr, dV, form=form, masked=masked)
    return opacity_block_plain(taus, vlsr, dV, vel_grid, block_mask,
                               mask_center=mask_center, form=form, masked=masked)


def opacity_pallas(taus, vlsr, dV, vel_grid, block_mask, *, mask_center: float):
    """Accumulated Gaussian opacity, (W, C), in the exp form over the
    block-sparse tiles (K4a; JAX opacity_pallas). taus (W, L); vlsr, dV
    (W,); vel_grid (L, C); block_mask (ceil(L/512), ceil(C/128)) int32
    from block_activity_mask."""
    return _block(taus, vlsr, dV, vel_grid, block_mask, mask_center, "exp", True)


def opacity_pallas_fused(taus, vlsr, dV, vel_grid, block_mask, *, mask_center: float):
    """The same function as opacity_pallas (the JAX package's fully fused
    VPU variant of it): the one K4a kernel in the exp form."""
    return _block(taus, vlsr, dV, vel_grid, block_mask, mask_center, "exp", True)


def opacity_pallas_mxu(taus, vlsr, dV, vel_grid, block_mask, *, mask_center: float,
                       unmasked: bool = False):
    """K4a in the exp2 form (JAX opacity_pallas_mxu). unmasked=True drops
    the per-element window select — only valid where unmasked_is_exact
    holds for the parameter box."""
    return _block(taus, vlsr, dV, vel_grid, block_mask, mask_center, "exp2",
                  not unmasked)


def opacity_pallas_csr(taus, vlsr, dV, line_table, vel_compact, tile_counts, *,
                       mask_center: float, n_channels: int, unmasked: bool = False):
    """Accumulated Gaussian opacity via line compaction, (W, n_channels),
    in the exp2 form (K4b; JAX opacity_pallas_csr). (line_table (nC, K)
    int32, vel_compact (nC * K, 128), tile_counts (nC,) int32) from
    build_opacity_csr; unmasked as in opacity_pallas_mxu."""
    if route(taus, "K4b") == "cuda":
        return opacity_planned(plan_opacity_csr(line_table, vel_compact, tile_counts,
                                                mask_center=mask_center,
                                                n_channels=n_channels),
                               taus, vlsr, dV, masked=not unmasked)
    return opacity_csr_plain(taus, vlsr, dV, line_table, vel_compact, tile_counts,
                             mask_center=mask_center, n_channels=n_channels,
                             masked=not unmasked)
