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
launches. `unmasked_is_exact` re-derives window_is_exact's underflow
argument for a card that keeps subnormals.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV
from cha1_mcmc_tpu_torch.models.sparse_opacity import TC, TL, window_is_exact
from cha1_mcmc_tpu_torch.sampler.fused import _AA, check_tensor, raise_on, route
from cha1_mcmc_tpu_torch.utils.cuda_build import build_library

__all__ = ["opacity_block_plain", "opacity_csr_plain", "opacity_pallas",
           "opacity_pallas_fused", "opacity_pallas_mxu", "opacity_pallas_csr",
           "unmasked_is_exact", "load_kernel_library", "LAUNCHES"]

_FORMS = {"exp": 0, "exp2": 1}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: Kernel launches per K4 entry, counted where each kernel is launched and
#: nowhere else (plain-version calls do not count).
LAUNCHES = {"opacity_block": 0, "opacity_csr": 0}

#: Below this z = |v - vlsr| / sigma the Gaussian does not round to exactly
#: 0 on a card that keeps subnormals: exp(-z^2 / 2) < 2^-150 (half the
#: smallest float32 subnormal), and < 2^-1075 in float64.
_Z_UNDERFLOW = {torch.float32: float(np.sqrt(2 * 150 * np.log(2))),
                torch.float64: float(np.sqrt(2 * 1075 * np.log(2)))}


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


def load_kernel_library():
    """Build K4a/K4b (at first use) and load them: returns (ctypes
    library, nvcc build log, empty when a cached build was loaded)."""
    global _library
    if _library is None:
        path, log = build_library("opacity.cu")
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"k4_block_opacity_{sfx}")
            fn.argtypes, fn.restype = [P] * 6 + [I] * 7 + [ctypes.c_double, P], I
            fn = getattr(lib, f"k4_csr_opacity_{sfx}")
            fn.argtypes, fn.restype = [P] * 7 + [I] * 6 + [ctypes.c_double, P], I
        lib.k4_error_string.argtypes, lib.k4_error_string.restype = [I], ctypes.c_char_p
        _library = lib, log
    return _library


def _check_walkers(taus, vlsr, dV, kernel):
    dtype, dev = taus.dtype, taus.device
    if dtype not in _SUFFIX:
        raise ValueError(f"{kernel} takes float32 or float64 taus, not {dtype}")
    W, L = taus.shape
    check_tensor(taus, "taus", dtype, (W, L), dev, kernel)
    check_tensor(vlsr, "vlsr", dtype, (W,), dev, kernel)
    check_tensor(dV, "dV", dtype, (W,), dev, kernel)
    return W, L, dtype, dev


def _launch_block(taus, vlsr, dV, vel_grid, block_mask, mask_center, form, masked):
    lib, _ = load_kernel_library()
    W, L, dtype, dev = _check_walkers(taus, vlsr, dV, "K4a")
    C = vel_grid.shape[1]
    nL, nC = -(-L // TL), -(-C // TC)
    check_tensor(vel_grid, "vel_grid", dtype, (L, C), dev, "K4a")
    check_tensor(block_mask, "block_mask", torch.int32, (nL, nC), dev, "K4a")
    out = torch.empty((W, C), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k4_block_opacity_{_SUFFIX[dtype]}")(
            taus.data_ptr(), vlsr.data_ptr(), dV.data_ptr(), vel_grid.data_ptr(),
            block_mask.data_ptr(), out.data_ptr(), W, L, C, nL, nC, _FORMS[form],
            int(masked), float(mask_center), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k4_error_string, "opacity_block", "K4a")
    LAUNCHES["opacity_block"] += 1
    return out


def _launch_csr(taus, vlsr, dV, line_table, vel_compact, tile_counts, mask_center,
                n_channels, masked):
    lib, _ = load_kernel_library()
    W, L, dtype, dev = _check_walkers(taus, vlsr, dV, "K4b")
    nC, K = line_table.shape
    if nC * TC < n_channels:
        raise ValueError(f"K4b: {nC} channel tiles cannot hold {n_channels} channels")
    check_tensor(line_table, "line_table", torch.int32, (nC, K), dev, "K4b")
    check_tensor(vel_compact, "vel_compact", dtype, (nC * K, TC), dev, "K4b")
    check_tensor(tile_counts, "tile_counts", torch.int32, (nC,), dev, "K4b")
    out = torch.empty((W, n_channels), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"k4_csr_opacity_{_SUFFIX[dtype]}")(
            taus.data_ptr(), vlsr.data_ptr(), dV.data_ptr(), line_table.data_ptr(),
            vel_compact.data_ptr(), tile_counts.data_ptr(), out.data_ptr(), W, L, K, nC,
            n_channels, int(masked), float(mask_center),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib.k4_error_string, "opacity_csr", "K4b")
    LAUNCHES["opacity_csr"] += 1
    return out


def _block(taus, vlsr, dV, vel_grid, block_mask, mask_center, form, masked):
    if route(taus, "K4a") == "cuda":
        return _launch_block(taus, vlsr, dV, vel_grid, block_mask, mask_center,
                             form, masked)
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
        return _launch_csr(taus, vlsr, dV, line_table, vel_compact, tile_counts,
                           mask_center, n_channels, not unmasked)
    return opacity_csr_plain(taus, vlsr, dV, line_table, vel_compact, tile_counts,
                             mask_center=mask_center, n_channels=n_channels,
                             masked=not unmasked)
