"""Static sparsity tables of the ±10·dV velocity window, and the
channel-major gather opacity.

Port of the host-side table functions and the jnp (not Pallas) part of
cha1_mcmc_tpu/models/pallas_kernels.py: `block_activity_mask` (:49-60)
and `build_opacity_csr` (:312-341), the tables of the block-sparse and
CSR opacity kernels K4a / K4b (models/opacity_kernels.py), with their
tile sizes; `window_is_exact` (:115-133); and `build_opacity_gather`,
`opacity_gather`, `build_opacity_gather_split`, `opacity_gather_split`
(:459-608); and `block_activity_mask_traced` (:63), the same mask
computed by torch ops on a (line-sharded) velocity grid tensor, for the
line-sharded path of parallel/sharded.py. The DMA redirect table
(`_dma_redirect_table`, :77) is not ported: it only lets the TPU
pipeline skip the copy of an inactive tile, and K4a already skips such
tiles by the mask. The gather tables
are per *channel*: line_table[m, c] lists the lines whose widest-possible
window (±10·dv_max around the mask center) covers channel c. The opacity
becomes a gather + an (N, M, C) elementwise Gaussian + a length-M
reduction, with M ~ a few instead of L lines. Lines that cover no channel
are dropped from the tau computation too (the `active` subset).

The table builders are NumPy, copied verbatim. The opacity functions are
torch ops. The split variant scatters its heavy-channel overflow with
`index_add` (one add per heavy channel), where the JAX package contracts
a one-hot matrix on the MXU: the result is the same single add, with no
dependence on matmul precision (TF32 would truncate the one-hot product).
"""

from __future__ import annotations

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV

__all__ = ["TC", "TL", "block_activity_mask", "block_activity_mask_traced",
           "window_is_exact",
           "build_opacity_csr", "build_opacity_gather", "opacity_gather",
           "build_opacity_gather_split", "opacity_gather_split"]

#: Channel and line tile of the block activity mask; TC is also the
#: channel tile of the CSR tables (the tables are defined by them).
TC, TL = 128, 512


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def block_activity_mask(vel_grid: np.ndarray, mask_center: float,
                        dv_max: float, *, tl: int = TL,
                        tc: int = TC) -> np.ndarray:
    """(nL, nC) int32 mask: does any (line, channel) in the tile fall inside
    the widest possible velocity window 10 * dv_max? Static per datagrid."""
    L, C = vel_grid.shape
    nL, nC = _ceil_to(L, tl) // tl, _ceil_to(C, tc) // tc
    inside = np.abs(np.asarray(vel_grid) - mask_center) < VELOCITY_WINDOW_DV * dv_max
    padded = np.zeros((nL * tl, nC * tc), dtype=bool)
    padded[:L, :C] = inside
    blocks = padded.reshape(nL, tl, nC, tc).any(axis=(1, 3))
    return blocks.astype(np.int32)


def block_activity_mask_traced(vel_grid: torch.Tensor, mask_center: float,
                               dv_max: float, *, tl: int = TL,
                               tc: int = TC) -> torch.Tensor:
    """block_activity_mask by torch ops on the (L, C) velocity grid
    tensor — a rank's line shard of it on the line-sharded path — on its
    device: (nL, nC) int32."""
    L, C = vel_grid.shape
    Lp, Cp = _ceil_to(L, tl), _ceil_to(C, tc)
    inside = torch.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    padded = torch.zeros((Lp, Cp), dtype=torch.bool, device=vel_grid.device)
    padded[:L, :C] = inside
    blocks = padded.reshape(Lp // tl, tl, Cp // tc, tc).any(dim=3).any(dim=1)
    return blocks.to(torch.int32)


def window_is_exact(dv_min: float, max_vlsr_offset: float,
                    margin: float = 1.1) -> bool:
    """Is dropping the per-element ±10·dV window select *exactly* lossless
    in f32 for every in-bounds (vlsr, dV)?

    At the window edge the Gaussian argument is
        z_edge = (10·dV − |vlsr − center|) / (dV / 2.355),
    worst-cased at dV = dv_min and |vlsr − center| = max_vlsr_offset.
    exp(−z²/2) flushes to exactly 0.0 in f32 (TPUs flush subnormals) once
    z ≳ 14.37 (2^−126 ≈ exp(−87.3)); with z_edge above that, every
    out-of-window channel underflows and the select is a no-op. Below it,
    the unmasked kernels would silently diverge from the reference window
    semantics — callers must use the masked variants.

    (Verbatim from the JAX package. On a CUDA card nothing flushes
    subnormals; models/opacity_kernels.py re-derives the threshold there.)
    """
    if dv_min <= 0:
        return False
    z_edge = (VELOCITY_WINDOW_DV * dv_min - max_vlsr_offset) * \
        FWHM_TO_SIGMA_MODEL / dv_min
    return z_edge >= 14.37 * margin


def build_opacity_csr(vel_grid: np.ndarray, mask_center: float,
                      dv_max: float, *, tc: int = TC, tl: int = 128):
    """Precompute the static compaction tables for the CSR opacity kernel.

    Returns (line_table (nC, K) int32, vel_compact (nC * K, tc) f32,
    tile_counts (nC,) int32) where K is the max number of active lines over
    channel tiles, padded to a multiple of tl, and tile_counts[j] is the
    number of active lines for channel tile j — the band is uneven, so
    most tiles have far fewer than K active lines; the kernel predicates
    the all-padding line-tile steps off. Padding entries point at velocity
    1e30, which underflows the Gaussian to exactly 0 regardless of tau.
    Static per (datagrid, prior dV bound) — same inputs as
    block_activity_mask.
    """
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    nC = _ceil_to(C, tc) // tc
    inside = np.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    active = [np.flatnonzero(inside[:, j * tc:(j + 1) * tc].any(axis=1))
              for j in range(nC)]
    K = _ceil_to(max((len(a) for a in active), default=1), tl)
    line_table = np.zeros((nC, K), dtype=np.int32)
    vel_compact = np.full((nC, K, tc), 1e30, dtype=vel_grid.dtype)
    tile_counts = np.zeros(nC, dtype=np.int32)
    for j, idx in enumerate(active):
        line_table[j, :len(idx)] = idx
        chunk = vel_grid[idx, j * tc:min((j + 1) * tc, C)]
        vel_compact[j, :len(idx), :chunk.shape[1]] = chunk
        tile_counts[j] = len(idx)
    return line_table, vel_compact.reshape(nC * K, tc), tile_counts


def build_opacity_gather(vel_grid: np.ndarray, mask_center: float,
                         dv_max: float):
    """Static channel-major gather tables for opacity_gather.

    Returns (line_table (M, C) int32, vel_t (M, C), active (La,) int64):
    line_table[m, c] indexes into the `active` line subset (the caller
    computes taus only for catalog lines `active`); vel_t[m, c] is that
    line's velocity at channel c. M is the max number of in-window lines
    over channels. Padding entries carry vel 1e30 (Gaussian exactly 0)
    and line index 0.
    """
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    inside = np.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    counts = inside.sum(axis=0)
    M = max(int(counts.max()), 1)
    active = np.flatnonzero(inside.any(axis=1))
    if active.size == 0:
        active = np.array([0], dtype=np.int64)
    remap = np.zeros(L, dtype=np.int32)
    remap[active] = np.arange(active.size, dtype=np.int32)
    line_table = np.zeros((M, C), dtype=np.int32)
    vel_t = np.full((M, C), 1e30, dtype=vel_grid.dtype)
    for c in np.flatnonzero(counts):
        idx = np.flatnonzero(inside[:, c])
        line_table[:idx.size, c] = remap[idx]
        vel_t[:idx.size, c] = vel_grid[idx, c]
    return line_table, vel_t, active


def opacity_gather(taus, vlsr, dV, line_table, vel_t, *, mask_center: float):
    """Accumulated Gaussian opacity via the channel-major gather, (N, C).

    taus: (N, La) over the active-line subset from build_opacity_gather;
    vlsr, dV: (N,); line_table (long) / vel_t: (M, C) tensors. Exact
    ±10·dV window semantics (the per-walker window select is kept)."""
    sigma = (dV / FWHM_TO_SIGMA_MODEL)[:, None, None]
    window = torch.abs(vel_t - mask_center) < VELOCITY_WINDOW_DV * dV[:, None, None]
    z = (vel_t - vlsr[:, None, None]) / sigma
    gauss = torch.where(window, torch.exp(-0.5 * z * z),
                        torch.zeros((), dtype=z.dtype, device=z.device))
    tau_g = taus[:, line_table]                               # (N, M, C)
    return torch.sum(tau_g * gauss, dim=-2)


def build_opacity_gather_split(vel_grid: np.ndarray, mask_center: float,
                               dv_max: float, m1: int | None = None,
                               min_saving: float = 1.3):
    """Two-class channel-major gather tables, or None when not worthwhile.

    Returns (table1 (M1, C), vel1 (M1, C), table2 (M2, C2), vel2 (M2, C2),
    heavy (C2,) int64 channel indices, active (La,) int64) with the same
    index/velocity conventions as build_opacity_gather. M1 is chosen to
    minimise the modeled element work C*M1 + C2*M2; returns None unless
    that beats the rectangular table's M*C by at least `min_saving` x
    (then callers use the plain gather)."""
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    inside = np.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    counts = inside.sum(axis=0)
    M = max(int(counts.max()), 1)

    def split_work(cand):
        c2 = int((counts > cand).sum())
        m2 = int(max(counts.max() - cand, 0)) if c2 else 0
        return C * cand + c2 * m2

    if m1 is not None:
        # A caller-chosen m1 is screened against ITS OWN work model, not
        # the work-optimal one the search would pick.
        chosen = (m1, split_work(m1))
    else:
        chosen = min(((cand, split_work(cand)) for cand in range(1, M)),
                     key=lambda t: t[1], default=None)
    if chosen is None or M * C < min_saving * chosen[1]:
        return None
    m1 = chosen[0]
    active = np.flatnonzero(inside.any(axis=1))
    if active.size == 0:
        active = np.array([0], dtype=np.int64)
    remap = np.zeros(L, dtype=np.int32)
    remap[active] = np.arange(active.size, dtype=np.int32)
    heavy = np.flatnonzero(counts > m1)
    M2 = max(int((counts[heavy] - m1).max()), 1) if heavy.size else 1
    table1 = np.zeros((m1, C), dtype=np.int32)
    vel1 = np.full((m1, C), 1e30, dtype=vel_grid.dtype)
    table2 = np.zeros((M2, max(heavy.size, 1)), dtype=np.int32)
    vel2 = np.full((M2, max(heavy.size, 1)), 1e30, dtype=vel_grid.dtype)
    for c in np.flatnonzero(counts):
        idx = np.flatnonzero(inside[:, c])
        k = min(idx.size, m1)
        table1[:k, c] = remap[idx[:k]]
        vel1[:k, c] = vel_grid[idx[:k], c]
    for j, c in enumerate(heavy):
        idx = np.flatnonzero(inside[:, c])[m1:]
        table2[:idx.size, j] = remap[idx]
        vel2[:idx.size, j] = vel_grid[idx, c]
    if heavy.size == 0:
        heavy = np.array([0], dtype=np.int64)
    return table1, vel1, table2, vel2, heavy, active


def opacity_gather_split(taus, vlsr, dV, table1, vel1, table2, vel2, heavy,
                         *, mask_center: float):
    """Accumulated Gaussian opacity via the split gather, (N, C).

    Same semantics as opacity_gather; `heavy` (C2,) long holds the channel
    of each overflow column. Light channels (count <= M1) equal the plain
    gather's; heavy channels get their overflow partial in one add (the
    split of the line sum in two reassociates it)."""
    part1 = opacity_gather(taus, vlsr, dV, table1, vel1,
                           mask_center=mask_center)         # (N, C)
    part2 = opacity_gather(taus, vlsr, dV, table2, vel2,
                           mask_center=mask_center)         # (N, C2)
    return part1.index_add(1, heavy, part2)
