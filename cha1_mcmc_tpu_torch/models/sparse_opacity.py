"""Channel-major gather opacity: the ±10·dV window sparsity transposed.

Port of the jnp (not Pallas) part of cha1_mcmc_tpu/models/
pallas_kernels.py:459-608 — `build_opacity_gather`, `opacity_gather`,
`build_opacity_gather_split`, `opacity_gather_split`. The static tables
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

__all__ = ["build_opacity_gather", "opacity_gather",
           "build_opacity_gather_split", "opacity_gather_split"]


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
