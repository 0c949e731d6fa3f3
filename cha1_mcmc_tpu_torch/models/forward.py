"""Forward emission model.

Port of cha1_mcmc_tpu/models/forward.py. Two layers:

* :func:`simulate_sticks_host` — host-side float64 stick simulation over the
  full (trimmed) catalog, equivalent to the reference's MolSim with
  gauss=False (reference spectral_simulator/classes.py:294-397). Used once
  per fit for data reduction / covered-line selection; never in the hot loop.

* :class:`SpectralModel` — the device model, an ``nn.Module`` whose static
  arrays (covered-line constants, the (lines x channels) velocity grid,
  state-sum arrays) are buffers. Its forward is batched over walkers with
  the walker axis written out: one call evaluates every proposal of a
  half-step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cha1_mcmc_tpu_torch.constants import (
    CKM,
    T_CMB,
    FWHM_TO_SIGMA_MODEL,
    VELOCITY_WINDOW_DV,
)
from cha1_mcmc_tpu_torch.ops.lte import planck_J, beam_dilution, tau_sticks, stick_spectrum
from cha1_mcmc_tpu_torch.catalogs.spcat import Catalog
from cha1_mcmc_tpu_torch.catalogs.partition import QModel, q_model_for_catalog
from cha1_mcmc_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["simulate_sticks_host", "forward_from_lines", "SpectralModel",
           "model_from_arrays"]

_LINE_FIELDS = ("line_freq", "line_elower", "line_aij", "line_gup", "line_glow")


def simulate_sticks_host(
    catalog: Catalog,
    C,
    dV,
    T,
    ll,
    ul,
    source_size: float,
    dish_size: float,
    Tbg: float = T_CMB,
    q_model: QModel | None = None,
):
    """Stick simulation over the trimmed catalog, float64 NumPy.

    Equivalent to MolSim(..., gauss=False) (reference classes.py:294-397):
    per component, compute full-catalog opacities, trim to the [ll, ul]
    windows, convert to stick intensities with beam dilution, and sum the
    components (after radiative transfer, reference classes.py:394-395).
    In stick mode the vlsr shift has no effect on the returned arrays (the
    reference computes the shift but extends the unshifted intensities,
    reference classes.py:379-386), so no vlsr argument is taken.

    C, dV, T are per-component sequences; ll, ul per-chunk sequences.
    Returns (freq_sim, int_sim, tau_sim) with int/tau summed over components.
    """
    C = np.atleast_1d(np.asarray(C, dtype=np.float64))
    dV = np.atleast_1d(np.asarray(dV, dtype=np.float64))
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    ll = np.atleast_1d(np.asarray(ll, dtype=np.float64))
    ul = np.atleast_1d(np.asarray(ul, dtype=np.float64))
    if q_model is None:
        q_model = q_model_for_catalog(catalog)

    chunks = [catalog.trim_indices(l, u) for l, u in zip(ll, ul)]
    freq_sim = np.concatenate([catalog.frequency[i:i2] for i, i2 in chunks])

    int_comps, tau_comps = [], []
    with np.errstate(under="ignore", over="ignore"):
        for ci in range(len(C)):
            Q = float(q_model.host_eval(T[ci]))
            tau_full = tau_sticks(
                np, catalog.frequency, catalog.elower, catalog.aij,
                catalog.gup, catalog.glow, Q, C[ci], T[ci], dV[ci],
            )
            tau = np.concatenate([tau_full[i:i2] for i, i2 in chunks])
            ints = stick_spectrum(np, freq_sim, tau, T[ci], Tbg, source_size, dish_size)
            int_comps.append(ints)
            tau_comps.append(tau)

    return freq_sim, np.sum(int_comps, axis=0), np.sum(tau_comps, axis=0)


def forward_from_lines(line_freq, line_elower, line_aij, line_gup, line_glow,
                       vel_grid, Q, grid_freq, mask_center, dish_size, Tbg,
                       source_size, Ncol, Tex, vlsr, dV, group=None):
    """Walker-batched composite emission model, (N, C).

    source_size, Ncol, vlsr: (N, ncomp); Tex, dV: (N,); Q: (N,) partition
    function at Tex. Each component is radiative-transferred and
    beam-diluted independently, then summed (reference
    TMC1_four_component.py:173-179; a single component reduces to reference
    inference.py:44-61). The physics is that of the JAX package's
    forward_from_lines, with its vmapped walker axis written out.

    The line arrays may be one shard of the catalog's lines: `group` then
    names the torch.distributed group of the ranks holding the other
    shards, and the partial opacities are summed over it (all_reduce, the
    JAX version's psum over its mesh axis) before the radiative transfer.
    """
    taus = tau_sticks(torch, line_freq, line_elower, line_aij, line_gup,
                      line_glow, Q[:, None, None], Ncol[..., None],
                      Tex[:, None, None], dV[:, None, None])   # (N, K, L)
    sigma = dV / FWHM_TO_SIGMA_MODEL                             # (N,)
    window = (torch.abs(vel_grid - mask_center)
              < VELOCITY_WINDOW_DV * dV[:, None, None])          # (N, L, C)
    z = ((vel_grid - vlsr[:, :, None, None])
         / sigma[:, None, None, None])                           # (N, K, L, C)
    gauss = torch.where(window[:, None], torch.exp(-0.5 * z * z),
                        torch.zeros((), dtype=z.dtype, device=z.device))
    # Contraction over lines: one batched mat-vec per walker and component.
    opac = torch.einsum("nkl,nklc->nkc", taus, gauss)          # (N, K, C)
    if group is not None:
        opac = opac.contiguous()
        dist.all_reduce(opac, group=group)

    # Hot-loop J uses the +1e-10 overflow guard (reference inference.py:56-57).
    J_T = planck_J(torch, grid_freq, Tex[:, None, None], guard=1e-10)
    J_Tbg = planck_J(torch, grid_freq, Tbg, guard=1e-10)
    dil = beam_dilution(torch, grid_freq, source_size[..., None], dish_size)
    comps = dil * (J_T - J_Tbg) * (1.0 - torch.exp(-opac))       # (N, K, C)
    return torch.sum(comps, dim=1)


def _velocity_grid(line_freq, grid_freq, vel_offset):
    """Static (L, C) velocity of each channel relative to each line, in f64
    on the host (reference inference.py:51)."""
    return (line_freq[:, None] - grid_freq[None, :]) / line_freq[:, None] * CKM + vel_offset


class SpectralModel(nn.Module):
    """On-grid emission model over the covered lines.

    Buffers (moved with ``.to(device)``):
      line_*      — (L,) covered-line catalog arrays
      grid_freq   — (C,) observed channel frequencies, MHz
      vel_grid    — (L, C) velocity of each channel relative to each line,
                    including `vel_offset` (reference inference.py:51)
      q_g, q_E    — (S,) state-sum arrays (empty for other Q kinds)

    Geometry knobs reproduce both reference model variants:
      * single component (reference inference.py:44-61):
        vel_offset = aligned_velocity, mask_center = aligned_velocity
      * TMC-1 multi component (reference
        scripts/MCMC/TMC1_four_component.py:148-181):
        vel_offset = 0, mask_center = 5.8 (the source's aligned velocity)
    """

    def __init__(self, arrays: dict, q_model: QModel, *, mask_center: float,
                 dish_size: float, Tbg: float = T_CMB, vel_offset: float = 0.0,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device, "SpectralModel")
        for name in _LINE_FIELDS + ("grid_freq", "vel_grid"):
            self.register_buffer(name, torch.as_tensor(
                arrays[name], dtype=dtype, device=device))
        self.q_model = q_model
        states = q_model.kind == "states"
        for name, values in (("q_g", q_model.g), ("q_E", q_model.E)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(values if states else [], dtype=np.float64),
                dtype=dtype, device=device))
        self.mask_center = float(mask_center)
        self.dish_size = float(dish_size)
        self.Tbg = float(Tbg)
        self.vel_offset = float(vel_offset)

    @staticmethod
    def build(
        catalog: Catalog,
        covered_idx: np.ndarray,
        grid_freq: np.ndarray,
        *,
        ll: float,
        ul: float,
        dish_size: float,
        vel_offset: float,
        mask_center: float,
        Tbg: float = T_CMB,
        q_model: QModel | None = None,
        device=DEFAULT_DEVICE,
        dtype=torch.float32,
    ) -> "SpectralModel":
        """Assemble a model from a catalog and a reduced datagrid.

        `covered_idx` indexes into the catalog *trimmed* to (ll, ul], exactly
        as the reference's covered_trans indexes the trimmed simulation
        (reference inference.py:142-144 after classes.py:358-364).
        """
        i, i2 = catalog.trim_indices(ll, ul)
        sel = np.arange(i, i2)[np.asarray(covered_idx, dtype=int)]
        if q_model is None:
            q_model = q_model_for_catalog(catalog)
        line_freq = catalog.frequency[sel]
        grid_freq = np.asarray(grid_freq, dtype=np.float64)
        arrays = dict(line_freq=line_freq, line_elower=catalog.elower[sel],
                      line_aij=catalog.aij[sel], line_gup=catalog.gup[sel],
                      line_glow=catalog.glow[sel], grid_freq=grid_freq,
                      vel_grid=_velocity_grid(line_freq, grid_freq, vel_offset))
        return SpectralModel(arrays, q_model, mask_center=mask_center,
                             dish_size=dish_size, Tbg=Tbg,
                             vel_offset=vel_offset, device=device, dtype=dtype)

    def with_q_model(self, q_model: QModel) -> "SpectralModel":
        """A copy of this model with another Q(T); the line and grid
        buffers are shared, not copied."""
        arrays = {name: getattr(self, name)
                  for name in _LINE_FIELDS + ("grid_freq", "vel_grid")}
        return SpectralModel(arrays, q_model, mask_center=self.mask_center,
                             dish_size=self.dish_size, Tbg=self.Tbg,
                             vel_offset=self.vel_offset, device=self.device,
                             dtype=self.dtype)

    def with_grid(self, grid_freq) -> "SpectralModel":
        """A copy of this model on another channel grid `grid_freq` (MHz):
        the same lines and Q(T), the velocity grid recomputed in f64 on the
        host from the lines as `build` computes it (vel_offset included),
        e.g. a fine grid around a line for plotting."""
        grid_freq = np.asarray(grid_freq, dtype=np.float64)
        arrays = {name: getattr(self, name) for name in _LINE_FIELDS}
        arrays["grid_freq"] = grid_freq
        arrays["vel_grid"] = _velocity_grid(self.line_freq.cpu().numpy().astype(np.float64),
                                            grid_freq, self.vel_offset)
        return SpectralModel(arrays, self.q_model, mask_center=self.mask_center,
                             dish_size=self.dish_size, Tbg=self.Tbg,
                             vel_offset=self.vel_offset, device=self.device,
                             dtype=self.dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.grid_freq.dtype

    @property
    def device(self) -> torch.device:
        return self.grid_freq.device

    @property
    def n_lines(self) -> int:
        return int(self.line_freq.shape[0])

    @property
    def n_channels(self) -> int:
        return int(self.grid_freq.shape[0])

    def q(self, Tex: torch.Tensor) -> torch.Tensor:
        """Partition function at each walker's Tex, (N,) -> (N,)."""
        return self.q_model(Tex, states=(self.q_g, self.q_E))

    def forward(self, source_size, Ncol, Tex, vlsr, dV):
        """Composite emission model on the channel grid, in K, (N, C).

        source_size, Ncol, vlsr: (N, ncomp); Tex, dV: (N,)."""
        return forward_from_lines(
            self.line_freq, self.line_elower, self.line_aij, self.line_gup,
            self.line_glow, self.vel_grid, self.q(Tex), self.grid_freq,
            self.mask_center, self.dish_size, self.Tbg,
            source_size, Ncol, Tex, vlsr, dV)

    def chi2_lnlike(self, model, grid_ints, inv_sigma2):
        """-0.5 * sum[(y - m)^2 / sigma^2 - ln(1/sigma^2)] per walker,
        (N, C) -> (N,) (reference inference.py:157-166)."""
        resid = grid_ints - model
        return -0.5 * torch.sum(resid * resid * inv_sigma2 - torch.log(inv_sigma2),
                                dim=-1)


def model_from_arrays(arrays: dict, q: dict, *, mask_center: float,
                      dish_size: float, Tbg: float = T_CMB,
                      vel_offset: float = 0.0, device=DEFAULT_DEVICE,
                      dtype=torch.float32) -> SpectralModel:
    """Build the port's SpectralModel from another model's fields given as
    NumPy arrays (`line_freq`, `line_elower`, `line_aij`, `line_gup`,
    `line_glow`, `grid_freq`, `vel_grid`) and its QModel as a dict of
    QModel fields — so two implementations can compute on identical
    constants."""
    q = dict(q)
    for name in ("coeffs", "power", "cheb_interval", "cheb_coeffs"):
        if q.get(name) is not None:
            q[name] = tuple(q[name])
    arrays = {k: np.array(v, copy=True) for k, v in arrays.items()}
    return SpectralModel(arrays, QModel(**q), mask_center=mask_center,
                         dish_size=dish_size, Tbg=Tbg, vel_offset=vel_offset,
                         device=device, dtype=dtype)
