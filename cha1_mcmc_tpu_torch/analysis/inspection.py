"""Best-fit spectrum inspection.

Port of cha1_mcmc_tpu/analysis/inspection.py. API equivalent of the
reference's DSN_spectra notebook (reference notebooks/DSN_spectra.ipynb
cells 0-12): recompute the best-fit model on the reduced data grid and on
fine per-transition grids, for per-line model-vs-data panels and a text
export of (freq, intensity, model).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import CKM
from cha1_mcmc_tpu_torch.models.forward import SpectralModel
from cha1_mcmc_tpu_torch.inference.params import ParamSpec
from cha1_mcmc_tpu_torch.reduce.datagrid import Datagrid

__all__ = ["LinePanel", "best_fit_inspection", "export_model_table"]


@dataclasses.dataclass
class LinePanel:
    """One transition's window: observed channels + fine model curve."""

    line_freq: float
    obs_freq: np.ndarray
    obs_int: np.ndarray
    obs_model: np.ndarray
    fine_freq: np.ndarray
    fine_model: np.ndarray


@torch.no_grad()
def best_fit_inspection(model: SpectralModel, spec: ParamSpec, grid: Datagrid,
                        theta, *, window_kms: float = 3.0,
                        fine_points: int = 1000) -> list[LinePanel]:
    """Per-transition panels of data vs the best-fit model.

    The fine model is evaluated on `fine_points` frequencies spanning
    +-window_kms around each covered line (the notebook uses 1000-point
    windows, reference DSN_spectra.ipynb cell 9), by a copy of the model
    on that grid (SpectralModel.with_grid), on the model's device.
    """
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=model.dtype,
                            device=model.device)[None]
    params = spec.unpack(theta)
    on_grid = model(*params)[0].cpu().numpy()

    panels = []
    for lf in model.line_freq.cpu().numpy().astype(np.float64):
        half = window_kms * lf / CKM
        fine = np.linspace(lf - half, lf + half, fine_points)
        fine_curve = model.with_grid(fine)(*params)[0].cpu().numpy()
        sel = np.abs((lf - grid.freqs) / lf * CKM) < window_kms
        panels.append(LinePanel(
            line_freq=float(lf),
            obs_freq=grid.freqs[sel], obs_int=grid.ints[sel],
            obs_model=on_grid[sel],
            fine_freq=fine, fine_model=fine_curve))
    return panels


def export_model_table(path: str, grid: Datagrid, model_on_grid) -> None:
    """Write the (freq, intensity, model) text table the notebook exports
    (reference DSN_spectra.ipynb cell 12). `model_on_grid` is an array or
    a tensor of the model on the grid's channels."""
    if isinstance(model_on_grid, torch.Tensor):
        model_on_grid = model_on_grid.detach().cpu().numpy()
    with open(path, "w") as fh:
        for f, i, m in zip(grid.freqs, grid.ints, np.asarray(model_on_grid)):
            fh.write(f"{f} {i} {m}\n")
