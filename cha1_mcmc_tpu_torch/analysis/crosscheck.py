"""Independent grid-chi^2 cross-validation.

Port of cha1_mcmc_tpu/analysis/crosscheck.py. The reference validates its
MCMC pipeline against CASSIS's independent chi^2/MCMC engine over
parameter grids (reference scripts/CASSIS/Cha1_HC5N_CASSIS.py:62-144:
nmol/temp/vlsr/size ranges with a fixed fwhm). This module plays the same
methodological role natively: a brute-force chi^2 scan of the *same*
forward model over a parameter grid, giving an MCMC-independent check that
the posterior mode sits at the grid minimum.

The grid is evaluated in batches of thetas through the batched dense
lnlike, on the model's device: a million grid points are 16 calls of
65,536.
"""

from __future__ import annotations

import numpy as np
import torch

from cha1_mcmc_tpu_torch.models.forward import SpectralModel
from cha1_mcmc_tpu_torch.inference.params import ParamSpec
from cha1_mcmc_tpu_torch.inference.likelihood import build_lnlike

__all__ = ["grid_chi2"]


@torch.no_grad()
def grid_chi2(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs,
              param_grids: dict, *, batch: int = 65536):
    """Evaluate -2 lnlike on the outer product of per-parameter grids.

    param_grids maps parameter names (in theta order, e.g. 'Ncol', 'Tex',
    'vlsr', 'dV' for the fixed-source-size layout) to 1D arrays. Returns
    (thetas (G, D), chi2 (G,), best_theta) as NumPy, thetas in
    itertools.product order (the last parameter varies fastest). Mirrors
    the CASSIS min/max/steps vocabulary (reference
    Cha1_HC5N_CASSIS.py:66-101).
    """
    axes = [np.asarray(v, dtype=np.float64) for v in param_grids.values()]
    thetas = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")], axis=1)
    lnlike = build_lnlike(model, spec, grid_ints, grid_yerrs)
    out = []
    for s in range(0, len(thetas), batch):
        th = torch.as_tensor(thetas[s:s + batch], dtype=model.dtype, device=model.device)
        out.append(lnlike(th).cpu().numpy())
    chi2 = -2.0 * np.concatenate(out)
    return thetas, chi2, thetas[int(np.argmin(chi2))]
