"""Maximum-likelihood initialization of the column density.

Port of cha1_mcmc_tpu/inference/mle.py. Role of reference
inference.py:344-376: bounded scalar maximization of lnlike over Ncol with
all other parameters pinned at their prior means.

* ``method="device"`` (default) — a bracketing grid search: each round
  evaluates the batched lnlike on 65 Ncol candidates in the current
  bracket (one walker-batched call) and shrinks the bracket around the
  argmax. A log-spaced first round covers the six-decade prior box, then
  linear rounds contract by ~32x each; the round count follows from xatol
  and from the resolution of `dtype`, exactly as in the JAX package.
* ``method="scipy"`` — scipy.optimize.minimize_scalar (bounded,
  xatol=1e-6) driving the lnlike one candidate at a time, the
  reference-shaped oracle for the device search.
"""

from __future__ import annotations

import numpy as np
import torch

from cha1_mcmc_tpu_torch.inference.params import ParamSpec
from cha1_mcmc_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["estimate_ncol_mle", "mle_rounds"]

_GRID_K = 65


def mle_rounds(ncol_bounds, dtype, xatol: float = 1e-6) -> int:
    """Round count of the device search: the bracket after the log round
    is <= hi * (r - 1) with r = (hi/lo)^(2/(K-1)); each linear round
    divides it by (K-1)/2; stop below max(xatol, dtype resolution)."""
    lo0, hi0 = float(ncol_bounds[0]), float(ncol_bounds[1])
    ratio = (hi0 / lo0) ** (2.0 / (_GRID_K - 1))
    width0 = hi0 * (ratio - 1.0)
    floor = max(xatol, hi0 * (1e-7 if dtype == torch.float32 else 1e-15))
    rounds = 1 + max(1, int(np.ceil(
        np.log(max(width0 / floor, 1.0)) / np.log((_GRID_K - 1) / 2))))
    return min(rounds, 16)


def estimate_ncol_mle(lnlike_fn, spec: ParamSpec, fixed_theta, ncol_bounds,
                      xatol: float = 1e-6, method: str = "device", *,
                      device=DEFAULT_DEVICE, dtype=torch.float32) -> float:
    """Return the Ncol maximizing the batched `lnlike_fn` ((N, D) -> (N,))
    with the other parameters fixed at `fixed_theta` (layout per `spec`).

    Raises RuntimeError if the scipy optimizer fails to converge
    (reference inference.py:371-373); the device search always terminates
    (fixed round count).
    """
    theta0 = np.asarray(fixed_theta, dtype=np.float64).copy()
    if spec.ncomp != 1:
        raise ValueError("MLE init is defined for single-component fits")
    ncol_index = spec.ncomp if spec.free_source_size else 0
    device = resolve_device(device, "estimate_ncol_mle")

    if method == "device":
        return _device_search(lnlike_fn, theta0, ncol_index, ncol_bounds,
                              xatol=xatol, device=device, dtype=dtype)

    import scipy.optimize as opt

    def nll(ncol):
        theta = theta0.copy()
        theta[ncol_index] = ncol
        t = torch.as_tensor(theta[None], dtype=dtype, device=device)
        return -float(lnlike_fn(t)[0])

    result = opt.minimize_scalar(nll, bounds=tuple(ncol_bounds), method="bounded",
                                 options={"xatol": xatol})
    if not result.success:
        raise RuntimeError("MLE for Ncol did not converge.")
    return float(result.x)


def _device_search(lnlike_fn, theta0, ncol_index: int, ncol_bounds, *,
                   xatol: float, device, dtype) -> float:
    rounds = mle_rounds(ncol_bounds, dtype, xatol)
    lo = torch.tensor(float(ncol_bounds[0]), dtype=dtype, device=device)
    hi = torch.tensor(float(ncol_bounds[1]), dtype=dtype, device=device)
    thetas = torch.as_tensor(theta0, dtype=dtype, device=device).repeat(_GRID_K, 1)
    with torch.no_grad():
        for i in range(rounds):
            if i == 0:
                xs = torch.logspace(float(torch.log10(lo)), float(torch.log10(hi)),
                                    _GRID_K, dtype=dtype, device=device)
            else:
                xs = torch.linspace(float(lo), float(hi), _GRID_K, dtype=dtype,
                                    device=device)
            thetas[:, ncol_index] = xs
            j = int(torch.argmax(lnlike_fn(thetas)))
            lo, hi = xs[max(j - 1, 0)], xs[min(j + 1, _GRID_K - 1)]
        return float(0.5 * (lo + hi))
