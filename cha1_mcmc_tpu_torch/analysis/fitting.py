"""Gaussian line-profile fitting.

Port of the reference's gauss_func / gauss_fit (reference
spectral_simulator/simulate_lte.py:3869-3962): per-line scipy curve_fit of
dT * exp(-(x - v)^2 / (2 c^2)) with c = dV * v / ckm / 2.35482, with the
reference's default bounds (amplitude unconstrained, center within 5 MHz,
width within 20%).

A NumPy copy of cha1_mcmc_tpu/analysis/fitting.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import curve_fit

from cha1_mcmc_tpu_torch.constants import CKM, FWHM_TO_SIGMA_PLOT

__all__ = ["gauss_func", "gauss_fit"]


def gauss_func(x, dT, v, dV):
    """Gaussian in frequency space with FWHM given in km/s
    (reference simulate_lte.py:3869-3885)."""
    df = dV * v / CKM
    c = df / FWHM_TO_SIGMA_PLOT
    return dT * np.exp(-((x - v) ** 2) / (2.0 * c ** 2))


def gauss_fit(freq_obs, int_obs, p_array, *, dT_bound=np.inf, v_bound=5.0,
              dV_bound=0.2, sigma=None):
    """Fit one Gaussian per initial guess [dT, v, dV].

    Returns a list of [dT, dT_err, v, v_err, dV, dV_err] rows (the
    reference's return_results format, simulate_lte.py:3948-3955).
    """
    freq_obs = np.asarray(freq_obs, dtype=np.float64)
    int_obs = np.asarray(int_obs, dtype=np.float64)
    results = []
    for x, p0 in enumerate(p_array):
        dT0, v0, dV0 = p0
        bounds = ([dT0 - dT0 * dT_bound, v0 - v_bound, dV0 * (1 - dV_bound)],
                  [dT0 + dT0 * dT_bound, v0 + v_bound, dV0 * (1 + dV_bound)])
        kwargs = {}
        if sigma is not None:
            kwargs["sigma"] = np.full_like(freq_obs, sigma[x])
        coeff, cov = curve_fit(gauss_func, freq_obs, int_obs, p0=p0,
                               bounds=bounds, **kwargs)
        err = np.sqrt(np.diag(cov))
        results.append([coeff[0], err[0], coeff[1], err[1], coeff[2], err[2]])
    return results


def make_gauss_params(path, vlsr, dV):
    """Initial [dT, center, dV] triples for gauss_fit from a two-column
    line list file (frequency intensity per row), the center shifted by
    the source velocity with the reference's literal 3E5 km/s
    (reference make_gauss_params, simulate_lte.py:3968-3988)."""
    p = []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            freq = float(line.split()[0])
            freq -= vlsr * freq / 3e5
            p.append([float(line.split()[1].strip("\n")), freq, float(dV)])
    return p
