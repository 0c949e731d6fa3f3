"""Flux-density / brightness-temperature conversions.

Pure-array versions of the reference's interactive jy_to_k / k_to_jy
(reference spectral_simulator/simulate_lte.py:3991-4059), which mutate
module globals and redraw a plot; here they just return the converted
intensities.

A NumPy copy of cha1_mcmc_tpu/analysis/conversions.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["jy_to_k", "k_to_jy", "planck_k_to_jy"]

_JYK_CONST = 1.224e6


def jy_to_k(intensity_jy, freq_mhz, bmaj, bmin):
    """Jy/beam -> K for a bmaj x bmin (arcsec) beam
    (reference simulate_lte.py:4000-4002):
    K = 1.224e6 * Jy / (nu_GHz^2 * bmaj * bmin)."""
    freq_ghz = np.asarray(freq_mhz, dtype=np.float64) / 1000.0
    return _JYK_CONST * np.asarray(intensity_jy, dtype=np.float64) / (
        freq_ghz ** 2 * bmaj * bmin)


def k_to_jy(intensity_k, freq_mhz, bmaj, bmin):
    """K -> Jy/beam, inverse of jy_to_k (reference simulate_lte.py:4030-4032)."""
    freq_ghz = np.asarray(freq_mhz, dtype=np.float64) / 1000.0
    return np.asarray(intensity_k, dtype=np.float64) * (
        freq_ghz ** 2 * bmaj * bmin) / _JYK_CONST


def planck_k_to_jy(intensity_k, freq_mhz, synth_beam):
    """Planck-scale K -> Jy/beam for a synthesized bmaj x bmin (arcsec)
    beam — the vendored tool's planck=True display mode (reference
    simulate_lte.py run_sim, :1831-1855):
    Jy = 3.92e-8 * nu_GHz^3 * omega / (exp(0.048 nu_GHz / T_K) - 1),
    omega = bmaj * bmin. Zero intensities stay exactly zero (the
    reference's mask)."""
    intensity_k = np.asarray(intensity_k, dtype=np.float64)
    freq_ghz = np.asarray(freq_mhz, dtype=np.float64) * 1e-3
    omega = synth_beam[0] * synth_beam[1]
    out = np.zeros_like(intensity_k)
    mask = intensity_k != 0
    # tiny K values overflow the exp to inf -> 0 Jy; the reference runs
    # under a global np.seterr(over='ignore') (simulate_lte.py:1710-1711)
    with np.errstate(over="ignore"):
        out[mask] = (3.92e-8 * freq_ghz[mask] ** 3 * omega
                     / (np.exp(0.048 * freq_ghz[mask] / intensity_k[mask]) - 1.0))
    return out
