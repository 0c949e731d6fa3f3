"""LTE physics primitives: Planck radiation temperature, beam dilution,
stick opacities, and stick intensities.

Formulas follow the reference exactly:
  * tau            — reference spectral_simulator/classes.py:349-354
  * J(T)           — reference classes.py:372-375 (unguarded) and
                     inference.py:56-57 (+1e-10 overflow guard in the hot loop)
  * beam dilution  — reference inference.py:33-41 / functions.py:627-650

All functions take the array namespace `xp` first (numpy for the float64
host path, torch for the device path, with tensor arguments) and are
shape-polymorphic and dtype-preserving.
"""

from __future__ import annotations

import numpy as np

from cha1_mcmc_tpu_torch.constants import CCM, CKM, CM, H, K, RAD_TO_ARCSEC, BEAM_FACTOR

__all__ = ["planck_J", "beam_dilution", "apply_beam", "tau_sticks", "stick_spectrum"]


def planck_J(xp, freq_mhz, T, guard: float = 0.0):
    """Planck radiation temperature J_T(nu) in K.

    J_T = (h nu / k) / (exp(h nu / (k T)) - 1 + guard). The reference's
    hot-loop kernel adds guard=1e-10 against overflow of the exponential
    (reference inference.py:56-57); its stick simulator does not
    (reference classes.py:372-375).
    """
    x = H * freq_mhz * 1e6 / K
    return (x) / (xp.exp(x / T) - 1.0 + guard)


def beam_dilution(xp, freq_mhz, source_size, dish_size):
    """Diffraction-limited beam dilution factor (dimensionless).

    beam = lambda * 206265 * 1.22 / dish;  factor = ss^2 / (beam^2 + ss^2)
    (reference inference.py:33-41).
    """
    wavelength = CM / (freq_mhz * 1e6)
    beam_size = wavelength * RAD_TO_ARCSEC * BEAM_FACTOR / dish_size
    return source_size ** 2 / (beam_size ** 2 + source_size ** 2)


def apply_beam(xp, freq_mhz, intensity, source_size, dish_size):
    """Intensity corrected by the beam dilution factor."""
    return intensity * beam_dilution(xp, freq_mhz, source_size, dish_size)


def apply_beam_interferometer(xp, intensity, source_size, synth_beam):
    """Beam dilution against a synthesized (bmaj, bmin) arcsec beam — the
    vendored tool's interferometer=True branch (reference
    simulate_lte.py:1580-1648): beam = (bmaj + bmin) / 2, frequency-
    independent; same ss^2/(beam^2 + ss^2) dilution."""
    beam_size = (synth_beam[0] + synth_beam[1]) / 2.0
    return intensity * (source_size ** 2
                        / (beam_size ** 2 + source_size ** 2))


def get_beam(xp, freq_mhz, dish_size):
    """Diffraction-limited beam size in arcseconds
    (reference simulate_lte.py:1650-1664)."""
    wavelength = CM / (freq_mhz * 1e6)
    return wavelength * RAD_TO_ARCSEC * BEAM_FACTOR / dish_size


def invert_beam(xp, freq_mhz, intensity, source_size, dish_size):
    """Un-dilute an observed intensity — the reverse beam correction the
    vendored tool applies to observed background temperatures
    (reference simulate_lte.py:1668-1700)."""
    return intensity / beam_dilution(xp, freq_mhz, source_size, dish_size)


def tau_sticks(xp, freq_mhz, elower, aij, gup, glow, Q, Ncol, Tex, dV):
    """Per-line peak opacity for an LTE column (reference classes.py:349-354).

    Nl      = Ncol * glow * exp(-elower / (0.695 * Tex)) / Q
    tau_num = (ccm / nu_Hz)^2 * aij * gup * Nl * (1 - exp(-h nu / (k Tex)))
    tau_den = 8 pi * (dV * nu_Hz / ckm) * glow
    """
    Nl = Ncol * glow * xp.exp(-elower / (0.695 * Tex)) / Q
    nu_hz = freq_mhz * 1e6
    tau_num = (CCM / nu_hz) ** 2 * aij * gup * Nl * (1.0 - xp.exp(-(H * nu_hz) / (K * Tex)))
    tau_den = 8.0 * np.pi * (dV * nu_hz / CKM) * glow
    return tau_num / tau_den


def scale_temp(xp, int_sim, elower, T, CT, Q_T, Q_CT):
    """Rescale linear intensities from catalog temperature CT to T
    (reference simulate_lte.py:1318-1341):
    int * (Q_CT / Q_T) * (CT / T) * exp(-((1/T - 1/CT) * elower) / 0.695).
    """
    return int_sim * (Q_CT / Q_T) * (CT / T) * xp.exp(
        -(((1.0 / T) - (1.0 / CT)) * elower) / 0.695)


def stick_spectrum(xp, freq_mhz, tau, Tex, Tbg, source_size, dish_size):
    """Stick (gauss=False) intensities with beam dilution applied.

    int = (J_Tex - J_Tbg) * (1 - exp(-tau)) * dilution
    (reference classes.py:370-377; the stick path uses the *unguarded* J).
    """
    J_T = planck_J(xp, freq_mhz, Tex)
    J_Tbg = planck_J(xp, freq_mhz, Tbg)
    intensity = (J_T - J_Tbg) * (1.0 - xp.exp(-tau))
    return apply_beam(xp, freq_mhz, intensity, source_size, dish_size)
