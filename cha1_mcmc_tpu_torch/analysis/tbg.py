"""Background-temperature models.

Port of the reference's calc_tbg dispatch (reference
spectral_simulator/simulate_lte.py:5366-5693): per-range constant,
polynomial, power-law, the Sgr B2 empirical continuum, and a greybody.
Frequencies outside every specified range default to 2.7 K.

A NumPy copy of cha1_mcmc_tpu/analysis/tbg.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np

from cha1_mcmc_tpu_torch.constants import CM, H, K, T_CMB
from cha1_mcmc_tpu_torch.ops.lte import beam_dilution

__all__ = ["calc_tbg"]


def _range_indices(frequencies: np.ndarray, ll: float, ul: float):
    """Same windowing convention as trim_array (reference functions.py:507)."""
    if frequencies.size == 0:   # empty simulation window: nothing to label
        return None
    above_ll = np.where(frequencies > ll)[0]
    if above_ll.size == 0:
        if frequencies[-1] < ll:
            return None
        i_low = 0
    else:
        i_low = int(above_ll[0])
    above_ul = np.where(frequencies > ul)[0]
    i_high = int(above_ul[0]) if above_ul.size else len(frequencies)
    return i_low, i_high


def calc_tbg(tbg_params, tbg_type: str, tbg_range, frequencies) -> np.ndarray:
    """Background temperature (K) per frequency channel (MHz).

    tbg_type in {'constant', 'poly', 'power', 'sgrb2', 'greybody'};
    tbg_range is a list of (ll, ul) MHz windows (may be empty);
    tbg_params is per-type (see the reference docstrings at
    simulate_lte.py:5366-5693).
    """
    frequencies = np.asarray(frequencies, dtype=np.float64)
    n_ranges = len(tbg_range)
    tbg = np.zeros_like(frequencies)
    if isinstance(tbg_params, (int, float)):
        tbg_params = [tbg_params]

    if tbg_type == "constant":
        if n_ranges == 0:
            return np.full_like(frequencies, tbg_params[0])
        for i in range(n_ranges):
            idx = _range_indices(frequencies, *tbg_range[i])
            if idx is None:
                continue
            value = tbg_params[i]
            tbg[idx[0]:idx[1]] += value
        tbg[tbg == 0] = T_CMB
        return tbg

    if tbg_type == "poly":
        # User supplies descending coefficients [A, B, C] for A x^2 + B x + C;
        # evaluation wants ascending (reference :5512-5520). NOTE: the
        # reference's own no-range poly evaluation is broken for inner lists
        # longer than one element (it multiplies the whole reversed list by
        # frequencies**x, reference :5532, which only broadcasts for
        # singleton lists); this implementation evaluates the full
        # polynomial as the docstring intends.
        params = [list(p)[::-1] for p in tbg_params]
        if n_ranges == 0:
            coeffs = params[0]
            for order, c in enumerate(coeffs):
                tbg += c * frequencies ** order
            tbg[tbg == 0] = T_CMB
            return tbg
        for i in range(n_ranges):
            idx = _range_indices(frequencies, *tbg_range[i])
            if idx is None:
                continue
            for order, c in enumerate(params[i]):
                tbg[idx[0]:idx[1]] += c * frequencies[idx[0]:idx[1]] ** order
        tbg[tbg == 0] = T_CMB
        return tbg

    if tbg_type == "power":
        # A * nu^B + C (reference :5600-5612)
        if n_ranges <= 1:
            return tbg + tbg_params[0] * frequencies ** tbg_params[1] + tbg_params[2]
        for i in range(n_ranges):
            idx = _range_indices(frequencies, *tbg_range[i])
            if idx is None:
                continue
            a, b, c = tbg_params[i]
            tbg[idx[0]:idx[1]] += a * frequencies[idx[0]:idx[1]] ** b + c
        tbg[tbg == 0] = T_CMB
        return tbg

    if tbg_type == "sgrb2":
        # Empirical Sgr B2 continuum, un-diluted for a 20" source on a 100 m
        # dish (reference :5670-5680).
        tmp = 10 ** (-1.06 * np.log10(frequencies / 1000.0) + 2.3)
        dilution = beam_dilution(np, frequencies, 20.0, 100.0)
        return tmp / dilution

    if tbg_type == "greybody":
        # T, beta, tau_ref, tau_ref_freq (GHz), major, minor (arcsec)
        # (reference :5395-5430). The reference's Jy->K step references
        # uninitialized globals; here the standard Jy/beam -> K conversion
        # closes the calculation.
        T, beta, tauref, taufreq, major, minor = tbg_params
        omega = (np.radians(major / 3600.0) * np.radians(minor / 3600.0)
                 * np.pi / (4 * np.log(2)))
        tau = tauref * (frequencies * 1e6 / (taufreq * 1e9)) ** beta
        jy = (omega * 1e23 * (1 - np.exp(-tau)) * 2 * H
              * (frequencies * 1e6) ** 3 / CM ** 2
              / np.expm1(H * frequencies * 1e6 / (K * T)))
        kelvin = 1.224e6 * jy / ((frequencies / 1000.0) ** 2 * major * minor)
        kelvin[kelvin < T_CMB] = T_CMB
        return kelvin

    raise ValueError(f"Unknown tbg_type: {tbg_type!r}")
