"""Observation-side utilities of the vendored tool.

Non-interactive equivalents of (reference spectral_simulator/
simulate_lte.py): baseline :4169, write_spectrum :1499,
get_subtraction :7336, and the compute core of plot_residuals :3573.

A NumPy copy of cha1_mcmc_tpu/analysis/obs_tools.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["subtract_baseline", "write_spectrum", "get_subtraction",
           "residual_spectrum", "find_limits"]


def subtract_baseline(freq_obs, int_obs, constants):
    """Subtract a polynomial baseline sum_x constants[x] * freq**x from the
    observed intensities (reference :4169-4190: the polynomial is
    evaluated at the *raw* frequency values, lowest order first; a bare
    int/float means a zeroth-order offset). Returns the new intensities.
    """
    if isinstance(constants, (int, float)):
        constants = [constants]
    freq_obs = np.asarray(freq_obs, dtype=np.float64)
    base = np.zeros_like(freq_obs)
    for x, c in enumerate(constants):
        base += c * freq_obs ** x
    return np.asarray(int_obs, dtype=np.float64) - base


def write_spectrum(freq, ints, output_file: str):
    """Two-column 'freq int' text export (reference :1499-1575).

    Reference quirk reproduced: the file starts with the first data row
    written twice — the reference writes row 0 as a header and then the
    append loop rewrites every row including row 0.
    """
    freq = np.asarray(freq)
    ints = np.asarray(ints)
    with open(output_file, "w") as out:
        out.write(f"{freq[0]} {ints[0]}\n")
        for h in range(len(freq)):
            out.write(f"{freq[h]} {ints[h]}\n")


def get_subtraction(obsx, obsy, simx, simy, ll: float, ul: float):
    """Sum of |obs - sim| over [ll, ul] with the simulation's grid as the
    comparison axis — the quick fit-quality metric (reference :7336-7356).
    Reference quirks reproduced: simulation channels falling outside the
    trimmed observation interpolate to NaN (np.interp left/right=nan) and
    the plain np.sum then returns NaN — the metric is only finite when
    the simulation grid lies inside [ll, ul], exactly as in the
    reference. (Its return_sim=True branch references an undefined
    variable and would raise; it is not reproduced.)
    """
    obsx = np.asarray(obsx, dtype=np.float64)
    obsy = np.asarray(obsy, dtype=np.float64)
    simx = np.asarray(simx, dtype=np.float64)
    simy = np.asarray(simy, dtype=np.float64)
    # trim_array boundary semantics: ll < freq <= ul (reference :1903-1935)
    sel = (obsx > ll) & (obsx <= ul)
    interped_obs = np.interp(simx, obsx[sel], obsy[sel],
                             left=np.nan, right=np.nan)
    return float(np.sum(np.abs(interped_obs - simy)))


def residual_spectrum(freq_obs, int_obs, freq_model, int_model):
    """obs minus the composite model interpolated onto the observed grid —
    the compute core of the reference's plot_residuals (reference
    :3573-3638, which re-renders every stored simulation onto the
    observation's frequency points and subtracts; here the caller passes
    the composite, e.g. Workbench.sum_stored()). Returns (freq_obs,
    residual)."""
    freq_obs = np.asarray(freq_obs, dtype=np.float64)
    model = np.interp(freq_obs, np.asarray(freq_model),
                      np.asarray(int_model), left=0.0, right=0.0)
    return freq_obs, np.asarray(int_obs, dtype=np.float64) - model


def find_limits(freq_arr, spacing_tolerance: float = 100.0):
    """Detect the contiguous coverage chunks of a spectrum: (ll, ul) lists
    of chunk boundaries wherever consecutive channels are more than
    spacing_tolerance x the typical spacing apart (reference
    find_limits, :3498-3530; the typical spacing is the reference's exact
    |f[0]-f[10]|/10 estimate). autoset-style padding is the caller's
    choice (the reference's autoset_limits subtracts/adds 25 MHz)."""
    freq_arr = np.asarray(freq_arr, dtype=np.float64)
    if freq_arr.size == 0:
        raise ValueError("the input array has no data")
    spacing = abs(freq_arr[0] - freq_arr[10]) / 10
    gaps = np.flatnonzero(np.abs(np.diff(freq_arr)) > spacing_tolerance * spacing)
    ll = [freq_arr[0], *freq_arr[gaps + 1]]
    ul = [*freq_arr[gaps], freq_arr[-1]]
    return ll, ul
