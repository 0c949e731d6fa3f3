"""Observed-spectrum format converters.

Ports of the DSN_pipeline notebook's converters (reference
notebooks/DSN_pipeline.ipynb cells 0-11):
  * CASSIS `.lis` ASCII (3 header lines; column 0 frequency in MHz,
    column 4 intensity) -> (2, N) array;
  * velocity-space spectra -> frequency space via nu = nu_rest (1 - v/c).

A NumPy copy of cha1_mcmc_tpu/reduce/converters.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np

from cha1_mcmc_tpu_torch.constants import CKM

__all__ = ["lis_to_array", "ascii_to_array", "velocity_to_frequency", "spec_to_array", "read_obs"]


def lis_to_array(path: str, skip_header: int = 3) -> np.ndarray:
    """Parse a CASSIS .lis file to a (2, N) [freq_MHz, intensity] array."""
    rows = np.genfromtxt(path, skip_header=skip_header)
    return np.vstack([rows[:, 0], rows[:, 4]])


def ascii_to_array(path: str, freq_col: int = 0, int_col: int = 1,
                   skip_header: int = 0) -> np.ndarray:
    """Parse a whitespace-separated frequency-space ASCII spectrum."""
    rows = np.genfromtxt(path, skip_header=skip_header)
    return np.vstack([rows[:, freq_col], rows[:, int_col]])


def velocity_to_frequency(velocities_kms: np.ndarray, rest_freq_mhz: float) -> np.ndarray:
    """nu = nu_rest * (1 - v / c) (reference DSN_pipeline.ipynb cell 9)."""
    return rest_freq_mhz * (1.0 - np.asarray(velocities_kms, dtype=np.float64) / CKM)


def spec_to_array(path: str, rest_freq_mhz: float, *, vel_col: int = 0,
                  int_col: int = 1, skip_header: int = 0) -> np.ndarray:
    """Convert a velocity-space `.spec` file to a (2, N) frequency-space
    array via nu = nu_rest (1 - v/c), sorted by frequency (reference
    DSN_pipeline.ipynb cell 9's per-line converter)."""
    rows = np.genfromtxt(path, skip_header=skip_header)
    freqs = velocity_to_frequency(rows[:, vel_col], rest_freq_mhz)
    order = np.argsort(freqs)
    return np.vstack([freqs[order], rows[order, int_col]])


def read_obs(path: str, rms: float | None = None):
    """Read an observation / laboratory spectrum (MolObs equivalent,
    reference spectral_simulator/classes.py:409-486).

    Detects the casaviewer `.ispec` header (#title block), applying a GHz
    flag from its #xLabel line; sorts by frequency; derives the channel
    resolution (falling back across identical leading channels, default
    0.01 MHz); estimates the rms with the reference's two-pass std quirk
    when not given. Returns (freq_obs, int_obs, res, rms).
    """
    with open(path) as fh:
        obs = fh.read().splitlines()

    GHz = False
    if obs and obs[0].split(":")[0] == "#title":
        # Reference quirk preserved (classes.py:441-454): j is incremented
        # *after* the first non-# line is seen and the delete is obs[:j+1],
        # so the header strip also discards the first TWO data rows.
        i = 0
        j = 0
        while i == 0:
            if obs[j].split(":")[0] == "#xLabel":
                if obs[j].split("[")[1].strip("]\n ") == "GHz":
                    GHz = True
            if obs[j][:1] != "#":
                i = 1
            j += 1
        del obs[: j + 1]

    rows = [ln.split() for ln in obs if ln.strip()]
    freq_obs = np.array([float(r[0]) for r in rows])
    int_obs = np.array([float(r[1]) for r in rows])
    order = freq_obs.argsort()
    freq_obs, int_obs = freq_obs[order], int_obs[order]
    if GHz:
        freq_obs = freq_obs * 1000.0

    res = abs(freq_obs[1] - freq_obs[0])
    if res == 0.0:
        res = abs(freq_obs[2] - freq_obs[1])
    if res == 0.0:
        res = 0.01

    if rms is None:
        # Reference quirk preserved (classes.py:481-483): the second pass
        # takes the std of a *boolean* comparison array.
        rms = np.std(int_obs)
        rms = np.std(int_obs < rms * 4)
    return freq_obs, int_obs, float(res), float(rms)
