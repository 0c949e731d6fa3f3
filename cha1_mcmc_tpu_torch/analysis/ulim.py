"""Upper-limit column-density tooling.

Non-interactive equivalents of the vendored tool's upper-limit commands
(reference spectral_simulator/simulate_lte.py): get_obs_rms :5772,
get_sim_peak :5783, set_ulim_c :7183, find_best_ulim :7203,
autoset_ulim_c :7285. The reference mutates the session's global C; here
the functions take spectra in and return the scaled column density, and
the Workbench wraps them with the mutating `ulim`/`auto_ulim` methods.

A NumPy copy of cha1_mcmc_tpu/analysis/ulim.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np

from cha1_mcmc_tpu_torch.constants import CKM
from cha1_mcmc_tpu_torch.analysis.stacking import get_rms, find_nearest, find_sim_peaks

__all__ = ["get_obs_rms", "get_sim_peak", "upper_limit_column",
           "find_best_ulim_lines"]


def get_obs_rms(freq_obs, int_obs, ll: float, ul: float) -> float:
    """Clipped rms of the observation over [ll, ul]
    (reference simulate_lte.py:5772-5780)."""
    freq_obs = np.asarray(freq_obs)
    l_idx = find_nearest(freq_obs, ll)
    u_idx = find_nearest(freq_obs, ul)
    return get_rms(np.asarray(int_obs)[l_idx:u_idx])


def get_sim_peak(freq_sim, int_sim, ll: float, ul: float,
                 absorption: bool = False) -> float:
    """Peak simulated intensity over [ll, ul]
    (reference simulate_lte.py:5783-5807, incl. the both-indices-zero
    fallback to the first channel)."""
    freq_sim = np.asarray(freq_sim)
    int_sim = np.asarray(int_sim)
    l_idx = find_nearest(freq_sim, ll)
    u_idx = find_nearest(freq_sim, ul)
    tmp = int_sim[0] if (l_idx == 0 and u_idx == 0) else int_sim[l_idx:u_idx]
    return float(np.abs(np.amin(tmp)) if absorption else np.amax(tmp))


def upper_limit_column(C: float, freq_sim, int_sim, freq_obs, int_obs,
                       ll: float, ul: float, *, level: float | None = None,
                       absorption: bool = False) -> float:
    """Column density scaled so the simulated peak in [ll, ul] matches the
    observed rms (or an explicit `level`) — the set_ulim_c rescale
    (reference simulate_lte.py:7183-7199). LTE intensities are linear in C
    in the optically thin limit, so one rescale sets the 1-sigma upper
    limit; the reference's repeated set_ulim_c calls converge this when
    lines are marginally thick (iterate with the re-simulated spectrum)."""
    target = (get_obs_rms(freq_obs, int_obs, ll, ul) if level is None
              else level)
    return C * target / get_sim_peak(freq_sim, int_sim, ll, ul,
                                     absorption=absorption)


def find_best_ulim_lines(freq_sim, int_sim, freq_obs, int_obs, dV: float,
                         res: float, *, sep: float | None = None, n: int = 1,
                         search_n: int = 100, rms_spread: float = 10.0):
    """The n simulated lines with the highest expected SNR against the
    local observed rms — the lines that set the most constraining upper
    limit (reference simulate_lte.py:7203-7283).

    Peaks at least `sep` km/s apart (default dV) are ranked by intensity,
    the local rms is measured +-rms_spread*FWHM around each of the top
    n*search_n, and the list is re-ranked by SNR. Returns (freqs, snrs)
    of the top n.
    """
    freq_sim = np.asarray(freq_sim, dtype=np.float64)
    int_sim = np.asarray(int_sim, dtype=np.float64)
    sep = dV if sep is None else sep
    peak_idx = find_sim_peaks(freq_sim, np.absolute(int_sim), sep, res)
    peak_ints = np.abs(int_sim[peak_idx])
    peak_freqs = freq_sim[peak_idx]
    order = peak_ints.argsort()[::-1]
    peak_ints, peak_freqs = peak_ints[order], peak_freqs[order]

    search_range = min(len(peak_freqs), n * search_n)
    snr = np.zeros(search_range)
    for i in range(search_range):
        dV_f = dV * peak_freqs[i] / CKM
        rms = get_obs_rms(freq_obs, int_obs,
                          peak_freqs[i] - rms_spread * dV_f,
                          peak_freqs[i] + rms_spread * dV_f)
        snr[i] = 0.0 if np.isnan(rms) else peak_ints[i] / rms

    best = snr.argsort()[::-1][:n]
    return peak_freqs[:search_range][best], snr[best]
