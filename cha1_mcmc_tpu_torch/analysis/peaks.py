"""Peak finding in observed spectra.

Equivalent of the reference's find_peaks (reference
spectral_simulator/simulate_lte.py:4207-4245): peaks above sigma * clipped
rms, separated by at least half a linewidth. The reference uses
peakutils.indexes (threshold as a fraction of the normalized span +
min_dist); scipy.signal.find_peaks with height/distance implements the same
selection.

A NumPy copy of cha1_mcmc_tpu/analysis/peaks.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

from cha1_mcmc_tpu_torch.constants import CKM
from cha1_mcmc_tpu_torch.analysis.stacking import get_rms

__all__ = ["find_peaks", "find_obs_peaks", "find_obs_brights"]


def find_peaks(frequency, intensity, fwhm: float, sigma: float = 3.0,
               width_tweak: float = 1.0):
    """Indices of peaks above sigma * rms, plus the rms.

    fwhm is the linewidth in km/s; peaks must be separated by at least half
    the linewidth in channels (reference :4242 min_dist=fwhm_chan*0.5).
    """
    frequency = np.asarray(frequency, dtype=np.float64)
    intensity = np.asarray(intensity, dtype=np.float64)
    fwhm_mhz = fwhm * np.median(frequency) / CKM
    dmhz_chan = abs(frequency[-1] - frequency[0]) / len(frequency)
    fwhm_chan = fwhm_mhz / dmhz_chan
    rms = get_rms(intensity)
    peak_indices, _ = signal.find_peaks(
        intensity, height=sigma * rms, distance=max(int(fwhm_chan * 0.5), 1))
    return peak_indices, rms


def _chunk_windows(n_obs: int, end_chan, chanstep: int):
    """The reference's chunk walk (simulate_lte.py:7374-7405): windows
    [llpt, llpt+chanstep) advancing by chanstep until llpt or ulpt passes
    len(obs) (or end_chan). start_chan is accepted by the reference but
    never used — reproduced by not taking it at all."""
    llpt, ulpt = 0, chanstep
    stop = n_obs if end_chan is None else end_chan
    while True:
        yield llpt, ulpt
        llpt += chanstep
        ulpt += chanstep
        if llpt > stop or ulpt > stop:
            return


def find_obs_peaks(freq_obs, int_obs, *, sigma: float = 5.0, end_chan=None,
                   chanstep: int = 500, fwhm: float = 0.3):
    """Chunked quick line scan of an observation (reference
    simulate_lte.py:7363-7430): find_peaks over successive `chanstep`
    windows with a per-window clipped rms. Returns (line_freqs, line_ints,
    rms_levels) as lists, one entry per peak."""
    freq_obs = np.asarray(freq_obs)
    int_obs = np.asarray(int_obs)
    line_freqs, line_ints, rms_level = [], [], []
    for llpt, ulpt in _chunk_windows(len(freq_obs), end_chan, chanstep):
        idx, tmp_rms = find_peaks(freq_obs[llpt:ulpt], int_obs[llpt:ulpt],
                                  fwhm, sigma=sigma)
        for x in idx:
            line_freqs.append(freq_obs[x + llpt])
            line_ints.append(int_obs[x + llpt])
            rms_level.append(tmp_rms)
    return line_freqs, line_ints, rms_level


def find_obs_brights(freq_obs, int_obs, *, sigma: float = 5.0, end_chan=None,
                     chanstep: int = 500):
    """Chunked bright-channel scan (reference simulate_lte.py:7433-7500).
    Reference quirk reproduced: the threshold is hardcoded at 5x the
    window rms — the sigma argument is accepted but ignored, exactly as in
    the original. Returns (bright_freqs, bright_ints)."""
    freq_obs = np.asarray(freq_obs)
    int_obs = np.asarray(int_obs)
    bright_freq, bright_int = [], []
    for llpt, ulpt in _chunk_windows(len(freq_obs), end_chan, chanstep):
        tmp_rms = get_rms(int_obs[llpt:ulpt])
        for chan in np.where(int_obs[llpt:ulpt] > 5 * tmp_rms)[0]:
            bright_freq.append(freq_obs[chan + llpt])
            bright_int.append(int_obs[chan + llpt])
    return bright_freq, bright_int
