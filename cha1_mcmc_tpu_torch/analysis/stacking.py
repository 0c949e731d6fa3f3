"""Velocity stacking and matched filtering.

These are the detection workhorses for weak-signal searches (GOTHAM-style):
stack the observed spectrum in velocity space around every simulated line,
weighted by predicted line strength and local noise, then cross-correlate
the stack with the equivalently-stacked simulation.

Algorithms follow the reference's interactive tool exactly (reference
spectral_simulator/simulate_lte.py): get_rms :5750-5766, find_nearest
:4460-4472, find_sim_peaks :4354-4412, ObsChunk :8040-8120,
velocity_stack :4476-5282 (compute core, minus plotting), matched_filter
:5283-5305.

A NumPy copy of cha1_mcmc_tpu/analysis/stacking.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import signal

from cha1_mcmc_tpu_torch.constants import CKM

__all__ = [
    "get_rms",
    "find_nearest",
    "find_sim_peaks",
    "ObsChunk",
    "velocity_stack",
    "StackResult",
    "matched_filter",
    "find_vel_peaks",
    "cut_spectra",
]


def get_rms(intensity: np.ndarray) -> float:
    """Iteratively 3-sigma-clipped root-mean-square
    (reference simulate_lte.py:5750-5766)."""
    tmp = np.copy(np.asarray(intensity, dtype=np.float64))
    x = np.nanmax(tmp)
    rms = np.sqrt(np.nanmean(np.square(tmp)))
    while x > 3 * rms:
        tmp[tmp > 3 * rms] = np.nan
        rms = np.sqrt(np.nanmean(np.square(tmp)))
        x = np.nanmax(tmp)
    return float(rms)


def find_nearest(array: np.ndarray, value: float) -> int:
    """Index of the closest element in a sorted array
    (reference simulate_lte.py:4460-4472)."""
    idx = int(np.searchsorted(array, value, side="left"))
    if idx > 0 and (idx == len(array)
                    or math.fabs(value - array[idx - 1]) < math.fabs(value - array[idx])):
        return idx - 1
    return idx


def find_sim_peaks(frequency: np.ndarray, intensity: np.ndarray, min_sep: float,
                   res: float, ckm: float = CKM) -> np.ndarray:
    """Indices of simulated peaks at least min_sep (km/s) apart
    (reference simulate_lte.py:4354-4412).

    Resamples onto a uniform velocity grid (resolution res*ckm/max_f, where
    `res` is the frequency resolution in MHz), finds peaks with
    scipy.signal.find_peaks at the equivalent channel separation, and maps
    back to indices in the original array.
    """
    frequency = np.asarray(frequency, dtype=np.float64)
    intensity = np.asarray(intensity, dtype=np.float64)
    max_f, min_f = np.amax(frequency), np.amin(frequency)
    cfreq = (max_f + min_f) / 2
    v_res = res * ckm / max_f
    v_span = (max_f - min_f) * ckm / cfreq
    nchans = int(v_span / v_res)
    v_samp = np.linspace(-v_span / 2, v_span / 2, num=nchans, endpoint=True)
    f_samp = cfreq + v_samp * cfreq / ckm
    int_samp = np.interp(f_samp, frequency, intensity, left=0.0, right=0.0)
    chan_sep = min_sep / v_res
    indices_samp = signal.find_peaks(int_samp, distance=chan_sep)
    peak_freqs = f_samp[indices_samp[0]]
    return np.asarray([find_nearest(frequency, x) for x in peak_freqs], dtype=int)


@dataclasses.dataclass
class ObsChunk:
    """One observed window around a line, in velocity space
    (reference simulate_lte.py:8040-8120)."""

    frequency: np.ndarray
    intensity: np.ndarray
    cfreq: float
    peak_int: float
    tag: int
    freq_sim: np.ndarray | None = None
    int_sim: np.ndarray | None = None
    ckm: float = CKM

    def __post_init__(self):
        self.flag = len(self.frequency) < 2
        self.weight = None
        if self.flag:
            self.velocity = self.sim_velocity = None
            self.rms = None
            return
        self.velocity = (self.frequency - self.cfreq) * self.ckm / self.cfreq
        self.sim_velocity = ((self.freq_sim - self.cfreq) * self.ckm / self.cfreq
                             if self.freq_sim is not None else None)
        self.set_rms()

    def set_rms(self):
        self.rms = get_rms(self.intensity)


@dataclasses.dataclass
class StackResult:
    velocity: np.ndarray      # (V,) km/s
    snr: np.ndarray           # (V,) stacked observation in SNR units
    sim_snr: np.ndarray       # (V,) stacked simulation, same normalization
    chunks: list              # the ObsChunks used (flagged ones included)
    rms: float                # stack rms used for the SNR normalization


def velocity_stack(
    freq_obs, int_obs, freq_sim, int_sim, dV: float, res: float, *,
    drops=(), flag_lines: bool = False, flag_int_thresh: float = 5.0,
    blank_lines: bool = False, blank_keep_range=None,
    vel_width: float = 40.0, v_res: float = 0.1,
    mf: bool = False, mf_vmult: float = 5.0, ckm: float = CKM,
    use_sum: bool = False, freq_sum=None, int_sum=None,
    cat_frequency=None, vlsr: float = 0.0, sum_width_extend: float = 3.0,
) -> StackResult:
    """SNR-weighted velocity stack (reference simulate_lte.py:4476-4860,
    compute core).

    Steps, exactly per the reference:
      1. peaks of the simulation at >= dV separation define line centers;
      2. windows of +-vel_width*dV (times mf_vmult if feeding a matched
         filter) are cut around each center;
      3. windows with no data within 0.5 dV of the center, empty windows,
         and dropped tags are flagged; optionally interloper channels are
         NaN-flagged (> flag_int_thresh * window rms) or blanked outside a
         keep range;
      4. each window is weighted by (peak_int / max_peak) / rms^2;
      5. windows are resampled onto a uniform velocity grid and averaged
         with per-channel sum(rms^2) normalization;
      6. 5 edge channels are dropped and the stack is normalized to SNR by
         its own clipped rms.

    use_sum=True stacks over a *summed* multi-species simulation
    (freq_sum, int_sum — e.g. Workbench.sum_stored) instead of the single
    current one (reference simulate_lte.py:4497-4533): peak centers come
    from the sum at dV*sum_width_extend separation, each is snapped to the
    nearest catalog frequency (`cat_frequency`, the loaded molecule's full
    catalog; the vlsr back-shift uses the *pre-snap* peak frequency — a
    reference quirk kept deliberately), and the weights use the integrated
    flux of the sum within ±dV*sum_width_extend/2 rather than the peak
    height. Simulation windows are then cut from the sum as well.
    """
    freq_local = np.copy(np.asarray(freq_obs, dtype=np.float64))
    int_local = np.copy(np.asarray(int_obs, dtype=np.float64))

    if use_sum:
        if freq_sum is None or int_sum is None or cat_frequency is None:
            raise ValueError("use_sum=True requires freq_sum, int_sum and "
                             "cat_frequency")
        freq_sim = np.asarray(freq_sum, dtype=np.float64)
        int_sim = np.asarray(int_sum, dtype=np.float64)
        cat_frequency = np.asarray(cat_frequency, dtype=np.float64)
        peak_indices = find_sim_peaks(freq_sim, int_sim,
                                      dV * sum_width_extend, res, ckm=ckm)
        peak_freqs = np.copy(freq_sim[peak_indices])
        for x in range(len(peak_freqs)):
            # Snap each sum-peak to the nearest catalog line; the back-
            # shift deliberately uses the pre-snap frequency (reference
            # simulate_lte.py:4509-4513).
            freq_idx = find_nearest(cat_frequency,
                                    peak_freqs[x] + vlsr * peak_freqs[x] / ckm)
            peak_freqs[x] = cat_frequency[freq_idx] - vlsr * peak_freqs[x] / ckm
        peak_ints = []
        for x in peak_freqs:
            # Integrated flux of the sum within +-freq_width/2
            # (reference simulate_lte.py:4521-4533).
            freq_width = dV * sum_width_extend * x / ckm
            tmp_ll = find_nearest(freq_sim, x - freq_width / 2)
            tmp_ul = find_nearest(freq_sim, x + freq_width / 2)
            peak_ints.append(np.nansum(int_sim[tmp_ll:tmp_ul]))
        peak_ints = np.asarray(peak_ints)
    else:
        freq_sim = np.asarray(freq_sim, dtype=np.float64)
        int_sim = np.asarray(int_sim, dtype=np.float64)
        peak_indices = find_sim_peaks(freq_sim, int_sim, dV, res, ckm=ckm)
        peak_freqs = freq_sim[peak_indices]
        peak_ints = int_sim[peak_indices]

    chunks = []
    for x in range(len(peak_freqs)):
        cfreq = peak_freqs[x]
        width_mult = mf_vmult if mf else 1.0
        freq_width = vel_width * dV * cfreq / ckm * width_mult
        l_idx = find_nearest(freq_local, cfreq - freq_width)
        u_idx = find_nearest(freq_local, cfreq + freq_width)
        sim_l = find_nearest(freq_sim, cfreq - freq_width)
        sim_u = find_nearest(freq_sim, cfreq + freq_width)
        chunks.append(ObsChunk(
            np.copy(freq_local[l_idx:u_idx]), np.copy(int_local[l_idx:u_idx]),
            cfreq, peak_ints[x], x,
            freq_sim=np.copy(freq_sim[sim_l:sim_u]),
            int_sim=np.copy(int_sim[sim_l:sim_u]), ckm=ckm))

    for obs in chunks:
        if obs.flag:
            continue
        if np.amin(np.abs(obs.frequency - obs.cfreq)) > 0.5 * dV:
            obs.flag = True
            continue
        if len(obs.frequency) == 0:
            obs.flag = True
            continue
        if obs.tag in drops:
            obs.flag = True
            continue
        # Independent ifs, as in the reference (simulate_lte.py:4649-4656):
        # despite its own warning that flag_lines supersedes blank_lines,
        # the reference applies both when both are set.
        if flag_lines:
            obs.intensity[obs.intensity > flag_int_thresh * obs.rms] = np.nan
        if blank_lines:
            if blank_keep_range is None:
                obs.intensity[np.abs(obs.intensity) > flag_int_thresh * obs.rms] = np.nan
            else:
                l_freq = obs.cfreq + blank_keep_range[0] * obs.cfreq / ckm
                u_freq = obs.cfreq + blank_keep_range[1] * obs.cfreq / ckm
                l_idx = find_nearest(obs.frequency, l_freq)
                u_idx = find_nearest(obs.frequency, u_freq)
                l_s = find_nearest(obs.freq_sim, l_freq)
                u_s = find_nearest(obs.freq_sim, u_freq)
                keep = np.copy(obs.intensity[l_idx:u_idx])
                keep_sim = np.copy(obs.int_sim[l_s:u_s])
                obs.intensity[l_idx:u_idx] = np.nan
                obs.int_sim[l_s:u_s] = np.nan
                obs.set_rms()
                obs.intensity[np.abs(obs.intensity) > flag_int_thresh * obs.rms] = np.nan
                obs.int_sim[np.abs(obs.int_sim) > 0.0] = np.nan
                obs.intensity[l_idx:u_idx] = keep
                obs.int_sim[l_s:u_s] = keep_sim

    # Weights: predicted line strength normalized to the brightest line,
    # divided by window rms^2 (reference :4747-4760).
    max_int = max(peak_ints)
    for obs in chunks:
        if not obs.flag:
            obs.weight = (obs.peak_int / max_int) / obs.rms ** 2
            obs.int_weighted = obs.intensity * obs.weight
            obs.int_sim_weighted = obs.int_sim * obs.weight

    width_mult = mf_vmult if mf else 1.0
    l_vel = -vel_width * dV * width_mult
    u_vel = vel_width * dV * width_mult
    velocity_avg = np.arange(l_vel, u_vel, v_res)

    interped_ints, interped_rms, interped_sim = [], [], []
    for obs in chunks:
        if obs.flag:
            continue
        interped_ints.append(np.interp(velocity_avg, obs.velocity,
                                       obs.int_weighted, left=np.nan, right=np.nan))
        interped_sim.append(np.interp(velocity_avg, obs.sim_velocity,
                                      obs.int_sim_weighted, left=np.nan, right=np.nan))
        interped_rms.append(obs.rms)
    if not interped_ints:
        raise ValueError("No unflagged line windows to stack.")
    interped_ints = np.asarray(interped_ints)
    interped_sim = np.asarray(interped_sim)
    interped_rms = np.asarray(interped_rms)

    # Per-channel sum of rms^2 over the windows contributing there
    # (reference :4800-4825).
    contributes = ~np.isnan(interped_ints)
    rms_array = (contributes * interped_rms[:, None] ** 2).sum(axis=0)

    # Reference quirk kept (simulate_lte.py:4834-4836): a velocity channel
    # with no contributing windows divides 0/0 and stacks as NaN. The
    # errstate scope only silences the RuntimeWarning; the NaN propagates
    # exactly as in the reference (whose edge-channel drop below usually,
    # but not always, removes them).
    with np.errstate(divide="ignore", invalid="ignore"):
        int_avg = np.nansum(interped_ints, axis=0) / rms_array
        int_sim_avg = np.nansum(interped_sim, axis=0) / rms_array

    int_avg = int_avg[5:-5]
    int_sim_avg = int_sim_avg[5:-5]
    velocity_avg = velocity_avg[5:-5]

    rms_tmp = get_rms(int_avg)
    return StackResult(velocity=velocity_avg, snr=int_avg / rms_tmp,
                       sim_snr=int_sim_avg / rms_tmp, chunks=chunks, rms=rms_tmp)


def find_vel_peaks(velocity, intensity, fwhm: float, sigma: float = 3.0,
                   width_tweak: float = 1.0):
    """Peaks in a velocity-space spectrum (e.g. a stack) above sigma * rms
    (reference simulate_lte.py:4249-4330 find_vel_peaks; same selection as
    find_peaks but with channel widths taken directly in velocity units)."""
    from scipy import signal as _signal

    intensity = np.asarray(intensity, dtype=np.float64)
    velocity = np.asarray(velocity, dtype=np.float64)
    v_res = abs(velocity[1] - velocity[0]) if len(velocity) > 1 else 1.0
    fwhm_chan = max(fwhm / v_res, 1.0)
    rms = get_rms(intensity)
    idx, _ = _signal.find_peaks(
        intensity, height=sigma * rms,
        distance=max(int(fwhm_chan * 0.5 * width_tweak), 1))
    return idx, rms


def cut_spectra(freq_obs, int_obs, freq_sim, dV: float, n_fwhm: float = 30.0):
    """Extract observed windows of +-n_fwhm linewidths around each simulated
    stick (reference simulate_lte.py:5307-5360 cut_spectra): for each stick
    with an observed channel within 1 MHz, take the local resolution and cut
    n_fwhm * dV on each side. Returns (freq_cut, int_cut) arrays."""
    freq_obs = np.asarray(freq_obs, dtype=np.float64)
    int_obs = np.asarray(int_obs, dtype=np.float64)
    freq_cut, int_cut = [], []
    for x in np.asarray(freq_sim, dtype=np.float64):
        i = int(np.abs(freq_obs - x).argmin())
        if abs(freq_obs[i] - x) < 1:
            # Local resolution from 10 channels away; step backwards when
            # the stick sits near the end of the spectrum.
            j = i + 10 if i + 10 < len(freq_obs) else i - 10
            if j < 0 or j == i:
                continue  # spectrum too short to estimate a resolution
            res_tmp = abs((freq_obs[i] - freq_obs[j]) / abs(j - i))
            vel_res = abs(res_tmp * CKM / freq_obs[i])
            if vel_res == 0:
                continue
            pts = int(n_fwhm * dV / vel_res)
            lo, hi = max(0, i - pts), min(len(freq_obs), i + pts)
            freq_cut.extend(freq_obs[lo:hi])
            int_cut.extend(int_obs[lo:hi])
    return np.asarray(freq_cut), np.asarray(int_cut)


def matched_filter(x_obs, y_obs, y_filter, filter_range=(-2, 2)) -> np.ndarray:
    """SNR-normalized matched filter (reference simulate_lte.py:5283-5305).

    Cross-correlates the stacked observation with the central
    `filter_range` (km/s) channels of the stacked simulation; the response
    is normalized by its own rms with the central 40-60% blanked.
    """
    x_obs = np.asarray(x_obs)
    y_obs = np.asarray(y_obs, dtype=np.float64)
    y_filter = np.asarray(y_filter, dtype=np.float64)
    l_idx = find_nearest(x_obs, filter_range[0])
    u_idx = find_nearest(x_obs, filter_range[1])
    int_mf = np.correlate(y_obs, y_filter[l_idx:u_idx], mode="valid")
    tmp = np.copy(int_mf)
    n = len(int_mf)
    tmp[int(0.40 * n):int(0.60 * n)] = np.nan
    return int_mf / get_rms(tmp)
