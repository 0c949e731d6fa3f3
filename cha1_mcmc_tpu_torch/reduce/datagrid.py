"""Datagrid construction: select channels covering a molecule's lines.

Host-side float64 equivalent of the reference's read_file + init_setup
(reference inference.py:256-342): simulate the molecule's stick spectrum at
fixed fiducial parameters, then for every sufficiently-bright transition
select the observed channels within +-1.5 km/s of the aligned velocity,
estimate their noise, optionally reject windows containing interloping
lines, and assemble the sparse 4-tuple datagrid
(freqs, ints, yerrs, covered_transition_indices).

NumPy port of cha1_mcmc_tpu/reduce/datagrid.py, verbatim in behaviour.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from cha1_mcmc_tpu_torch.constants import CKM, GRAY, RESET
from cha1_mcmc_tpu_torch.catalogs.spcat import Catalog
from cha1_mcmc_tpu_torch.models.forward import simulate_sticks_host
from cha1_mcmc_tpu_torch.reduce.noise import calc_noise_std, calc_noise_std_gotham

__all__ = [
    "Datagrid",
    "read_spectrum",
    "read_spectrum_gotham",
    "reduce_spectrum",
    "load_datagrid",
    "save_datagrid",
]

# Fiducial simulation parameters used only for covered-line selection
# (reference inference.py:324-325: C=3.4e12, dV=0.89, T=7.0).
_FIDUCIAL = dict(C=3.4e12, dV=0.89, T=7.0)


@dataclasses.dataclass(frozen=True)
class Datagrid:
    """Sparse reduced spectrum (reference inference.py:337 4-tuple)."""

    freqs: np.ndarray          # (C,) MHz
    ints: np.ndarray           # (C,) K
    yerrs: np.ndarray          # (C,) K
    covered_trans: np.ndarray  # (L,) indices into the trimmed line list

    def as_object_array(self) -> np.ndarray:
        return np.array(
            [self.freqs, self.ints, self.yerrs, self.covered_trans], dtype=object)


def _select_channels(data, restfreqs, int_sim, *, vel_of, vel_window,
                     noise_fn, interloper_sigma, GHz, block_interlopers,
                     verbose, peak_threshold, calibration_frac) -> Datagrid:
    """Shared per-transition channel-selection walk (reference
    inference.py:256-303 and scripts/MCMC/TMC1_four_component.py:69-116 —
    the two variants differ only in the velocity conversion, the window
    criterion, the noise estimator, and the interloper threshold, all
    injected here so the selection loop exists once).

    Quirks kept: overlapping windows overwrite; zero-frequency channels
    are dropped at the end (reference :298-301); yerr =
    sqrt(noise_std^2 + (calibration_frac * intensity)^2) (reference :290).
    """
    freqs = np.asarray(data[0], dtype=np.float64)
    intensity = np.asarray(data[1], dtype=np.float64)
    if GHz:
        freqs = freqs * 1000.0

    relevant_freqs = np.zeros(freqs.shape)
    relevant_intensity = np.zeros(intensity.shape)
    relevant_yerrs = np.zeros(freqs.shape)
    covered_trans = []

    def log(msg):
        if verbose:
            print(f"{GRAY}{msg}{RESET}")

    int_sim = np.asarray(int_sim, dtype=np.float64)
    peak = np.max(int_sim)
    for i, rf in enumerate(np.asarray(restfreqs, dtype=np.float64)):
        if int_sim[i] > peak_threshold * peak:
            vel = vel_of(rf, freqs)
            locs = np.where((vel < vel_window[1]) & (vel > vel_window[0]))
            if locs[0].size != 0:
                noise_mean, noise_std = noise_fn(intensity[locs])
                if block_interlopers and (np.max(intensity[locs]) > interloper_sigma * noise_std):
                    log(f"{rf:10.4f} MHz  |  Interloping line detected.")
                else:
                    covered_trans.append(i)
                    log(f"{rf:10.4f} MHz  |  Line found.")
                    relevant_freqs[locs] = freqs[locs]
                    relevant_intensity[locs] = intensity[locs]
                    relevant_yerrs[locs] = np.sqrt(
                        noise_std ** 2 + (intensity[locs] * calibration_frac) ** 2)
            else:
                log(f"{rf:10.4f} MHz  |  No data.")

    mask = relevant_freqs > 0
    return Datagrid(
        freqs=relevant_freqs[mask],
        ints=relevant_intensity[mask],
        yerrs=relevant_yerrs[mask],
        covered_trans=np.array(covered_trans, dtype=int),
    )


def read_spectrum(data, restfreqs, int_sim, *, aligned_velocity, shift=None,
                  GHz=False, block_interlopers=True, verbose=True,
                  peak_threshold: float = 0.05, velocity_halfwidth: float = 1.5,
                  interloper_sigma: float = 3.5, calibration_frac: float = 0.1) -> Datagrid:
    """Select covered channels from an observed spectrum.

    `data` is a (2, N) array [freqs_MHz, intensity]. Semantics per reference
    read_file (reference inference.py:256-303), including:
      * a transition participates if its simulated intensity exceeds 5% of
        the simulation's peak (reference :272-273);
      * windows are channels with velocity within +-1.5 km/s of the aligned
        velocity (reference :274-275);
      * a window whose peak exceeds 3.5x its clipped noise is blocked as an
        interloper (reference :279);
      * yerr = sqrt(noise_std^2 + (0.1 * intensity)^2) (reference :290);
      * overlapping windows overwrite; zero-frequency channels are dropped
        at the end (reference :298-301).
    """
    return _select_channels(
        data, restfreqs, int_sim,
        vel_of=lambda rf, freqs: ((rf - freqs) / rf * CKM
                                  + (shift if shift else aligned_velocity)),
        vel_window=(aligned_velocity - velocity_halfwidth,
                    aligned_velocity + velocity_halfwidth),
        noise_fn=calc_noise_std, interloper_sigma=interloper_sigma,
        GHz=GHz, block_interlopers=block_interlopers, verbose=verbose,
        peak_threshold=peak_threshold, calibration_frac=calibration_frac)


def read_spectrum_gotham(data, restfreqs, int_sim, *, shift: float = 0.0,
                         GHz=False, block_interlopers=True, verbose=True,
                         peak_threshold: float = 0.05,
                         vel_window=(5.3, 6.3),
                         interloper_sigma: float = 6.0,
                         calibration_frac: float = 0.1) -> Datagrid:
    """GOTHAM-variant channel selection (reference
    scripts/MCMC/TMC1_four_component.py:69-116).

    Differences from the DSN variant reproduced exactly:
      * fixed velocity window (5.3, 6.3) km/s rather than +-1.5 km/s around
        an aligned velocity (reference :88);
      * the frequency->velocity conversion uses c = 300000 km/s rather than
        ckm = 2.998e5 (reference :87);
      * interlopers are blocked at 6 sigma (reference :92);
      * the 3-pass +-10-channel noise estimator (reference :29-66).
    """
    return _select_channels(
        data, restfreqs, int_sim,
        vel_of=lambda rf, freqs: (rf - freqs) / rf * 300000.0 + shift,
        vel_window=vel_window,
        noise_fn=calc_noise_std_gotham, interloper_sigma=interloper_sigma,
        GHz=GHz, block_interlopers=block_interlopers, verbose=verbose,
        peak_threshold=peak_threshold, calibration_frac=calibration_frac)


def reduce_spectrum(catalog: Catalog, data_path: str, *, ll: float, ul: float,
                    aligned_velocity: float, dish_size: float, source_size: float,
                    block_interlopers: bool = True, verbose: bool = True) -> Datagrid:
    """Full reduction: fiducial stick sim + channel selection
    (reference init_setup, inference.py:305-342)."""
    data = np.load(data_path, allow_pickle=True)
    freq_sim, int_sim, _ = simulate_sticks_host(
        catalog, C=[_FIDUCIAL["C"]], dV=[_FIDUCIAL["dV"]], T=[_FIDUCIAL["T"]],
        ll=[ll], ul=[ul], source_size=source_size, dish_size=dish_size)
    return read_spectrum(
        data, freq_sim, int_sim, aligned_velocity=aligned_velocity,
        block_interlopers=block_interlopers, verbose=verbose)


def save_datagrid(path: str, grid: Datagrid) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, grid.as_object_array(), allow_pickle=True)


def load_datagrid(path: str) -> Datagrid:
    arr = np.load(path, allow_pickle=True)
    return Datagrid(
        freqs=np.asarray(arr[0], dtype=np.float64),
        ints=np.asarray(arr[1], dtype=np.float64),
        yerrs=np.asarray(arr[2], dtype=np.float64),
        covered_trans=np.asarray(arr[3], dtype=int),
    )
