"""Iterative sigma-clipped RMS noise estimation.

Reproduces reference calc_noise_std (reference inference.py:108-124)
exactly, including its quirks, which matter for golden-file parity:

  * the outlier threshold is computed from the *raw* spectrum's mean/std
    once, outside the clipping loop (dummy_mean/dummy_std are never
    updated), so the three passes mask the same channels each time;
  * the mask window is asymmetric: [chan - 3, chan + 3) — three channels
    before, two after, plus the channel itself.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calc_noise_std", "calc_noise_std_gotham"]


def calc_noise_std(intensity: np.ndarray, threshold: float = 3.5,
                   mask_radius: int = 3) -> tuple[float, float]:
    """Return (noise_mean, noise_std) of a spectrum with lines masked out."""
    dummy_ints = np.copy(intensity)
    noise = np.copy(intensity).astype(np.float64)
    dummy_mean = np.nanmean(dummy_ints)
    dummy_std = np.nanstd(dummy_ints)

    noise_mean = dummy_mean
    noise_std = dummy_std
    for _ in range(3):
        for chan in np.where(dummy_ints - dummy_mean < (-dummy_std * threshold))[0]:
            noise[max(0, chan - mask_radius): chan + mask_radius] = np.nan
        for chan in np.where(dummy_ints - dummy_mean > (dummy_std * threshold))[0]:
            noise[max(0, chan - mask_radius): chan + mask_radius] = np.nan
        noise_mean = np.nanmean(noise)
        noise_std = np.nanstd(np.real(noise))

    return float(noise_mean), float(noise_std)


def calc_noise_std_gotham(intensity: np.ndarray, threshold: float = 3.5) -> tuple[float, float]:
    """GOTHAM-variant noise estimator (reference
    scripts/MCMC/TMC1_four_component.py:29-66).

    Three unrolled passes masking +-10 channels around outliers of the *raw*
    spectrum; passes 2-3 re-threshold against the updated noise statistics.
    Quirk reproduced: the mask uses the raw slice `noise[chan-10:chan+10]`,
    so an outlier within 10 channels of the start produces a negative start
    index, which wraps and masks *nothing* (unlike the DSN variant's
    max(0, ...) clamp, reference inference.py:118).
    """
    dummy_ints = np.copy(intensity)
    noise = np.copy(intensity).astype(np.float64)

    def mask_pass(center_mean, center_std):
        for chan in np.where(dummy_ints - center_mean < (-center_std * threshold))[0]:
            noise[chan - 10: chan + 10] = np.nan
        for chan in np.where(dummy_ints - center_mean > (center_std * threshold))[0]:
            noise[chan - 10: chan + 10] = np.nan
        return np.nanmean(noise), np.nanstd(np.real(noise))

    noise_mean, noise_std = mask_pass(np.nanmean(dummy_ints), np.nanstd(dummy_ints))
    noise_mean, noise_std = mask_pass(noise_mean, noise_std)
    noise_mean, noise_std = mask_pass(noise_mean, noise_std)
    return float(noise_mean), float(noise_std)
