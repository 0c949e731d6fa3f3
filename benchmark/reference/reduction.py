"""The reduction of an observed spectrum to the channels the fit uses, in
NumPy: the catalog's stick spectrum at fixed fiducial parameters (Ncol
3.4e12, dV 0.89, Tex 7.0, the stated source and dish), and for every line
brighter than 5% of the brightest in (ll, ul] the channels within ±1.5
km/s of the aligned velocity, each with its noise (a three-pass clipped
RMS of the window, the channels within [-3, +3) of a 3.5-sigma outlier
left out) and yerr = sqrt(noise^2 + (0.1 intensity)^2); a window whose
peak passes 3.5 noise sigma holds an interloper and is left out, and
where windows overlap the later line's values stand. In float64.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.catalog import Catalog

CKM, CM, H, K = 2.998e5, 2.998e8, 6.626e-34, 1.381e-23
FIDUCIAL = (3.4e12, 0.89, 7.0)   # Ncol, dV, Tex
T_CMB = 2.7


def planck(freq_mhz, T, guard=0.0):
    x = H * freq_mhz * 1e6 / K
    return x / (np.exp(x / T) - 1.0 + guard)


def dilution(freq_mhz, source_size, dish_size):
    beam = CM / (freq_mhz * 1e6) * 206265.0 * 1.22 / dish_size
    return source_size ** 2 / (beam ** 2 + source_size ** 2)


def stick_taus(cat: Catalog, Ncol, Tex, dV, sel=slice(None)):
    nu = cat.frequency[sel] * 1e6
    Q = cat.partition(Tex)
    Nl = Ncol * cat.glow[sel] * np.exp(-cat.elower[sel] / (0.695 * Tex)) / Q
    return ((2.998e10 / nu) ** 2 * cat.aij[sel] * cat.gup[sel] * Nl
            * (1.0 - np.exp(-(H * nu) / (K * Tex)))
            / (8.0 * np.pi * (dV * nu / CKM) * cat.glow[sel]))


def noise_std(x, threshold=3.5, radius=3):
    noise = x.copy()
    mean, std = np.nanmean(x), np.nanstd(x)
    outliers = np.nonzero((x - mean < -std * threshold) | (x - mean > std * threshold))[0]
    for chan in outliers:
        noise[max(0, chan - radius):chan + radius] = np.nan
    return np.nanstd(noise)


def reduce(cat: Catalog, data: np.ndarray, *, ll, ul, aligned_velocity, dish_size,
           source_size):
    """(freqs, ints, yerrs, covered): the reduced channels and the
    indices of the covered lines among the catalog's lines in (ll, ul]."""
    i, i2 = cat.trim(ll, ul)
    C, dV, T = FIDUCIAL
    with np.errstate(under="ignore", over="ignore"):
        rf = cat.frequency[i:i2]
        tau = stick_taus(cat, C, T, dV)[i:i2]
        sticks = ((planck(rf, T) - planck(rf, T_CMB)) * (1.0 - np.exp(-tau))
                  * dilution(rf, source_size, dish_size))
    freqs = np.asarray(data[0], dtype=np.float64)
    ints = np.asarray(data[1], dtype=np.float64)
    out_f, out_i, out_e = (np.zeros(freqs.shape) for _ in range(3))
    covered = []
    lo, hi = aligned_velocity - 1.5, aligned_velocity + 1.5
    for k, f0 in enumerate(rf):
        if not sticks[k] > 0.05 * sticks.max():
            continue
        vel = (f0 - freqs) / f0 * CKM + aligned_velocity
        locs = np.nonzero((vel < hi) & (vel > lo))[0]
        if locs.size == 0:
            continue
        sigma = noise_std(ints[locs])
        if np.max(ints[locs]) > 3.5 * sigma:
            continue
        covered.append(k)
        out_f[locs], out_i[locs] = freqs[locs], ints[locs]
        out_e[locs] = np.sqrt(sigma ** 2 + (ints[locs] * 0.1) ** 2)
    keep = out_f > 0
    return out_f[keep], out_i[keep], out_e[keep], np.array(covered, dtype=np.int64)
