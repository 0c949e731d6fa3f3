"""Offline Gaussian line-profile renderer for plots.

Vectorized equivalent of the reference's sim_gaussian (reference
spectral_simulator/functions.py:544-623): build an adaptive frequency grid
covering +-10 FWHM around every line (merging overlapping line groups),
accumulate each stick's Gaussian at sigma = FWHM / 2.35482, and regrid onto
the uniform [ll, ul] output grid. The reference loops per line with
wall-clock ETA warnings (functions.py:568-604); this version is a single
vectorized accumulation, so no pacing heuristics are needed.

A NumPy copy of cha1_mcmc_tpu/analysis/renderer.py, so the port imports nothing of
the JAX package; its outputs equal that module's on the same inputs.
"""

from __future__ import annotations

import numpy as np

from cha1_mcmc_tpu_torch.analysis.stacking import find_nearest
from cha1_mcmc_tpu_torch.constants import CKM, FWHM_TO_SIGMA_PLOT

__all__ = ["render_gaussian_profile"]


def render_gaussian_profile(stick_freqs, stick_ints, dV: float,
                            ll: float, ul: float, res: float,
                            cavity_split: float | None = None,
                            two_fwhm_only: bool = False,
                            match_obs=None,
                            rms: float = float("-inf")):
    """Return (freq_grid, intensity) of the Gaussian-broadened spectrum.

    stick_freqs/stick_ints: line frequencies (MHz) and stick amplitudes;
    dV: FWHM in km/s; [ll, ul] and res define the output grid in MHz.
    Matches reference functions.py:544-623 semantics: the adaptive grid is
    the union of per-line windows of +-10 FWHM at resolution `res`, sorted;
    accumulated intensity is interpolated onto arange(ll, ul + 1e-8, res).

    cavity_split (km/s): cavity-FTMW Doppler doublets — each stick renders
    as two half-amplitude Gaussians at f(1 -+ split/ckm), the grid still
    built from the unsplit line centers (reference simulate_lte.py's
    vendored sim_gaussian, :1475-1487; pass dV = the cavity linewidth, the
    tool overrides it to cavity_dV at :1370).

    two_fwhm_only: the vendored tool's grid-thinning flag (simulate_lte.py
    :236, :1376-1384): per-line windows shrink to +-2 FWHM, but the
    window-merge walk still extends groups by +10 FWHM of the group leader
    (the reference quirk at :1388-1394 is kept).

    match_obs: observed frequency axis (MHz); when given, each line window
    becomes the slice of this axis between the nearest samples to
    [min_f, max_f] (the tool's match_obs mode, :1396-1404), and the
    *adaptive* grid is returned un-regridded — the vendored sim_gaussian
    never interpolates onto a uniform grid; the uniform regrid below is
    the live pipeline's (functions.py:618-623) convention.

    rms: sticks with |amplitude| < rms/10 are skipped in the accumulation
    (but still shape the grid) — the tool's weak-line cutoff (:1425).
    (The tool's res_kHz / res_kms unit flags are declared at :208-212 but
    never read by any code path, so they are not reproduced.)
    """
    stick_freqs = np.asarray(stick_freqs, dtype=np.float64)
    stick_ints = np.asarray(stick_ints, dtype=np.float64)
    if match_obs is not None:
        match_obs = np.asarray(match_obs, dtype=np.float64)

    l_f = dV * stick_freqs / CKM                       # per-line FWHM in MHz
    # Adaptive grid with the reference's exact window-merging walk
    # (functions.py:546-562): windows of lines within 10 FWHM of each other
    # merge into one arange, keeping the *group leader's* FWHM for the
    # extension (the reference does not recompute l_f inside the merge loop).
    pieces = []
    n = stick_freqs.size
    x = 0
    while x < n:
        w = l_f[x]
        half = 2 if two_fwhm_only else 10
        min_f = stick_freqs[x] - half * w
        max_f = stick_freqs[x] + half * w
        if x < n - 2:
            while stick_freqs[x + 1] < max_f and x < n - 2:
                x += 1
                max_f = stick_freqs[x] + 10 * w
        if match_obs is not None:
            # exact find_nearest semantics (searchsorted, ties to the
            # right) — the tool's window edges, simulate_lte.py:1396-1400
            l_idx = find_nearest(match_obs, min_f)
            u_idx = find_nearest(match_obs, max_f)
            pieces.append(match_obs[l_idx:u_idx])
        else:
            pieces.append(np.arange(min_f, max_f, res))
        x += 1
    if pieces:
        freq_gauss = np.sort(np.concatenate(pieces))
    else:
        freq_gauss = np.arange(ll, ul + 1e-8, res)

    if np.isfinite(rms):
        keep = ~(np.abs(stick_ints) < rms / 10.0)
        stick_freqs, stick_ints, l_f = (stick_freqs[keep], stick_ints[keep],
                                        l_f[keep])

    c = l_f / FWHM_TO_SIGMA_PLOT                       # per-line sigma in MHz
    # (L, G) accumulation, vectorized; for very large L x G fall back to
    # chunked accumulation to bound memory.
    G = freq_gauss.size
    int_gauss = np.zeros(G)
    chunk = max(1, int(2e7 // max(G, 1)))
    for s in range(0, stick_freqs.size, chunk):
        e = min(s + chunk, stick_freqs.size)
        if cavity_split is not None:
            shift = cavity_split * stick_freqs[s:e, None] / CKM
            two_c2 = 2.0 * c[s:e, None] ** 2
            dl = freq_gauss[None, :] - (stick_freqs[s:e, None] - shift)
            dh = freq_gauss[None, :] - (stick_freqs[s:e, None] + shift)
            int_gauss += (0.5 * stick_ints[s:e, None]
                          * (np.exp(-(dl * dl) / two_c2)
                             + np.exp(-(dh * dh) / two_c2))).sum(axis=0)
        else:
            d = freq_gauss[None, :] - stick_freqs[s:e, None]
            int_gauss += (stick_ints[s:e, None]
                          * np.exp(-(d * d) / (2.0 * c[s:e, None] ** 2))).sum(axis=0)

    if match_obs is not None:
        return freq_gauss, int_gauss
    freq_sim = np.arange(ll, ul + 1e-8, res)
    return freq_sim, np.interp(freq_sim, freq_gauss, int_gauss)
