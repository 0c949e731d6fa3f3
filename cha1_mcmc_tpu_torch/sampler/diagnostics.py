"""Convergence diagnostics: integrated autocorrelation time, effective
sample size, and Gelman-Rubin R-hat.

Port of cha1_mcmc_tpu/sampler/diagnostics.py (NumPy only, copied so the
port imports nothing of the JAX package). Every function takes a chain
in the emcee (nwalkers, nsteps, ndim) layout; a MultiChainSampler's
pooled (K*W, S, D) chain keeps whole chains contiguous, so `gelman_rubin`
on it measures cross-chain mixing.

The reference has no diagnostics beyond eyeballing trace plots (its only
nod is a comment mentioning Gelman-Rubin, reference
TMC1_four_component.py:343). These are standard ensemble-MCMC health
metrics; the autocorrelation estimator follows the standard
Goodman & Weare / emcee windowing (Sokal's adaptive truncation
sum_{t<C*tau} rho(t)).
"""

from __future__ import annotations

import numpy as np

__all__ = ["autocorr_time", "effective_sample_size", "gelman_rubin", "summarize_convergence"]


def _autocorr_1d(x: np.ndarray) -> np.ndarray:
    n = len(x)
    x = x - x.mean()
    # FFT-based autocovariance
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conjugate(f))[:n].real
    return acf / acf[0]


def autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per dimension.

    chain: (nwalkers, nsteps, ndim). Averages the per-walker ACF (the
    ensemble estimator), then applies Sokal's adaptive window: the smallest
    M with M >= c * tau_int(M).
    """
    W, S, D = chain.shape
    taus = np.empty(D)
    for d in range(D):
        rho = np.mean([_autocorr_1d(chain[w, :, d]) for w in range(W)], axis=0)
        cumulative = 2.0 * np.cumsum(rho) - 1.0
        window = np.arange(len(cumulative)) < c * cumulative
        M = int(np.argmin(window)) if not window.all() else len(cumulative) - 1
        taus[d] = cumulative[M]
    return taus


def effective_sample_size(chain: np.ndarray) -> np.ndarray:
    """ESS per dimension: nwalkers * nsteps / tau."""
    W, S, D = chain.shape
    return W * S / autocorr_time(chain)


def gelman_rubin(chain: np.ndarray) -> np.ndarray:
    """Split R-hat per dimension, treating walkers as chains.

    chain: (nwalkers, nsteps, ndim); each walker's history is split in two
    to detect within-chain drift. Values near 1 indicate convergence.
    """
    W, S, D = chain.shape
    half = S // 2
    pieces = np.concatenate([chain[:, :half, :], chain[:, half:2 * half, :]], axis=0)
    m, n = pieces.shape[0], half
    means = pieces.mean(axis=1)                        # (m, D)
    variances = pieces.var(axis=1, ddof=1)             # (m, D)
    B = n * means.var(axis=0, ddof=1)
    Wv = variances.mean(axis=0)
    var_hat = (n - 1) / n * Wv + B / n
    return np.sqrt(var_hat / Wv)


def summarize_convergence(chain: np.ndarray, burn_in_frac: float = 0.2) -> dict:
    """Dict of tau / ESS / R-hat after burn-in discard."""
    burn = int(burn_in_frac * chain.shape[1])
    trimmed = chain[:, burn:, :]
    tau = autocorr_time(trimmed)
    return {
        "tau": tau,
        "ess": trimmed.shape[0] * trimmed.shape[1] / tau,
        "r_hat": gelman_rubin(trimmed),
        "nsteps_post_burn": trimmed.shape[1],
    }
