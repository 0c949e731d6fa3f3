"""Chain persistence, resume, walker initialization, posterior-as-prior.

Chain file contract matches the reference: a (nwalkers, nsteps, ndim) .npy
saved cumulatively, with resume positions read as chain[:, -1, :]
(reference inference.py:462-463).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "save_chain",
    "load_chain",
    "last_position",
    "chain_to_priors",
    "initialize_walkers",
]


def save_chain(path: str, chain: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, np.asarray(chain))


def load_chain(path: str) -> np.ndarray:
    if path is None:
        raise FileNotFoundError(
            "No chain path given (prior_path is required for non-template runs).")
    if not os.path.exists(path):
        raise FileNotFoundError(f"The prior path {path} could not be found.")
    return np.load(path)


def last_position(chain: np.ndarray) -> np.ndarray:
    """Resume positions: chain[:, -1, :] (reference inference.py:463)."""
    return np.asarray(chain)[:, -1, :]


def chain_to_priors(chain: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Posterior-as-prior chaining (reference inference.py:401-408).

    The reference loads the (W, S, D) chain, transposes to (D, S, W), takes
    per-walker percentiles over steps, and averages over walkers:
      prior_means = mean_w(p50);  prior_stds = |(p16 - mu + p84 - mu) / 2|.
    """
    psamples = np.asarray(chain).T  # (D, S, W)
    prior_means = np.mean(np.percentile(psamples, 50, axis=1), axis=1)
    percentile_16 = np.percentile(psamples, 16, axis=1).mean(axis=1)
    percentile_84 = np.percentile(psamples, 84, axis=1).mean(axis=1)
    prior_stds = np.abs((percentile_16 - prior_means + percentile_84 - prior_means) / 2.0)
    return prior_means, prior_stds


def initialize_walkers(initial, prior_stds, nwalkers: int, is_within_bounds,
                       rng: np.random.Generator | None = None,
                       scale: float = 0.1, max_tries: int = 10_000) -> np.ndarray:
    """Rejection-sample a tight walker ball around `initial`.

    trial = initial + randn * (prior_stds * scale), redrawn until inside the
    box bounds, per walker (reference inference.py:441-453 with scale=1/10).
    """
    rng = rng or np.random.default_rng()
    initial = np.asarray(initial, dtype=np.float64)
    prior_stds = np.asarray(prior_stds, dtype=np.float64)
    pos = np.empty((nwalkers, initial.size), dtype=np.float64)
    for w in range(nwalkers):
        for _ in range(max_tries):
            trial = initial + rng.standard_normal(initial.size) * (prior_stds * scale)
            if is_within_bounds(trial):
                pos[w] = trial
                break
        else:
            raise RuntimeError(
                f"Could not initialize walker {w} inside bounds after {max_tries} tries.")
    return pos
