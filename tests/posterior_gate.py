"""The posterior gate: summarise an MCMC chain and hold one summary to
another at a stated z, refusing a comparison the chains cannot resolve.

NumPy and SciPy only (no jax, no torch, no package import), so the
script that writes the JAX package's goldens
(scripts/make_posterior_goldens.py), the CPU tests
(tests/test_torch_posterior.py) and chip_smoke.py on the card all
summarise and compare with this one module.

    summary = summarize(chain, burn)           # chain (W, S, D), any float dtype
    rows = compare(golden, summary)            # one row per (parameter, statistic)
    assert not failures(rows), format_rows(rows)

`summarize` reduces in float64 (an f32 mean over millions of samples
drifts, tests/test_pipeline.py:228-231). Standard errors, from each
side's own integrated autocorrelation time tau (emcee's estimator,
c = 5) and ESS = W (S - burn) / tau, combine in quadrature:

* mean: sigma / sqrt(ESS);
* std: sigma sqrt((kappa - 1) / (4 ESS)), kappa the kurtosis;
* percentile q: sqrt(q (1 - q) / ESS) / f(x_q), f a Gaussian KDE on a
  thinned sample.

A side whose chain is too short to measure its own tau (the estimator
runs low there) takes `tau_floor`, a longer run's tau of the same
posterior and sampler, as a lower bound: chip_smoke.py floors the card's
at its golden's.

A row fails at |z| > z (4.5 by default: GOTHAM's 14 parameters x 5
statistics give a false failure about once in 2,000 runs). The gate
also fails, rather than passes, when either side has fewer than
`post_tau` tau_max of samples after its burn, a burn shorter than
`burn_tau` tau_max, or when the combined standard error of a mean
exceeds `mean_se` of that parameter's posterior sigma (CARD_FLOORS:
50, 20, 0.05), so a short or loose chain cannot pass.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Floors", "CARD_FLOORS", "GOLDEN_FLOORS", "STATS", "Z",
           "autocorr_time", "pick_burn", "summarize", "compare",
           "check_floors", "failures", "max_abs_z", "format_rows"]

#: The statistics compared for every parameter.
STATS = ("mean", "std", "p16", "p50", "p84")
_QUANTILES = {"p16": 0.16, "p50": 0.50, "p84": 0.84}
#: |z| above which a row fails.
Z = 4.5
#: Most samples the percentile KDE is fitted on (an even stride through
#: the post-burn samples).
KDE_SAMPLES = 20_000
#: Most times pick_burn measures tau again on what its burn leaves.
BURN_ROUNDS = 6


@dataclasses.dataclass(frozen=True)
class Floors:
    """What a side must have for the gate to judge it: at least
    `post_tau` tau_max of samples after its burn, a burn of at least
    `burn_tau` tau_max, and a standard error of every mean of at most
    `mean_se` of that parameter's posterior sigma (combined over both
    sides in `compare`, one side's own in `check_floors`)."""

    post_tau: float
    burn_tau: float
    mean_se: float


#: The card's floors (chip_smoke.py's posterior phase and every run
#: held to a golden at the card's standard).
CARD_FLOORS = Floors(post_tau=50.0, burn_tau=20.0, mean_se=0.05)
#: What a golden meets on its own: the card's lengths and half its
#: standard-error budget.
GOLDEN_FLOORS = Floors(post_tau=50.0, burn_tau=20.0, mean_se=0.025)


def _mean_acf(x: np.ndarray, chunk: int = 32) -> np.ndarray:
    """The normalised autocorrelation function of each row of the (W, S)
    array x (FFT, zero-padded to a fast length of at least 2 S),
    averaged over rows; a row with no variance contributes zeros."""
    from scipy import fft

    W, S = x.shape
    n = fft.next_fast_len(2 * S)
    total = np.zeros(S)
    for i in range(0, W, chunk):
        rows = np.asarray(x[i:i + chunk], dtype=np.float64)
        f = fft.rfft(rows - rows.mean(axis=1, keepdims=True), n=n, axis=1, workers=-1)
        acf = fft.irfft(f * np.conj(f), n=n, axis=1, workers=-1)[:, :S]
        var = acf[:, :1]
        total += np.divide(acf, var, out=np.zeros_like(acf), where=var > 0).sum(axis=0)
    return total / W


def autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per dimension of a (W, S, D)
    chain: the per-walker ACF averaged over walkers (the ensemble
    estimator), then Sokal's adaptive window, the smallest M with
    M >= c tau_int(M). The port's sampler/diagnostics.py:autocorr_time,
    its FFTs batched over walkers."""
    W, S, D = chain.shape
    taus = np.empty(D)
    for d in range(D):
        rho = _mean_acf(chain[:, :, d])
        cumulative = 2.0 * np.cumsum(rho) - 1.0
        window = np.arange(len(cumulative)) < c * cumulative
        M = int(np.argmin(window)) if not window.all() else len(cumulative) - 1
        taus[d] = cumulative[M]
    return taus


def _tau(chain: np.ndarray, tau_floor=None) -> np.ndarray:
    """autocorr_time of the chain, at least 1 (an ESS never above the
    draws) and at least `tau_floor` (per parameter) where given."""
    floor = 1.0 if tau_floor is None else np.maximum(np.asarray(tau_floor, float), 1.0)
    return np.maximum(autocorr_time(chain), floor)


def pick_burn(chain: np.ndarray, burn_tau: float = CARD_FLOORS.burn_tau,
              tau_floor=None) -> int:
    """The burn of a (W, S, D) chain counted in its own tau: starting
    from S / 20, raise it to burn_tau x tau_max of the samples after it
    until it stops growing, at most to S / 2 (a chain that needs more
    cannot meet the floors, which then refuse it). Each side of a
    comparison picks its own. `tau_floor` (per parameter) bounds tau from
    below, as in `summarize`."""
    S = chain.shape[1]
    burn = S // 20
    for _ in range(BURN_ROUNDS):
        want = int(math.ceil(burn_tau * _tau(chain[:, burn:], tau_floor).max()))
        if want <= burn or burn == S // 2:
            break
        burn = min(want, S // 2)
    return burn


def summarize(chain, burn: int, labels=None, tau_floor=None) -> dict:
    """Summary of the (W, S, D) chain after `burn` steps, in float64:
    per parameter its mean, std, p16 / p50 / p84, the KDE density at
    each percentile, tau, ESS and kurtosis; and S, burn, W. JSON-ready
    (lists and numbers). tau is at least 1 (ESS never above the draws)
    and at least `tau_floor` (per parameter) where given: a chain too
    short to measure its own tau, which the estimator then puts too low,
    takes a longer chain's of the same posterior and sampler."""
    chain = np.asarray(chain)
    W, S, D = chain.shape
    if not 0 <= burn < S - 1:
        raise ValueError(f"burn {burn} outside a chain of {S} steps")
    post = chain[:, burn:, :]
    flat = post.reshape(-1, D).astype(np.float64)
    mean = flat.mean(axis=0)
    centred = flat - mean
    m2 = (centred ** 2).mean(axis=0)
    m4 = (centred ** 4).mean(axis=0)
    del centred
    tau = _tau(post, tau_floor)
    out = {"labels": list(labels) if labels is not None else [f"p{i}" for i in range(D)],
           "S": int(S), "burn": int(burn), "W": int(W),
           "mean": mean.tolist(), "std": np.sqrt(m2).tolist(),
           "tau": tau.tolist(), "ess": (W * (S - burn) / tau).tolist(),
           "kurtosis": (m4 / m2 ** 2).tolist()}
    qs = np.percentile(flat, [100 * q for q in _QUANTILES.values()], axis=0)
    thin = flat[::max(1, flat.shape[0] // KDE_SAMPLES)]
    from scipy.stats import gaussian_kde

    for (name, _), x in zip(_QUANTILES.items(), qs):
        out[name] = x.tolist()
        out[f"density_{name}"] = [float(gaussian_kde(thin[:, d])(x[d])[0])
                                  for d in range(D)]
    return out


def _se(s: dict, stat: str, d: int) -> float:
    """One side's standard error of `stat` of parameter d."""
    ess, sigma = s["ess"][d], s["std"][d]
    if stat == "mean":
        return sigma / math.sqrt(ess)
    if stat == "std":
        return sigma * math.sqrt(max(s["kurtosis"][d] - 1.0, 0.0) / (4.0 * ess))
    q = _QUANTILES[stat]
    return math.sqrt(q * (1.0 - q) / ess) / s[f"density_{stat}"][d]


def _length_rows(side: str, s: dict, floors: Floors) -> list:
    """The length floors of one side, as rows."""
    tau_max = max(s["tau"])
    post = (s["S"] - s["burn"]) / tau_max
    burn = s["burn"] / tau_max
    return [{"param": "*", "stat": f"{side} steps after burn / tau_max",
             "value": post, "limit": floors.post_tau, "ok": post >= floors.post_tau},
            {"param": "*", "stat": f"{side} burn / tau_max",
             "value": burn, "limit": floors.burn_tau, "ok": burn >= floors.burn_tau}]


def check_floors(s: dict, floors: Floors = GOLDEN_FLOORS) -> list:
    """Rows of one summary's own floors: its lengths in tau_max and
    each mean's standard error over its sigma."""
    rows = _length_rows("this side", s, floors)
    for d, label in enumerate(s["labels"]):
        ratio = _se(s, "mean", d) / s["std"][d]
        rows.append({"param": label, "stat": "mean SE / sigma", "value": ratio,
                     "limit": floors.mean_se, "ok": ratio <= floors.mean_se})
    return rows


def compare(golden: dict, ours: dict, z: float = Z,
            floors: Floors = CARD_FLOORS) -> list:
    """One row per (parameter, statistic): golden and our value, their
    difference, the combined standard error, z and ok (|z| <= z); then
    the floor rows of both sides (lengths in tau_max, combined mean SE
    over the golden's sigma), which fail a comparison the chains
    cannot resolve."""
    if golden["labels"] != ours["labels"]:
        raise ValueError(f"parameters differ: {golden['labels']} vs {ours['labels']}")
    rows = []
    for d, label in enumerate(golden["labels"]):
        for stat in STATS:
            g, o = golden[stat][d], ours[stat][d]
            se = math.hypot(_se(golden, stat, d), _se(ours, stat, d))
            zz = (o - g) / se if se > 0 else math.inf
            ok = bool(np.isfinite(o)) and abs(zz) <= z
            rows.append({"param": label, "stat": stat, "golden": g, "ours": o,
                         "diff": o - g, "se": se, "z": zz, "ok": ok})
    rows += _length_rows("golden", golden, floors) + _length_rows("ours", ours, floors)
    for d, label in enumerate(golden["labels"]):
        ratio = math.hypot(_se(golden, "mean", d), _se(ours, "mean", d)) / golden["std"][d]
        rows.append({"param": label, "stat": "combined mean SE / sigma", "value": ratio,
                     "limit": floors.mean_se, "ok": ratio <= floors.mean_se})
    return rows


def failures(rows: list) -> list:
    """The rows that fail."""
    return [r for r in rows if not r["ok"]]


def max_abs_z(rows: list) -> float:
    """The largest |z| of the statistic rows."""
    return max(abs(r["z"]) for r in rows if "z" in r)


def format_rows(rows: list) -> str:
    """One line per row: statistic rows as golden, ours, SE, z, ok;
    floor rows as value against limit."""
    lines = []
    for r in rows:
        mark = "ok" if r["ok"] else "FAIL"
        if "z" in r:
            lines.append(f"{r['param']:>14} {r['stat']:>4}: golden {r['golden']:.6g} "
                         f"ours {r['ours']:.6g} se {r['se']:.3g} z {r['z']:+.2f} {mark}")
        else:
            lines.append(f"{r['param']:>14} {r['stat']}: {r['value']:.4g} "
                         f"(limit {r['limit']:g}) {mark}")
    return "\n".join(lines)
