"""Partition-function models Q(T).

Port of cha1_mcmc_tpu/catalogs/partition.py. The dispatch on substrings of
the catalog filename is copied verbatim from the reference chain of
hardcoded polynomials / power laws with a generic state-sum fallback
(reference spectral_simulator/functions.py:136-325), quirks included:

  * first match wins (if/elif chain), e.g. '13ch3oh.cat' hits the
    '13methanol' branch before the later 0.399272*T**1.756329 one;
  * the '1-cyanonaphthalene' / 'acenapthylene' patterns do NOT match the
    shipped files, so those catalogs take the state-sum fallback;
  * the fallback dedupes states by their lower-state QN tuple + elower and
    sums (2J+1)*exp(-E/(kcm*T)).

The model is resolved once at catalog load into a frozen form: analytic
coefficients (poly + power law) or unique-state (g, E) arrays, plus an
optional Chebyshev device surrogate. `host_eval` is the float64 NumPy
oracle; `__call__` evaluates on torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from cha1_mcmc_tpu_torch.constants import KCM

if TYPE_CHECKING:
    from cha1_mcmc_tpu_torch.catalogs.spcat import Catalog

__all__ = ["QModel", "q_model_for_catalog", "fit_device_cheb",
           "device_n_states", "int_pow"]


def int_pow(x, n: int):
    """x**n for a non-negative int n by binary exponentiation, multiplying
    in the order jax.lax.integer_pow does (so polynomial Q(T) rounds the
    same way as the JAX package's)."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


@dataclasses.dataclass(frozen=True)
class QModel:
    """Q(T) = scale * (sum_i coeffs[i] * T**i  +  a * T**b), or a state sum.

    For ``kind == 'analytic'``: `coeffs` are ascending polynomial
    coefficients and `power` an optional (a, b) power-law term.
    For ``kind == 'states'``: Q(T) = sum_s g[s] * exp(-E[s] / (kcm * T)).
    `cheb_interval` / `cheb_coeffs` optionally carry a Chebyshev-T device
    surrogate (fit_device_cheb): `__call__` then evaluates the Clenshaw
    recurrence instead of the state sum, while `host_eval` always
    evaluates the exact formulas.
    """

    kind: str
    coeffs: tuple = ()
    power: tuple | None = None
    scale: float = 1.0
    g: np.ndarray | None = None   # (S,) degeneracies 2J+1
    E: np.ndarray | None = None   # (S,) lower-state energies, cm^-1
    cheb_interval: tuple | None = None
    cheb_coeffs: tuple | None = None

    def host_eval(self, T):
        """Evaluate with NumPy (float64), for host-side setup and tests.
        Always the exact formulas — never the Chebyshev surrogate."""
        if self.kind == "states":
            T_arr = np.asarray(T)
            return np.sum(self.g * np.exp(-self.E / (KCM * T_arr[..., None])),
                          axis=-1)
        q = np.zeros_like(T) if hasattr(T, "shape") else 0.0
        for i, c in enumerate(self.coeffs):
            q = q + c * T ** i
        if self.power is not None:
            a, b = self.power
            q = q + a * T ** b
        return self.scale * q

    def __call__(self, T: torch.Tensor, states=None) -> torch.Tensor:
        """Evaluate on a tensor of temperatures (any shape). `states`
        optionally passes the (g, E) arrays as tensors already on T's
        device (SpectralModel keeps them as buffers); otherwise they are
        converted here. Uses the Chebyshev surrogate when one is
        attached."""
        if self.cheb_coeffs is not None:
            return self._cheb_eval(T)
        if self.kind == "states":
            if states is None:
                states = (torch.as_tensor(self.g, dtype=T.dtype, device=T.device),
                          torch.as_tensor(self.E, dtype=T.dtype, device=T.device))
            g, E = states
            return torch.sum(g * torch.exp(-E / (KCM * T[..., None])), dim=-1)
        q = torch.zeros_like(T)
        for i, c in enumerate(self.coeffs):
            q = q + c * int_pow(T, i)
        if self.power is not None:
            a, b = self.power
            q = q + a * T ** b
        return self.scale * q

    def _cheb_eval(self, T):
        """Clenshaw recurrence for sum_k c_k T_k(x(T)); broadcasts over
        any T shape."""
        t_lo, t_hi = self.cheb_interval
        x = (T - t_lo) * (2.0 / (t_hi - t_lo)) - 1.0
        bk1 = torch.zeros_like(x)
        bk2 = torch.zeros_like(x)
        for c in self.cheb_coeffs[:0:-1]:     # c_deg .. c_1
            bk1, bk2 = c + 2.0 * x * bk1 - bk2, bk1
        return self.cheb_coeffs[0] + x * bk1 - bk2


def _poly(*ascending_coeffs, scale=1.0):
    return QModel(kind="analytic", coeffs=tuple(ascending_coeffs), scale=scale)


def _powlaw(a, b, c=0.0, scale=1.0):
    return QModel(kind="analytic", coeffs=(c,), power=(a, b), scale=scale)


def _linear(slope, intercept, scale=1.0):
    return QModel(kind="analytic", coeffs=(intercept, slope), scale=scale)


def q_model_for_catalog(catalog: "Catalog") -> QModel:
    """Resolve the Q(T) model for a catalog, per the reference dispatch.

    Match order and patterns are copied from reference functions.py:139-261.
    """
    f = catalog.catalog_file.lower()

    def has(*subs):
        return any(s in f for s in subs)

    if has("n2h+_hfs.cat"):
        return _poly(3.32018827, 4.01951955e0, 3.28722820e-05, -3.13420474e-08)
    if has("acetone.cat"):
        return _poly(16431.0, -2728.3, 245.28, -5.5477, 0.05471337, -0.00021050085, 2.91296e-7)
    if has("sh.cat"):
        return _poly(15.3572397281574, 0.069272946237033, 0.002288160909445,
                     -0.000008528126823, 0.000000012549467)
    if has("h2s.cat"):
        return _poly(-1.76449475563974, 0.507648423477309, 0.005498622332982, -0.000004859941547)
    if has("hcn.cat"):
        return _poly(0.386550361, 1.48629408, -1.15188755e-3, 4.62476813e-6, -1.64946939e-9)
    if has("methanol.cat", "ch3oh.cat", "ch3oh_v0.cat", "ch3oh_v1.cat", "ch3oh_v2.cat", "ch3oh_vt.cat"):
        return _poly(-1.25670, 4.39632e-1, 2.05911e-1, -1.83807e-3, 1.27624e-5, -4.04024e-8, 4.83410e-11)
    if has("13methanol.cat", "13ch3oh.cat"):
        return _poly(-31.876881967, 4.317920731, 0.076540934, 0.000050130)
    if has("c2n.cat", "ccn.cat"):
        return _poly(22.55770, 7.135161, 0.1837397, -1.40473e-3, 5.99936e-6, -1.324086e-8, 1.173755e-11)
    if has("ch2nh.cat"):
        return _powlaw(1.2152, 1.4863)
    if has("13ch3oh.cat", "c033502.cat"):  # unreachable for 13ch3oh; kept for order parity
        return _powlaw(0.399272, 1.756329)

    # GOTHAM cyanopolyynes and isocyanides (hfs variants scale x3 or /3).
    hfs = "hfs" in f
    if has("hc3n"):
        return _linear(4.581898, 0.2833, scale=3.0 if hfs else 1.0)
    if has("hc2nc_hfs"):
        return _linear(12.58340, 1.0604)
    if has("hc5n"):
        return _linear(15.65419, 0.2214, scale=3.0 if hfs else 1.0)
    if has("hc4nc"):
        return _linear(44.62171, 0.6734, scale=1.0 if hfs else 1.0 / 3.0)
    if has("hc7n"):
        return _linear(36.94999, 0.1356, scale=3.0 if hfs else 1.0)
    if has("hc6nc"):
        return _linear(107.3126, 1.2714, scale=1.0 if hfs else 1.0 / 3.0)
    if has("hc9n"):
        return _linear(71.7308577, 0.02203968, scale=3.0 if hfs else 1.0)
    if (has("hc11n.cat") and not hfs) or (has("hc11n") and hfs):
        return _linear(123.2554, 0.1381, scale=3.0 if hfs else 1.0)

    # Other GOTHAM species: power laws (reference functions.py:214-261).
    for pattern, (a, b, c) in _POWER_LAWS.items():
        if pattern in f:
            return _powlaw(a, b, c)

    # Generic fallback: state sum over unique lower states
    # (reference functions.py:263-325).
    return _state_sum_model(catalog)


# pattern -> (a, b, additive constant) for Q = a*T**b + c, in reference
# dispatch order; several deliberately fail to match the shipped filenames.
_POWER_LAWS = {
    "propargylcyanide": (41.542, 1.5008, 0.0),
    "pyrrole": (27.727, 1.4752, 0.0),
    "cyclopropylcyanide_hfs": (38.199, 1.4975, 0.0),
    "pyridine": (50.478, 1.4955, 0.0),
    "1-cyanonaphthalene": (560.39, 1.4984, 0.0),
    "2-cyanonaphthalene": (562.57, 1.4993, 0.0),
    "furan": (33.725, 1.4982, 0.0),
    "phenol": (264.20, 1.4984, 0.0),
    "benzaldehyde": (53.798, 1.4997, 0.0),
    "anisole": (54.850, 1.4992, 0.0),
    "azulene": (96.066, 1.4988, 0.0),
    "acenaphthene": (161.29, 1.4994, 0.0),
    "acenapthylene": (151.58, 1.4988, 0.0),
    "fluorene": (219.51, 1.4996, 0.0),
    "benzonitrile": (25.896, 1.4998, 0.38109),
}


def _state_sum_model(catalog: "Catalog") -> QModel:
    """Precompute unique-state (g, E) arrays for the generic Q fallback:
    rows [qn7..qn(6+qns), elower] deduped with np.unique, g = 2J+1 with
    J = qn7 (reference functions.py:263-325)."""
    qns = catalog.qns
    rows = np.column_stack(
        [catalog.qn[:, 6:6 + qns].astype(np.float64), catalog.elower]
    )
    unique_rows = np.unique(rows, axis=0)
    J = unique_rows[:, 0]
    E = unique_rows[:, -1]
    return QModel(kind="states", g=(2.0 * J + 1.0), E=E)


def device_n_states(qm: QModel) -> int:
    """Number of states the DEVICE evaluation of this QModel walks: 0 for
    analytic forms and for state-sum models carrying a Chebyshev
    surrogate."""
    if qm.kind == "analytic" or qm.cheb_coeffs is not None:
        return 0
    return int(np.size(qm.g))


def fit_device_cheb(qm: QModel, t_lo: float, t_hi: float, *,
                    tol: float = 1e-10, max_deg: int = 64) -> QModel:
    """Attach a Chebyshev-T device surrogate for Q(T) over [t_lo, t_hi].

    Fits at Chebyshev nodes in f64, raising the degree until the max
    relative error on a dense check grid is below `tol`. Returns a new
    QModel with cheb_interval/cheb_coeffs set, or `qm` unchanged for
    analytic models, when one is already attached, or when no degree
    reaches `tol`. The surrogate is only valid inside [t_lo, t_hi]:
    callers pass the sampler's Tex prior box, and out-of-box proposals
    are -inf by the prior before Q's value matters.
    """
    if qm.kind == "analytic" or qm.cheb_coeffs is not None:
        return qm
    t_lo, t_hi = float(t_lo), float(t_hi)
    if not (np.isfinite(t_lo) and np.isfinite(t_hi)) or t_hi <= t_lo:
        return qm
    from numpy.polynomial import chebyshev as _cheb

    T_check = np.linspace(t_lo, t_hi, 4001)
    Q_check = qm.host_eval(T_check)
    x_check = (T_check - t_lo) * (2.0 / (t_hi - t_lo)) - 1.0
    deg = 8
    while deg <= max_deg:
        nodes = np.cos((2 * np.arange(deg + 1) + 1) * np.pi
                       / (2 * (deg + 1)))
        tn = 0.5 * (t_hi - t_lo) * nodes + 0.5 * (t_hi + t_lo)
        coef = _cheb.chebfit(nodes, qm.host_eval(tn), deg)
        rel = np.max(np.abs(_cheb.chebval(x_check, coef) / Q_check - 1.0))
        if rel <= tol:
            return dataclasses.replace(
                qm, cheb_interval=(t_lo, t_hi),
                cheb_coeffs=tuple(float(c) for c in coef))
        deg = deg * 3 // 2
    return qm
