"""SPCAT catalog parsing and the partition function Q(T), in float64 NumPy.

The fixed-width layout: freq [0:13], error [13:21], logint [21:29], dof
[29:31], elower [31:41], gup [41:44], tag [44:51], qnformat [51:55], then
twelve two-character quantum numbers (the last one to the end of the
line); a quantum number of 100 or more is a letter and a digit (A0 = 100,
B3 = 113). From the linear intensity at 300 K the line strength and the
Einstein A follow through Q(300); the lower-state degeneracy is the upper
degeneracy of the first line whose six upper quantum numbers equal this
line's lower ones (1 where none does).

Q(T) is what the configuration states: `{"kind": "linear", "slope",
"intercept", "scale"}` (scale * (intercept + slope T)) or `{"kind":
"states"}`, the sum of (2J + 1) exp(-E / (kcm T)) over the catalog's
distinct lower states (J and the other lower quantum numbers, E).
"""

from __future__ import annotations

import dataclasses

import numpy as np

KCM = 0.69503476          # Boltzmann's constant, cm^-1 / K
EUPPER_CONV = 29979.2458  # MHz -> cm^-1
SIJMU_CONST = 4.16231e-5
AIJ_CONST = 1.16395e-20


def decode_qn(field: str) -> int:
    s = field.strip()
    if not s:
        return 0
    if s.lstrip("-").isdigit():
        return int(s)
    base = 100 + 10 * "ABCDEFGHIJKLMNOPQRSTUVWXYZ".find(s[0].upper())
    return base + int(s[1]) if len(s) > 1 and s[1].isdigit() else base


@dataclasses.dataclass(frozen=True)
class Catalog:
    frequency: np.ndarray   # MHz
    elower: np.ndarray      # cm^-1
    gup: np.ndarray
    glow: np.ndarray
    aij: np.ndarray
    lower_qn: np.ndarray    # (L, qns) lower-state quantum numbers
    q: dict                 # the configuration's Q(T)

    def trim(self, ll: float, ul: float) -> tuple[int, int]:
        """[i, i2): the lines with ll < frequency <= ul (sorted by frequency)."""
        above = np.nonzero(self.frequency > ll)[0]
        i = int(above[0]) if above.size else len(self.frequency)
        above = np.nonzero(self.frequency > ul)[0]
        return i, int(above[0]) if above.size else len(self.frequency)

    def partition(self, T):
        """Q(T) in float64 for scalar or array T."""
        T = np.asarray(T, dtype=np.float64)
        if self.q["kind"] == "linear":
            return self.q["scale"] * (self.q["intercept"] + self.q["slope"] * T)
        g, E = self.state_table()
        return np.sum(g * np.exp(-E / (KCM * T[..., None])), axis=-1)

    def state_table(self):
        """(g, E) of the distinct lower states (the "states" Q)."""
        states = np.unique(np.column_stack([self.lower_qn.astype(np.float64),
                                            self.elower]), axis=0)
        return 2.0 * states[:, 0] + 1.0, states[:, -1]


def parse_catalog(path: str, q: dict) -> Catalog:
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    n = len(lines)
    freq = np.array([float(ln[0:13]) for ln in lines])
    logint = np.array([float(ln[21:29]) for ln in lines])
    elower = np.array([float(ln[31:41]) for ln in lines])
    gup = np.array([decode_qn(ln[41:44]) for ln in lines], dtype=np.int64)
    qns = min(int(lines[0][51:55].strip()[-1]), 6)
    qn = np.zeros((n, 12), dtype=np.int64)
    for i, ln in enumerate(lines):
        for k in range(11):
            qn[i, k] = decode_qn(ln[55 + 2 * k:57 + 2 * k])
        qn[i, 11] = decode_qn(ln[77:])
    eupper = elower + freq / EUPPER_CONV
    cat = Catalog(freq, elower, gup, np.ones(n, dtype=np.int64), np.zeros(n),
                  qn[:, 6:6 + qns], q)
    q300 = float(cat.partition(300.0))
    sijmu = (1.0 / (np.exp(-(elower / 0.695) / 300.0) - np.exp(-(eupper / 0.695) / 300.0))
             * (10.0 ** logint / freq) / SIJMU_CONST * q300)
    aij = AIJ_CONST * freq ** 3 * sijmu / gup
    weights = 10 ** np.arange(6, dtype=np.int64)
    uhash, lhash = qn[:, 0:6] @ weights, qn[:, 6:12] @ weights
    first = {}
    for i, hsh in enumerate(uhash):
        first.setdefault(int(hsh), i)
    glow = np.array([gup[first[int(hsh)]] if int(hsh) in first else 1 for hsh in lhash],
                    dtype=np.int64)
    return dataclasses.replace(cat, glow=glow, aij=aij)
