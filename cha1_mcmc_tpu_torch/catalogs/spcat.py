"""SPCAT (CDMS/JPL) fixed-width catalog parser.

Parses the `.cat` format into frozen NumPy arrays and derives the
quantities the LTE simulator needs (eupper, linear intensity, line
strength sijmu, Einstein A, lower-state degeneracy glow), with semantics
matching the reference parser (reference spectral_simulator/classes.py:16-288)
including its quantum-number quirks:

  * '+'/'-' parity labels are remapped to 1/2 and '' to 0 whenever a QN
    column contains any parity label (reference functions.py:330-335).
  * alphabetic "extended" QNs (SPCAT encodes 100+ as A0..Z9, a0..z9) are
    decoded as 100 + 10*letter_index + digit (reference functions.py:340-501).
  * glow is found by hashing each state's six QNs base-10 and matching each
    line's lower-state hash against upper-state hashes; unmatched lines get
    glow = 1 (reference classes.py:100-110). The reference does this with an
    O(n^2) `np.equal.outer`; we use a stable argsort + searchsorted, which is
    O(n log n) and returns the *same* first-match index.

This is deliberately host-side NumPy in float64: it runs once per molecule
and its outputs become static device tensors. Port of
cha1_mcmc_tpu/catalogs/spcat.py.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from cha1_mcmc_tpu_torch.constants import EUPPER_CONV, SIJMU_CONST, AIJ_CONST

__all__ = ["Catalog", "parse_spcat", "load_catalog"]

# Decoder table for SPCAT alphabetic quantum numbers: 'A0' -> 100, 'B3' -> 113,
# ... 'Z9' -> 359; lowercase follows the same mapping (reference
# functions.py:340-501 maps both cases identically).
_ALPHA_BASE = {}
for _i, _ch in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZ"):
    _ALPHA_BASE[_ch] = 100 + 10 * _i
    _ALPHA_BASE[_ch.lower()] = 100 + 10 * _i


def _decode_qn(field: str, has_pm: bool) -> int:
    """Decode one two-character SPCAT quantum-number field to an int.

    `has_pm` mirrors the reference's column-wise rule: fix_pm is applied to a
    whole QN column only when that column contains a '+' or '-' entry
    (reference classes.py:180-214); it then maps '' -> 0, '+' -> 1, '-' -> 2
    (reference functions.py:330-335).
    """
    s = field.strip()
    if has_pm:
        if s == "":
            return 0
        if s == "+":
            return 1
        if s == "-":
            return 2
    if s == "":
        # int('') raises in the reference and falls into fix_qn, which leaves
        # its default 0 for a string with no alphabetic character
        # (reference functions.py:341,499).
        return 0
    try:
        return int(s)
    except ValueError:
        base = _ALPHA_BASE.get(s[0])
        if base is None:
            # No alphabetic lead character: the reference's fix_qn would write
            # 0 (its `new_qn` default) for such malformed fields.
            return 0
        return base + int(s[1]) if len(s) > 1 and s[1].isdigit() else base


@dataclasses.dataclass(frozen=True)
class Catalog:
    """Frozen per-molecule spectroscopy arrays (float64/int64 NumPy).

    Field layout mirrors the reference MolCat attributes
    (reference classes.py:16-110). `qns` is the number of quantum numbers
    per state, capped at 6 (reference classes.py:116-122).
    """

    name: str
    catalog_file: str
    frequency: np.ndarray   # (L,) MHz
    error: np.ndarray       # (L,)
    logint: np.ndarray      # (L,) log10 intensity at 300 K
    dof: np.ndarray         # (L,)
    elower: np.ndarray      # (L,) cm^-1
    eupper: np.ndarray      # (L,) cm^-1
    gup: np.ndarray         # (L,)
    glow: np.ndarray        # (L,)
    tag: np.ndarray         # (L,)
    qnformat: np.ndarray    # (L,)
    qn: np.ndarray          # (L, 12) decoded quantum numbers
    qns: int                # QNs per state (<= 6)
    intensity: np.ndarray   # (L,) linear intensity = 10**logint
    sijmu: np.ndarray       # (L,) line strength * dipole^2
    aij: np.ndarray         # (L,) Einstein A
    CT: float               # catalog temperature used for sijmu (300 K)

    def __len__(self) -> int:
        return int(self.frequency.shape[0])

    def trim_indices(self, ll: float, ul: float) -> tuple[int, int]:
        """Index range [i, i2) of lines in the window (ll, ul].

        Matches reference trim_array (reference functions.py:507-540):
        i = first index with frequency > ll, i2 = first with frequency > ul.
        """
        above_ll = np.where(self.frequency > ll)[0]
        if above_ll.size == 0:
            if self.frequency[-1] < ll:
                return 0, 0
            i = 0
        else:
            i = int(above_ll[0])
        above_ul = np.where(self.frequency > ul)[0]
        i2 = int(above_ul[0]) if above_ul.size else len(self)
        return i, i2


def _first_match_glow(uhash: np.ndarray, lhash: np.ndarray, gup: np.ndarray) -> np.ndarray:
    """glow[l] = gup[first i with uhash[i] == lhash[l]], else 1.

    Equivalent to `np.equal.outer(uhash, lhash).argmax(axis=0)` followed by
    the no-match fixup (reference classes.py:106-110), but O(n log n).
    """
    order = np.argsort(uhash, kind="stable")  # stable: equal hashes keep row order
    sorted_hash = uhash[order]
    pos = np.searchsorted(sorted_hash, lhash, side="left")
    pos_clipped = np.minimum(pos, len(sorted_hash) - 1)
    matched = sorted_hash[pos_clipped] == lhash
    first_idx = order[pos_clipped]
    glow = np.where(matched, gup[first_idx], 1)
    return glow.astype(np.int64)


def _tokenize_python(lines: list[str]) -> dict:
    """Pure-Python fixed-width tokenizer (reference classes.py:154-178)."""
    n = len(lines)
    frequency = np.empty(n, dtype=np.float64)
    error = np.empty(n, dtype=np.float64)
    logint = np.empty(n, dtype=np.float64)
    dof = np.empty(n, dtype=np.int64)
    elower = np.empty(n, dtype=np.float64)
    gup = np.empty(n, dtype=np.int64)
    tag = np.empty(n, dtype=np.int64)
    qnformat = np.empty(n, dtype=np.int64)
    qn_raw = [[""] * 12 for _ in range(n)]

    for i, ln in enumerate(lines):
        frequency[i] = float(ln[0:13])
        error[i] = float(ln[13:21])
        logint[i] = float(ln[21:29])
        dof[i] = int(ln[29:31])
        elower[i] = float(ln[31:41])
        gup_s = ln[41:44].strip()
        try:
            gup[i] = int(gup_s) if gup_s else 0
        except ValueError:
            gup[i] = _decode_qn(gup_s, has_pm=False)
        tag[i] = int(ln[44:51])
        qnformat[i] = int(ln[51:55])
        for q in range(11):
            qn_raw[i][q] = ln[55 + 2 * q: 57 + 2 * q].strip() if len(ln) > 55 + 2 * q else ""
        # qn12 runs to end of line, not 2 chars (reference classes.py:178:
        # qn12 = x[line][77:].strip()) — matters only for catalogs wider
        # than 79 columns, but the hash-matched glow depends on it.
        qn_raw[i][11] = ln[77:].strip() if len(ln) > 77 else ""

    # Column-wise parity detection, then per-field decode (reference
    # classes.py:180-214 applies fix_pm per column).
    qn = np.empty((n, 12), dtype=np.int64)
    for q in range(12):
        col = [qn_raw[i][q] for i in range(n)]
        has_pm = any(s == "+" or s == "-" for s in col)
        for i in range(n):
            qn[i, q] = _decode_qn(col[i], has_pm)

    return dict(frequency=frequency, error=error, logint=logint, dof=dof,
                elower=elower, gup=gup, tag=tag, qnformat=qnformat, qn=qn)


def parse_spcat(catalog_file: str, name: str | None = None, CT: float = 300.0) -> Catalog:
    """Parse an SPCAT .cat file into a :class:`Catalog`.

    Column layout (reference classes.py:154-178): freq [0:13], error [13:21],
    logint [21:29], dof [29:31], elower [31:41], gup [41:44], tag [44:51],
    qnformat [51:55], then twelve 2-char quantum numbers [55:79].

    Tokenization runs through the native C++ loader when it builds
    (catalogs/native.py over the port's copy of native/spcat_parser.cpp),
    falling back to the pure-Python tokenizer, as the JAX package does.
    Derived quantities follow reference
    classes.py:90-110 exactly; sijmu needs Q(CT), so the partition model is
    resolved here (late import avoids a module cycle: the generic Q
    fallback needs parsed QNs).
    """
    from cha1_mcmc_tpu_torch.catalogs.native import tokenize_native

    with open(catalog_file, "rb") as fh:
        raw = fh.read()
    fields = tokenize_native(raw)
    if fields is None:
        fields = _tokenize_python(
            [ln for ln in raw.decode().splitlines() if ln.strip()])

    frequency = fields["frequency"]
    error = fields["error"]
    logint = fields["logint"]
    dof = fields["dof"]
    elower = fields["elower"]
    gup = fields["gup"]
    tag = fields["tag"]
    qnformat = fields["qnformat"]
    qn = fields["qn"]
    n = frequency.shape[0]

    eupper = elower + frequency / EUPPER_CONV
    intensity = 10.0 ** logint
    qns = min(int(str(qnformat[0])[-1:] or 0), 6)

    cat = Catalog(
        name=name or os.path.splitext(os.path.basename(catalog_file))[0],
        catalog_file=catalog_file,
        frequency=frequency, error=error, logint=logint, dof=dof,
        elower=elower, eupper=eupper, gup=gup,
        glow=np.ones(n, dtype=np.int64),  # placeholder, replaced below
        tag=tag, qnformat=qnformat, qn=qn, qns=qns,
        intensity=intensity,
        sijmu=np.zeros(n), aij=np.zeros(n), CT=CT,
    )

    # Partition function at catalog temperature; then sijmu and aij
    # (reference classes.py:94-98).
    from cha1_mcmc_tpu_torch.catalogs.partition import q_model_for_catalog

    q_model = q_model_for_catalog(cat)
    Q_CT = float(q_model.host_eval(CT))
    sijmu = (
        (np.exp(-(elower / 0.695) / CT) - np.exp(-(eupper / 0.695) / CT)) ** (-1)
        * (intensity / frequency)
        * (SIJMU_CONST ** (-1))
        * Q_CT
    )
    aij = AIJ_CONST * frequency ** 3 * sijmu / gup

    # Lower-state degeneracy via QN-hash matching (reference classes.py:100-110).
    weights = np.array([1, 10, 100, 1000, 10000, 100000], dtype=np.int64)
    uhash = (qn[:, 0:6] * weights).sum(axis=1)
    lhash = (qn[:, 6:12] * weights).sum(axis=1)
    glow = _first_match_glow(uhash, lhash, gup)

    return dataclasses.replace(cat, sijmu=sijmu, aij=aij, glow=glow)


def load_catalog(catalog_file: str, name: str | None = None, CT: float = 300.0) -> Catalog:
    """Load and parse an SPCAT catalog file."""
    if not os.path.exists(catalog_file):
        raise FileNotFoundError(f"No catalog file found at {catalog_file}.")
    return parse_spcat(catalog_file, name=name, CT=CT)
