"""Synthetic flagship problem shared by the JAX package's and the torch
port's tests, and by chip_smoke.py.

NumPy only (no jax, no torch, no package import), so every consumer can
import it on any machine. From a seed it writes:

* ``hc5n_hfs.cat`` — a 63-transition SPCAT catalog in the fixed-width
  layout the parsers read (freq [0:13], error [13:21], logint [21:29],
  dof [29:31], elower [31:41], gup [41:44], tag [44:51], qnformat [51:55],
  then twelve 2-char quantum numbers). 21 rotational transitions
  J_up = 2..22 of an HC5N-like linear rotor, each split into the three
  strong ΔF = ΔJ hyperfine components. Only J_up = 7, 8, 9 fall inside the
  (18 000, 25 000] MHz window, so 9 lines are in reach of the spectrum.
  The filename makes the partition-function dispatch pick the analytic
  hc5n Q(T), and upper/lower quantum numbers chain so the lower-state
  degeneracy hash match finds every in-window line's lower state.
* a (2, 561) spectrum ``.npy`` — three 187-channel chunks, one per
  in-window J, with an LTE signal injected at the truth below and Gaussian
  noise whose sigma puts the brightest injected peak at 2 sigma (so the
  reduction's 3.5-sigma interloper test keeps the lines).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["TRUTH", "LL", "UL", "ALIGNED_VELOCITY", "DISH_SIZE",
           "SOURCE_SIZE", "write_hc5n_problem"]

# Injected truth (Ncol cm^-2, Tex K, vlsr km/s, dV km/s).
TRUTH = (3.2e12, 7.5, 4.11, 0.78)
LL, UL = 18_000.0, 25_000.0
ALIGNED_VELOCITY = 4.10
DISH_SIZE = 70.0
SOURCE_SIZE = 52.0

_B_MHZ = 1331.3313          # rotational constant of the synthetic rotor
_MU2_DEBYE2 = 4.33 ** 2     # dipole moment squared
_HFS_MHZ = 0.15             # hyperfine splitting of the three components
_N_CHUNK = 187              # channels per spectral chunk (3 x 187 = 561)
_CKM = 2.998e5
_H, _K, _CCM, _CM = 6.626e-34, 1.381e-23, 2.998e10, 2.998e8


def _q_hc5n(T):
    """Analytic hc5n_hfs partition function, 3 * (0.2214 + 15.65419 T)."""
    return 3.0 * (0.2214 + 15.65419 * T)


def _catalog_rows():
    """(freq, elower, aij, gup, qn_up (J, F), qn_low (J, F)) per line,
    sorted by frequency."""
    b_cm = _B_MHZ / 29979.2458
    rows = []
    for J in range(2, 23):
        nu0 = 2.0 * _B_MHZ * J
        a_j = 1.16395e-20 * nu0 ** 3 * _MU2_DEBYE2 * J / (2 * J + 1)
        for dF, df in ((1, _HFS_MHZ), (0, 0.0), (-1, -_HFS_MHZ)):
            F = J + dF
            rows.append((nu0 + df, b_cm * (J - 1) * J, a_j, 2 * F + 1,
                         (J, F), (J - 1, F - 1)))
    rows.sort(key=lambda r: r[0])
    return rows


def _spcat_line(freq, elower, aij, gup, qn_up, qn_low, q300):
    """One fixed-width SPCAT record whose derived aij reproduces `aij`
    (inverting the parser's sijmu / Einstein-A relations at 300 K)."""
    eupper = elower + freq / 29979.2458
    sijmu = aij * gup / (1.16395e-20 * freq ** 3)
    boltz = np.exp(-(elower / 0.695) / 300.0) - np.exp(-(eupper / 0.695) / 300.0)
    intensity = sijmu * 4.16231e-5 * freq * boltz / q300
    qns = "".join(f"{q:2d}" for q in qn_up) + " " * 8
    qns += "".join(f"{q:2d}" for q in qn_low) + " " * 8
    return (f"{freq:13.4f}{0.001:8.4f}{np.log10(intensity):8.4f}{3:2d}"
            f"{elower:10.4f}{gup:3d}{75503:7d}{1302:4d}{qns}")


def _glow(rows):
    gup_of = {r[4]: r[3] for r in rows}
    return np.array([gup_of.get(r[5], 1) for r in rows], dtype=np.float64)


def _inject(freqs, rows, glow):
    """LTE model brightness at the truth on the channel grid (f64): the
    same physics the packages fit (stick opacities, windowed Gaussians
    in the aligned-velocity frame, Planck radiative transfer with the
    1e-10 guard, beam dilution)."""
    Ncol, Tex, vlsr, dV = TRUTH
    sel = [i for i, r in enumerate(rows) if LL < r[0] <= UL]
    lf = np.array([rows[i][0] for i in sel])
    le = np.array([rows[i][1] for i in sel])
    la = np.array([rows[i][2] for i in sel])
    lg = np.array([rows[i][3] for i in sel], dtype=np.float64)
    lgl = glow[sel]
    Nl = Ncol * lgl * np.exp(-le / (0.695 * Tex)) / _q_hc5n(Tex)
    nu = lf * 1e6
    tau = ((_CCM / nu) ** 2 * la * lg * Nl * (1 - np.exp(-_H * nu / (_K * Tex)))
           / (8 * np.pi * (dV * nu / _CKM) * lgl))
    vel = (lf[:, None] - freqs[None, :]) / lf[:, None] * _CKM + ALIGNED_VELOCITY
    sigma = dV / 2.355
    gauss = np.where(np.abs(vel - ALIGNED_VELOCITY) < 10 * dV,
                     np.exp(-0.5 * ((vel - vlsr) / sigma) ** 2), 0.0)
    opac = tau @ gauss
    x = _H * freqs * 1e6 / _K
    J_T = x / (np.exp(x / Tex) - 1 + 1e-10)
    J_bg = x / (np.exp(x / 2.7) - 1 + 1e-10)
    beam = _CM / (freqs * 1e6) * 206265.0 * 1.22 / DISH_SIZE
    dil = SOURCE_SIZE ** 2 / (beam ** 2 + SOURCE_SIZE ** 2)
    return dil * (J_T - J_bg) * (1 - np.exp(-opac))


def write_hc5n_problem(folder: str, seed: int = 4) -> dict:
    """Write the synthetic catalog and spectrum into `folder`.

    The default noise seed keeps all 9 in-window lines through the
    reduction (561 channels); other seeds lose one or two lines to the
    interloper test on a noise spike, as real data can.

    Returns a dict with `cat_folder`, `cat_path`, `data_path`, `truth`
    and `noise_sigma`. The catalog goes to
    ``<folder>/catalog/hc5n_hfs.cat`` (the layout FitConfig expects:
    cat_folder + mol_name + '.cat'), the spectrum to
    ``<folder>/hc5n_spectrum.npy``."""
    rows = _catalog_rows()
    q300 = _q_hc5n(300.0)
    cat_folder = os.path.join(folder, "catalog")
    os.makedirs(cat_folder, exist_ok=True)
    cat_path = os.path.join(cat_folder, "hc5n_hfs.cat")
    with open(cat_path, "w") as fh:
        for r in rows:
            fh.write(_spcat_line(*r, q300) + "\n")

    # Three chunks centred on the in-window J multiplets; each spans the
    # union of its components' +-1.5 km/s reduction windows, so every
    # channel lands in some window (tens of channels per window).
    chunks = []
    for J in (7, 8, 9):
        nu0 = 2.0 * _B_MHZ * J
        w = nu0 * 1.5 / _CKM
        half = _HFS_MHZ + 0.9 * w
        chunks.append(nu0 + np.linspace(-half, half, _N_CHUNK))
    freqs = np.concatenate(chunks)
    signal = _inject(freqs, rows, _glow(rows))
    sigma = float(signal.max()) / 2.0
    rng = np.random.default_rng(seed)
    ints = signal + rng.normal(0.0, sigma, freqs.size)
    data_path = os.path.join(folder, "hc5n_spectrum.npy")
    np.save(data_path, np.stack([freqs, ints]))
    return dict(cat_folder=cat_folder, cat_path=cat_path,
                data_path=data_path, truth=TRUTH, noise_sigma=sigma)
