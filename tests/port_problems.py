"""Synthetic problems shared by the JAX package's and the torch port's
tests, and by chip_smoke.py: the flagship HC5N fit (`write_hc5n_problem`)
and the 4-component GOTHAM HC9N multifit (`write_hc9n_problem`, see its
docstring).

NumPy only (no jax, no torch, no package import), so every consumer can
import it on any machine. From a seed `write_hc5n_problem` writes:

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
           "SOURCE_SIZE", "write_hc5n_problem", "GOTHAM_TRUTH",
           "write_hc9n_problem"]

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


def _catalog_rows(b_mhz=_B_MHZ, mu2=_MU2_DEBYE2, j_ups=range(2, 23),
                  hfs_mhz=lambda J: _HFS_MHZ):
    """(freq, elower, aij, gup, qn_up (J, F), qn_low (J, F)) per line,
    sorted by frequency: each J_up -> J_up - 1 transition of a linear
    rotor split into its three ΔF = ΔJ hyperfine components, offset by
    +hfs_mhz(J), 0 and -hfs_mhz(J)."""
    b_cm = b_mhz / 29979.2458
    rows = []
    for J in j_ups:
        nu0 = 2.0 * b_mhz * J
        a_j = 1.16395e-20 * nu0 ** 3 * mu2 * J / (2 * J + 1)
        df = hfs_mhz(J)
        for dF, off in ((1, df), (0, 0.0), (-1, -df)):
            F = J + dF
            rows.append((nu0 + off, b_cm * (J - 1) * J, a_j, 2 * F + 1,
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


# -- the GOTHAM HC9N 4-component problem --------------------------------------

#: Injected truth: the HC9N template means of the multifit
#: (cha1_mcmc_tpu/pipeline/multifit.py:30-31, reference
#: TMC1_four_component.py:292-294), theta = [ss x4 | Ncol x4 | Tex |
#: vlsr x4 | dV].
GOTHAM_TRUTH = (37.0, 25.0, 56.0, 22.0, 2.47e12, 11.19e12, 2.20e12, 5.64e12,
                6.7, 5.624, 5.790, 5.910, 6.033, 0.117)
GOTHAM_LL, GOTHAM_UL = 7000.0, 30000.0     # MultiFitConfig lower/upper limits
GOTHAM_DISH = 100.0
GOTHAM_CENTER = 5.8                        # mask center, km/s
_GOTHAM_FIDUCIAL = (7.0e11, 0.37, 8.0, 40.0)   # MultiFitConfig.fiducial
_GOTHAM_WINDOW = (5.3, 6.3)                # read_spectrum_gotham, c = 300000
_B9_MHZ = 290.5184          # rotational constant of the HC9N-like rotor
_MU2_HC9N = 5.2 ** 2
_CHAN_MHZ = 0.00122         # channel spacing: 22 multiplets give ~1,133 channels
_J9 = range(2, 61)


def _q_hc9n(T):
    """Analytic hc9n_hfs partition function, 3 * (0.02203968 + 71.7308577 T)."""
    return 3.0 * (0.02203968 + 71.7308577 * T)


def _hfs9(J):
    """Offset of the F = J +- 1 components from F = J, MHz: a nitrogen
    quadrupole splitting that falls off as 1/J^2 (9.5 kHz at J = 13)."""
    return 1.6 / J ** 2


def _lte_model(freqs, lf, le, la, lg, lgl, theta, ncomp):
    """Multi-component LTE brightness (f64) on `freqs` from the lines
    (lf, le, la, lg, lgl): the multifit's physics (stick opacities per
    component, windowed Gaussians around the mask center with no velocity
    offset, per-component Planck radiative transfer with the 1e-10 guard
    and beam dilution, summed over components)."""
    theta = np.asarray(theta, dtype=np.float64)
    ss, Ncol = theta[:ncomp], theta[ncomp:2 * ncomp]
    Tex, vlsr, dV = theta[2 * ncomp], theta[2 * ncomp + 1:3 * ncomp + 1], theta[-1]
    nu = lf * 1e6
    vel = (lf[:, None] - freqs[None, :]) / lf[:, None] * _CKM
    window = np.abs(vel - GOTHAM_CENTER) < 10 * dV
    sigma = dV / 2.355
    x = _H * freqs * 1e6 / _K
    J_T = x / (np.exp(x / Tex) - 1 + 1e-10)
    J_bg = x / (np.exp(x / 2.7) - 1 + 1e-10)
    beam = _CM / (freqs * 1e6) * 206265.0 * 1.22 / GOTHAM_DISH
    out = np.zeros_like(freqs)
    for k in range(ncomp):
        Nl = Ncol[k] * lgl * np.exp(-le / (0.695 * Tex)) / _q_hc9n(Tex)
        tau = ((_CCM / nu) ** 2 * la * lg * Nl * (1 - np.exp(-_H * nu / (_K * Tex)))
               / (8 * np.pi * (dV * nu / _CKM) * lgl))
        gauss = np.where(window, np.exp(-0.5 * ((vel - vlsr[k]) / sigma) ** 2), 0.0)
        dil = ss[k] ** 2 / (beam ** 2 + ss[k] ** 2)
        out += dil * (J_T - J_bg) * (1 - np.exp(-(tau @ gauss)))
    return out


def _fiducial_sticks(rows, glow):
    """The reduction's fiducial stick intensities (the multifit's
    simulate_sticks_host at MultiFitConfig.fiducial, unguarded Planck
    terms) of the lines in (GOTHAM_LL, GOTHAM_UL]: (indices, values)."""
    C, dV, T, ss = _GOTHAM_FIDUCIAL
    sel = np.array([i for i, r in enumerate(rows) if GOTHAM_LL < r[0] <= GOTHAM_UL])
    lf = np.array([rows[i][0] for i in sel])
    le = np.array([rows[i][1] for i in sel])
    la = np.array([rows[i][2] for i in sel])
    lg = np.array([rows[i][3] for i in sel], dtype=np.float64)
    lgl = glow[sel]
    nu = lf * 1e6
    Nl = C * lgl * np.exp(-le / (0.695 * T)) / _q_hc9n(T)
    tau = ((_CCM / nu) ** 2 * la * lg * Nl * (1 - np.exp(-_H * nu / (_K * T)))
           / (8 * np.pi * (dV * nu / _CKM) * lgl))
    x = _H * nu / _K
    J_T, J_bg = x / (np.exp(x / T) - 1), x / (np.exp(x / 2.7) - 1)
    beam = _CM / nu * 206265.0 * 1.22 / GOTHAM_DISH
    return sel, (J_T - J_bg) * (1 - np.exp(-tau)) * ss ** 2 / (beam ** 2 + ss ** 2)


def write_hc9n_problem(folder: str, n_multiplets: int = 22, seed: int = 0,
                       snr: float = 3.0) -> dict:
    """Write a synthetic GOTHAM HC9N problem into `folder`: the shape of
    the 4-component TMC-1 fit (reference TMC1_four_component.py) with
    the real inputs' structure.

    * ``catalog/hc9n_hfs.cat`` — an HC9N-like linear rotor (B = 290.5
      MHz, J_up = 2..60), each rotational transition split into its three
      ΔF = ΔJ hyperfine components whose lower states chain to upper
      states (so the degeneracy hash finds glow). The filename makes
      `q_model_for_catalog` pick the analytic hc9n Q(T).
    * ``gotham_hc9n_chunks.npy`` — a (2, N) GOTHAM spectrum at 1.4 kHz
      channels: one chunk per covered multiplet (the `n_multiplets`
      multiplets brightest in the reduction's fiducial simulation), each
      spanning its triplet's (5.3, 6.3) km/s reduction windows plus four
      channels a side, with the 4-component LTE signal injected at
      GOTHAM_TRUTH and Gaussian noise putting the brightest channel at
      `snr` sigma.

    At the default 22 multiplets the reduction keeps 66 lines x ~1,100
    channels (tens of channels per line window); the hfs triplets share
    one ±10·dV_max window start, every window is contiguous in channel
    order, and the chunks lie hundreds of MHz apart. The default seed
    keeps every line through the 6-sigma interloper test.

    Returns a dict with `cat_folder`, `cat_path`, `data_path`, `truth`,
    `n_lines` and `noise_sigma`."""
    rows = _catalog_rows(_B9_MHZ, _MU2_HC9N, _J9, _hfs9)
    glow = _glow(rows)
    cat_folder = os.path.join(folder, "catalog")
    os.makedirs(cat_folder, exist_ok=True)
    cat_path = os.path.join(cat_folder, "hc9n_hfs.cat")
    q300 = _q_hc9n(300.0)
    with open(cat_path, "w") as fh:
        for r in rows:
            fh.write(_spcat_line(*r, q300) + "\n")

    sel, ints = _fiducial_sticks(rows, glow)
    by_j = {}
    for i, val in zip(sel, ints):
        by_j.setdefault(rows[i][4][0], []).append((i, val))
    # the multiplets whose weakest component is brightest; every chosen
    # line must pass the reduction's 5%-of-peak test
    ranked = sorted((J for J, ls in by_j.items() if len(ls) == 3),
                    key=lambda J: -min(v for _, v in by_j[J]))
    chosen = sorted(ranked[:n_multiplets])
    if len(chosen) < n_multiplets or min(
            v for J in chosen for _, v in by_j[J]) <= 0.05 * ints.max():
        raise ValueError(f"{n_multiplets} multiplets do not all pass the "
                         "reduction's 5% test")

    lo, hi = _GOTHAM_WINDOW
    chunks = []
    for J in chosen:
        rf = np.array([rows[i][0] for i, _ in by_j[J]])
        f0 = rf.min() * (1 - hi / 300000.0) - 4 * _CHAN_MHZ
        f1 = rf.max() * (1 - lo / 300000.0) + 4 * _CHAN_MHZ
        chunks.append(f0 + _CHAN_MHZ * np.arange(int((f1 - f0) / _CHAN_MHZ) + 1))
    freqs = np.concatenate(chunks)
    idx = [i for J in chosen for i, _ in by_j[J]]
    line_arrays = [np.array([rows[i][c] for i in idx], dtype=np.float64)
                   for c in range(4)]
    signal = _lte_model(freqs, *line_arrays, glow[idx], GOTHAM_TRUTH, 4)
    sigma = float(signal.max()) / snr
    rng = np.random.default_rng(seed)
    data_path = os.path.join(folder, "gotham_hc9n_chunks.npy")
    np.save(data_path, np.stack([freqs, signal + rng.normal(0.0, sigma, freqs.size)]))
    return dict(cat_folder=cat_folder, cat_path=cat_path, data_path=data_path,
                truth=GOTHAM_TRUTH, n_lines=3 * n_multiplets, noise_sigma=sigma)
