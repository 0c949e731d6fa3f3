"""Synthetic problems of the benchmark's configurations: the flagship HC5N
fit (`write_hc5n_problem`) and the dense asymmetric-top fit
(`write_dense_problem`); see their docstrings.

A frozen copy of the two writers of the repository's test helpers
(tests/port_problems.py, with their constants), so that a later change to
the tests cannot move the benchmark's inputs. NumPy only. From a seed
`write_hc5n_problem` writes:

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
           "SOURCE_SIZE", "write_hc5n_problem", "DENSE_NAME", "DENSE_CENTER",
           "DENSE_DISH", "DENSE_SOURCE_SIZE", "DENSE_BOUNDS", "write_dense_problem"]

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


def _spcat_line(freq, elower, aij, gup, qn_up, qn_low, q300, qnformat=1302):
    """One fixed-width SPCAT record whose derived aij reproduces `aij`
    (inverting the parser's sijmu / Einstein-A relations at 300 K); the
    last digit of `qnformat` is the number of quantum numbers per state."""
    eupper = elower + freq / 29979.2458
    sijmu = aij * gup / (1.16395e-20 * freq ** 3)
    boltz = np.exp(-(elower / 0.695) / 300.0) - np.exp(-(eupper / 0.695) / 300.0)
    intensity = sijmu * 4.16231e-5 * freq * boltz / q300
    pad = " " * (12 - 2 * len(qn_up))
    qns = "".join(_qn2(q) for q in qn_up) + pad
    qns += "".join(_qn2(q) for q in qn_low) + pad
    return (f"{freq:13.4f}{0.001:8.4f}{np.log10(intensity):8.4f}{3:2d}"
            f"{elower:10.4f}{gup:3d}{75503:7d}{qnformat:4d}{qns}")


def _qn2(q: int) -> str:
    """A quantum number as SPCAT's 2-character field: 100 and above as a
    letter and a digit (A0 = 100, B3 = 113)."""
    if q < 100:
        return f"{q:2d}"
    return "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[(q - 100) // 10] + str((q - 100) % 10)


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


# -- the dense asymmetric-top problem -------------------------------------------

#: The dense single-component fit, shaped after the JAX package's
#: dense-aromatic case (tools/dense_full_fit.py: a 1-cyanonaphthalene
#: catalog, whose file is not in the repository, under a DSN-style
#: spectrum with a weak injected signal): 100 m dish, aligned velocity
#: 5.8 km/s, 14 kHz channels, 1 mK noise, injected peak at 1.5 sigma
#: (below the reduction's 3.5-sigma interloper test), fixed 52" source.
DENSE_NAME = "dense_asym_top"
DENSE_CENTER = 5.8
DENSE_DISH = 100.0
DENSE_SOURCE_SIZE = 52.0
DENSE_NOISE = 1.0e-3
DENSE_PEAK_SNR = 1.5
DENSE_BOUNDS = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
                "Tex": (3.5, 12.0), "vlsr": (4.0, 7.5), "dV": (0.4, 1.5)}
#: (Tex, vlsr, dV) of the injected signal; Ncol is calibrated per problem
#: so the brightest channel sits at DENSE_PEAK_SNR sigma.
DENSE_TEX, DENSE_VLSR, DENSE_DV = 8.0, 5.8, 0.7575
_DENSE_DF = 0.014                 # raw channel width, MHz
_DENSE_FIDUCIAL = (3.4e12, 0.89, 7.0)   # the reduction's (C, dV, T)
#: Near-prolate asymmetric rotor, MHz: mean of B and C, A - (B+C)/2, the
#: centrifugal terms D_J and D_JK, and the Ka = 1 asymmetry splitting per
#: J(J+1) (shrinking 10x for every further Ka); dipole in Debye.
_DENSE_BBAR, _DENSE_A_MINUS_B = 100.0, 900.0
_DENSE_DJ, _DENSE_DJK = 2e-6, 4e-4
_DENSE_SPLIT = 0.004
_DENSE_MU2, _DENSE_MUB2 = 4.0 ** 2, 3.0 ** 2
_DENSE_JMAX, _DENSE_KMAX = 120, 60
#: (ll, ul) of the spectrum per scale, MHz.
_DENSE_BANDS = {"full": (6000.0, 24000.0), "small": (9700.0, 10500.0)}


def _dense_levels():
    """(J, Ka, Kc, s, E MHz) of every rotational level: Ka <= min(J,
    KMAX), two asymmetry components s = +-1 for Ka >= 1 (Kc = J - Ka + 1
    and J - Ka), one for Ka = 0 (Kc = J)."""
    J, Ka, Kc, s = [], [], [], []
    for j in range(_DENSE_JMAX + 1):
        for ka in range(min(j, _DENSE_KMAX) + 1):
            for sign in ((0,) if ka == 0 else (1, -1)):
                J.append(j), Ka.append(ka), s.append(sign)
                Kc.append(j - ka + (1 if sign > 0 else 0))
    J, Ka, Kc, s = (np.array(x) for x in (J, Ka, Kc, s))
    jj = J * (J + 1.0)
    split = np.where(Ka > 0, _DENSE_SPLIT * jj * 0.1 ** np.maximum(Ka - 1, 0), 0.0)
    E = (_DENSE_BBAR * jj + _DENSE_A_MINUS_B * Ka ** 2 - _DENSE_DJ * jj ** 2
         - _DENSE_DJK * jj * Ka ** 2 + 0.5 * s * split)
    return J, Ka, Kc, s, E


def _dense_lines():
    """The a-type R branch (J+1, Ka, Kc+1) <- (J, Ka, Kc) and the b-type
    Q branch (J, Ka+1) <- (J, Ka) of the rotor, sorted by frequency: (freq MHz, elower cm^-1 as the catalog rounds it,
    aij, gup, qn_up, qn_low)."""
    J, Ka, Kc, s, E = _dense_levels()
    index = {(j, ka, sg): i for i, (j, ka, sg) in enumerate(zip(J, Ka, s))}
    lines = []
    for i in range(J.size):
        up = index.get((J[i] + 1, Ka[i], s[i]))
        if up is None:
            continue
        freq = E[up] - E[i]
        jp = J[i] + 1
        strength = (jp ** 2 - Ka[i] ** 2) / jp
        if freq <= 0 or strength <= 0:
            continue
        aij = 1.16395e-20 * freq ** 3 * _DENSE_MU2 * strength / (2 * jp + 1)
        elower = float(f"{E[i] / 29979.2458:10.4f}")
        lines.append((freq, elower, aij, 2 * jp + 1,
                      (jp, Ka[i], Kc[i] + 1), (J[i], Ka[i], Kc[i])))
        # b-type Q branch (J, Ka+1) <- (J, Ka): every J of one Ka piles up
        # near (2 Ka + 1)(A - B), as the aromatics' Q-branch heads do
        up = index.get((J[i], Ka[i] + 1, s[i] if Ka[i] else 1))
        if up is None or J[i] == 0:
            continue
        freq = E[up] - E[i]
        strength = (Ka[i] + 1) ** 2 * (2 * J[i] + 1) / (J[i] * (J[i] + 1.0))
        if freq <= 0:
            continue
        aij = 1.16395e-20 * freq ** 3 * _DENSE_MUB2 * strength / (2 * J[i] + 1)
        lines.append((freq, elower, aij, 2 * J[i] + 1,
                      (J[i], Ka[i] + 1, Kc[up]), (J[i], Ka[i], Kc[i])))
    lines.sort(key=lambda r: r[0])
    return lines


def _dense_q(lines, T):
    """The catalog's state-sum Q(T) as the parser derives it: unique
    (J, Ka, Kc, elower) lower states, g = 2J + 1."""
    rows = np.unique(np.array([(*r[5], r[1]) for r in lines]), axis=0)
    T = np.asarray(T, dtype=np.float64)
    return np.sum((2 * rows[:, 0] + 1)
                  * np.exp(-rows[:, 3] / (0.69503476 * T[..., None])), axis=-1)


def _dense_taus(lf, le, la, lg, Ncol, Tex, dV, Q):
    """Stick opacities (glow cancels from the tau formula)."""
    nu = lf * 1e6
    Nl = Ncol * np.exp(-le / (0.695 * Tex)) / Q
    return ((_CCM / nu) ** 2 * la * lg * Nl * (1 - np.exp(-_H * nu / (_K * Tex)))
            / (8 * np.pi * (dV * nu / _CKM)))


def _dense_signal(freqs, lf, le, la, lg, Ncol, Q):
    """LTE brightness at the injected (Tex, vlsr, dV) on `freqs`, f64: the
    packages' single-component physics in the aligned-velocity frame."""
    taus = _dense_taus(lf, le, la, lg, Ncol, DENSE_TEX, DENSE_DV, Q)
    sigma = DENSE_DV / 2.355
    opac = np.zeros_like(freqs)
    for s in range(0, lf.size, 256):
        l = lf[s:s + 256, None]
        vel = (l - freqs[None, :]) / l * _CKM + DENSE_CENTER
        gauss = np.where(np.abs(vel - DENSE_CENTER) < 10 * DENSE_DV,
                         np.exp(-0.5 * ((vel - DENSE_VLSR) / sigma) ** 2), 0.0)
        opac += taus[s:s + 256] @ gauss
    x = _H * freqs * 1e6 / _K
    J_T = x / (np.exp(x / DENSE_TEX) - 1 + 1e-10)
    J_bg = x / (np.exp(x / 2.7) - 1 + 1e-10)
    beam = _CM / (freqs * 1e6) * 206265.0 * 1.22 / DENSE_DISH
    dil = DENSE_SOURCE_SIZE ** 2 / (beam ** 2 + DENSE_SOURCE_SIZE ** 2)
    return dil * (J_T - J_bg) * (1 - np.exp(-opac))


def write_dense_problem(folder: str, scale: str = "full", seed: int = 7) -> dict:
    """Write the synthetic dense problem into `folder` and print its
    geometry.

    * ``catalog/dense_asym_top.cat`` — 21,481 lines of a near-prolate
      asymmetric rotor (quantum numbers J, Ka, Kc; qnformat 1303; J <= 120,
      Ka <= 60): its a-type R branch, whose Ka ladders spread each J's
      lines over tens of MHz, and its b-type Q branches, whose low-J lines
      pile up within a few MHz of each head. Their 10,860 distinct lower
      states feed the state-sum Q(T): the name matches no analytic Q, so
      the packages take the fallback, as they do for 1-cyanonaphthalene.
    * ``dense_spectrum.npy`` — a (2, N) spectrum on a 14 kHz channel
      lattice over the scale's band, in chunks around every line the
      reduction can select (each line's +-1.5 km/s window and four
      channels a side), with the LTE signal of those lines injected at
      (Ncol, DENSE_TEX, DENSE_VLSR, DENSE_DV) and 1 mK Gaussian noise;
      Ncol puts the brightest channel at 1.5 sigma.

    After the packages' reduction (aligned velocity DENSE_CENTER, dish
    DENSE_DISH, source size DENSE_SOURCE_SIZE), scale="full" (6-24 GHz)
    gives 2,232 lines x 10,924 channels (n_lines x n_channels > 4e6, so
    the fit auto-selects the sparse path) and, at the prior's dV bound
    1.5, a split gather table with M1 = 9 lines per channel and M2 = 11
    more on 1,467 heavy channels; scale="small" (9.7-10.5 GHz) gives 228
    lines x 858 channels (M1 = 9, M2 = 11, 141 heavy channels) for the
    CPU tests. Returns a dict with `cat_folder`, `cat_path`, `data_path`,
    `truth` (Ncol, Tex, vlsr, dV), `ll`, `ul` and
    `noise_sigma`."""
    ll, ul = _DENSE_BANDS[scale]
    lines = _dense_lines()
    q300 = float(_dense_q(lines, 300.0))
    cat_folder = os.path.join(folder, "catalog")
    os.makedirs(cat_folder, exist_ok=True)
    cat_path = os.path.join(cat_folder, f"{DENSE_NAME}.cat")
    with open(cat_path, "w") as fh:
        for r in lines:
            fh.write(_spcat_line(*r, q300, qnformat=1303) + "\n")

    # the lines the reduction can select: fiducial stick intensity, beam
    # diluted, above 5% of the band's peak (reduce/datagrid.py:read_spectrum)
    band = [r for r in lines if ll < r[0] <= ul]
    lf, le, la, lg = (np.array([r[c] for r in band], dtype=np.float64)
                      for c in range(4))
    C0, dV0, T0 = _DENSE_FIDUCIAL
    tau0 = _dense_taus(lf, le, la, lg, C0, T0, dV0, float(_dense_q(lines, T0)))
    x = _H * lf * 1e6 / _K
    beam = _CM / (lf * 1e6) * 206265.0 * 1.22 / DENSE_DISH
    stick = ((x / (np.exp(x / T0) - 1) - x / (np.exp(x / 2.7) - 1)) * (1 - np.exp(-tau0))
             * DENSE_SOURCE_SIZE ** 2 / (beam ** 2 + DENSE_SOURCE_SIZE ** 2))
    keep = stick > 0.05 * stick.max()
    lf, le, la, lg = lf[keep], le[keep], la[keep], lg[keep]

    # channel lattice: each kept line's window plus four channels a side
    f0 = ll
    lo = np.floor((lf * (1 - 1.5 / _CKM) - f0) / _DENSE_DF).astype(np.int64) - 4
    hi = np.ceil((lf * (1 + 1.5 / _CKM) - f0) / _DENSE_DF).astype(np.int64) + 4
    idx = np.unique(np.concatenate([np.arange(a, b + 1) for a, b in zip(lo, hi)]))
    freqs = f0 + _DENSE_DF * idx
    Q = float(_dense_q(lines, DENSE_TEX))
    ncol = 1e12
    for _ in range(2):
        ncol *= DENSE_PEAK_SNR * DENSE_NOISE / float(
            _dense_signal(freqs, lf, le, la, lg, ncol, Q).max())
    signal = _dense_signal(freqs, lf, le, la, lg, ncol, Q)
    rng = np.random.default_rng(seed)
    data_path = os.path.join(folder, "dense_spectrum.npy")
    np.save(data_path, np.stack([freqs, signal + rng.normal(0.0, DENSE_NOISE,
                                                            freqs.size)]))
    print(f"write_dense_problem({scale!r}): {len(lines)} catalog lines, "
          f"{keep.sum()} selectable in ({ll:.0f}, {ul:.0f}] MHz, "
          f"{freqs.size} raw channels, Ncol {ncol:.4e}", flush=True)
    return dict(cat_folder=cat_folder, cat_path=cat_path, data_path=data_path,
                truth=(ncol, DENSE_TEX, DENSE_VLSR, DENSE_DV), ll=ll, ul=ul,
                noise_sigma=DENSE_NOISE)
