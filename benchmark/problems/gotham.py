"""The synthetic GOTHAM HC9N problem of the 4-component TMC-1 multifit
(`write_hc9n_problem`; see its docstring).

A frozen copy of the writer of the repository's test helpers
(tests/port_problems.py, with its constants), so that a later change to
the tests cannot move the benchmark's inputs; the rotor's catalog rows,
SPCAT records and lower-state degeneracies come from the frozen
benchmark/problems/synthetic.py, whose helpers are the same as the
tests'. NumPy only. The same arguments write the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.problems.synthetic import (_CCM, _CKM, _CM, _H, _K, _catalog_rows,
                                          _glow, _spcat_line)

__all__ = ["GOTHAM_TRUTH", "GOTHAM_LL", "GOTHAM_UL", "GOTHAM_DISH", "GOTHAM_CENTER",
           "write_hc9n_problem"]

#: Injected truth: the HC9N template means of the multifit (reference
#: TMC1_four_component.py:292-294), theta = [ss x4 | Ncol x4 | Tex |
#: vlsr x4 | dV].
GOTHAM_TRUTH = (37.0, 25.0, 56.0, 22.0, 2.47e12, 11.19e12, 2.20e12, 5.64e12,
                6.7, 5.624, 5.790, 5.910, 6.033, 0.117)
GOTHAM_LL, GOTHAM_UL = 7000.0, 30000.0     # the multifit's lower / upper limits
GOTHAM_DISH = 100.0
GOTHAM_CENTER = 5.8                        # mask center, km/s
_GOTHAM_FIDUCIAL = (7.0e11, 0.37, 8.0, 40.0)   # the reduction's (C, dV, T, source size)
_GOTHAM_WINDOW = (5.3, 6.3)                # the GOTHAM reduction's window, c = 300000
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
    (lf, le, la, lg, lgl): stick opacities per component, windowed
    Gaussians around the mask center with no velocity offset,
    per-component Planck radiative transfer with the 1e-10 guard and beam
    dilution, summed over components."""
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
    """The reduction's fiducial stick intensities (at _GOTHAM_FIDUCIAL,
    unguarded Planck terms) of the lines in (GOTHAM_LL, GOTHAM_UL]:
    (indices, values)."""
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
      states (so the degeneracy hash finds glow). The filename makes the
      program pick the analytic hc9n Q(T).
    * ``gotham_hc9n_chunks.npy`` — a (2, N) GOTHAM spectrum at 1.22 kHz
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
