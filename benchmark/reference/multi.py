"""The N-component posterior of the GOTHAM multifit (the 4-component TMC-1
fit of the reference's scripts/MCMC/TMC1_four_component.py), written again
in NumPy (the reduction) and plain PyTorch (the model, the likelihood, the
prior): a configuration's `"reference": "multi"`.

theta = (ss_1..ss_N, Ncol_1..Ncol_N, Tex, vlsr_1..vlsr_N, dV): a source
size, a column density and a velocity per component, Tex and dV shared.

Reduction, float64: the catalog's stick spectrum at the fit's `fiducial`
(C, dV, T, source size) over its lines in (ll, ul] at `dish_size`,
(J(T) - J(2.7)) (1 - exp(-tau)) x dilution with the unguarded Planck J;
for every line brighter than 5% of the brightest, the channels whose
velocity (nu - f) / nu x 300,000 km/s lies strictly inside (5.3, 6.3)
km/s (the GOTHAM window, 5.8 +- 0.5, fixed whatever `source_velocity`
is), each with its noise (three passes of the GOTHAM estimator: the
window's channels within [chan - 10, chan + 10) of a 3.5-sigma outlier
of the raw window blanked, the first pass against the raw mean and sd,
the next two against the last pass's; a start below 0 wraps, as a
Python slice does, and blanks nothing in a window of 20 channels or
more) and yerr = sqrt(noise^2 + (0.1 intensity)^2). Where
`block_interlopers`, a window whose peak passes 6 noise sigma is left
out. Where windows overlap, the later line's values stand.

Model, on the reduced channels f_c, over the covered lines: per component
k the peak opacity tau_kl = (c / nu)^2 A gup N_kl (1 - exp(-h nu / k Tex))
/ (8 pi dV nu / c glow), N_kl = Ncol_k glow exp(-E_low / (0.695 Tex)) /
Q(Tex); opac_k(c) = sum over the lines whose velocity v_lc = (nu_l -
f_c) / nu_l x 2.998e5 (no offset) lies within 10 dV of the mask center
(`source_velocity`) of tau_kl exp(-z^2 / 2), z = (v_lc - vlsr_k) / (dV /
2.355); T(c) = sum over k of dil_k(c) (J(Tex) - J(2.7)) (1 -
exp(-opac_k(c))), each component through its own radiative transfer and
its own dilution ss_k^2 / (beam^2 + ss_k^2), beam = lambda 206265 x 1.22
/ dish, J with the 1e-10 guard. lnlike = -1/2 sum ((y - T)^2 / s^2 -
ln(1 / s^2)).

Prior: a strict box, 0 < ss_k < 200, 0 < Ncol_k < 1e16, vlsr_k <
vlsr_{k+1} - 0.05 and vlsr_{k+1} < vlsr_k + 0.3, dV < `dv_bound`, Tex >
2.7 (no other bound); Gaussians (with their normalisations) on each
ss_k and on Tex at the template's means and sds, on each vlsr_k at sd
0.8 mean dV and on dV at sd 0.3 mean dV; flat in Ncol. The means and sds
are the fit's `template_means` / `template_stds` (a template run).

Q(T) is the configuration's `partition` (catalog.py); for the synthetic
hc9n_hfs catalog it is the analytic 3 (0.02203968 + 71.7308577 T) that
the program chooses by the file's name.

As in model.py, the (line, channel) terms are held sparsely, those
within 10 dv_bound of the mask center, the only ones a theta inside the
box can reach; `scale` is 1/2 sum r^2 + |ln prior|; everything a theta
touches is computed in `dtype`. No departure from the program's
function is known; its order of operations differs, so float64 results
agree to rounding, not bitwise. Imports nothing of the program, JAX, the
repository's tests or its bench scripts.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.reference.catalog import Catalog, parse_catalog
from benchmark.reference.model import Posterior
from benchmark.reference.reduction import CM, T_CMB, dilution, planck, stick_taus

#: The GOTHAM reduction's window (km/s, strict), the speed of light it
#: converts with (km/s), its interloper threshold and the noise
#: estimator's outlier threshold (noise sigma).
WINDOW, C_GOTHAM, INTERLOPER_SIGMA, OUTLIER_SIGMA = (5.3, 6.3), 300000.0, 6.0, 3.5
#: The prior's box beside `dv_bound` (reference TMC1_four_component.py:224-231).
SS_BOUNDS, NCOL_BOUNDS, TEX_MIN, VLSR_MIN_SEP, VLSR_MAX_SEP = (
    (0.0, 200.0), (0.0, 1e16), 2.7, 0.05, 0.3)


def noise_std_gotham(x: np.ndarray) -> float:
    """The GOTHAM noise of a window's intensities (see the module's
    docstring)."""
    noise = np.array(x, dtype=np.float64)

    def blank(mean, std):
        low = np.nonzero(x - mean < -std * OUTLIER_SIGMA)[0]
        high = np.nonzero(x - mean > std * OUTLIER_SIGMA)[0]
        for chan in np.concatenate([low, high]):
            noise[chan - 10:chan + 10] = np.nan
        return np.nanmean(noise), np.nanstd(noise)

    mean, std = blank(np.nanmean(x), np.nanstd(x))
    mean, std = blank(mean, std)
    return float(blank(mean, std)[1])


def reduce_gotham(cat: Catalog, data: np.ndarray, *, ll, ul, fiducial, dish_size,
                  block_interlopers: bool):
    """(freqs, ints, yerrs, covered): the reduced channels and the indices
    of the covered lines among the catalog's lines in (ll, ul]."""
    i, i2 = cat.trim(ll, ul)
    C, dV, T, source_size = fiducial
    with np.errstate(under="ignore", over="ignore"):
        rf = cat.frequency[i:i2]
        tau = stick_taus(cat, C, T, dV)[i:i2]
        sticks = ((planck(rf, T) - planck(rf, T_CMB)) * (1.0 - np.exp(-tau))
                  * dilution(rf, source_size, dish_size))
    freqs = np.asarray(data[0], dtype=np.float64)
    ints = np.asarray(data[1], dtype=np.float64)
    out_f, out_i, out_e = (np.zeros(freqs.shape) for _ in range(3))
    covered = []
    lo, hi = WINDOW
    for k, f0 in enumerate(rf):
        if not sticks[k] > 0.05 * sticks.max():
            continue
        vel = (f0 - freqs) / f0 * C_GOTHAM
        locs = np.nonzero((vel < hi) & (vel > lo))[0]
        if locs.size == 0:
            continue
        sigma = noise_std_gotham(ints[locs])
        if block_interlopers and np.max(ints[locs]) > INTERLOPER_SIGMA * sigma:
            continue
        covered.append(k)
        out_f[locs], out_i[locs] = freqs[locs], ints[locs]
        out_e[locs] = np.sqrt(sigma ** 2 + (ints[locs] * 0.1) ** 2)
    keep = out_f > 0
    return out_f[keep], out_i[keep], out_e[keep], np.array(covered, dtype=np.int64)


def build(fitkw: dict, config: dict, device, dtype=torch.float64) -> "MultiPosterior":
    """The multi-component reference of a configuration (see
    check.Reference). Every field it reads must be in the configuration's
    `fit`: the reference takes no default of the program's."""
    if not fitkw["template_run"]:
        raise ValueError("the multi-component reference takes its prior from the "
                         "template (template_run true)")
    cat = parse_catalog(os.path.join(fitkw["cat_folder"], fitkw["mol_name"] + ".cat"),
                        config["partition"])
    data = np.load(fitkw["data_path"], allow_pickle=True)
    grid = reduce_gotham(cat, data, ll=fitkw["lower_limit"], ul=fitkw["upper_limit"],
                         fiducial=fitkw["fiducial"], dish_size=fitkw["dish_size"],
                         block_interlopers=fitkw["block_interlopers"])
    return MultiPosterior(cat, grid, fitkw, device=device, dtype=dtype)


class MultiPosterior(Posterior):
    """lnprob over (N, 3 ncomp + 2) thetas for one configuration and its
    reduced grid; `lnprob` (model.Posterior's) returns (lnp, scale),
    scale the size of the terms that depend on theta, 1/2 sum r^2 + |ln
    prior|. The lines, channels and sparse terms, each component's
    opacity, J(Tex) - J(2.7) and the likelihood are model.Posterior's;
    the dilution per component, the prior and theta's layout are its own."""

    def __init__(self, cat: Catalog, grid, fit: dict, *, device, dtype=torch.float64):
        self.ncomp = n = int(fit["ncomp"])
        self.dv_bound = float(fit["dv_bound"])
        t = self._lines_and_channels(cat, grid, fit, offset=0.0,
                                     center=float(fit["source_velocity"]),
                                     dv_max=self.dv_bound, device=device, dtype=dtype)
        beam = CM / (grid[0] * 1e6) * 206265.0 * 1.22 / fit["dish_size"]
        self.chan_beam2 = t(beam ** 2)
        means = np.asarray(fit["template_means"], np.float64)
        stds = np.asarray(fit["template_stds"], np.float64)
        if means.shape != (3 * n + 2,) or stds.shape != means.shape:
            raise ValueError(f"template_means / template_stds need {3 * n + 2} entries")
        mean_dv = float(means[3 * n + 1])
        # (column, mean, sd) of each Gaussian term
        self.gauss = ([(k, means[k], stds[k]) for k in range(n)]
                      + [(2 * n, means[2 * n], stds[2 * n])]
                      + [(2 * n + 1 + k, means[2 * n + 1 + k], 0.8 * mean_dv)
                         for k in range(n)]
                      + [(3 * n + 1, mean_dv, 0.3 * mean_dv)])

    def unpack(self, th):
        """(ss (N, n), Ncol (N, n), Tex (N,), vlsr (N, n), dV (N,))."""
        n = self.ncomp
        return (th[:, :n], th[:, n:2 * n], th[:, 2 * n], th[:, 2 * n + 1:3 * n + 1],
                th[:, 3 * n + 1])

    def lnprior(self, th):
        ss, ncol, tex, vlsr, dv = self.unpack(th)
        ok = torch.all((ss > SS_BOUNDS[0]) & (ss < SS_BOUNDS[1]), dim=1)
        ok &= torch.all((ncol > NCOL_BOUNDS[0]) & (ncol < NCOL_BOUNDS[1]), dim=1)
        ok &= torch.all(vlsr[:, :-1] < vlsr[:, 1:] - VLSR_MIN_SEP, dim=1)
        ok &= torch.all(vlsr[:, 1:] < vlsr[:, :-1] + VLSR_MAX_SEP, dim=1)
        ok &= (dv < self.dv_bound) & (tex > TEX_MIN)
        lp = torch.zeros(th.shape[0], dtype=th.dtype, device=th.device)
        for j, mean, sd in self.gauss:
            norm = math.log(1.0 / (math.sqrt(2.0 * math.pi) * sd))
            lp = lp + (norm - 0.5 * ((th[:, j] - mean) ** 2 / sd ** 2))
        return torch.where(ok, lp, torch.full_like(lp, -math.inf))

    def _lnprob(self, th):
        ss, ncol, tex, vlsr, dv = self.unpack(th)
        Tex, dV = tex[:, None], dv[:, None]
        Q = self.partition(tex)[:, None, None]
        opac = self._opacity(ncol[:, :, None], Tex[:, :, None], Q, vlsr[:, :, None],
                             dV[:, :, None])                                 # (N, n, C)
        s2 = (ss * ss)[:, :, None]
        dil = s2 / (self.chan_beam2 + s2)                                    # (N, n, C)
        model = torch.sum(dil * self._radiance(Tex)[:, None, :] * (1.0 - torch.exp(-opac)),
                          dim=1)
        return self._finish(model, self.lnprior(th))
