"""The single-component posterior in plain PyTorch: the LTE forward model
on the reduced channels, the chi^2 likelihood and the priors.

theta = (Ncol, Tex, vlsr, dV) at a fixed source size. Per line, the peak
opacity tau = (c / nu)^2 A gup N_l (1 - exp(-h nu / k Tex)) / (8 pi dV nu
/ c glow), with N_l = Ncol glow exp(-E_low / (0.695 Tex)) / Q(Tex); per
channel, opac = sum over lines of tau exp(-z^2 / 2), z = (v - vlsr) /
(dV / 2.355), over the lines whose velocity v at that channel lies within
10 dV of the mask center; then T = dilution (J(Tex) - J(2.7)) (1 -
exp(-opac)), J the Planck temperature with a 1e-10 guard. lnlike = -1/2
sum ((y - T)^2 / s^2 - ln(1 / s^2)); the prior is a strict box, Gaussians
on Tex, vlsr (sd 0.8 mean dV) and dV (sd 0.3 mean dV), flat in Ncol.

The (line, channel) terms are held sparsely: only those within 10 dV_max
of the mask center, dV_max the prior's bound, can contribute to a theta
inside the box. Everything a theta touches is computed in `dtype`:
float64 for the reference, bfloat16 for the lower-precision control.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.reference.catalog import KCM, Catalog, parse_catalog
from benchmark.reference.reduction import CKM, H, K, T_CMB, dilution, reduce

CCM = 2.998e10


def build(fitkw: dict, config: dict, device, dtype=torch.float64) -> "Posterior":
    """The default reference of a configuration (see check.Reference): the
    catalog parsed with the configuration's Q(T) (`partition`), the
    spectrum reduced at the fit's fixed source size, and the posterior in
    `dtype`."""
    cat = parse_catalog(os.path.join(fitkw["cat_folder"], fitkw["mol_name"] + ".cat"),
                        config["partition"])
    data = np.load(fitkw["data_path"], allow_pickle=True)
    f = fitkw
    grid = reduce(cat, data, ll=f["lower_limit"], ul=f["upper_limit"],
                  aligned_velocity=f["aligned_velocity"], dish_size=f["dish_size"],
                  source_size=f["fixed_source_size"])
    return Posterior(cat, grid, fitkw, device=device, dtype=dtype)


class Posterior:
    """lnprob over (N, 4) thetas for one configuration and its reduced
    grid; `lnprob` returns (lnp, scale), scale the size of the terms
    that depend on theta, 1/2 sum r^2 + |ln prior|. The constant 1/2 sum
    ln(1/s^2) is left out of it: on the dense band it is ~75,000 nats
    against ~5,500 that move, and a gap measured against it would pass
    an lnprob or a decision wrong by several nats."""

    def __init__(self, cat: Catalog, grid, fit: dict, *, device, dtype=torch.float64):
        self.bounds = {k: tuple(map(float, v)) for k, v in fit["bounds"].items()}
        t = self._lines_and_channels(cat, grid, fit, offset=fit["aligned_velocity"],
                                     center=fit["aligned_velocity"],
                                     dv_max=self.bounds["dV"][1], device=device, dtype=dtype)
        self.chan_dil = t(dilution(grid[0], fit["fixed_source_size"], fit["dish_size"]))
        means, stds = fit["template_means"], fit["template_stds"]
        if len(means) == 5:      # a fixed source size drops the first entry
            means, stds = means[1:], stds[1:]
        _, m_tex, m_vlsr, m_dv = means
        self.gauss = [(1, m_tex, stds[1]), (2, m_vlsr, 0.8 * m_dv), (3, m_dv, 0.3 * m_dv)]

    def _lines_and_channels(self, cat: Catalog, grid, fit: dict, *, offset, center, dv_max,
                            device, dtype):
        """Set what every posterior here holds of the covered lines and the
        reduced channels: the sparse (line, channel) terms within 10
        `dv_max` of `center` (a term's velocity (nu_l - f_c) / nu_l c +
        `offset`), the lines' factors of tau, the channels' Planck terms,
        the data and its weights, and Q(T)'s table. Returns the function
        that makes a tensor of the posterior's device and dtype."""
        freqs, ints, yerrs, covered = grid
        self.cat, self.grid = cat, grid
        self.device, self.dtype = torch.device(device), dtype
        i, _ = cat.trim(fit["lower_limit"], fit["upper_limit"])
        sel = i + np.asarray(covered, dtype=np.int64)
        lf = cat.frequency[sel]
        vel = (lf[:, None] - freqs[None, :]) / lf[:, None] * CKM + offset
        line, chan = np.nonzero(np.abs(vel - center) < 10.0 * dv_max)

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=self.device).to(dt)

        self.center = center
        self.n_channels = len(freqs)
        self.pair_line, self.pair_chan = t(line, torch.int64), t(chan, torch.int64)
        self.pair_vel = t(vel[line, chan])
        self.pair_dist = t(np.abs(vel[line, chan] - center))
        nu = lf * 1e6
        self.line_elower = t(cat.elower[sel])
        self.line_glow = t(cat.glow[sel].astype(np.float64))
        # Ncol-, Tex- and dV-free factors of tau
        self.line_a = t((CCM / nu) ** 2 * cat.aij[sel] * cat.gup[sel])
        self.line_hnu_k = t(H * nu / K)
        self.line_den = t(8.0 * np.pi * nu / CKM)
        x = H * freqs * 1e6 / K
        self.chan_x = t(x)
        self.chan_jbg = t(x / (np.exp(x / T_CMB) - 1.0 + 1e-10))
        self.y = t(ints)
        self.inv_s2 = t(1.0 / yerrs ** 2)
        self.log_inv_s2 = t(np.log(1.0 / yerrs ** 2))
        self.q = cat.q
        if cat.q["kind"] == "states":
            g, E = cat.state_table()
            self.q_g, self.q_E = t(g), t(E)
        return t

    def partition(self, Tex):
        if self.q["kind"] == "linear":
            return self.q["scale"] * (self.q["intercept"] + self.q["slope"] * Tex)
        return torch.sum(self.q_g * torch.exp(-self.q_E / (KCM * Tex[:, None])), dim=1)

    def lnprior(self, th):
        ok = torch.ones(th.shape[0], dtype=torch.bool, device=th.device)
        for j, key in enumerate(("Ncol", "Tex", "vlsr", "dV")):
            lo, hi = self.bounds[key]
            ok &= (th[:, j] > lo) & (th[:, j] < hi)
        lp = torch.zeros(th.shape[0], dtype=th.dtype, device=th.device)
        for j, mean, sd in self.gauss:
            norm = math.log(1.0 / (math.sqrt(2.0 * math.pi) * sd))
            lp = lp + (norm - 0.5 * ((th[:, j] - mean) ** 2 / sd ** 2))
        return torch.where(ok, lp, torch.full_like(lp, -math.inf))

    @torch.no_grad()
    def lnprob(self, theta, block: int = 64):
        """(lnp, scale), each (N,), in float64 whatever `dtype` computed."""
        theta = torch.as_tensor(np.asarray(theta, dtype=np.float64),
                                device=self.device).to(self.dtype)
        out = [self._lnprob(theta[i:i + block]) for i in range(0, theta.shape[0], block)]
        return tuple(torch.cat(x).double().cpu().numpy() for x in zip(*out))

    def _lnprob(self, th):
        Ncol, Tex, vlsr, dV = (th[:, j:j + 1] for j in range(4))
        Q = self.partition(Tex[:, 0])[:, None]
        opac = self._opacity(Ncol, Tex, Q, vlsr, dV)
        model = self.chan_dil * self._radiance(Tex) * (1.0 - torch.exp(-opac))
        return self._finish(model, self.lnprior(th))

    def _opacity(self, Ncol, Tex, Q, vlsr, dV):
        """opac (..., C) on the reduced channels: Ncol and vlsr (..., 1) of
        one component each, Tex, Q and dV (..., 1) broadcast against them."""
        Nl = Ncol * self.line_glow * torch.exp(-self.line_elower / (0.695 * Tex)) / Q
        tau = (self.line_a * Nl * (1.0 - torch.exp(-self.line_hnu_k / Tex))
               / (self.line_den * dV * self.line_glow))                       # (..., L)
        z = (self.pair_vel - vlsr) / (dV / 2.355)
        g = torch.where(self.pair_dist < 10.0 * dV, torch.exp(-0.5 * z * z),
                        torch.zeros((), dtype=z.dtype, device=z.device))
        terms = tau[..., self.pair_line] * g
        return torch.zeros(terms.shape[:-1] + (self.n_channels,), dtype=terms.dtype,
                           device=terms.device).index_add_(-1, self.pair_chan, terms)

    def _radiance(self, Tex):
        """J(Tex) - J(2.7) (N, C) on the reduced channels, Tex (N, 1)."""
        jt = self.chan_x / (torch.exp(self.chan_x / Tex) - 1.0 + 1e-10)
        return jt - self.chan_jbg

    def _finish(self, model, lp):
        """(lnp, scale) of the model (N, C) and the ln prior (N,)."""
        r2 = (self.y - model) ** 2 * self.inv_s2
        ll = -0.5 * torch.sum(r2 - self.log_inv_s2, dim=1)
        ok = torch.isfinite(ll) & torch.isfinite(lp)
        lnp = torch.where(ok, lp + ll, torch.full_like(ll, -math.inf))
        scale = 0.5 * torch.sum(r2, dim=1) + lp.abs()
        return lnp, scale
