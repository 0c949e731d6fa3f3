"""Log-prior functions, batched over walkers.

Port of cha1_mcmc_tpu/inference/priors.py. Reference semantics reproduced
exactly:
  * hard box bounds with *strict* inequalities return -inf
    (reference inference.py:169-190);
  * Gaussian priors with normalization term ln(1/(sqrt(2 pi) sigma)), with
    sigma_vlsr overridden to 0.8 * mean_dV and sigma_dV to 0.3 * mean_dV
    (reference inference.py:200-201, 221-222);
  * flat (zero) prior on every Ncol (reference inference.py:208, 230,
    TMC1_four_component.py:260);
  * multi-component runs add velocity ordering constraints
    vlsr_i < vlsr_{i+1} - 0.05 and vlsr_{i+1} < vlsr_i + 0.3
    (reference TMC1_four_component.py:230-231).

The box check is a `where(ok, value, -inf)` at the same decision points
where the reference returns -inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cha1_mcmc_tpu_torch.inference.params import ParamSpec

__all__ = ["single_component_lnprior", "ordered_velocity_lnprior"]


def _gauss_norm(std: float, dtype) -> float:
    """ln(1/(sqrt(2 pi) std)) evaluated in `dtype` (the JAX package
    evaluates it in the walkers' dtype), returned as a Python float that
    is exact in `dtype`."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype)
    return float(torch.log(1.0 / (torch.sqrt(two_pi) * std)))


def _log_gauss(x, mean, std, norm):
    return norm - 0.5 * ((x - mean) ** 2 / std ** 2)


def _strictly_inside(x, lo, hi):
    return (x > lo) & (x < hi)


def single_component_lnprior(spec: ParamSpec, bounds: dict, prior_means, prior_stds,
                             weight: float = 1.0, *, dtype=torch.float32):
    """Batched lnprior, (N, D) -> (N,), for the 4/5-dim single-component
    layouts (reference inference.py:193-236).

    `bounds` maps 'source_size' / 'Ncol' / 'Tex' / 'vlsr' / 'dV' to (lo, hi).
    `prior_means` / `prior_stds` follow the theta layout of `spec`. `dtype`
    is the walkers' dtype, in which the Gaussian normalizations are
    rounded.
    """
    if spec.ncomp != 1:
        raise ValueError("single_component_lnprior needs ncomp == 1")
    means = np.asarray(prior_means, dtype=np.float64)
    stds = np.asarray(prior_stds, dtype=np.float64)
    free_ss = spec.free_source_size
    if free_ss:
        mean_ss, mean_Ncol, mean_Tex, mean_vlsr, mean_dV = means
        std_ss, std_Ncol, std_Tex, std_vlsr, std_dV = stds
    else:
        mean_Ncol, mean_Tex, mean_vlsr, mean_dV = means
        std_Ncol, std_Tex, std_vlsr, std_dV = stds
    # Velocity-related sigmas are relaxed relative to the loaded priors
    # (reference inference.py:200-201).
    std_vlsr = mean_dV * 0.8
    std_dV = mean_dV * 0.3
    terms = [("Tex", float(mean_Tex), float(std_Tex)),
             ("vlsr", float(mean_vlsr), float(std_vlsr)),
             ("dV", float(mean_dV), float(std_dV))]
    if free_ss:
        terms.append(("ss", float(mean_ss), float(std_ss)))
    terms = [(name, mu, sd, _gauss_norm(sd, dtype)) for name, mu, sd in terms]

    def lnprior(theta):
        ss, Ncol, Tex, vlsr, dV = spec.unpack(theta)
        cols = dict(ss=ss[..., 0], Ncol=Ncol[..., 0], Tex=Tex,
                    vlsr=vlsr[..., 0], dV=dV)
        ok = _strictly_inside(cols["Ncol"], *bounds["Ncol"])
        ok &= _strictly_inside(Tex, *bounds["Tex"])
        ok &= _strictly_inside(cols["vlsr"], *bounds["vlsr"])
        ok &= _strictly_inside(dV, *bounds["dV"])
        if free_ss:
            ok &= _strictly_inside(cols["ss"], *bounds["source_size"])
        # Ncol prior is flat (reference inference.py:208)
        lp = None
        for name, mu, sd, norm in terms:
            g = _log_gauss(cols[name], mu, sd, norm)
            lp = g if lp is None else lp + g
        return torch.where(ok, weight * lp,
                           torch.full_like(lp, -torch.inf))

    return lnprior


def ordered_velocity_lnprior(spec: ParamSpec, prior_means, prior_stds, *,
                             ss_bounds=(0.0, 200.0), ncol_bounds=(0.0, 1e16),
                             tex_min: float = 2.7, dv_max: float = 0.3,
                             vlsr_min_sep: float = 0.05,
                             vlsr_max_sep: float = 0.3, dtype=torch.float32):
    """Batched lnprior, (N, D) -> (N,), for multi-component fits with
    ordered velocities (reference TMC1_four_component.py:224-268; the
    defaults are its hardcoded bounds).

    Gaussian priors on the source sizes, Tex, each vlsr_i and dV; flat on
    Ncol. sigma_vlsr_i = 0.8 mean_dV, sigma_dV = 0.3 mean_dV (reference
    :244-248). `dtype` is the walkers' dtype, in which the Gaussian
    normalizations are rounded.
    """
    if not spec.free_source_size:
        raise ValueError("ordered_velocity_lnprior needs a free source size")
    n = spec.ncomp
    means = np.asarray(prior_means, dtype=np.float64)
    stds = np.asarray(prior_stds, dtype=np.float64)
    mean_dV = float(means[3 * n + 1])
    # (mean, std) per Gaussian term: ss (n,), Tex, vlsr (n,), dV
    gauss = {"ss": (means[0:n], stds[0:n]),
             "Tex": (means[2 * n], stds[2 * n]),
             "vlsr": (means[2 * n + 1:3 * n + 1], np.full(n, mean_dV * 0.8)),
             "dV": (mean_dV, mean_dV * 0.3)}
    consts = {}   # device -> {term: (mean, std, norm) tensors}

    def consts_on(device):
        if device not in consts:
            def tensor(v):
                return torch.as_tensor(np.atleast_1d(np.asarray(v, np.float64)),
                                       dtype=dtype, device=device)
            consts[device] = {
                name: (tensor(mu), tensor(sd),
                       tensor([_gauss_norm(float(x), dtype) for x in np.atleast_1d(sd)]))
                for name, (mu, sd) in gauss.items()}
        return consts[device]

    def lnprior(theta):
        ss, Ncol, Tex, vlsr, dV = spec.unpack(theta)
        g = consts_on(theta.device)
        ok = torch.all(_strictly_inside(ss, *ss_bounds), dim=-1)
        ok &= torch.all(_strictly_inside(Ncol, *ncol_bounds), dim=-1)
        if n > 1:
            ok &= torch.all(vlsr[..., :-1] < vlsr[..., 1:] - vlsr_min_sep, dim=-1)
            ok &= torch.all(vlsr[..., 1:] < vlsr[..., :-1] + vlsr_max_sep, dim=-1)
        ok &= dV < dv_max
        ok &= Tex > tex_min
        lp = (torch.sum(_log_gauss(ss, *g["ss"]), dim=-1)
              + _log_gauss(Tex, *g["Tex"])
              + torch.sum(_log_gauss(vlsr, *g["vlsr"]), dim=-1)
              + _log_gauss(dV, *g["dV"]))
        return torch.where(ok, lp, torch.full_like(lp, -torch.inf))

    return lnprior
