"""Likelihood and posterior log-probability functions, batched over walkers.

Port of cha1_mcmc_tpu/inference/likelihood.py:build_lnlike / build_lnprob.
The JAX package returns scalar functions that callers vmap; here both
return explicitly batched (N, D) -> (N,) functions, so one call evaluates
every proposal of a half-step.

Failure semantics: the reference converts exceptions and non-finite values
to -inf so the sampler rejects the proposal (reference inference.py:145-147,
153-155, 162-164, 241-245); here non-finite values map to -inf.
"""

from __future__ import annotations

import torch

from cha1_mcmc_tpu_torch.models.forward import SpectralModel
from cha1_mcmc_tpu_torch.inference.params import ParamSpec

__all__ = ["build_lnlike", "build_lnprob"]


def build_lnlike(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs):
    """Batched lnlike(thetas (N, D)) -> (N,) (reference inference.py:127-166).

    chi^2 form: -0.5 * sum[(y - m)^2 / sigma^2 - ln(1/sigma^2)].
    """
    y = torch.as_tensor(grid_ints, dtype=model.dtype, device=model.device)
    yerrs = torch.as_tensor(grid_yerrs, dtype=model.dtype, device=model.device)
    inv_sigma2 = 1.0 / (yerrs ** 2)

    def lnlike(thetas):
        ss, Ncol, Tex, vlsr, dV = spec.unpack(thetas)
        m = model(ss, Ncol, Tex, vlsr, dV)
        ll = model.chi2_lnlike(m, y, inv_sigma2)
        # Non-finite model/likelihood -> reject (reference inference.py:162-164).
        return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))

    return lnlike


def build_lnprob(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs,
                 lnprior_fn):
    """Batched lnprob(thetas (N, D)) = lnprior + lnlike -> (N,)
    (reference inference.py:239-246).

    Both terms are computed for every walker and -inf propagates through
    the sum, with a guard so that -inf prior + NaN likelihood still yields
    -inf.
    """
    lnlike = build_lnlike(model, spec, grid_ints, grid_yerrs)

    def lnprob(thetas):
        lp = lnprior_fn(thetas)
        ll = lnlike(thetas)
        total = lp + ll
        return torch.where(torch.isfinite(lp) & torch.isfinite(ll), total,
                           torch.full_like(total, -torch.inf))

    return lnprob
