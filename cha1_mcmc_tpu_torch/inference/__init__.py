"""Inference layer: parameter vectors, priors, likelihood, MLE init."""

from cha1_mcmc_tpu_torch.inference.params import ParamSpec
from cha1_mcmc_tpu_torch.inference.priors import (single_component_lnprior,
                                                 ordered_velocity_lnprior)
from cha1_mcmc_tpu_torch.inference.likelihood import (build_lnlike, build_lnprob,
                                                      build_lnlike_batched,
                                                      build_lnprob_batched)
from cha1_mcmc_tpu_torch.inference.mle import estimate_ncol_mle

__all__ = [
    "ParamSpec",
    "single_component_lnprior",
    "ordered_velocity_lnprior",
    "build_lnlike",
    "build_lnprob",
    "build_lnlike_batched",
    "build_lnprob_batched",
    "estimate_ncol_mle",
]
