"""Affine-invariant ensemble MCMC on the device: the general stretch-move
sampler and the fused whole-step kernels K1 (one component) and K2
(K components)."""

from cha1_mcmc_tpu_torch.sampler.stretch import (EnsembleSampler, draw_randomness,
                                                 run_ensemble)
from cha1_mcmc_tpu_torch.sampler.fused import (FusedEnsemble, FusedEnsembleSampler,
                                               make_fused_ensemble)
from cha1_mcmc_tpu_torch.sampler.fused_multi import (MultiFusedEnsemble,
                                                     make_fused_ensemble_multi)
from cha1_mcmc_tpu_torch.sampler.chain import (
    save_chain,
    load_chain,
    last_position,
    chain_to_priors,
    initialize_walkers,
)

__all__ = [
    "EnsembleSampler",
    "FusedEnsemble",
    "FusedEnsembleSampler",
    "make_fused_ensemble",
    "MultiFusedEnsemble",
    "make_fused_ensemble_multi",
    "draw_randomness",
    "run_ensemble",
    "save_chain",
    "load_chain",
    "last_position",
    "chain_to_priors",
    "initialize_walkers",
]
