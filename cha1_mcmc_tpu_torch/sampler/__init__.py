"""Affine-invariant ensemble MCMC on the device: the general stretch-move
sampler and the fused whole-step kernel K1."""

from cha1_mcmc_tpu_torch.sampler.stretch import (EnsembleSampler, draw_randomness,
                                                 run_ensemble)
from cha1_mcmc_tpu_torch.sampler.fused import (FusedEnsemble, FusedEnsembleSampler,
                                               make_fused_ensemble)
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
    "draw_randomness",
    "run_ensemble",
    "save_chain",
    "load_chain",
    "last_position",
    "chain_to_priors",
    "initialize_walkers",
]
