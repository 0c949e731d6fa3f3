"""Affine-invariant ensemble MCMC on the device: the general stretch-move
sampler, K independent ensembles (MultiChainSampler) with their
convergence diagnostics, and the fused whole-step kernels K1 (one
component) and K2 (K components)."""

from cha1_mcmc_tpu_torch.sampler.stretch import (EnsembleSampler, MultiChainSampler,
                                                 draw_chain_randomness, draw_randomness,
                                                 run_ensemble, run_ensemble_chains)
from cha1_mcmc_tpu_torch.sampler.diagnostics import (autocorr_time, effective_sample_size,
                                                     gelman_rubin, summarize_convergence)
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
    "MultiChainSampler",
    "FusedEnsemble",
    "FusedEnsembleSampler",
    "make_fused_ensemble",
    "MultiFusedEnsemble",
    "make_fused_ensemble_multi",
    "draw_randomness",
    "draw_chain_randomness",
    "run_ensemble",
    "run_ensemble_chains",
    "autocorr_time",
    "effective_sample_size",
    "gelman_rubin",
    "summarize_convergence",
    "save_chain",
    "load_chain",
    "last_position",
    "chain_to_priors",
    "initialize_walkers",
]
