"""cha1_mcmc_tpu_torch — PyTorch + CUDA port of cha1_mcmc_tpu.

LTE molecular-emission fitting of sparse radio spectra with an
affine-invariant ensemble MCMC (KahaanGandhi/Cha1-MCMC; Loomis et al.,
Nat Astron 5, 188-196, 2021), for one NVIDIA GPU. The JAX package
`cha1_mcmc_tpu` is the reference this port is held against; the port
imports none of it.

  * The catalog is parsed once on the host into frozen NumPy arrays that
    become device tensors (buffers of the `SpectralModel` nn.Module).
  * Likelihood, priors and the stretch-move sampler are plain torch
    functions batched over walkers; every tensor-creating entry takes an
    explicit device and dtype, and randomness comes from an explicit
    torch.Generator.
  * The flagship single-component fit runs its whole ensemble step in one
    hand-written CUDA kernel (K1, csrc/fused_step.cu), and the
    K-component GOTHAM multifit in another (K2, csrc/multi_step.cu),
    each with a plain PyTorch version beside it.
"""

__version__ = "0.1.0"

from cha1_mcmc_tpu_torch import constants
from cha1_mcmc_tpu_torch.catalogs import Catalog, load_catalog, QModel
from cha1_mcmc_tpu_torch.models import SpectralModel
from cha1_mcmc_tpu_torch.sampler import (EnsembleSampler, FusedEnsembleSampler,
                                         make_fused_ensemble,
                                         make_fused_ensemble_multi, run_ensemble)
from cha1_mcmc_tpu_torch.pipeline import (FitConfig, SpectralFit, MultiFitConfig,
                                          MultiComponentFit, load_preset)

__all__ = [
    "constants",
    "Catalog",
    "load_catalog",
    "QModel",
    "SpectralModel",
    "EnsembleSampler",
    "FusedEnsembleSampler",
    "make_fused_ensemble",
    "make_fused_ensemble_multi",
    "run_ensemble",
    "FitConfig",
    "SpectralFit",
    "MultiFitConfig",
    "MultiComponentFit",
    "load_preset",
    "__version__",
]
