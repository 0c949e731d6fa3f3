"""Forward models: LTE stick simulation and the on-grid emission model."""

from cha1_mcmc_tpu_torch.models.forward import (SpectralModel, model_from_arrays,
                                                simulate_sticks_host)

__all__ = ["SpectralModel", "model_from_arrays", "simulate_sticks_host"]
