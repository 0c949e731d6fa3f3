"""Forward models: LTE stick simulation, the on-grid emission model and the
channel-major gather opacity (sparse_opacity)."""

from cha1_mcmc_tpu_torch.models.forward import (SpectralModel, model_from_arrays,
                                                simulate_sticks_host)

__all__ = ["SpectralModel", "model_from_arrays", "simulate_sticks_host"]
