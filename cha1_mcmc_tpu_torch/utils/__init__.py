"""Utilities: throughput metrics and the CUDA build of the kernels."""

from cha1_mcmc_tpu_torch.utils.metrics import Throughput

__all__ = ["Throughput"]
