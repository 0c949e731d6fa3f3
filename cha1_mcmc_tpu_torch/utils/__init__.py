"""Utilities: throughput metrics, the default device and the CUDA build
of the kernels."""

from cha1_mcmc_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from cha1_mcmc_tpu_torch.utils.metrics import Throughput

__all__ = ["Throughput", "DEFAULT_DEVICE", "resolve_device"]
