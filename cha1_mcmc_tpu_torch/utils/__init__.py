"""Utilities: throughput metrics and sampling traces, the default device
and the device-error type, and the CUDA build of the kernels."""

from cha1_mcmc_tpu_torch.utils.device import (DEFAULT_DEVICE, DEVICE_ERRORS, DeviceError,
                                             resolve_device)
from cha1_mcmc_tpu_torch.utils.metrics import Throughput, trace_profile

__all__ = ["Throughput", "trace_profile", "DEFAULT_DEVICE", "DeviceError", "DEVICE_ERRORS",
           "resolve_device"]
