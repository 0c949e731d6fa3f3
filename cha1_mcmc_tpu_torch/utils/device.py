"""The device an entry point runs on.

Every entry point of the port that creates tensors takes a `device`
argument whose default is the card ("cuda"); the caller asks for the CPU
with device="cpu". `resolve_device` turns the argument into a
torch.device and refuses "cuda" with a clear message where no CUDA device
is available, instead of the error of the first tensor put there.

`DeviceError` is what a kernel wrapper raises when a CUDA entry returns
an error code; the samplers retry a block that raises it (or torch's own
AcceleratorError) with the block's saved random state
(sampler/stretch.py:EnsembleSampler.run_mcmc), and nothing else.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "DeviceError", "DEVICE_ERRORS", "resolve_device"]

#: The default device of every entry point.
DEFAULT_DEVICE = "cuda"


class DeviceError(RuntimeError):
    """A CUDA entry of the port's kernels returned an error code (a launch
    that was refused or a fault it reported)."""


#: The errors a sampler block is retried on: the wrappers' DeviceError and
#: torch's AcceleratorError (a CUDA error surfaced by a torch call).
DEVICE_ERRORS = (DeviceError, torch.AcceleratorError)


def resolve_device(device=DEFAULT_DEVICE, what: str = "this call") -> torch.device:
    """torch.device(device); raises RuntimeError for a CUDA device when
    torch sees none (`what` names the caller in the message)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on device={str(device)!r} (the default is "
                           f"{DEFAULT_DEVICE!r}) but no CUDA device is available: "
                           "pass device='cpu' to run on the CPU")
    return device
