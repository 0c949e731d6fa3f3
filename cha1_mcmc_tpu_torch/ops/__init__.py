"""LTE radiative-transfer primitives, written once against an array
namespace `xp`: numpy for the float64 host oracle, torch on tensors for
the device path."""

from cha1_mcmc_tpu_torch.ops.lte import (
    planck_J,
    beam_dilution,
    apply_beam,
    apply_beam_interferometer,
    get_beam,
    invert_beam,
    tau_sticks,
    stick_spectrum,
    scale_temp,
)

__all__ = ["planck_J", "beam_dilution", "apply_beam", "apply_beam_interferometer",
           "get_beam", "invert_beam", "tau_sticks", "stick_spectrum", "scale_temp"]
