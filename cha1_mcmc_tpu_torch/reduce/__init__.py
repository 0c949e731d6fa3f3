"""Spectral data reduction (host-side NumPy, runs once per fit)."""

from cha1_mcmc_tpu_torch.reduce.noise import calc_noise_std, calc_noise_std_gotham
from cha1_mcmc_tpu_torch.reduce.datagrid import (Datagrid, read_spectrum,
                                                 reduce_spectrum, load_datagrid,
                                                 save_datagrid)
from cha1_mcmc_tpu_torch.reduce.converters import (lis_to_array, ascii_to_array,
                                                   velocity_to_frequency,
                                                   spec_to_array, read_obs)

__all__ = [
    "calc_noise_std",
    "calc_noise_std_gotham",
    "Datagrid",
    "read_spectrum",
    "reduce_spectrum",
    "load_datagrid",
    "save_datagrid",
    "lis_to_array",
    "ascii_to_array",
    "velocity_to_frequency",
    "spec_to_array",
    "read_obs",
]
