"""Spectral data reduction (host-side NumPy, runs once per fit)."""

from cha1_mcmc_tpu_torch.reduce.noise import calc_noise_std, calc_noise_std_gotham
from cha1_mcmc_tpu_torch.reduce.datagrid import (Datagrid, read_spectrum,
                                                 reduce_spectrum, load_datagrid,
                                                 save_datagrid)

__all__ = [
    "calc_noise_std",
    "calc_noise_std_gotham",
    "Datagrid",
    "read_spectrum",
    "reduce_spectrum",
    "load_datagrid",
    "save_datagrid",
]
