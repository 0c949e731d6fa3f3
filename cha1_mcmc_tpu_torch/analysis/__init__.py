"""Analysis toolkit: the scientifically load-bearing capabilities of the
reference's interactive simulator (reference
spectral_simulator/simulate_lte.py), re-expressed as pure functions.

Port of cha1_mcmc_tpu/analysis: the NumPy modules are copies; the grid
chi^2 scan (`crosscheck`), the best-fit inspection (`inspection`) and the
independent adaptive-Metropolis engine (`independent`) run in torch on
the model's or the chains' device."""

from cha1_mcmc_tpu_torch.analysis.stacking import (
    get_rms,
    find_nearest,
    find_sim_peaks,
    find_vel_peaks,
    cut_spectra,
    ObsChunk,
    velocity_stack,
    matched_filter,
)
from cha1_mcmc_tpu_torch.analysis.tbg import calc_tbg
from cha1_mcmc_tpu_torch.analysis.peaks import (find_peaks, find_obs_peaks,
                                                find_obs_brights)
from cha1_mcmc_tpu_torch.analysis.fitting import gauss_func, gauss_fit, make_gauss_params
from cha1_mcmc_tpu_torch.analysis.conversions import jy_to_k, k_to_jy, planck_k_to_jy
from cha1_mcmc_tpu_torch.analysis.renderer import render_gaussian_profile
from cha1_mcmc_tpu_torch.analysis.obs_tools import (
    subtract_baseline,
    write_spectrum,
    get_subtraction,
    residual_spectrum,
    find_limits,
)
from cha1_mcmc_tpu_torch.analysis.independent import run_adaptive_metropolis
from cha1_mcmc_tpu_torch.analysis.ulim import (
    get_obs_rms,
    get_sim_peak,
    upper_limit_column,
    find_best_ulim_lines,
)
from cha1_mcmc_tpu_torch.analysis.crosscheck import grid_chi2
from cha1_mcmc_tpu_torch.analysis.inspection import best_fit_inspection

__all__ = [
    "get_rms",
    "find_nearest",
    "find_sim_peaks",
    "ObsChunk",
    "velocity_stack",
    "matched_filter",
    "find_vel_peaks",
    "cut_spectra",
    "calc_tbg",
    "find_obs_peaks",
    "find_obs_brights",
    "subtract_baseline",
    "write_spectrum",
    "get_subtraction",
    "residual_spectrum",
    "find_limits",
    "get_obs_rms",
    "get_sim_peak",
    "upper_limit_column",
    "find_best_ulim_lines",
    "find_peaks",
    "gauss_func",
    "gauss_fit",
    "make_gauss_params",
    "jy_to_k",
    "k_to_jy",
    "planck_k_to_jy",
    "render_gaussian_profile",
    "run_adaptive_metropolis",
    "grid_chi2",
    "best_fit_inspection",
]
