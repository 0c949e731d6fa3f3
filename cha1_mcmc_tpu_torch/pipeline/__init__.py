"""Run orchestration: typed configs, the single-molecule and multi-component
fits, batch fits over molecules, survey presets, posterior reporting."""

from cha1_mcmc_tpu_torch.pipeline.config import FitConfig
from cha1_mcmc_tpu_torch.pipeline.fit import SpectralFit
from cha1_mcmc_tpu_torch.pipeline.multifit import MultiFitConfig, MultiComponentFit
from cha1_mcmc_tpu_torch.pipeline.batch import fit_molecules
from cha1_mcmc_tpu_torch.pipeline.presets import PRESETS, load_preset
from cha1_mcmc_tpu_torch.pipeline.plotting import plot_results, summarize_posterior

__all__ = ["FitConfig", "SpectralFit", "MultiFitConfig", "MultiComponentFit",
           "fit_molecules", "PRESETS", "load_preset", "plot_results", "summarize_posterior"]
