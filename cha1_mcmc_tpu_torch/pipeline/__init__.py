"""Run orchestration: typed config, the single-molecule fit, posterior reporting."""

from cha1_mcmc_tpu_torch.pipeline.config import FitConfig
from cha1_mcmc_tpu_torch.pipeline.fit import SpectralFit
from cha1_mcmc_tpu_torch.pipeline.plotting import plot_results, summarize_posterior

__all__ = ["FitConfig", "SpectralFit", "plot_results", "summarize_posterior"]
