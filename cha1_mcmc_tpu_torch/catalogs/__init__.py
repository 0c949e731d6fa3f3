"""Catalog layer: SPCAT parsing and partition-function models.

Host-side (NumPy, float64). Produces frozen arrays that become device
tensors once, at model build.
"""

from cha1_mcmc_tpu_torch.catalogs.spcat import Catalog, load_catalog, parse_spcat
from cha1_mcmc_tpu_torch.catalogs.partition import QModel, q_model_for_catalog

__all__ = ["Catalog", "load_catalog", "parse_spcat", "QModel", "q_model_for_catalog"]
