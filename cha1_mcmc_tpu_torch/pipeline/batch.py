"""Multi-molecule batch fitting.

Port of cha1_mcmc_tpu/pipeline/batch.py. The reference's config carries a
data_paths dict of molecules but runs one at a time by editing mol_name
(reference inference.py:621-630). Here a batch run fits every molecule in
the mapping; across hosts, each process takes a slice (independent
molecules across hosts, walkers across a host's devices).
"""

from __future__ import annotations

import dataclasses

from cha1_mcmc_tpu_torch.constants import CYAN, RESET
from cha1_mcmc_tpu_torch.pipeline.config import FitConfig
from cha1_mcmc_tpu_torch.pipeline.fit import SpectralFit

__all__ = ["fit_molecules"]


def fit_molecules(base_config: FitConfig, data_paths: dict[str, str],
                  *, process_index: int = 0, process_count: int = 1) -> dict:
    """Fit each molecule in data_paths; returns {mol_name: chain}.

    process_index/process_count implement static round-robin sharding of
    molecules across independent processes (set them from the
    torch.distributed rank and world size, or from a job scheduler). Each
    fit reuses the base config with mol_name and data_path swapped.
    """
    results = {}
    molecules = sorted(data_paths)
    for i, mol in enumerate(molecules):
        if i % process_count != process_index:
            continue
        print(f"{CYAN}=== [{i + 1}/{len(molecules)}] {mol} ==={RESET}")
        cfg = dataclasses.replace(base_config, mol_name=mol,
                                  data_path=data_paths[mol])
        results[mol] = SpectralFit(cfg).run()
    return results
