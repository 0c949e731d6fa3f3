"""Typed run configuration.

Field vocabulary matches the reference's hand-edited config dict 1:1
(reference inference.py:585-631) so reference configs translate directly,
plus execution knobs. The config serializes to JSON alongside results for
provenance (the reference keeps no record of its dict). Port of
cha1_mcmc_tpu/pipeline/config.py with an explicit `device`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

__all__ = ["FitConfig"]


@dataclasses.dataclass
class FitConfig:
    # Frequently adjusted per run (reference inference.py:586-590)
    mol_name: str
    template_run: bool = True
    nruns: int = 10_000
    nwalkers: int = 128

    # Physical priors (reference inference.py:592-599)
    bounds: dict = dataclasses.field(default_factory=lambda: {
        "source_size": (30.0, 90.0),
        "Ncol": (1e8, 1e14),
        "Tex": (3.5, 12.0),
        "vlsr": (3.0, 5.5),
        "dV": (0.4, 1.5),
    })

    # Template priors (reference inference.py:602-603). Full 5-dim layout;
    # the source-size entry is stripped automatically when it is fixed
    # (reference inference.py:634-636).
    template_means: tuple = (46.91, 3.4e10, 8.0, 4.3, 0.7575)
    template_stds: tuple = (6.5, 0.34e10, 3.0, 0.06, 0.22)

    # Observation settings (reference inference.py:606-610)
    dish_size: float = 70.0
    lower_limit: float = 18_000.0
    upper_limit: float = 25_000.0
    aligned_velocity: float = 4.10
    fixed_source_size: float | None = 52.0

    # Options (reference inference.py:613-620)
    MLE_for_Ncol: bool = True
    block_interlopers: bool = True
    fit_folder: str = "results"
    cat_folder: str = "catalog"
    prior_path: str | None = None
    data_path: str | None = None

    # Execution knobs (no reference equivalent; replace 'parallelize')
    seed: int = 0
    checkpoint_every: int = 512
    dtype: str = "float32"
    device: str = "cuda"             # torch device the fit runs on; "cuda"
                                     # with no CUDA device raises
    n_devices: int | None = None     # shard the fit over this many devices:
                                     # a torch.distributed world of that
                                     # size, one rank per device, each
                                     # running the fit (rank 0 writes)
    n_line_shards: int = 1           # of which, this many shard the line axis
    n_chains: int = 1                # independent ensembles (nwalkers is the
                                     # total; enables cross-chain R-hat)
    stretch_a: float = 2.0
    use_pallas: bool | None = None   # sparse opacity path for dense
                                     # catalogs (the gather tables, K3 on
                                     # the card). None = auto: taken when
                                     # n_lines x n_channels > 4e6, where
                                     # the dense (W/2, L, C) intermediate
                                     # would be too large.
    use_fused_step: bool = True      # fused whole-step kernel (K1, or K3
                                     # on the sparse path) when applicable
    resume: bool = False             # continue an existing chain file
    profile_dir: str | None = None   # write a torch.profiler trace of the
                                     # sampling here (utils/metrics.py:
                                     # trace_profile)

    def __post_init__(self):
        if self.fixed_source_size is not None and len(self.template_means) == 5:
            # Strip the source-size prior entries (reference inference.py:634-636).
            self.template_means = tuple(self.template_means[1:])
            self.template_stds = tuple(self.template_stds[1:])
        self.template_means = tuple(float(x) for x in self.template_means)
        self.template_stds = tuple(float(x) for x in self.template_stds)
        self.bounds = {k: tuple(float(x) for x in v) for k, v in self.bounds.items()}

    @property
    def ndim(self) -> int:
        return 4 if self.fixed_source_size is not None else 5

    @property
    def catfile_path(self) -> str:
        return os.path.join(self.cat_folder, f"{self.mol_name}.cat")

    @property
    def mol_folder(self) -> str:
        return os.path.join(self.fit_folder, self.mol_name)

    @property
    def chain_path(self) -> str:
        name = "chain_template.npy" if self.template_run else "chain.npy"
        return os.path.join(self.mol_folder, name)

    @property
    def datagrid_path(self) -> str:
        # Same artifact name as the reference (inference.py:338).
        return os.path.join(self.mol_folder,
                            f"all_{self.mol_name}_lines_DSN_freq_space.npy")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FitConfig":
        """Accept a reference-style config dict (reference inference.py:585-631)."""
        d = dict(d)
        data_paths = d.pop("data_paths", None)
        if data_paths and "data_path" not in d:
            d["data_path"] = data_paths.get(d["mol_name"])
        d.pop("parallelize", None)  # CPU-pool toggle has no device meaning
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        def default(o):
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            if isinstance(o, np.ndarray):
                return o.tolist()
            return str(o)

        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2, default=default)
