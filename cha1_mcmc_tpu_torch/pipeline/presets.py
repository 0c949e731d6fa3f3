"""Quickload observation presets.

Port of cha1_mcmc_tpu/pipeline/presets.py. The vendored tool ships
quickload functions pointing at survey data on the author's machine
(reference simulate_lte.py:7554-7998: load_mm1, load_tmc1, load_asai,
load_hexos, ...). Here presets are data, in two flavors:

* PRESETS — named FitConfig/MultiFitConfig templates for the surveys whose
  reduced data ships with the reference, resolvable against any data root.
* WORKBENCH_PRESETS — the vendored tool's full quickload vocabulary as
  workbench parameters, plain data copied verbatim. The
  workbench itself is ROADMAP P12: `load_workbench_preset` raises
  NotImplementedError until it is ported.
"""

from __future__ import annotations

import os

from cha1_mcmc_tpu_torch.pipeline.config import FitConfig
from cha1_mcmc_tpu_torch.pipeline.multifit import MultiFitConfig

__all__ = ["PRESETS", "load_preset",
           "WORKBENCH_PRESETS", "load_workbench_preset"]

# name -> (config factory, relative data path under the data root)
PRESETS = {
    # DSN DSS-43 Chamaeleon MMS1 HC5N template fit (reference
    # inference.py:585-631 defaults).
    "dsn_cha_mms1_hc5n": (
        lambda root, cat: FitConfig(
            mol_name="hc5n_hfs", template_run=True, cat_folder=cat,
            data_path=os.path.join(root, "DSN", "cha_mms1_hc5n_example.npy")),
        "DSN/cha_mms1_hc5n_example.npy",
    ),
    # GOTHAM TMC-1 HC9N 4-component fit (reference
    # TMC1_four_component.py:292-294, 393-403).
    "gotham_tmc1_hc9n": (
        lambda root, cat: MultiFitConfig(
            mol_name="hc9n_hfs", template_run=True, cat_folder=cat,
            data_path=os.path.join(root, "GOTHAM", "hc9n_hfs_chunks.npy")),
        "GOTHAM/hc9n_hfs_chunks.npy",
    ),
    # GOTHAM TMC-1 benzonitrile / HC11N: pre-reduced chunks ship with the
    # reference, but their literature priors do not — these presets are
    # non-template (posterior-as-prior from an HC9N-style template chain,
    # the reference's own workflow: TMC1_four_component.py:296-327).
    "gotham_tmc1_benzonitrile": (
        lambda root, cat: MultiFitConfig(
            mol_name="benzonitrile", template_run=False, cat_folder=cat,
            data_path=os.path.join(root, "GOTHAM", "benzonitrile_chunks.npy")),
        "GOTHAM/benzonitrile_chunks.npy",
    ),
    "gotham_tmc1_hc11n": (
        lambda root, cat: MultiFitConfig(
            mol_name="hc11n", template_run=False, cat_folder=cat,
            data_path=os.path.join(root, "GOTHAM", "hc11n_chunks.npy")),
        "GOTHAM/hc11n_chunks.npy",
    ),
}


def load_preset(name: str, data_root: str, cat_folder: str):
    """Return a ready config for a named survey preset.

    Raises KeyError with the available names, or FileNotFoundError naming
    the expected file, so a missing dataset is diagnosable.
    """
    if name not in PRESETS:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}")
    make_config, rel = PRESETS[name]
    cfg = make_config(data_root, cat_folder)
    if not os.path.exists(cfg.data_path):
        raise FileNotFoundError(
            f"Preset {name!r} expects {rel} under {data_root} "
            f"(looked at {cfg.data_path}).")
    return cfg


def _asai(T, dV, source_size=1e20):
    # ASAI IRAM-30m common frame (reference load_asai, :7666-7760)
    return dict(T=T, dV=dV, vlsr=0.0, source_size=source_size,
                dish_size=30.0, tbg_params=2.7, tbg_type="constant",
                tbg_range=())


# Workbench parameters of the vendored tool's quickloads (reference
# simulate_lte.py:7554-7998). Keys are workbench keyword arguments; the
# observation data is user-supplied (see module docstring).
WORKBENCH_PRESETS = {
    # ALMA NGC 6334I MM1 (load_mm1, :7554): per-window continuum Tbg,
    # Jy/beam display scale (planck=True + 0.26" synthesized beam).
    "mm1": dict(
        T=135.0, dV=3.2, vlsr=-7.0, C=1e17,
        planck=True, synth_beam=[0.26, 0.26],
        tbg_type="constant",
        tbg_params=[11.25, 11.25, 27.4, 27.4, 27.4, 26.94, 28.16, 35.0,
                    31.28, 31.28, 43.0, 41.38, 35.9, 35.9],
        tbg_range=[[130000, 132500], [143500, 146000], [251000, 252500],
                   [266000, 266600], [270400, 271000], [279000, 283000],
                   [290000, 295000], [302400, 306100], [336000, 340000],
                   [348000, 352000], [635000, 690000], [698400, 706000],
                   [873500, 881500], [890000, 898000]]),
    # GBT TMC-1 (load_tmc1 / load_tmc1_II, :7567): GOTHAM cold cloud;
    # the quickload doubles the render resolution (res *= 2 from the
    # 0.01 MHz default, :7600).
    "tmc1": dict(T=8.0, dV=0.15, vlsr=5.82, source_size=30.0, res=0.02,
                 dish_size=100.0, tbg_params=2.7, tbg_type="constant"),
    # GBT PRIMOS Sgr B2(N) (load_primos_cold / _hot, :7589): sgrb2
    # continuum model.
    "primos_cold": dict(T=5.0, dV=9.0, vlsr=0.0, source_size=20.0,
                        dish_size=100.0, tbg_type="sgrb2", tbg_params=[]),
    "primos_hot": dict(T=80.0, dV=9.0, vlsr=0.0, source_size=5.0,
                       dish_size=100.0, tbg_type="sgrb2", tbg_params=[]),
    # ASAI IRAM-30m survey sources (load_asai, :7666).
    "asai_barnard1": _asai(10.0, 0.8),
    "asai_iras4a": _asai(21.0, 5.0),
    "asai_l1157b1": _asai(60.0, 8.0),
    "asai_l1157mm": _asai(60.0, 3.0),
    "asai_l1448r2": _asai(60.0, 8.0),
    "asai_l1527": _asai(12.0, 0.5),
    "asai_l1544": _asai(10.0, 0.5),
    "asai_svs13a": _asai(19.0, 3.0, source_size=0.3),
    "asai_tmc1": _asai(7.0, 0.3),
    # Herschel HEXOS (load_hexos, :7766): piecewise-poly / power-law
    # continuum fits.
    "hexos_sgrb2": dict(
        T=280.0, dV=8.0, vlsr=0.0, source_size=2.3, dish_size=3.5,
        tbg_type="poly",
        tbg_params=[[1.65327e-5, -3.10799], [0, 16.19],
                    [-7.03292e-6, 28.1471]],
        tbg_range=[[479600, 1280200], [1425500, 1535200],
                   [1573600, 1907150]]),
    "hexos_orionkl": dict(
        T=200.0, dV=6.5, vlsr=0.0, source_size=10.0, dish_size=3.5,
        tbg_type="power", tbg_params=[8.2279e-14, 2.3395, 2.5501],
        tbg_range=[[470000, 1296000]]),
    # IRAM-30m Sgr B2(N) Belloche survey (load_belloche, :7942).
    "belloche": dict(T=120.0, dV=5.0, vlsr=0.0, source_size=2.2,
                     dish_size=30.0, tbg_params=5.2, tbg_type="constant"),
}


def load_workbench_preset(name: str, obs_path: str | None = None,
                          **overrides):
    """A Workbench configured like the vendored tool's quickload `name` (see
    WORKBENCH_PRESETS): the Workbench is ROADMAP P12, not ported yet."""
    raise NotImplementedError("the Workbench (load_workbench_preset) is "
                              "ROADMAP P12, not ported yet")
