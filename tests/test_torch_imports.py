"""The port's import rule, held in a fresh interpreter: importing every
module of cha1_mcmc_tpu_torch (walked with pkgutil) and chip_smoke.py
loads neither jax nor the JAX package cha1_mcmc_tpu."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import cha1_mcmc_tpu_torch
names = ["cha1_mcmc_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    cha1_mcmc_tpu_torch.__path__, "cha1_mcmc_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cha1_mcmc_tpu"))
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == [], result["loaded"]
    modules = set(result["modules"])
    # this slice's modules are among those walked
    for name in ("__main__", "analysis.independent", "analysis.crosscheck",
                 "analysis.inspection", "catalogs.native", "pipeline.batch",
                 "reduce.converters"):
        assert f"cha1_mcmc_tpu_torch.{name}" in modules, name


def test_every_kernel_module_registers_its_launch_counters():
    """Each module of the port with a LAUNCHES dict registers it with
    utils.metrics.register_launches (so a fit's throughput.json counts its
    launches), and chip_smoke.kernel_modules imports every such module (so
    the smoke's launch counts cover it)."""
    import importlib
    import pkgutil

    import chip_smoke
    import cha1_mcmc_tpu_torch
    from cha1_mcmc_tpu_torch.utils.metrics import launch_counters

    names = [m.name for m in pkgutil.walk_packages(cha1_mcmc_tpu_torch.__path__,
                                                   "cha1_mcmc_tpu_torch.")
             if m.name != "cha1_mcmc_tpu_torch.__main__"]
    kernels = {name for name in names
               if isinstance(getattr(importlib.import_module(name), "LAUNCHES", None), dict)}
    assert len(kernels) >= 6, kernels
    registered = [id(c) for c in launch_counters()]
    for name in kernels:
        assert id(importlib.import_module(name).LAUNCHES) in registered, name
    assert {m.__name__ for m in chip_smoke.kernel_modules()} == kernels
