"""The three posterior problems of the port's synthetic fits, their JAX
goldens and their float64 lnprob from either package, as its fit builds
it: the golden script (scripts/make_posterior_goldens.py) writes the
goldens and records the JAX package's values at each golden's probe
thetas; tests/test_torch_posterior.py holds both packages to them and
chip_smoke.py holds the card's fits to them.

    prob = write_problem("flagship", folder)
    golden = load_golden("flagship")
    grid, lnprob = build_lnprob64("cha1_mcmc_tpu", "flagship", prob, folder)
    values = lnprob(thetas)          # (N, D) float64 -> (N,) float64
    check_datagrid("flagship", grid, golden)

The JAX side must be called with float64 enabled (jax.enable_x64() or
jax_enable_x64); the port's side runs on the CPU. Neither package is
imported until a function is called.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json
import math
import os

import numpy as np

__all__ = ["JAX", "PORT", "PROBLEMS", "HASHED", "FINGERPRINT_RTOL", "write_problem",
           "fit_fields", "load_golden", "datagrid_sha256", "datagrid_fingerprint",
           "check_datagrid", "make_fit", "build_lnprob64"]

JAX, PORT = "cha1_mcmc_tpu", "cha1_mcmc_tpu_torch"
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

#: name -> (fit class, writer, writer arguments, golden file under tests/golden).
PROBLEMS = {
    "flagship": ("SpectralFit", "write_hc5n_problem", {"seed": 4},
                 "port_posterior_flagship.json"),
    "gotham": ("MultiComponentFit", "write_hc9n_problem",
               {"n_multiplets": 22, "seed": 0}, "port_posterior_gotham.json"),
    "dense": ("SpectralFit", "write_dense_problem", {"scale": "full"},
              "port_posterior_dense.json"),
}
#: The problems whose reduced datagrid is bitwise the same on every
#: machine, held to the golden's sha256. The dense writer's NumPy sums
#: differ in the last bits from one machine to another (ROADMAP F7), so
#: its datagrid is held to the golden's fingerprint at FINGERPRINT_RTOL.
HASHED = ("flagship", "gotham")
FINGERPRINT_RTOL = 1e-12


def write_problem(name: str, folder: str) -> dict:
    """Write problem `name`'s catalog and spectrum into `folder`
    (tests/port_problems.py); returns the writer's dict."""
    from tests import port_problems

    _, writer, kwargs, _ = PROBLEMS[name]
    return getattr(port_problems, writer)(folder, **kwargs)


def fit_fields(name: str, prob: dict) -> dict:
    """The config fields of problem `name` that both packages' fits
    share (FitConfig / MultiFitConfig), apart from folders, nwalkers,
    nruns, checkpoint_every, seed, dtype and device."""
    fields = {"cat_folder": prob["cat_folder"], "data_path": prob["data_path"]}
    if name == "flagship":
        return {"mol_name": "hc5n_hfs", **fields}
    if name == "gotham":
        return {"mol_name": "hc9n_hfs", "template_run": True, **fields}
    from tests.port_problems import (DENSE_BOUNDS, DENSE_CENTER, DENSE_DISH,
                                     DENSE_NAME, DENSE_SOURCE_SIZE)

    ncol = prob["truth"][0]
    return {"mol_name": DENSE_NAME, **fields, "lower_limit": prob["ll"],
            "upper_limit": prob["ul"], "dish_size": DENSE_DISH,
            "aligned_velocity": DENSE_CENTER, "fixed_source_size": DENSE_SOURCE_SIZE,
            "bounds": dict(DENSE_BOUNDS),
            "template_means": (DENSE_SOURCE_SIZE, 1.2 * ncol, 8.0, DENSE_CENTER, 0.7575),
            "template_stds": (6.5, 0.5 * ncol, 3.0, 0.06, 0.22)}


def load_golden(name: str) -> dict:
    """The JAX package's posterior golden of problem `name`."""
    with open(os.path.join(GOLDEN_DIR, PROBLEMS[name][3])) as fh:
        return json.load(fh)


def _arrays(grid):
    return {k: np.asarray(getattr(grid, k), dtype=np.float64).ravel()
            for k in ("freqs", "ints", "yerrs")}


def datagrid_sha256(grid) -> str:
    """sha256 of a reduced datagrid's freqs, ints and yerrs as float64."""
    h = hashlib.sha256()
    for a in _arrays(grid).values():
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def datagrid_fingerprint(grid) -> dict:
    """Per array of a reduced datagrid (freqs, ints, yerrs): the sums of
    x, x^2 and (i / n) x, each rounded once (math.fsum), so one array
    gives the same three numbers on every machine; the last catches a
    reordering."""
    out = {}
    for k, a in _arrays(grid).items():
        ramp = np.arange(a.size) / a.size
        out[k] = [math.fsum(a), math.fsum(a * a), math.fsum(ramp * a)]
    return out


def check_datagrid(name: str, grid, golden: dict) -> str:
    """Hold a reduced datagrid to its golden's: the sha256 on the HASHED
    problems, the fingerprint within FINGERPRINT_RTOL on the others.
    Raises AssertionError where it differs; returns a line with the hash
    comparison and each array's largest relative fingerprint difference."""
    same = datagrid_sha256(grid) == golden["datagrid_sha256"]
    want = golden["datagrid_fingerprint"]
    rel = {k: max(abs(g - w) / abs(w) if w else abs(g) for g, w in zip(got, want[k]))
           for k, got in datagrid_fingerprint(grid).items()}
    line = (f"datagrid sha256 {'equal to' if same else 'differs from'} the golden's; "
            "fingerprint relative difference " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + (" (held: sha256)" if name in HASHED else f" (held: rtol {FINGERPRINT_RTOL:g})"))
    if name in HASHED:
        assert same, f"{name}: {line}"
    else:
        assert max(rel.values()) <= FINGERPRINT_RTOL, f"{name}: {line}"
    return line


def make_fit(package: str, name: str, prob: dict, folder: str, **fields):
    """The package's fit object of problem `name` (SpectralFit or
    MultiComponentFit) with its config fields plus `fields`."""
    pkg = importlib.import_module(package)
    kind = PROBLEMS[name][0]
    config = pkg.MultiFitConfig if kind == "MultiComponentFit" else pkg.FitConfig
    return getattr(pkg, kind)(config(**fit_fields(name, prob), fit_folder=folder,
                                     **fields))


def build_lnprob64(package: str, name: str, prob: dict, folder: str):
    """(datagrid, lnprob) of problem `name` in float64 from `package`:
    the spectrum reduced as the fit reduces it, the model as the fit
    builds it (the dense problem's Chebyshev Q included), the prior of
    the fit's template means and stds, and the lnprob the fit samples:
    the plain dense one, one theta at a time, on the flagship and GOTHAM
    problems; the batched sparse (gather) one on the dense problem, where
    the fit auto-selects it (the JAX one as on the CPU, interpret=True)."""
    port = package == PORT
    extra = {"dtype": "float64", **({"device": "cpu"} if port else {})}
    fit = make_fit(package, name, prob, folder, **extra)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = fit.init_setup()
    model = fit.build_model(grid)
    cfg, spec = fit.config, fit.spec
    means = np.asarray(cfg.template_means, dtype=np.float64)
    stds = np.asarray(cfg.template_stds, dtype=np.float64)
    inference = importlib.import_module(f"{package}.inference")
    if port:
        import torch

        kw, to_array = {"dtype": torch.float64}, torch.as_tensor
    else:
        import jax
        import jax.numpy as jnp

        kw, to_array = {}, jnp.asarray
    if name == "gotham":
        lnprior = inference.ordered_velocity_lnprior(spec, means, stds,
                                                     dv_max=cfg.dv_bound, **kw)
    else:
        lnprior = inference.single_component_lnprior(spec, cfg.bounds, means, stds, **kw)
    args = (model, spec, grid.ints, grid.yerrs, lnprior)
    if name == "dense":
        sparse = dict(use_pallas=True, dv_max=cfg.bounds["dV"][1], dv_min=cfg.bounds["dV"][0],
                      vlsr_bounds=cfg.bounds["vlsr"], **({} if port else {"interpret": True}))
        fn = inference.build_lnprob_batched(*args, **sparse)

        def lnprob(thetas):
            return np.asarray(fn(to_array(np.asarray(thetas, dtype=np.float64))),
                              dtype=np.float64)
    elif port:
        fn = inference.build_lnprob(*args)

        def lnprob(thetas):
            t = torch.as_tensor(np.asarray(thetas, dtype=np.float64))
            return np.array([float(fn(t[i:i + 1])[0]) for i in range(t.shape[0])])
    else:
        fn = jax.jit(inference.build_lnprob(*args))

        def lnprob(thetas):
            th = np.asarray(thetas, dtype=np.float64)
            return np.array([float(fn(jnp.asarray(t, dtype=jnp.float64))) for t in th])
    return grid, lnprob
