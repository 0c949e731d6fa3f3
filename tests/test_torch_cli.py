"""The port's command line, `python -m cha1_mcmc_tpu_torch`, against the JAX
package's (cha1_mcmc_tpu/__main__.py): the same subcommands and arguments;
`fit`, `fit --all-molecules`, `multifit` and `diagnose` run in
subprocesses on the synthetic problems with `"device": "cpu"` in the
config, a few walkers and steps; `workbench` and `bench` exit non-zero,
naming what ports them.

Tolerances: a CLI fit's chain is bitwise equal to the in-process fit's
on the same config, and it writes the same files."""

import contextlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.port_problems import write_hc5n_problem, write_hc9n_problem


def _run(package, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    return subprocess.run([sys.executable, "-m", package, *args], capture_output=True,
                          text=True, env=env, timeout=timeout)


def _write_config(tmp_path, name, cfg):
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def _files(folder):
    return sorted(os.path.relpath(os.path.join(r, f), folder)
                  for r, _, fs in os.walk(folder) for f in fs)


@pytest.fixture(scope="module")
def hc5n(tmp_path_factory):
    return write_hc5n_problem(str(tmp_path_factory.mktemp("hc5n")))


def _fit_config(problem, folder, **kw):
    return {"mol_name": "hc5n_hfs", "template_run": True, "nruns": 6, "nwalkers": 8,
            "cat_folder": problem["cat_folder"], "data_path": problem["data_path"],
            "fit_folder": folder, "MLE_for_Ncol": False, "checkpoint_every": 3,
            "device": "cpu", **kw}


def _main(package, *args):
    """Run a package's command line in this process: (exit code, stdout)."""
    main = importlib.import_module(f"{package}.__main__").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            code = main(list(args))
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


@pytest.mark.parametrize("command", [[], ["fit"], ["multifit"], ["diagnose"], ["bench"],
                                     ["workbench"]])
def test_cli_arguments_match_jax(command):
    """Every subcommand takes the JAX command line's arguments (its --help
    text, the program name aside)."""
    helps = []
    for package in ("cha1_mcmc_tpu", "cha1_mcmc_tpu_torch"):
        code, text = _main(package, *command, "--help")
        assert code == 0
        helps.append(re.sub(r"\s+", " ", text.replace(package, "PROG")))
    assert helps[0] == helps[1]


def test_cli_fit(hc5n, tmp_path):
    """Twin of tests/test_workbench.py::test_cli_fit on the synthetic
    flagship: `fit --config` exits 0 and writes the in-process fit's files,
    its chain bitwise equal to the in-process chain."""
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

    cfg = _fit_config(hc5n, str(tmp_path / "results"))
    out = _run("cha1_mcmc_tpu_torch", "fit", "--config",
               _write_config(tmp_path, "run.json", cfg))
    assert out.returncode == 0, out.stderr[-2000:]
    chain_path = tmp_path / "results" / "hc5n_hfs" / "chain_template.npy"
    assert os.path.exists(chain_path)
    ref = SpectralFit(FitConfig.from_dict({**cfg, "fit_folder": str(tmp_path / "ref")}))
    chain = ref.run()
    np.testing.assert_array_equal(np.load(chain_path), chain)
    assert _files(tmp_path / "results") == _files(tmp_path / "ref")
    with open(tmp_path / "results" / "hc5n_hfs" / "throughput.json") as fh:
        tp = json.load(fh)
    assert tp["device"] == "cpu" and tp["sampler"] == "EnsembleSampler"
    assert tp["launches"] == {}          # the general path launches no kernel
    assert tp["setup_s"] > 0.0 and tp["elapsed_s"] > 0.0


def test_cli_fit_all_molecules(hc5n, tmp_path):
    """`fit --all-molecules` fits every molecule of the config's
    data_paths: two copies of the flagship problem (the second catalog a
    copy under another name), each with its own files; the two chains are
    bitwise equal (same data, same Q, same seed)."""
    cat_folder = tmp_path / "catalog"
    cat_folder.mkdir()
    shutil.copy(hc5n["cat_path"], cat_folder / "hc5n_hfs.cat")
    shutil.copy(hc5n["cat_path"], cat_folder / "hc5n_hfs_copy.cat")
    cfg = _fit_config(hc5n, str(tmp_path / "results"), cat_folder=str(cat_folder),
                      data_paths={"hc5n_hfs_copy": hc5n["data_path"],
                                  "hc5n_hfs": hc5n["data_path"]})
    out = _run("cha1_mcmc_tpu_torch", "fit", "--all-molecules", "--config",
               _write_config(tmp_path, "batch.json", cfg))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.index("[1/2] hc5n_hfs ") < out.stdout.index("[2/2] hc5n_hfs_copy")
    chains = [np.load(tmp_path / "results" / mol / "chain_template.npy")
              for mol in ("hc5n_hfs", "hc5n_hfs_copy")]
    assert chains[0].shape == (8, 6, 4)
    np.testing.assert_array_equal(chains[0], chains[1])


def test_fit_molecules_round_robin(hc5n, tmp_path):
    """fit_molecules takes the sorted molecules round-robin: process 1 of
    2 fits the second one only."""
    from cha1_mcmc_tpu_torch import FitConfig
    from cha1_mcmc_tpu_torch.pipeline import fit_molecules

    cat_folder = tmp_path / "catalog"
    cat_folder.mkdir()
    for mol in ("hc5n_a", "hc5n_b"):
        shutil.copy(hc5n["cat_path"], cat_folder / f"{mol}.cat")
    cfg = FitConfig.from_dict(_fit_config(hc5n, str(tmp_path / "results"), nruns=3,
                                          cat_folder=str(cat_folder)))
    out = fit_molecules(cfg, {"hc5n_b": hc5n["data_path"], "hc5n_a": hc5n["data_path"]},
                        process_index=1, process_count=2)
    assert list(out) == ["hc5n_b"] and out["hc5n_b"].shape == (8, 3, 4)
    assert not os.path.exists(tmp_path / "results" / "hc5n_a")


def test_cli_multifit(tmp_path):
    """`multifit --config` on the synthetic GOTHAM problem (4 multiplets)
    exits 0 and writes the 14-dim chain, bitwise equal to the in-process
    multifit's."""
    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig

    prob = write_hc9n_problem(str(tmp_path / "problem"), n_multiplets=4)
    cfg = {"mol_name": "hc9n_hfs", "template_run": True, "cat_folder": prob["cat_folder"],
           "data_path": prob["data_path"], "fit_folder": str(tmp_path / "results"),
           "nwalkers": 32, "nruns": 6, "checkpoint_every": 3, "seed": 0, "device": "cpu"}
    out = _run("cha1_mcmc_tpu_torch", "multifit", "--config",
               _write_config(tmp_path, "gotham.json", cfg))
    assert out.returncode == 0, out.stderr[-2000:]
    chain = np.load(tmp_path / "results" / "hc9n_hfs" / "chain.npy")
    assert chain.shape == (32, 6, 14) and np.isfinite(chain).all()
    ref = MultiComponentFit(MultiFitConfig(**{**cfg, "fit_folder": str(tmp_path / "ref")}))
    np.testing.assert_array_equal(chain, ref.run())
    assert _files(tmp_path / "results") == _files(tmp_path / "ref")


def test_cli_diagnose(tmp_path):
    """Twin of tests/test_workbench.py::test_cli_diagnose: `diagnose
    chain.npy` prints the tau/ESS/R-hat table and a convergence verdict,
    the same lines as the JAX command line."""
    rng = np.random.default_rng(0)
    chain = rng.normal(size=(16, 400, 3)).astype(np.float32)
    path = str(tmp_path / "chain.npy")
    np.save(path, chain)
    out = _run("cha1_mcmc_tpu_torch", "diagnose", path, timeout=300)
    assert out.returncode == 0, out.stderr[-1000:]
    assert "R-hat" in out.stdout
    assert "converged (all R-hat < 1.05)" in out.stdout
    stuck = np.repeat(rng.normal(size=(16, 1, 3)), 400, axis=1).astype(np.float32)
    stuck += rng.normal(scale=1e-3, size=stuck.shape).astype(np.float32)
    np.save(path, stuck)
    out = _run("cha1_mcmc_tpu_torch", "diagnose", path, "--burn-frac", "0.5", timeout=300)
    assert out.returncode == 0, out.stderr[-1000:]
    assert "NOT converged (max R-hat" in out.stdout
    assert "200 steps post burn-in" in out.stdout


def test_cli_diagnose_matches_jax(tmp_path):
    """The port's diagnose prints the JAX command line's table and verdict
    line for line."""
    chain = np.random.default_rng(1).normal(size=(8, 300, 2))
    path = str(tmp_path / "chain.npy")
    np.save(path, chain)
    outs = [_main(pkg, "diagnose", path) for pkg in ("cha1_mcmc_tpu", "cha1_mcmc_tpu_torch")]
    assert outs[0] == outs[1] == (0, outs[1][1]) and "R-hat" in outs[1][1]


@pytest.mark.parametrize("command,names", [
    ("workbench", ("workbench", "P12")),
    ("bench", ("benchmark", "P9")),
])
def test_unported_subcommands_exit_nonzero(command, names):
    """`workbench` and `bench` are not ported yet: they exit non-zero with
    an error naming the ROADMAP item that ports them."""
    out = _run("cha1_mcmc_tpu_torch", command, timeout=120)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    for name in names:
        assert name in out.stderr, (name, out.stderr[-500:])


def test_prepare_and_setup_leave_the_chain_and_count_apart():
    """EnsembleSampler.prepare (the set-up a fit times apart from its rate:
    one step's draws from a generator of its own, the starting lnprob)
    leaves the run's chain bitwise as it was; Throughput.setup adds its
    seconds to setup_s, not to elapsed, and its launches to launches."""
    import torch
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler, fused
    from cha1_mcmc_tpu_torch.utils import Throughput

    cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)

    def lnprob(theta):
        return -0.5 * torch.einsum("wi,ij,wj->w", theta, prec, theta)

    pos = torch.as_tensor(np.random.default_rng(0).standard_normal((16, 2)))
    chains = []
    for prepared in (False, True):
        sampler = EnsembleSampler(lnprob_fn=lnprob, nwalkers=16, ndim=2, a=2.0,
                                  dtype=torch.float64, device=torch.device("cpu"))
        gen = torch.Generator().manual_seed(3)
        lnp0 = sampler.prepare(pos) if prepared else None
        sampler.run_mcmc(pos, 64, gen, checkpoint_every=32, lnp0=lnp0)
        chains.append(sampler.chain)
    np.testing.assert_array_equal(chains[0], chains[1])

    saved = dict(fused.LAUNCHES)
    try:
        tp = Throughput()
        with tp.setup():
            fused.LAUNCHES["fused_lnprob"] += 1
        with tp:
            fused.LAUNCHES["fused_steps"] += 2
        with tp:
            fused.LAUNCHES["fused_steps"] += 2
    finally:
        fused.LAUNCHES.update(saved)
    assert tp.launches == {"fused_lnprob": 1, "fused_steps": 4}
    assert tp.setup_s > 0.0 and tp.elapsed > 0.0
    assert tp.summary()["setup_s"] == tp.setup_s
