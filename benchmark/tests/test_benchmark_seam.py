"""The configuration seam on the CPU: a configuration may name its fit
(`fit_class`) and its reference (`reference`); without them a cell runs
the single-component fit. The
multi-component reference (benchmark/reference/multi.py) against the
program's multifit, and the frozen GOTHAM writer against the tests'.

    python -m pytest benchmark/tests -q"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, drivers, roofline  # noqa: E402
from benchmark import run as harness  # noqa: E402
from benchmark.problems.gotham import write_hc9n_problem  # noqa: E402
from benchmark.reference import model, multi  # noqa: E402
from benchmark.reference.catalog import parse_catalog  # noqa: E402
from benchmark.reference.reduction import reduce  # noqa: E402
from benchmark.tests.small_cells import HC9N_CONFIG  # noqa: E402

HC9N = json.loads(HC9N_CONFIG.read_text())


def listed(name, tmp_path):
    """(config, fit fields) of a configuration of BENCHMARK.json on the
    CPU, the dense one on its small band."""
    bench = harness.Bench()
    config = next(bench.config(w) for w in bench.spec["workloads"] if w["config"] == name)
    if name == "dense-rotor":
        config["problem"]["args"]["scale"] = "small"
        config["fit"]["lower_limit"], config["fit"]["upper_limit"] = 9700.0, 10500.0
    return config, harness.problem_fitkw(config, str(tmp_path))


def single_thetas(fitkw, n, seed):
    """n thetas around the template, some outside the prior box."""
    rng = np.random.default_rng(seed)
    means = np.asarray(fitkw["template_means"][1:], np.float64)
    stds = np.asarray(fitkw["template_stds"][1:], np.float64)
    th = means + rng.normal(size=(n, 4)) * stds * np.array([1.0, 0.5, 2.0, 1.0])
    th[:, 0] = np.abs(th[:, 0]) + 1e9
    return th


def multi_thetas(n, seed):
    """n thetas of the 14-dim layout: half near the template, half pushed
    out of the prior box one way each (velocity order, dV bound, Tex,
    a source size, a column density)."""
    rng = np.random.default_rng(seed)
    means = np.asarray(HC9N["fit"]["template_means"], np.float64)
    stds = np.asarray(HC9N["fit"]["template_stds"], np.float64)
    th = means + rng.normal(size=(n, 14)) * stds * 3.0
    out = th[n // 2:]
    for k, row in enumerate(out):
        kind = k % 5
        if kind == 0:
            row[10], row[11] = row[11], row[10]        # vlsr_2 > vlsr_3
        elif kind == 1:
            row[13] = 0.3 + 0.01 * rng.random()        # dV at or past dv_bound
        elif kind == 2:
            row[8] = 2.7 - rng.random()                # Tex below 2.7
        elif kind == 3:
            row[2] = 200.0 + rng.random()              # a source size past 200
        else:
            row[5] = -1e10                             # a negative column
    return th


@pytest.mark.parametrize("name", ["hc5n-cha1", "dense-rotor"])
def test_a_configuration_without_the_keys_resolves_to_the_single_component_fit(name, tmp_path):
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

    config, fitkw = listed(name, tmp_path)
    assert not {"fit_class", "reference"} & set(config)
    assert drivers.fit_classes(config) == (SpectralFit, FitConfig)
    ref = check.Reference(fitkw, config, "cpu")
    assert ref.build is model.build and isinstance(ref.post, model.Posterior)

    class Traced:
        requests = [dict(nsteps=4, final_pos=np.arange(12.0).reshape(3, 4))]
        result, launches = None, {}

    assert np.array_equal(harness.Run([], {}, Traced, ref).traced_dv[0], [3.0, 7.0, 11.0])


@pytest.mark.parametrize("name", ["hc5n-cha1", "dense-rotor"])
def test_the_default_reference_is_the_single_component_posterior_bitwise(name, tmp_path):
    """The default reference, given the configuration or its partition
    alone, is model.Posterior over the parsed catalog and the reduction,
    bit for bit, and so is its bfloat16 control; a configuration without
    a partition is refused."""
    config, fitkw = listed(name, tmp_path)
    f = fitkw
    cat = parse_catalog(os.path.join(f["cat_folder"], f["mol_name"] + ".cat"),
                        config["partition"])
    grid = reduce(cat, np.load(f["data_path"], allow_pickle=True), ll=f["lower_limit"],
                  ul=f["upper_limit"], aligned_velocity=f["aligned_velocity"],
                  dish_size=f["dish_size"], source_size=f["fixed_source_size"])
    th = single_thetas(fitkw, 64, 5)
    want = model.Posterior(cat, grid, fitkw, device="cpu").lnprob(th)
    assert np.isfinite(want[0]).sum() > 16 and not np.isfinite(want[0]).all()
    for second in (config, config["partition"]):
        ref = check.Reference(fitkw, second, "cpu")
        for got, w in zip(ref.post.lnprob(th), want):
            assert np.array_equal(got, w)
    with pytest.raises(KeyError, match="partition"):
        check.Reference(fitkw, {k: v for k, v in config.items() if k != "partition"}, "cpu")
    lower = model.Posterior(cat, grid, fitkw, device="cpu", dtype=torch.bfloat16).lnprob(th)
    post_in, lnz = ref.stand_in("bfloat16")
    assert lnz and post_in.dtype == torch.bfloat16
    for got, w in zip(post_in.lnprob(th), lower):
        assert np.array_equal(got, w)


def test_a_configuration_names_the_multifit():
    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig

    assert drivers.fit_classes(HC9N) == (MultiComponentFit, MultiFitConfig)
    with pytest.raises(ValueError, match="__all__"):
        drivers.fit_classes({"fit_class": "Datagrid"})


def _tests_writer():
    """tests/port_problems.py:write_hc9n_problem, loaded under a name
    that is not `tests` (a run refuses a loaded `tests` module)."""
    spec = importlib.util.spec_from_file_location("port_problems_as_tested",
                                                  ROOT / "tests" / "port_problems.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.write_hc9n_problem


@pytest.mark.parametrize("args", [{}, {"n_multiplets": 4}, {"n_multiplets": 9, "seed": 5,
                                                            "snr": 2.0}])
def test_the_gotham_writer_writes_the_tests_bytes(args, tmp_path):
    def sha(path):
        return hashlib.sha256(Path(path).read_bytes()).hexdigest()

    want = _tests_writer()(str(tmp_path / "tests"), **args)
    got = write_hc9n_problem(str(tmp_path / "bench"), **args)
    for key in ("cat_path", "data_path"):
        assert sha(got[key]) == sha(want[key])
    assert got["noise_sigma"] == want["noise_sigma"] and got["n_lines"] == want["n_lines"]


def program_multifit(fitkw, tmp_path):
    """The program's float64 multifit on the CPU (the general path), run
    two steps: its Datagrid and its lnprob."""
    import contextlib
    import io

    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig

    cfg = MultiFitConfig(**dict(fitkw, dtype="float64"), nwalkers=16, nruns=2,
                         checkpoint_every=2, seed=1, device="cpu",
                         fit_folder=str(tmp_path / "fit"))
    fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = fit.init_setup()
        fit.fit(grid)
    return grid, fit.sampler.lnprob_fn


@pytest.mark.parametrize("n_multiplets", [22, 4])
def test_multi_reference_equals_the_programs_multifit(n_multiplets, tmp_path):
    config = json.loads(json.dumps(HC9N))
    config["problem"]["args"]["n_multiplets"] = n_multiplets
    fitkw = harness.problem_fitkw(config, str(tmp_path / "problem"))
    grid, lnprob = program_multifit(fitkw, tmp_path)
    ref = check.Reference(fitkw, config, "cpu")
    assert ref.build is multi.build
    for got, want in zip(ref.grid, (grid.freqs, grid.ints, grid.yerrs, grid.covered_trans)):
        assert np.array_equal(got, want)
    if n_multiplets == 22:
        geo = HC9N["geometry"]
        assert (len(grid.covered_trans), len(grid.freqs)) == (geo["n_lines"],
                                                              geo["n_channels"])
    th = multi_thetas(64, n_multiplets)
    want = lnprob(torch.as_tensor(th)).numpy()
    got, scale = ref.post.lnprob(th)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(want).sum() >= 24 and np.isneginf(want).sum() >= 32
    ok = np.isfinite(want)
    assert np.max(np.abs(got[ok] - want[ok]) / scale[ok]) < 1e-12


def test_the_hc9n_partition_is_the_programs(tmp_path):
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.catalogs.partition import q_model_for_catalog

    made = write_hc9n_problem(str(tmp_path), n_multiplets=2)
    q = q_model_for_catalog(load_catalog(made["cat_path"], name="hc9n_hfs"))
    cat = parse_catalog(made["cat_path"], HC9N["partition"])
    for T in (2.8, 6.7, 8.0, 40.0, 300.0):
        assert float(q.host_eval(T)) == pytest.approx(float(cat.partition(T)), rel=1e-15)


def test_the_multi_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.multi, benchmark.check; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert "benchmark" in out
    assert not set(out) & (set(harness.FORBIDDEN) | {"cha1_mcmc_tpu_torch"})


def test_no_roofline_reader_counts_a_k2_window(monkeypatch, tmp_path):
    """A traced K2 window (launches under `multi_steps`) gives the K1 and
    K3 readers nothing, without calling the single-component count; and
    a cell of the multifit is given neither metric."""
    def refuse(*args):
        raise AssertionError("step_bound_s called with a multi-component posterior")

    monkeypatch.setattr(roofline, "step_bound_s", refuse)
    config = json.loads(json.dumps(HC9N))
    config["problem"]["args"]["n_multiplets"] = 2
    fitkw = harness.problem_fitkw(config, str(tmp_path))

    class Traced:
        requests = [dict(nsteps=512, final_pos=np.full((128, 14), 0.117))]
        result = dict(kernels={"multi_cluster_steps_kernel": [20_000.0]}, busy_s=1.0,
                      window_s=1.0)
        launches = {"multi_steps": 16}

    run = harness.Run([], {}, Traced, check.Reference(fitkw, config, "cpu"))
    bench = harness.Bench()
    for name in ("k1_roofline", "k3_roofline"):
        assert bench.reader(name)(run) is None
    cell = dict(name="hc9n-chain", config="hc9n-gotham", traffic="chains-64k", chips=1)
    assert not {"k1_roofline", "k3_roofline"} & {m["name"] for m in
                                                bench.metrics(cell, "per_layer")}
