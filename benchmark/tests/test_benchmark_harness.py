"""The benchmark's files and its harness on the CPU: every configuration,
traffic mix and metric file is found by the names in BENCHMARK.json and
only by them, names and units keep to the allowed characters, the import
guard compares whole top-level names, and a small copy of each cell runs
end to end (the program on the CPU, the reference judging it).

    python -m pytest benchmark/tests -q

The test marked `cuda` runs a cell on the card and skips elsewhere."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402
from benchmark.drivers import derive_seed  # noqa: E402
from benchmark.tests.small_cells import CELLS, run_small  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
BDIR = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for key in ("config", "traffic"):
            assert NAME.match(w[key])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(
        BENCH["workloads"])


def test_every_name_in_benchmark_json_has_its_file():
    configs = {c["file"] for c in BENCH["configs"]}
    assert configs == {str(p.relative_to(ROOT)) for p in (BDIR / "configs").glob("*.json")}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["precision"] == data["fit"]["dtype"] == "float32"
        assert set(data["limits"]) >= {"lnp_rel", "pos_rel", "flip_rel"}
    traffic = {p.stem for p in (BDIR / "traffic").glob("*.json")}
    assert {w["traffic"] for w in BENCH["workloads"]} <= traffic
    for t in traffic:
        assert NAME.match(t)
        assert json.loads((BDIR / "traffic" / f"{t}.json").read_text())["kind"] == "chain"
    metrics = {p.stem for p in (BDIR / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= metrics
    bench = harness.Bench()
    for name in metrics:
        assert NAME.match(name) and callable(bench.reader(name))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_cell_reports_the_metrics_it_needs():
    bench = harness.Bench()
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w, "end_to_end")}
        assert e2e == {"setup_s", "chain.walker_steps_per_s"}
        assert bench.metrics(w, "per_layer")
        for m in bench.metrics(w, "per_layer"):
            assert m["moves"] in e2e


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cha1_mcmc_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cha1_mcmc_tpu.sampler", object())
    assert harness.forbidden_modules() == ["cha1_mcmc_tpu"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["cha1_mcmc_tpu", "jax"]


@pytest.mark.parametrize("name", ["tests", "tests.port_problems", "bench", "bench_torch"])
def test_import_guard_refuses_the_repositorys_tests_and_bench_scripts(name, monkeypatch):
    for near in ("benchmark", "benchmark.tests", "benchmark.tests.small_cells", "testsuite",
                 "bench_torch_like", "benchmarks"):
        monkeypatch.setitem(sys.modules, near, sys.modules.get(near, object()))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == [name.split(".")[0]]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5])
def test_derived_seeds_fit_every_consumer(seed):
    import numpy as np
    import torch

    s = derive_seed(seed, 1, 2)
    assert 0 <= s < 2 ** 63 and s == derive_seed(seed, 1, 2) != derive_seed(seed, 1, 3)
    torch.Generator().manual_seed(s)
    np.random.default_rng(s)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_small_cell_runs_and_is_correct(cell):
    result = run_small(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    bench = harness.Bench()
    result = harness.run_cell(bench, bench.cell("hc5n-chain"), 5, 2.0, True)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert "chain.launches_per_kstep" in result["metrics"]
