"""Run one cell of the benchmark of cha1_mcmc_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The cell
(an entry of BENCHMARK.json's `workloads`) names a configuration
(benchmark/configs/<config>.json: the problem, its writer and data seed,
the fit's settings, the limits of the comparison) and a traffic mix
(benchmark/traffic/<traffic>.json, read by benchmark/drivers.py).

Besides its problem writer (`problem`: benchmark/problems/<module>.py), a
configuration may name, each optional:

* `fit_class`: the fit, a name in cha1_mcmc_tpu_torch's `__all__`
  (default "SpectralFit"); its configuration class is the one its
  constructor takes (benchmark/drivers.py);
* `reference`: the module of benchmark/reference/ whose
  `build(fitkw, config, device, dtype)` makes the posterior the run is
  judged against (default "model", the single-component posterior).

dV is theta's last column in every fit (Run.traced_dv).

The run writes the problem under $TMPDIR, warms up the cell's shapes
(set-up), runs the traffic for --seconds (the window), then judges what
the window produced against the plain reference (benchmark/check.py) and
prints one JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer metrics, each read by benchmark/metrics/<metric>.py),
`device`, with --trace 1 `breakdown`, and last `checks`, each number
compared beside its limit, which also end standard error.

The run exits non-zero with no result line when no CUDA device (or fewer
than the cell's chips) is present, when the program cannot be imported,
and when a module of jax, jaxlib, flax, the JAX package, the repository's
tests/ or its bench.py / bench_torch.py is loaded once the window has
closed. Kernel libraries (the CUDA sources and the native catalog
tokenizer) are built by the program into the checkout's build/ (fixed
paths), so only a checkout's first run compiles; the seconds that took
are reported apart as `compile_s` (in the result line and on standard
error) and left out of `setup_s`.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)      # benchmark/'s modules are imported as benchmark.<name>
sys.path.insert(0, str(ROOT))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"

#: Top-level module names no run may load: JAX and the JAX package, and
#: the repository's tests and bench scripts (the benchmark's own tests are
#: `benchmark.tests`, whose top-level name is `benchmark`).
FORBIDDEN = ("jax", "jaxlib", "flax", "cha1_mcmc_tpu", "tests", "bench", "bench_torch")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Bench:
    """BENCHMARK.json and the data files its names lead to."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.spec = json.loads((root / "BENCHMARK.json").read_text())
        self.bdir = root / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no configuration {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.bdir / "traffic" / f"{cell['traffic']}.json").read_text())

    def metrics(self, cell: dict, kind: str) -> list[dict]:
        """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, name: str):
        path = self.bdir / "metrics" / f"{name}.py"
        module_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def problem_fitkw(config: dict, folder: str) -> dict:
    """Write the configuration's problem into `folder`; the FitConfig
    fields of the configuration's fit on it."""
    import importlib

    p = config["problem"]
    writer = getattr(importlib.import_module(f"benchmark.problems.{p['module']}"), p["writer"])
    made = writer(folder, **p["args"])
    fitkw = dict(config["fit"], cat_folder=made["cat_folder"], data_path=made["data_path"])
    scale = config.get("ncol_from_truth")
    if scale:
        means, stds = list(fitkw["template_means"]), list(fitkw["template_stds"])
        means[1], stds[1] = scale["mean"] * made["truth"][0], scale["std"] * made["truth"][0]
        fitkw.update(template_means=means, template_stds=stds)
    return fitkw


def proc_io() -> dict:
    try:
        with open("/proc/self/io") as fh:
            return {k: int(v) for k, v in (ln.split(":") for ln in fh)}
    except OSError:
        return {}


def card(device: str) -> dict:
    import torch

    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1)
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


class Run:
    """What the per-layer readers read: the window's requests, its launch
    counts, the traced window and the reference (for the roofline)."""

    def __init__(self, records, launches, tracer, ref):
        self.records, self.launches, self.ref = records, launches, ref
        ok = [r for r in records if "error" not in r]
        self.steps = sum(r["nsteps"] for r in ok)
        traced = [r for r in tracer.requests if "error" not in r]
        self.traced_steps = sum(r["nsteps"] for r in traced)
        self.traced_dv = [r["final_pos"][:, -1] for r in traced]   # one ensemble's each
        self.trace = tracer.result
        self.traced_launches = tracer.launches or {}


def time_builds(sources, device: str) -> float:
    """Build the configuration's kernel sources and the native catalog
    tokenizer where the checkout's build/ has no library of them yet (the
    program would build each at its first use, into the same place); the
    seconds that took, 0.0 where every one was cached."""
    if device == "cpu":
        return 0.0
    from cha1_mcmc_tpu_torch.catalogs import native
    from cha1_mcmc_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    built = [bool(cuda_build.build_library(src)[1]) for src in sources]
    before = set(native.BUILD_DIR.glob("libspcat-*.so"))
    try:
        native.build_native()
    except RuntimeError:     # no g++: the program parses catalogs in Python
        pass
    built.append(set(native.BUILD_DIR.glob("libspcat-*.so")) != before)
    return time.perf_counter() - t0 if any(built) else 0.0


def run_cell(bench: Bench, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: dict | None = None,
             traffic: dict | None = None) -> dict | None:
    """One run of `cell` (a `workloads` entry); the result line's dict, or
    None where the run must print no result. `config` / `traffic` replace
    the files the cell names (tests run a small copy of a cell on the
    CPU)."""
    import numpy as np
    import torch

    from benchmark import check, drivers
    from benchmark.trace import Tracer

    config = config or bench.config(cell)
    traffic = traffic or bench.traffic(cell)
    workdir = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    quiet = open(os.devnull, "w")
    try:
        with contextlib.redirect_stdout(quiet):
            fitkw = problem_fitkw(config, os.path.join(workdir, "problem"))
            import cha1_mcmc_tpu_torch  # noqa: F401  (the import is set-up)
            compile_s = time_builds(config["kernel_sources"], device)
            driver = drivers.Driver(traffic, fitkw, config, seed, workdir, device)
            driver.setup()
            tracer = Tracer(trace and device != "cpu", traffic.get("trace_requests"), device)
            tracer.warm()
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            io0 = proc_io()
            launches0 = drivers.launches()
            setup_s = time.perf_counter() - T_PROCESS - compile_s
            records, t_start, t_end = driver.window(seconds, tracer)
            tracer.close(drivers.launches())
            launches = {k: v - launches0.get(k, 0) for k, v in drivers.launches().items()}
        memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded by the end of the window: {found}",
                  file=sys.stderr)
            return None
        driver.release()
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        ref = check.Reference(fitkw, config, device)
        pick_rng = np.random.default_rng(drivers.derive_seed(seed, 4))
        numbers, per_request = check.judge(ref, records, traffic, pick_rng,
                                           a=fitkw.get("stretch_a", 2.0))
        limits = config["limits"]
        failed = {r["i"] for r in records if "error" in r}
        failed |= {i for i, nums in per_request.items()
                   if any(v > limits[k] for k, v in nums.items())}
        correct = not failed and all(numbers[k] <= limits[k] for k in numbers)

        ok = [r for r in records if "error" not in r]
        walker_steps = sum(r["walker_steps"] for r in ok)
        run = Run(records, launches, tracer, ref)
        metrics = {}
        if trace:
            for m in bench.metrics(cell, "per_layer"):
                value = bench.reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            rate = walker_steps / (t_end - t_start)
            values = {"setup_s": setup_s, "chain.walker_steps_per_s": rate}
            for m in bench.metrics(cell, "end_to_end"):
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        print("request seconds " + " ".join(f"{r['t1'] - r['t0']:.4f}" for r in records),
              file=sys.stderr)
        io1 = proc_io()
        written = {k: io1.get(k, 0) - io0.get(k, 0) for k in ("wchar", "write_bytes")}
        dev = card(device)
        dev["memory_peak_bytes"] = int(memory_peak)
        if trace and tracer.result is not None:
            dev["busy_s"] = tracer.result["busy_s"]
            dev["window_s"] = tracer.result["window_s"]
        print(f"requests {len(records)}, walker-steps {walker_steps}, "
              f"window {t_end - t_start:.3f} s, set-up {setup_s:.3f} s, compile_s "
              f"{compile_s:.3f}, launches {launches}", file=sys.stderr)
        print(f"bytes written in the window: {written['wchar']} by write() calls, "
              f"{written['write_bytes']} to storage (/proc/self/io); process total "
              f"{io1.get('wchar', 0)} / {io1.get('write_bytes', 0)}; card {dev}",
              file=sys.stderr)
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return None
        result = dict(correct=bool(correct), attempted=len(records), failed=len(failed),
                      metrics=metrics, device=dev, compile_s=compile_s,
                      bytes_written=written)
        if trace and tracer.result is not None:
            result["breakdown"] = {k: tracer.result[k] for k in ("device_ops", "idle_gaps")}
        result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
        for k, v in numbers.items():
            print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
        return result
    finally:
        quiet.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no CUDA device for {args.workload} ({cell['chips']} needed): no result",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
