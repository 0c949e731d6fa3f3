"""Read the two sides of each limit of a cell's comparison: the program's
numbers over many seeds (the lower readings), and on the same steps those
of the lower-precision control and of a planted fault (the upper
readings), in one process so that set-up is paid once.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <k>] [--out <file.jsonl>]

Each seed runs a short window of the cell's traffic (--seconds, the
chain in flight finished) and judges it as a run does
(benchmark/check.py, the same number of steps); the first --control-seeds
seeds also judge each of check.STAND_INS put in the program's place on
the same steps: the reference in bfloat16 (the control) and the
reference in float64 whose acceptance leaves out (D - 1) ln z (a fault).
One JSON line a seed: {"seed", "requests", "program": {number: value},
"bfloat16": {...} or null, "no_lnz": {...} or null, "rate"}. Not part of
a run: the benchmark's runs never compute a stand-in.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
if Path(sys.path[1]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(1)

from benchmark.run import Bench, problem_fitkw, time_builds  # noqa: E402


def calibrate(bench: Bench, cell: dict, seeds, seconds: float, control_seeds: int,
              device: str = "cuda", config=None, traffic=None, out=None):
    import numpy as np

    from benchmark import check, drivers
    from benchmark.trace import Tracer

    config = config or bench.config(cell)
    traffic = traffic or bench.traffic(cell)
    workdir = tempfile.mkdtemp(prefix="bench-cal-", dir=os.environ.get("TMPDIR"))
    lines = []
    quiet = open(os.devnull, "w")
    try:
        with contextlib.redirect_stdout(quiet):
            fitkw = problem_fitkw(config, os.path.join(workdir, "problem"))
            time_builds(config["kernel_sources"], device)
            first = drivers.Driver(traffic, fitkw, config, seeds[0], workdir, device)
            first.setup()
        ref = check.Reference(fitkw, config, device)
        a = fitkw.get("stretch_a", 2.0)
        for k, seed in enumerate(seeds):
            d = drivers.Driver(traffic, fitkw, config, seed, workdir, device)
            d.base, d.pos, d.lnp = first.base, first.pos, first.lnp
            with contextlib.redirect_stdout(quiet):
                records, t0, t1 = d.window(seconds, Tracer(False, None, device))
            first.pos, first.lnp = d.pos, d.lnp
            t = time.perf_counter()

            def judged(stand_in=None):
                rng = np.random.default_rng(drivers.derive_seed(seed, 4))
                return check.judge(ref, records, traffic, rng, a=a, stand_in=stand_in)[0]

            line = dict(seed=seed, requests=len(records),
                        errors=[r["error"] for r in records if "error" in r],
                        program=judged())
            for kind in check.STAND_INS:
                line[kind] = judged(kind) if k < control_seeds else None
            line.update(judge_s=time.perf_counter() - t,
                        rate=sum(r["walker_steps"] for r in records) / (t1 - t0))
            lines.append(line)
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as fh:
                    fh.write(json.dumps(dict(line, workload=cell["name"])) + "\n")
        return lines
    finally:
        quiet.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    calibrate(bench, bench.cell(args.workload), args.seeds, args.seconds, args.control_seeds,
              out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
