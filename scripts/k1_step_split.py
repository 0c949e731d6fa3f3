"""Split a K1 step on the card: where a half-update's time goes.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/k1_step_split.py [--parent DIR] [--out FILE]

On the synthetic flagship (chip_smoke's first case: 9 lines x 561
channels, fixed source size, 128 walkers, float32) it prints, and writes
as JSON to FILE (default build/k1_step_split.json):

  * the whole K1 step at each geometry (the wide path; 16 and 8 CTAs; 16
    CTAs with the tables in device memory), the card's time alone, from
    the walker ball, from the state after a 65,536-step chain (the
    `hc5n-chain` length) and from walkers outside the prior box (every
    proposal refused before its likelihood: the floor);
  * the parts of a half-update, each as the slope between launches of 16
    and 48 steps (so a launch's own cost drops out), from the variants of
    scripts/k1_step_split.cu: the lnprob round alone (a proposal per
    4-warp group on 16 CTAs, or per 16-warp CTA on 64), the step loop
    around an lnprob that costs nothing (proposal, acceptance, the row
    broadcast or row write, the barriers), and the bare barriers
    (cluster.sync() of 16 CTAs, grid.sync() of 64);
  * K = 1, 2, 4 and 8 chains of 128 walkers in one launch against K
    single-chain launches (chip_smoke.time_chains).

With --parent DIR (a `git archive` of an older commit, unpacked in a
directory .gitignore lists), the whole K1 step of that checkout's own
main path is timed in a process of its own before and after, from the
same walkers and randomness (`--whole-only` runs that part alone).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SLOPE_STEPS = (16, 48)
REPS = 20


def _root(path):
    root = Path(path).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    return root


@functools.cache
def problem(tmp):
    """chip_smoke's flagship case "analytic-4d" on the synthetic problem:
    (the case, f32 statics, f32 tables, the walker ball)."""
    import torch

    import chip_smoke
    from tests.port_problems import write_hc5n_problem

    case = chip_smoke.cases(write_hc5n_problem(tmp))[0]
    (st, tb), _ = chip_smoke.flagship_tables(case)
    pos0 = chip_smoke.flagship_pos0(case[3].ndim, seed=1, dtype=torch.float32)
    return case, st, tb, pos0


def whole_steps(tmp, geometries=None, nb=64):
    """{start: [(geometry, median, q1, q3 us/step)]}: the whole step,
    the card's time alone (chip_smoke.time_geometries), from the ball,
    from a 65,536-step state and from outside the prior box."""
    import torch

    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler.fused import FusedEnsemble, block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    case, st, tb, ball = problem(tmp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    run = FusedEnsemble(tb, st)
    pos, lnp = ball, run.lnprob(ball)
    t0 = time.perf_counter()
    for _ in range(65_536 // 512):
        _, _, _, (pos, lnp) = run(pos, lnp, 512, chip_smoke.K_STEPS, generator=gen)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    floor = ball.clone()
    floor[:, -2] = 9.0 + 0.1 * torch.rand(ball.shape[0], generator=gen, device="cuda")
    kw = {} if geometries is None else dict(geometries=geometries)
    out = {"65536-step chain s": chain_s}
    for name, start in (("ball", ball), ("65536-step state", pos), ("floor", floor)):
        rb = block_randomness(draw_randomness(nb * chip_smoke.K_STEPS, chip_smoke.W, gen,
                                              device="cuda"), chip_smoke.K_STEPS)
        out[name] = chip_smoke.time_geometries("K1", case[0], tb, st, start, gen, "card",
                                               rb=rb, queued=True, where=f" from {name}",
                                               **kw)
    return out


def build_split():
    """Build scripts/k1_step_split.cu against the package's csrc/ (cached
    under build/ by a digest of both) and bind its entries."""
    import hashlib

    from cha1_mcmc_tpu_torch.utils.cuda_build import (BUILD_DIR, CSRC_DIR, NVCC_FLAGS,
                                                      find_nvcc, source_digest)

    src = Path(__file__).resolve().with_suffix(".cu")
    digest = hashlib.sha256((source_digest(src) + source_digest(CSRC_DIR / "fused_step.cu"))
                            .encode()).hexdigest()[:16]
    out = BUILD_DIR / f"k1_step_split-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
                               str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.split_null_steps_f32.argtypes = [P] * 10 + [I] * 5 + [ctypes.c_float, P]
    lib.split_lnprob_f32.argtypes = [P] * 9 + [I] * 8 + [P]
    lib.split_barriers.argtypes = [I] * 3 + [P]
    for fn in (lib.split_null_steps_f32, lib.split_lnprob_f32, lib.split_barriers):
        fn.restype = I
    return lib


def launch_us(launch, reps=REPS):
    """us of one launch() by CUDA events over `reps` back to back (the
    card's time: a ~20-ms sleep first lets the host queue them all)."""
    import torch

    launch()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    t0.record()
    for _ in range(reps):
        launch()
    t1.record()
    torch.cuda.synchronize()
    return 1e3 * t0.elapsed_time(t1) / reps


def half_update_parts(tmp):
    """{part: (median, q1, q3) us a half-update}, each the slope between
    SLOPE_STEPS steps a launch, medians of 2 x chip_smoke.TIMING_PAIRS
    runs in turns."""
    import torch

    import chip_smoke
    from cha1_mcmc_tpu_torch.sampler import cluster, fused
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    case, st, tb, pos0 = problem(tmp)
    lib = build_split()
    dev, f32 = tb[0].device, torch.float32
    ktb, (La, M, C, S) = fused.kernel_tables(tb, f32, dev)
    W, D = pos0.shape
    h = W // 2
    statics = fused._pack_statics(st, f32)
    wide = cluster.plan_wide(fused.FAMILY, W, 1, D, La, C, M, f32)
    clus = cluster.plan_cluster(fused.FAMILY, W, 1, D, La, C, M, f32, cluster=16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    lnp0 = torch.zeros(W, dtype=f32, device=dev)
    thetas = pos0[:h].contiguous()
    lnps = torch.empty(h, dtype=f32, device=dev)
    blocks = {}
    for k in SLOPE_STEPS:
        rb = [t[0].contiguous() for t in fused.block_randomness(
            draw_randomness(k, W, gen, device="cuda"), k)]
        outs = (torch.empty((k * W, D), dtype=f32, device=dev),
                torch.empty(k * W, dtype=f32, device=dev),
                torch.empty(k, dtype=torch.float32, device=dev))
        blocks[k] = (rb, outs)

    def null(plan, k):
        rb, outs = blocks[k]
        args = (pos0.data_ptr(), lnp0.data_ptr(), *(t.data_ptr() for t in rb),
                *(t.data_ptr() for t in outs), ctypes.addressof(plan.layout.packed), W, D, k,
                plan.cluster, int(plan.wide), ctypes.c_float(st.a), stream)
        return lambda: check(lib.split_null_steps_f32(*args))

    def lnprob(plan, k):
        args = (thetas.data_ptr(), lnps.data_ptr(), *(t.data_ptr() for t in ktb),
                ctypes.addressof(statics), ctypes.addressof(plan.layout.packed),
                h if plan.wide else 16, int(plan.wide), D, La, M, C, S, 2 * k, stream)
        return lambda: check(lib.split_lnprob_f32(*args))

    def barriers(n, grid, k):
        return lambda: check(lib.split_barriers(n, grid, 2 * k, stream))

    def check(err):
        if err:
            raise RuntimeError(f"split launch failed: CUDA error {err}")

    parts = {
        "lnprob round, 16 CTAs (4 groups of 4 warps)": lambda k: lnprob(clus, k),
        "lnprob round, 64 CTAs (1 group of 16 warps)": lambda k: lnprob(wide, k),
        "null step half, 16-CTA cluster (DSMEM broadcast)": lambda k: null(clus, k),
        "null step half, wide (row write, grid.sync)": lambda k: null(wide, k),
        "bare cluster.sync(), 16 CTAs": lambda k: barriers(16, 0, k),
        "bare grid.sync(), 64 CTAs": lambda k: barriers(h, 1, k),
    }
    times = {name: [] for name in parts}
    launches = {name: {k: make(k) for k in SLOPE_STEPS} for name, make in parts.items()}
    order = list(parts)
    lo, hi = SLOPE_STEPS
    for _ in range(chip_smoke.TIMING_PAIRS):
        for name in order + order[::-1]:
            a, b = (launch_us(launches[name][k]) for k in SLOPE_STEPS)
            times[name].append((b - a) / (2 * (hi - lo)))
    return {name: chip_smoke.quartiles(ts) for name, ts in times.items()}


def chains(tmp):
    """chip_smoke.time_chains for K1: K = 1, 2, 4, 8 chains in one launch
    against K single-chain launches."""
    import torch

    import chip_smoke

    case, *_ = problem(tmp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    out = chip_smoke.time_chains("K1", case, gen, "card")
    return {K: {"one launch": one, "sequential": seq, "bound us": b}
            for K, (one, seq, b, _) in out.items()}


def parent_whole(parent, script):
    proc = subprocess.run([sys.executable, str(script), "--whole-only", "--root", parent],
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        raise RuntimeError(f"the parent's run failed ({proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an older commit, timed alongside")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--whole-only", action="store_true",
                    help="time the whole step of the checkout at --root, print JSON")
    ap.add_argument("--out", default="build/k1_step_split.json")
    args = ap.parse_args()
    script = Path(__file__).resolve()
    root = _root(args.root)
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        if args.whole_only:
            import chip_smoke

            main_path = tuple(g for g in chip_smoke.TIMED_GEOMETRIES if g[1] == 16)[:1]
            print(json.dumps(whole_steps(tmp, geometries=main_path, nb=64)))
            return 0
        gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        result = {"card": gpu.stdout.strip(), "torch": torch.__version__}
        if args.parent:
            result["parent before"] = parent_whole(args.parent, script)
        result["whole"] = whole_steps(tmp)
        result["parts"] = half_update_parts(tmp)
        for name, (m, q1, q3) in result["parts"].items():
            print(f"[split] {name}: {m:.3f} [{q1:.3f}, {q3:.3f}] us a half-update", flush=True)
        result["chains"] = chains(tmp)
        if args.parent:
            result["parent after"] = parent_whole(args.parent, script)
    out = root / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
