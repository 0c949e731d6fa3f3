#!/usr/bin/env python3
"""What a process's first fit pays inside its timed region that later
fits do not, for one or more checkouts of this repository, on one GPU.

    python3 scripts/first_fit_probe.py OTHER_CHECKOUT . . OTHER_CHECKOUT

Run from the repository root on a CUDA card. It writes the synthetic
flagship problem of tests/port_problems.py once into build/first_fit/.
Each checkout builds its K1 library first (into its own build/
directory), in a process of its own. Then, for each checkout in the
order given, a fresh process with that
checkout first on sys.path runs three SpectralFit.run() in a row (128
walkers x 1,024 steps, checkpoints every 256, seed 0, K1) and prints, for
each fit, the walker-steps/s and the seconds of its Throughput
(throughput.json's rate, elapsed_s and, where the checkout records it,
setup_s), and the time of the sampler's parts, each timed with
torch.cuda.synchronize on both sides: the set-up (prepare, where the
checkout has it), the starting lnprob (lnp0), the
kernel library's load, K1's cluster plan, the random draws
(draw_randomness, block_randomness), each checkpoint block (_run_block)
and np.save; the first call's time beside the sum. The last line is the
card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(repo: str, cat_folder: str, data_path: str, out: str) -> None:
    sys.path.insert(0, repo)
    import time

    import numpy as np
    import torch

    import cha1_mcmc_tpu_torch as port
    from cha1_mcmc_tpu_torch.sampler import fused
    from cha1_mcmc_tpu_torch.sampler import stretch

    log = []

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            log.append((name, (time.perf_counter() - t0) * 1e3))
            return r
        return wrapper

    sampler = fused.FusedEnsembleSampler
    sampler.lnp0 = timed("lnp0", sampler.lnp0)
    sampler._run_block = timed("run_block", sampler._run_block)
    if hasattr(sampler, "prepare"):          # the set-up timed apart from the rate
        sampler.prepare = timed("prepare", sampler.prepare)
    fused.load_kernel_library = timed("load_lib", fused.load_kernel_library)
    fused.cluster_plan = timed("cluster_plan", fused.cluster_plan)
    fused.draw_randomness = timed("draw_randomness", fused.draw_randomness)
    fused.block_randomness = timed("block_randomness", fused.block_randomness)
    stretch.np.save = timed("np.save", np.save)
    print(f"checkout {os.path.abspath(repo)}", flush=True)
    for i in range(3):
        log.clear()
        fit = port.SpectralFit(port.FitConfig(
            mol_name="hc5n_hfs", cat_folder=cat_folder, data_path=data_path,
            fit_folder=os.path.join(out, f"fit{i}"), nwalkers=128, nruns=1024,
            checkpoint_every=256, seed=0, device="cuda"))
        fit.run()
        tp = fit.throughput
        parts = {}
        for name, ms in log:
            calls, total, first = parts.get(name, (0, 0.0, ms))
            parts[name] = (calls + 1, total + ms, first)
        print(f"PROBE fit {i}: {tp.walker_steps_per_sec:,.0f} walker-steps/s, elapsed "
              f"{tp.elapsed * 1e3:.2f} ms, setup {getattr(tp, 'setup_s', 0.0) * 1e3:.2f} ms; "
              + "; ".join(f"{n} x{c} {t:.2f} ms (first {f:.2f})"
                          for n, (c, t, f) in parts.items()), flush=True)
        print("PROBE   blocks: " + ", ".join(f"{ms:.2f}" for n, ms in log
                                             if n == "run_block"), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(*sys.argv[2:6])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--build":
        sys.path.insert(0, sys.argv[2])
        from cha1_mcmc_tpu_torch.sampler import fused
        fused.load_kernel_library()
        return 0
    sys.path.insert(0, HERE)
    from tests.port_problems import write_hc5n_problem

    root = os.path.join(HERE, "build", "first_fit")
    prob = write_hc5n_problem(os.path.join(root, "problem"))
    repos = sys.argv[1:] or ["."]
    for repo in dict.fromkeys(repos):   # build each checkout's K1 first, untimed
        subprocess.run([sys.executable, os.path.abspath(__file__), "--build", repo],
                       check=True)
    for n, repo in enumerate(repos):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", repo,
                              prob["cat_folder"], prob["data_path"],
                              os.path.join(root, f"run{n}")],
                             capture_output=True, text=True)
        print("\n".join(ln for ln in out.stdout.splitlines()
                        if ln.startswith(("PROBE", "checkout"))), flush=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
