#!/usr/bin/env python3
"""Which engine's Ncol spread is right on the synthetic flagship, and how
the independent Metropolis's spread depends on its run's length.

    python3 scripts/posterior_gate_probe.py

Run from the repository root on a CUDA card. It writes the synthetic
flagship problem of tests/port_problems.py and takes chip_smoke.cases'
first case (analytic Q, 4 dims). Then, all in f32 with 128 walkers or
chains:

- two K1 fits (SpectralFit, as chip_smoke phase 5 runs it): seed 0 x
  4,096 steps (the smoke's reference length) and seed 1 x 16,384 steps,
  each after 1,024 steps of burn-in, the second also cut at 4,096 and
  8,192 steps;
- two runs of run_adaptive_metropolis (8 x 128 warm-up steps, 19,200
  frozen), seeds 6 and 7, each cut at 2,400 / 4,800 / 9,600 / 19,200
  frozen steps after 600, with tests/test_convergence.py:365's relative
  std gap |K1 std - Metropolis std| / Metropolis std against the seed-0
  fit;
- the posterior integrated over grids of 64 x 48 x 16 x 16, 128 x 96 x
  24 x 24 and 192 x 128 x 32 x 32 points (f64 lnprob on the card) spanning
  every chain (10% past their range, inside the prior's box): marginal
  means and stds, the mass on each axis's outer planes and Ncol's
  quantiles.

Each line prints the mean, std and quantiles of (Ncol, Tex, vlsr, dV).
The last lines print the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
import cha1_mcmc_tpu_torch as port  # noqa: E402
from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis  # noqa: E402
from cha1_mcmc_tpu_torch.inference import build_lnprob, single_component_lnprior  # noqa: E402
from tests.port_problems import write_hc5n_problem  # noqa: E402


def stats(name, x):
    q = np.percentile(x, [2.5, 50, 97.5], axis=0)
    print(f"{name:34s} n={x.shape[0]:9d} mean " + " ".join(f"{v:.5g}" for v in x.mean(0))
          + " | std " + " ".join(f"{v:.5g}" for v in x.std(0))
          + " | q2.5/50/97.5 Ncol " + " ".join(f"{v:.4g}" for v in q[:, 0])
          + " Tex " + " ".join(f"{v:.4g}" for v in q[:, 1]), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("posterior_gate_probe: no CUDA device", file=sys.stderr)
        return 1
    tmp = tempfile.mkdtemp()
    prob = write_hc5n_problem(os.path.join(tmp, "problem"))
    label, m32, m64, spec, cfg, grid = cs.cases(prob)[0]
    print("case", label, flush=True)
    k1 = {}
    for seed, nruns in ((0, 4096), (1, 16384)):
        fit = port.SpectralFit(port.FitConfig(
            mol_name="hc5n_hfs", cat_folder=prob["cat_folder"], data_path=prob["data_path"],
            fit_folder=os.path.join(tmp, f"fit{seed}"), nwalkers=128, nruns=nruns,
            checkpoint_every=4096, seed=seed, device="cuda"))
        k1[seed] = fit.run()
    means, stds = np.asarray(cfg.template_means), np.asarray(cfg.template_stds)
    lnprob = build_lnprob(m32, spec, grid.ints, grid.yerrs,
                          single_component_lnprior(spec, cfg.bounds, means, stds))
    ref = k1[0][:, 1024:].reshape(-1, 4).astype(np.float64)
    stats("K1 seed0 4096 (smoke ref)", ref)
    for n in (4096, 8192, 16384):
        stats(f"K1 seed1 first {n}", k1[1][:, 1024:n].reshape(-1, 4).astype(np.float64))
    mh = {}
    for seed in (6, 7):
        rng = np.random.default_rng(11)
        pos0 = torch.as_tensor(means + (stds / 10) * rng.standard_normal((128, 4)),
                               dtype=torch.float32, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        chain, _, acc = run_adaptive_metropolis(lnprob, pos0, gen, nsteps=19200,
                                                init_sigma=stds / 10, batched=True)
        torch.cuda.synchronize()
        print(f"MH seed {seed}: {time.perf_counter() - t0:.1f} s acc {acc:.4f}", flush=True)
        chain = chain.cpu().numpy()
        mh[seed] = chain
        for n in (2400, 4800, 9600, 19200):
            m = chain[600:n].reshape(-1, 4).astype(np.float64)
            stats(f"MH seed{seed} frozen {n}", m)
            print(f"    std ratio K1ref/MH {ref.std(0) / m.std(0)}  JAX check "
                  f"|s-m|/m {np.abs(ref.std(0) - m.std(0)) / m.std(0)}", flush=True)
    allc = np.concatenate([ref] + [c[600:].reshape(-1, 4) for c in mh.values()]
                          + [k1[1][:, 1024:].reshape(-1, 4)])
    lo, hi = allc.min(0), allc.max(0)
    span = hi - lo
    box = np.array([cfg.bounds[k] for k in ("Ncol", "Tex", "vlsr", "dV")])
    lo = np.maximum(lo - 0.1 * span, box[:, 0])
    hi = np.minimum(hi + 0.1 * span, box[:, 1])
    print("grid box", lo, hi, flush=True)
    lnprob64 = build_lnprob(m64, spec, grid.ints, grid.yerrs,
                            single_component_lnprior(spec, cfg.bounds, means, stds,
                                                     dtype=torch.float64))
    for shape in ((64, 48, 16, 16), (128, 96, 24, 24), (192, 128, 32, 32)):
        axes = [np.linspace(a, b, n + 2)[1:-1] for a, b, n in zip(lo, hi, shape)]
        t0 = time.perf_counter()
        g_mean, g_std, edge = cs.posterior_grid_moments(lnprob64, lo, hi, shape)
        secs = time.perf_counter() - t0
        # Ncol's quantiles from its marginal on the same grid
        mesh = torch.stack(torch.meshgrid(
            *(torch.as_tensor(a, dtype=torch.float64, device="cuda") for a in axes),
            indexing="ij"), -1).reshape(-1, 4)
        lnp = torch.cat([lnprob64(mesh[i:i + 65536]) for i in range(0, mesh.shape[0], 65536)])
        w = torch.nan_to_num(torch.exp(lnp - lnp.max()), nan=0.0).reshape(shape)
        cdf = np.cumsum(w.sum((1, 2, 3)).cpu().numpy())
        q = np.interp([0.025, 0.16, 0.5, 0.84, 0.975], cdf / cdf[-1], axes[0])
        print(f"grid {shape} ({int(np.prod(shape)):,} pts, {secs:.2f} s f64): mean "
              + " ".join(f"{v:.5g}" for v in g_mean) + " | std "
              + " ".join(f"{v:.5g}" for v in g_std) + " | edge mass "
              + " ".join(f"{v:.2e}" for v in edge) + " | Ncol q2.5/16/50/84/97.5 "
              + " ".join(f"{v:.4g}" for v in q), flush=True)
    print("std ratio K1 seed0 / finest grid", ref.std(0) / g_std)
    for seed, c in mh.items():
        print(f"std ratio MH seed{seed} 19200 / finest grid",
              c[600:].reshape(-1, 4).astype(np.float64).std(0) / g_std)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
