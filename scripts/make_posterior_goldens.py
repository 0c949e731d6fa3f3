#!/usr/bin/env python3
"""Write the JAX package's float64 posterior goldens of the port's three
synthetic fits, on the CPU.

    python scripts/make_posterior_goldens.py                      # all three
    python scripts/make_posterior_goldens.py --problem gotham     # one
    python scripts/make_posterior_goldens.py --problem dense --chains DIR

For each problem of tests/posterior_probe.py's PROBLEMS (the flagship
SpectralFit on write_hc5n_problem, the GOTHAM MultiComponentFit on
write_hc9n_problem, the dense SpectralFit on
write_dense_problem(scale="full"), each configured as chip_smoke.py's
phase 5 configures the port) the script runs the JAX package's fit,
init_setup() then fit() (run() less its corner plot), in float64 with
one checkpoint block, twice, from two seeds. Each run's burn is picked
in its own tau (posterior_gate.pick_burn), the two runs are held to
each other with posterior_gate.compare at the card's floors, and the
script stops there if they disagree. Otherwise it pools them (the
walkers side by side, the larger burn), checks that the pool meets
GOLDEN_FLOORS on its own, and writes tests/golden/port_posterior_<name>.json:
the pooled summary, both runs' summaries, the provenance (generator,
problem, config fields, lengths, seeds, jax version, wall seconds, the
runs' largest |z|), the sha256 and fingerprint (exactly rounded sums,
posterior_probe.datagrid_fingerprint) of the reduced datagrid, and 16 probe
thetas with the JAX lnprob at each. --chains DIR also saves the raw
chains there. Run the three problems as three processes in parallel:
on 8 CPU cores the flagship took ~6 minutes, GOTHAM ~40 and the dense
problem ~90.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (nwalkers, nsteps) of each of the two JAX runs.
SIZES = {"flagship": (256, 30_000), "gotham": (256, 60_000), "dense": (128, 40_000)}
SEEDS = (1, 2)
N_PROBES = 16


def probe_thetas(lnprob, summary, rng, n=N_PROBES):
    """n thetas with a finite lnprob, drawn uniformly from the pooled
    posterior's p50 +- 4 sigma box by `rng` (candidates whose prior is
    -inf, outside the prior box or out of velocity order, are skipped)."""
    import numpy as np

    lo = np.asarray(summary["p50"]) - 4 * np.asarray(summary["std"])
    hi = np.asarray(summary["p50"]) + 4 * np.asarray(summary["std"])
    out, vals = [], []
    while len(out) < n:
        cand = rng.uniform(lo, hi, size=(4 * n, lo.size))
        lp = lnprob(cand)
        keep = np.isfinite(lp)
        out += list(cand[keep])
        vals += list(lp[keep])
    return np.array(out[:n]), np.array(vals[:n])


def run_problem(name: str, walkers: int, steps: int, chains_dir: str | None) -> dict:
    import jax
    import numpy as np

    from tests import posterior_gate as gate
    from tests import posterior_probe as probe
    from tests.posterior_probe import JAX, build_lnprob64, make_fit

    fit_kind, writer, writer_kwargs, _ = probe.PROBLEMS[name]
    runs, chains, walls = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        prob = probe.write_problem(name, os.path.join(tmp, "problem"))
        for seed in SEEDS:
            fit = make_fit(JAX, name, prob, os.path.join(tmp, f"fit{seed}"),
                           nwalkers=walkers, nruns=steps, checkpoint_every=steps,
                           seed=seed, dtype="float64")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                grid = fit.init_setup()
                chain = np.asarray(fit.fit(grid))
            walls.append(time.perf_counter() - t0)
            assert chain.shape == (walkers, steps, fit.spec.ndim), chain.shape
            assert chain.dtype == np.float64 and np.isfinite(chain).all()
            if chains_dir:
                os.makedirs(chains_dir, exist_ok=True)
                np.save(os.path.join(chains_dir, f"{name}_seed{seed}.npy"), chain)
            burn = gate.pick_burn(chain)
            runs.append(gate.summarize(chain, burn, fit.spec.labels))
            chains.append(chain)
            print(f"{name} seed {seed}: {walls[-1]:.1f} s, burn {burn}, tau "
                  + ", ".join(f"{t:.1f}" for t in runs[-1]["tau"]), flush=True)
        rows = gate.compare(runs[0], runs[1], floors=gate.CARD_FLOORS)
        print(gate.format_rows(rows), flush=True)
        if gate.failures(rows):
            raise SystemExit(f"{name}: the two JAX seeds disagree or cannot be "
                             "resolved; no golden written")
        burn = max(r["burn"] for r in runs)
        pooled = gate.summarize(np.concatenate([c[:, burn:] for c in chains], axis=0),
                                0, fit.spec.labels)
        pooled["burn"], pooled["S"] = burn, steps
        del chains
        own = gate.check_floors(pooled, gate.GOLDEN_FLOORS)
        print(gate.format_rows(own), flush=True)
        if gate.failures(own):
            raise SystemExit(f"{name}: the pooled runs miss GOLDEN_FLOORS; no golden written")
        with jax.enable_x64():
            grid, lnprob = build_lnprob64(JAX, name, prob, os.path.join(tmp, "probe"))
            thetas, values = probe_thetas(lnprob, pooled, np.random.default_rng(0))
        cfg = {k: (list(v) if isinstance(v, tuple) else v)
               for k, v in vars(fit.config).items()
               if k not in ("cat_folder", "data_path", "fit_folder", "seed")}
    return {
        "provenance": {
            "generator": "scripts/make_posterior_goldens.py",
            "package": "cha1_mcmc_tpu", "jax_version": jax.__version__,
            "backend": "cpu", "fit": fit_kind, "entry": f"{fit_kind}.init_setup() + fit()",
            "problem": f"tests/port_problems.py:{writer}",
            "problem_kwargs": writer_kwargs, "config": cfg,
            "nwalkers": walkers, "nsteps": steps, "burn": burn, "seeds": list(SEEDS),
            "wall_seconds": walls, "seeds_max_abs_z": gate.max_abs_z(rows),
        },
        **pooled,
        "runs": runs,
        "datagrid_sha256": probe.datagrid_sha256(grid),
        "datagrid_fingerprint": probe.datagrid_fingerprint(grid),
        "probe": {"thetas": thetas.tolist(), "lnprob": values.tolist()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", choices=sorted(SIZES), action="append",
                    help="problem to run (repeatable; default: all three)")
    ap.add_argument("--chains", help="directory to save the raw chains in")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    from tests.posterior_probe import GOLDEN_DIR, PROBLEMS

    for name in args.problem or sorted(SIZES):
        golden = run_problem(name, *SIZES[name], args.chains)
        path = os.path.join(GOLDEN_DIR, PROBLEMS[name][3])
        with open(path, "w") as fh:
            json.dump(golden, fh, indent=1)
        print(f"wrote {path}: pooled tau_max {max(golden['tau']):.1f}, ESS min "
              f"{min(golden['ess']):.0f}, seeds' max |z| "
              f"{golden['provenance']['seeds_max_abs_z']:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
