"""Command-line entry point of the port (cha1_mcmc_tpu/__main__.py's
subcommands and arguments).

The reference is driven by hand-editing a config dict inside a script
(reference inference.py:585-631, README.md:49-54). Here the same
vocabulary is a JSON file:

  python -m cha1_mcmc_tpu_torch fit --config run.json
  python -m cha1_mcmc_tpu_torch fit --config run.json --all-molecules
  python -m cha1_mcmc_tpu_torch multifit --config gotham.json
  python -m cha1_mcmc_tpu_torch diagnose results/hc5n_hfs/chain_template.npy

A fit runs on the device its config names (`"device"`, default "cuda";
`"device": "cpu"` runs it on the CPU). `workbench` and `bench` are not
ported yet and exit with an error that names the ROADMAP item porting them.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_config(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cha1_mcmc_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_fit = sub.add_parser("fit", help="single-molecule fit (DSN-style)")
    p_fit.add_argument("--config", required=True, help="JSON config (FitConfig fields)")
    p_fit.add_argument("--all-molecules", action="store_true",
                       help="fit every molecule in the config's data_paths")

    p_multi = sub.add_parser("multifit", help="multi-component fit (GOTHAM-style)")
    p_multi.add_argument("--config", required=True, help="JSON config (MultiFitConfig fields)")

    sub.add_parser("bench", help="run the HC5N benchmark and print one JSON line")

    p_diag = sub.add_parser(
        "diagnose", help="convergence report (tau / ESS / R-hat) for a "
                         "chain .npy")
    p_diag.add_argument("chain", help="chain file, (nwalkers, nsteps, ndim)")
    p_diag.add_argument("--burn-frac", type=float, default=0.2)

    p_wb = sub.add_parser(
        "workbench",
        help="interactive simulation shell (the vendored tool's command "
             "vocabulary over the arrays-in/arrays-out Workbench)")
    p_wb.add_argument("--session", default=None,
                      help="saved session path (from the shell's `save`)")

    args = parser.parse_args(argv)

    if args.command == "fit":
        from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

        raw = _load_config(args.config)
        cfg = FitConfig.from_dict(raw)
        if args.all_molecules:
            from cha1_mcmc_tpu_torch.pipeline.batch import fit_molecules

            fit_molecules(cfg, raw.get("data_paths", {cfg.mol_name: cfg.data_path}))
        else:
            SpectralFit(cfg).run()
    elif args.command == "multifit":
        from cha1_mcmc_tpu_torch import MultiFitConfig, MultiComponentFit

        d = _load_config(args.config)
        cfg = MultiFitConfig(**{k: v for k, v in d.items()
                                if k in MultiFitConfig.__dataclass_fields__})
        MultiComponentFit(cfg).run()
    elif args.command == "diagnose":
        import numpy as np

        from cha1_mcmc_tpu_torch.sampler import summarize_convergence

        chain = np.load(args.chain)
        conv = summarize_convergence(chain, burn_in_frac=args.burn_frac)
        print(f"chain {chain.shape} ({args.chain}); "
              f"{conv['nsteps_post_burn']} steps post burn-in")
        print(f"{'dim':>4} {'tau':>10} {'ESS':>12} {'R-hat':>8}")
        for i, (t, e, r) in enumerate(zip(conv["tau"], conv["ess"],
                                          conv["r_hat"])):
            print(f"{i:>4} {t:>10.1f} {e:>12.0f} {r:>8.4f}")
        worst = float(max(conv["r_hat"]))
        print("converged (all R-hat < 1.05)" if worst < 1.05
              else f"NOT converged (max R-hat {worst:.3f})")
    elif args.command == "workbench":
        raise NotImplementedError(
            "workbench: the Workbench shell (pipeline/workbench.py, repl.py) is not "
            "ported yet; it is the next slice of ROADMAP Queue 1 (P12, the workbench)")
    elif args.command == "bench":
        raise NotImplementedError(
            "bench: the port's benchmark is not written yet; it belongs to a "
            "`benchmark` issue (ROADMAP Queue 1, P9), which also writes BENCHMARK.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
