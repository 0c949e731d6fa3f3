"""The traffic generator: back-to-back chains, the one kind of traffic a
mix file under benchmark/traffic names (`"kind": "chain"`), driven
through the program's public API in a closed loop (one user, the next
chain once the last one is done).

Set-up runs one short `fit_class(config(...)).init_setup()` + `.fit(grid)`
on the cell's configuration, then one chain of the window's length. The
window runs chains of `nsteps` steps in blocks of `block` through
`run_mcmc` of a fresh sampler of the class and kernel the set-up fit
chose, each starting from the state the previous one ended in; no chain
file.

The fit is the one the configuration names: `"fit_class"`, a name in
cha1_mcmc_tpu_torch's `__all__` (default "SpectralFit"; or
"MultiComponentFit"). Its configuration class is the one its
constructor's `config` annotation names (FitConfig, MultiFitConfig: both
take the same run fields), built from the fit's fields (the
configuration's `fit` with the problem's files) and the traffic's
walkers, block and seed; the fit exposes `.sampler` and reduces to a
Datagrid.

A chain in flight when the window closes is finished and counted. The
work is fixed by the mix and the seed only orders the draws: every seed
runs the same sizes.
"""

from __future__ import annotations

import dataclasses
import os
import time
import typing

import numpy as np
import torch
from torch.profiler import record_function


def derive_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, *keys]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def launches() -> dict:
    from cha1_mcmc_tpu_torch.utils.metrics import kernel_launches
    return kernel_launches()


def fit_classes(config: dict):
    """(fit class, its configuration class): the class of
    cha1_mcmc_tpu_torch's public API that the configuration's
    `fit_class` names (default "SpectralFit"), and the class its
    constructor's `config` argument is annotated with."""
    import cha1_mcmc_tpu_torch as program

    name = config.get("fit_class", "SpectralFit")
    if name not in program.__all__:
        raise ValueError(f"fit_class {name!r} is not a name in cha1_mcmc_tpu_torch.__all__")
    fit_class = getattr(program, name)
    return fit_class, typing.get_type_hints(fit_class.__init__)["config"]


class Driver:
    """One run's traffic: `setup` warms up the cell's shapes (and checks
    the configuration's geometry and kernel path), `window` runs the
    measured loop, `release` drops the program's state."""

    def __init__(self, traffic: dict, fitkw: dict, config: dict, seed: int, workdir: str,
                 device: str):
        self.traffic, self.fitkw, self.config = traffic, fitkw, config
        self.seed, self.workdir, self.device = seed, workdir, device

    def _check_setup(self, grid, before: dict):
        geo, moved = self.config["geometry"], launches()
        got = (len(grid.covered_trans), len(grid.freqs))
        if got != (geo["n_lines"], geo["n_channels"]):
            raise RuntimeError(f"reduced geometry {got} lines x channels, the configuration "
                               f"states {(geo['n_lines'], geo['n_channels'])}")
        counter = self.config["path_counter"]
        if counter and moved.get(counter, 0) == before.get(counter, 0):
            raise RuntimeError(f"the set-up fit did not launch {counter}: not the "
                               "configuration's kernel path")

    def setup(self):
        fit_class, config_class = fit_classes(self.config)
        if self.traffic["kind"] != "chain":
            raise ValueError(f"traffic kind {self.traffic['kind']!r}: the generator runs "
                             "\"chain\" only")
        before = launches()
        tr = self.traffic
        cfg = config_class(**self.fitkw, nwalkers=tr["nwalkers"], nruns=tr["block"],
                           checkpoint_every=tr["block"], seed=derive_seed(self.seed, 0),
                           device=self.device, fit_folder=os.path.join(self.workdir, "fit"))
        fit = fit_class(cfg)
        with record_function("bench/init_setup"):
            grid = fit.init_setup()
        with record_function("bench/fit"):
            chain = fit.fit(grid)
        self._check_setup(grid, before)
        self.base = fit.sampler
        pos, lnp = chain[:, -1], fit.sampler.lnprobability[:, -1]
        # one chain of the window's length: its host arrays are the
        # window's sizes, so the first chain of the window pays no more
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(self.seed, 2))
        self.pos, self.lnp = dataclasses.replace(self.base).run_mcmc(
            pos, tr["nsteps"], gen, checkpoint_every=tr["block"], lnp0=lnp)
        if self.device != "cpu":
            torch.cuda.synchronize(self.device)

    def release(self):
        self.base = None

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, tracer) -> tuple[list, float, float]:
        """(records, window start, last request's end) on the host clock."""
        keep_rng = np.random.default_rng(derive_seed(self.seed, 3))
        records = []
        tracer.open(launches())
        t_start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            try:
                with record_function("bench/request"):
                    rec = self._chain_request(i)
            except Exception as e:   # a failed request is counted, the loop goes on
                import traceback
                traceback.print_exc()
                rec = dict(i=i, error=repr(e), walker_steps=0)
            t1 = time.perf_counter()
            rec.update(t0=t0, t1=t1)
            records.append(rec)
            tracer.request_end(rec, launches())
            last = t1 - t_start >= seconds
            if "error" not in rec:
                keep = i == 0 or last or keep_rng.random() < self.traffic["check_share"]
                sampler = rec.pop("sampler")
                if keep:
                    rec["chain"], rec["lnps"] = sampler.chain, sampler.lnprobability
                del sampler
            if last:
                return records, t_start, t1
            i += 1

    def _chain_request(self, i: int) -> dict:
        tr = self.traffic
        seed = derive_seed(self.seed, 1, i)
        sampler = dataclasses.replace(self.base)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        pos0, lnp0 = self.pos, self.lnp
        with record_function("bench/run_mcmc"):
            self.pos, self.lnp = sampler.run_mcmc(pos0, tr["nsteps"], gen,
                                                  checkpoint_every=tr["block"], lnp0=lnp0)
        return dict(i=i, seed=seed, nsteps=tr["nsteps"], block=tr["block"],
                    walker_steps=tr["nsteps"] * tr["nwalkers"], sampler=sampler,
                    pos0=pos0, lnp0=lnp0, final_pos=self.pos)
