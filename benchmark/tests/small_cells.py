"""Small copies of the benchmark's cells for the CPU tests: the dense
configuration on its small band, the GOTHAM multifit on 4 of its 22
multiplets, 16 walkers, short chains; the program runs its general
sampler on the CPU (no kernel path to check)."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import run as harness

#: The GOTHAM HC9N multifit at its published widths, a configuration no
#: cell of BENCHMARK.json names yet, held here on the CPU through the
#: configuration seam (`fit_class`, `reference`).
HC9N_CONFIG = Path(__file__).with_name("hc9n-gotham.json")

#: Every configuration of BENCHMARK.json with every traffic mix of the
#: benchmark's files, as cells: those BENCHMARK.json names and the two
#: pairs it does not; and the multifit with the flagship's chains.
CELLS = {f"{c}:{t}": dict(name=f"{c}.{t}", config=c, traffic=t, chips=1)
         for c in ("hc5n-cha1", "dense-rotor")
         for t in ("chains-16k", "chains-64k")}
CELLS["hc9n-gotham:chains-64k"] = dict(name="hc9n-gotham.chains-64k", config="hc9n-gotham",
                                       traffic="chains-64k", chips=1)


def config_of(bench, cell: dict) -> dict:
    """The configuration of a cell, the multifit's from its file."""
    if cell["config"] == "hc9n-gotham":
        return json.loads(HC9N_CONFIG.read_text())
    return bench.config(cell)


def small(cell_name: str):
    """A copy of a cell ("config:traffic", see CELLS) cut to a CPU test's
    size: the small dense band, 4 GOTHAM multiplets, 16 walkers, short
    chains."""
    bench = harness.Bench()
    cell = CELLS[cell_name]
    config, traffic = config_of(bench, cell), bench.traffic(cell)
    config["path_counter"] = None        # the CPU runs the general sampler
    if config["name"] == "dense-rotor":
        config["problem"]["args"]["scale"] = "small"
        config["geometry"] = {"n_lines": 228, "n_channels": 858}
        config["fit"]["lower_limit"], config["fit"]["upper_limit"] = 9700.0, 10500.0
    if config["name"] == "hc9n-gotham":
        config["problem"]["args"]["n_multiplets"] = 4
        config["geometry"] = {"n_lines": 12, "n_channels": 199}
    traffic.update(nwalkers=16, nsteps=64, block=16, check_transitions=8)
    return bench, cell, config, traffic


def run_small(cell_name: str, seed: int = 3_000_000_017, seconds: float = 1.0):
    bench, cell, config, traffic = small(cell_name)
    return harness.run_cell(bench, cell, seed, seconds, False, device="cpu",
                            config=config, traffic=traffic)
