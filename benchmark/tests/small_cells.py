"""Small copies of the benchmark's cells for the CPU tests: the dense
configuration on its small band, 16 walkers, short chains; the program
runs its general sampler on the CPU (no kernel path to check)."""

from __future__ import annotations

from benchmark import run as harness


#: Every configuration with every traffic mix of the benchmark's files,
#: as cells: those BENCHMARK.json names and the two pairs it does not.
CELLS = {f"{c}:{t}": dict(name=f"{c}.{t}", config=c, traffic=t, chips=1)
         for c in ("hc5n-cha1", "dense-rotor")
         for t in ("chains-16k", "chains-64k")}


def small(cell_name: str):
    """A copy of a cell ("config:traffic", see CELLS) cut to a CPU test's
    size: the small dense band, 16 walkers, short chains."""
    bench = harness.Bench()
    cell = CELLS[cell_name]
    config, traffic = bench.config(cell), bench.traffic(cell)
    config["path_counter"] = None        # the CPU runs the general sampler
    if config["name"] == "dense-rotor":
        config["problem"]["args"]["scale"] = "small"
        config["geometry"] = {"n_lines": 228, "n_channels": 858}
        config["fit"]["lower_limit"], config["fit"]["upper_limit"] = 9700.0, 10500.0
    traffic.update(nwalkers=16, nsteps=64, block=16, check_transitions=8)
    return bench, cell, config, traffic


def run_small(cell_name: str, seed: int = 3_000_000_017, seconds: float = 1.0):
    bench, cell, config, traffic = small(cell_name)
    return harness.run_cell(bench, cell, seed, seconds, False, device="cpu",
                            config=config, traffic=traffic)
