"""The benchmark of cha1_mcmc_tpu_torch: `python3 benchmark/run.py` runs one
cell of BENCHMARK.json (see run.py)."""
