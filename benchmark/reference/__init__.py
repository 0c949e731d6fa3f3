"""The benchmark's plain reference: the same semantics as the program's
single-component fit, written again in NumPy (the catalog, the partition
function, the reduction) and plain PyTorch (the forward model, the
likelihood, the priors, the stretch move). It imports nothing of the
program, of its JAX original or of the repository's tests, and takes
nothing the program made: it parses the same catalog and spectrum files
and replays the stretch move's random stream from the benchmark's seed.
"""
