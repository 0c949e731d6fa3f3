"""The benchmark's plain reference: the same semantics as the program's fits,
written again in NumPy (the catalog, the partition function, the
reductions) and plain PyTorch (the forward models, the likelihood, the
priors, the stretch move). A configuration names the module that builds
its posterior (`"reference"`, a module here with `build(fitkw, config,
device, dtype)`): `model`, the single-component fit (the default), or
`multi`, the N-component GOTHAM multifit. It imports nothing of the
program, of its JAX original or of the repository's tests, and takes
nothing the program made: it parses the same catalog and spectrum files
and replays the stretch move's random stream from the benchmark's seed.
"""
