"""Multi-chain ensembles of the torch port (cha1_mcmc_tpu_torch/sampler/
stretch.py: run_ensemble_chains, MultiChainSampler; sampler/diagnostics.py;
the same-state retry of EnsembleSampler.run_mcmc; the fits with n_chains > 1
and profile_dir) against the JAX package, on the CPU.

Inputs are made from seeds with NumPy and handed to both packages; each
chain's randomness is the JAX package's, rebuilt from that chain's key
(tests/torch_parity.py:jax_randomness). Tolerances: float64 chains and
acceptances bitwise; lnps rtol 1e-12 (reductions run in another order);
the diagnostics, a NumPy copy, exactly equal. The K-chain CUDA launches of
K1 and K2 are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import (TRUTH_4, gotham_problem, jax_gotham_model,
                                jax_gotham_reduce, jax_model, jax_randomness, jax_reduce,
                                port_model, problem, spec_and_prior, to_torch, walker_ball)
from tests.torch_ranks import spawn

torch.set_num_threads(1)

K, W, NSTEPS, K_STEPS = 3, 16, 8, 4
DV_BOUND = 0.3


def _stack(rnds):
    """The per-chain randomness tuples stacked on a leading chain axis."""
    return tuple(torch.stack(t) for t in zip(*(to_torch(r) for r in rnds)))


def _toy_lnprob(theta):
    """A cheap batched lnprob (correlated Gaussian) for contract tests."""
    x = theta - torch.arange(theta.shape[1], dtype=theta.dtype)
    return -0.5 * (x * x).sum(dim=1) - 0.3 * x[:, 0] * x[:, 1]


def _toy_pos(n_chains, nwalkers, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n_chains, nwalkers, 3)) * 0.1 + np.arange(3))


@pytest.fixture(scope="module")
def reduced(problem):
    return jax_reduce(problem)


@pytest.fixture(scope="module")
def gotham_reduced(gotham_problem):
    return jax_gotham_reduce(gotham_problem)


# -- (a) run_ensemble_chains against the JAX package ---------------------------

@pytest.mark.parametrize("thin", [1, 2])
def test_run_ensemble_chains_matches_jax_f64(reduced, thin):
    import jax
    import jax.numpy as jnp
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnprob,
                                         single_component_lnprior)
    from cha1_mcmc_tpu.sampler import run_ensemble_chains as jax_chains
    from cha1_mcmc_tpu_torch import inference as port_inf
    from cha1_mcmc_tpu_torch.sampler import run_ensemble_chains

    cat, grid = reduced
    ss, means, stds, bounds = spec_and_prior(4)
    nsteps = 12 // thin
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        jl = build_lnprob(jm, spec, grid.ints, grid.yerrs,
                          single_component_lnprior(spec, bounds, means, stds))
        pos0 = jnp.asarray(np.stack([walker_ball(TRUTH_4, W, 30 + c) for c in range(K)]))
        lnp0 = jax.vmap(jax.vmap(jl))(pos0)
        keys = jax.random.split(jax.random.PRNGKey(17), K)
        cj, lj, aj, (pj, lpj) = jax_chains(jl, pos0, lnp0, keys, nsteps=nsteps, thin=thin)
        rnd = _stack([jax_randomness(keys[c], nsteps * thin, W, "float64")
                      for c in range(K)])
        cj, lj, aj, pj, lpj, pos0, lnp0 = map(np.array, (cj, lj, aj, pj, lpj, pos0, lnp0))
    pspec = port_inf.ParamSpec(ncomp=1, fixed_source_size=ss)
    pl = port_inf.build_lnprob(port_model(jm, torch.float64), pspec, grid.ints, grid.yerrs,
                               port_inf.single_component_lnprior(pspec, bounds, means, stds,
                                                                 dtype=torch.float64))
    cp, lp, ap, (pp, lpp) = run_ensemble_chains(pl, torch.from_numpy(pos0),
                                                torch.from_numpy(lnp0), rnd, nsteps,
                                                thin=thin)
    assert cp.shape == (K, nsteps, W, 4) and lp.shape == (K, nsteps, W)
    assert ap.shape == (K, nsteps) and pp.shape == (K, W, 4) and lpp.shape == (K, W)
    np.testing.assert_array_equal(cp.numpy(), cj)
    np.testing.assert_array_equal(ap.numpy(), aj)
    np.testing.assert_array_equal(pp.numpy(), pj)
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-12)
    np.testing.assert_allclose(lpp.numpy(), lpj, rtol=1e-12)
    assert (0 < ap.sum(dim=1)).all() and (ap.sum(dim=1) < nsteps * thin * W).all()


# -- (b) each chain is run_ensemble alone ---------------------------------------

def test_each_chain_equals_run_ensemble_alone():
    """Twin of tests/test_sampler.py:125: chain c of run_ensemble_chains,
    on randomness drawn from one generator in chain order
    (draw_chain_randomness), equals run_ensemble on that chain drawing
    from the generator's stream at chain c's turn."""
    from cha1_mcmc_tpu_torch.sampler import run_ensemble, run_ensemble_chains
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_chain_randomness

    pos0 = _toy_pos(K, W)
    lnp0 = torch.stack([_toy_lnprob(p) for p in pos0])
    rnd = draw_chain_randomness(K, 50, W, torch.Generator().manual_seed(7),
                                dtype=torch.float64)
    chains, lnps, acc, (pos, lnp) = run_ensemble_chains(_toy_lnprob, pos0, lnp0, rnd, 50)
    assert chains.shape == (K, 50, W, 3)
    ref = torch.Generator().manual_seed(7)
    for c in range(K):
        ck, lk, ak, (pk, lpk) = run_ensemble(_toy_lnprob, pos0[c], lnp0[c], ref, 50)
        assert torch.equal(chains[c], ck) and torch.equal(lnps[c], lk)
        assert torch.equal(acc[c], ak) and torch.equal(pos[c], pk)
    with pytest.raises(ValueError, match="K, W, D"):
        run_ensemble_chains(_toy_lnprob, pos0[0], lnp0[0], tuple(t[0] for t in rnd), 5)


# -- (c) MultiChainSampler: the pooled layout and exact resume -----------------

def _multichain(n_chains=2, nwalkers=16, lnprob_fn=_toy_lnprob, **kw):
    from cha1_mcmc_tpu_torch.sampler import MultiChainSampler

    return MultiChainSampler(lnprob_fn=lnprob_fn, nwalkers=nwalkers, ndim=3,
                             dtype=torch.float64, device="cpu", n_chains=n_chains, **kw)


def test_multichain_sampler_pools_chains(tmp_path):
    """Twin of tests/test_sampler.py:142: the pooled (K*W, S, D) chain is
    K run_ensemble histories stacked chains-contiguous, each block drawing
    chain 0's randomness, then chain 1's, from the one generator; the
    .npy / .state.npz contract holds, and a split resume equals the
    unsplit run bitwise."""
    from cha1_mcmc_tpu_torch.sampler import run_ensemble

    Kc, Wc = 2, 8
    pos0 = _toy_pos(Kc, Wc, seed=1)
    path = str(tmp_path / "mc.npy")
    s = _multichain(Kc, Kc * Wc)
    pos, lnp = s.run_mcmc(pos0, 30, torch.Generator().manual_seed(5),
                          checkpoint_every=10, chain_file=path)
    assert s.chain.shape == (Kc * Wc, 30, 3) and s.lnprobability.shape == (Kc * Wc, 30)
    assert pos.shape == (Kc, Wc, 3) and lnp.shape == (Kc, Wc)
    np.testing.assert_array_equal(np.load(path), s.chain)
    state = np.load(str(tmp_path / "mc.state.npz"))
    np.testing.assert_array_equal(state["pos"], pos)
    assert int(state["total_proposals"]) == 30 * Kc * Wc == s.total_proposals

    gen = torch.Generator().manual_seed(5)
    cur = [(pos0[c], _toy_lnprob(pos0[c])) for c in range(Kc)]
    blocks = {c: [] for c in range(Kc)}
    for _ in range(3):
        for c in range(Kc):
            ck, _, _, cur[c] = run_ensemble(_toy_lnprob, *cur[c], gen, 10)
            blocks[c].append(ck.numpy().transpose(1, 0, 2))
    per_chain = s.chain.reshape(Kc, Wc, 30, 3)
    for c in range(Kc):
        np.testing.assert_array_equal(per_chain[c], np.concatenate(blocks[c], axis=1))

    # split at a block boundary, resumed from the sidecar (pos (K, W, D))
    first = _multichain(Kc, Kc * Wc)
    first.run_mcmc(pos0, 20, torch.Generator().manual_seed(5), checkpoint_every=10,
                   chain_file=path)
    second = _multichain(Kc, Kc * Wc)
    second.preload(np.load(path))
    pos, lnp0, rng_state = second.load_state(path)
    gen = torch.Generator()
    gen.set_state(rng_state)
    second.run_mcmc(pos, 10, gen, checkpoint_every=10, chain_file=path, lnp0=lnp0)
    np.testing.assert_array_equal(second.chain, s.chain)
    assert second.accepted == s.accepted and second.total_proposals == s.total_proposals

    # a pooled (K*W, D) tail, as preload returns it, is taken too
    third = _multichain(Kc, Kc * Wc)
    tail = third.preload(s.chain[:, :20])
    assert tail.shape == (Kc * Wc, 3)
    third.run_mcmc(tail, 10, torch.Generator().manual_seed(9), checkpoint_every=10)
    assert third.chain.shape == (Kc * Wc, 30, 3)
    with pytest.raises(ValueError, match="divisible"):
        _multichain(3, 16)


def test_multichain_thin_records_every_thin_th_state():
    s1, s2 = _multichain(), _multichain()
    s1.run_mcmc(_toy_pos(2, 8, 3), 12, torch.Generator().manual_seed(4), checkpoint_every=12)
    s2.run_mcmc(_toy_pos(2, 8, 3), 6, torch.Generator().manual_seed(4), checkpoint_every=6,
                thin=2)
    np.testing.assert_array_equal(s2.chain, s1.chain[:, 1::2])
    assert s2.accepted == s1.accepted and s2.total_proposals == s1.total_proposals


# -- (d) K1 and K2 over a chain axis; MultiChainSampler with their run_fn -------

@pytest.fixture(scope="module")
def k1_run(reduced):
    """The port's float64 K1 runner on the synthetic flagship problem."""
    import jax
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.sampler.fused import make_fused_ensemble

    cat, grid = reduced
    ss, means, stds, bounds = spec_and_prior(4)
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
    return make_fused_ensemble(port_model(jm, torch.float64),
                               ParamSpec(ncomp=1, fixed_source_size=ss), grid.ints,
                               grid.yerrs, bounds, means, stds)


@pytest.fixture(scope="module")
def k2_run(gotham_reduced):
    """The port's float64 K2 runner on the synthetic HC9N problem (K = 4
    components) and its template (means, perturbation)."""
    import jax
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.pipeline.multifit import (_HC9N_MEANS, _HC9N_STDS,
                                                        _PERTURBATION)
    from cha1_mcmc_tpu_torch.sampler.fused_multi import make_fused_ensemble_multi

    cat, grid = gotham_reduced
    with jax.enable_x64():
        jm = jax_gotham_model(cat, grid, "float64")
    run = make_fused_ensemble_multi(port_model(jm, torch.float64), ParamSpec(ncomp=4),
                                    grid.ints, grid.yerrs, np.array(_HC9N_MEANS),
                                    np.array(_HC9N_STDS), dv_max=DV_BOUND)
    return run, np.array(_HC9N_MEANS), np.array(_PERTURBATION)


def _k1_pos(n_chains, nwalkers=W, seed=40):
    return torch.as_tensor(np.stack([walker_ball(TRUTH_4, nwalkers, seed + c)
                                     for c in range(n_chains)]))


def _k2_pos(means, pert, n_chains, nwalkers=W, seed=40):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(means + pert * rng.standard_normal((n_chains, nwalkers,
                                                                means.size)))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_plain_step_over_chains_equals_per_chain_calls(k1_run, k2_run, kernel):
    """The plain K1 / K2 step block over a leading chain axis equals a call
    per chain, and FusedEnsemble over (K, W, D) equals a run per chain on
    that chain's randomness, bitwise (f64)."""
    from cha1_mcmc_tpu_torch.sampler import draw_chain_randomness
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness

    if kernel == "K1":
        run, pos0 = k1_run, _k1_pos(K)
    else:
        run, means, pert = k2_run
        pos0 = _k2_pos(means, pert, K)
    lnp0 = torch.stack([run.lnprob(p) for p in pos0])
    rnd = draw_chain_randomness(K, NSTEPS, W, torch.Generator().manual_seed(2),
                                dtype=torch.float64)
    perm_b, z_b, pair_b, acc_b = block_randomness(rnd, K_STEPS)
    assert perm_b.shape == (NSTEPS // K_STEPS, K, K_STEPS * W) and perm_b.is_contiguous()
    batched = run.step_block(pos0, lnp0, perm_b[0], z_b[0], pair_b[0], acc_b[0])
    assert batched[0].shape == (K, K_STEPS * W, pos0.shape[-1])
    assert batched[2].shape == (K, K_STEPS)
    for c in range(K):
        alone = run.step_block(pos0[c], lnp0[c], perm_b[0, c], z_b[0, c], pair_b[0, c],
                               acc_b[0, c])
        for b, a in zip(batched, alone):
            assert torch.equal(b[c], a)
    cb, lb, ab, (pb, lpb) = run(pos0, lnp0, NSTEPS, K_STEPS, randomness=rnd)
    assert cb.shape == (K, NSTEPS, W, pos0.shape[-1]) and ab.shape == (K, NSTEPS)
    for c in range(K):
        ca, la, aa, (pa, lpa) = run(pos0[c], lnp0[c], NSTEPS, K_STEPS,
                                    randomness=tuple(t[c] for t in rnd))
        for x, y in ((cb[c], ca), (lb[c], la), (ab[c], aa), (pb[c], pa), (lpb[c], lpa)):
            assert torch.equal(x, y)
    assert 0 < float(ab.sum()) < NSTEPS * W * K


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_multichain_run_fn_equals_general_multichain(k1_run, k2_run, kernel, tmp_path):
    """The port's counterpart of tests/test_pallas.py::
    test_multichain_fused_matches_general: MultiChainSampler with the K1
    (synthetic HC5N) or K2 (synthetic HC9N) run_fn over the chain axis
    records the same pooled chain as the general MultiChainSampler over the
    same lnprob, bitwise in f64, thinned, across two checkpoint blocks."""
    from cha1_mcmc_tpu_torch.sampler import MultiChainSampler

    if kernel == "K1":
        run, pos0 = k1_run, _k1_pos(2)
    else:
        run, means, pert = k2_run
        pos0 = _k2_pos(means, pert, 2)
    D = pos0.shape[-1]
    runs = []
    for run_fn in (run, None):
        s = MultiChainSampler(lnprob_fn=run.lnprob, nwalkers=2 * W, ndim=D,
                              dtype=torch.float64, device="cpu", n_chains=2,
                              run_fn=run_fn, k_steps=K_STEPS)
        s.run_mcmc(pos0, 8, torch.Generator().manual_seed(11), checkpoint_every=4, thin=2,
                   chain_file=str(tmp_path / f"{run_fn is None}.npy"))
        runs.append(s)
    fused, general = runs
    assert fused.chain.shape == (2 * W, 8, D)
    np.testing.assert_array_equal(fused.chain, general.chain)
    np.testing.assert_array_equal(fused.lnprobability, general.lnprobability)
    assert fused.accepted == general.accepted and 0 < fused.accepted
    a = np.load(str(tmp_path / "False.state.npz"))
    b = np.load(str(tmp_path / "True.state.npz"))
    for key in ("pos", "lnp", "rng_state", "accepted"):
        np.testing.assert_array_equal(a[key], b[key])


# -- (e) the plain K1 over chains against the JAX kernel vmapped over chains ---

def test_plain_k1_over_chains_matches_jax_kernel_vmapped(reduced):
    """The port's plain K1 over K = 2 chains against the JAX fused kernel
    (interpret mode) vmapped over the chains' keys, as the JAX
    MultiChainSampler runs it (stretch.py:344-347). Tolerance: f64 chains,
    acceptances and final positions bitwise; lnps rtol 1e-12 (the channel
    sums run in another order)."""
    import jax
    import jax.numpy as jnp
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnprob,
                                         single_component_lnprior)
    from cha1_mcmc_tpu.sampler.fused import make_fused_ensemble
    from cha1_mcmc_tpu_torch.inference import ParamSpec as PortSpec
    from cha1_mcmc_tpu_torch.sampler.fused import make_fused_ensemble as port_make

    cat, grid = reduced
    ss, means, stds, bounds = spec_and_prior(4)
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        lnprob = build_lnprob(jm, spec, grid.ints, grid.yerrs,
                              single_component_lnprior(spec, bounds, means, stds))
        run = make_fused_ensemble(jm, spec, grid.ints, grid.yerrs, bounds, means, stds,
                                  interpret=True)
        pos0 = jnp.asarray(_k1_pos(2, seed=50).numpy())
        lnp0 = jax.vmap(jax.vmap(lnprob))(pos0)
        keys = jax.random.split(jax.random.PRNGKey(23), 2)
        out_j = jax.vmap(lambda p, l, k: run(p, l, k, NSTEPS, K_STEPS))(pos0, lnp0, keys)
        cj, lj, aj, pj, lpj = (np.asarray(t) for t in (*out_j[:3], *out_j[3]))
        rnd = _stack([jax_randomness(keys[c], NSTEPS, W, "float64") for c in range(2)])
        pos0, lnp0 = np.array(pos0), np.array(lnp0)
    prun = port_make(port_model(jm, torch.float64), PortSpec(ncomp=1, fixed_source_size=ss),
                     grid.ints, grid.yerrs, bounds, means, stds)
    cp, lp, ap, (pp, lpp) = prun(torch.from_numpy(pos0), torch.from_numpy(lnp0), NSTEPS,
                                 K_STEPS, randomness=rnd)
    assert cp.shape == cj.shape == (2, NSTEPS, W, 4)
    np.testing.assert_array_equal(cp.numpy(), cj)
    np.testing.assert_array_equal(ap.numpy(), aj)
    np.testing.assert_array_equal(pp.numpy(), pj)
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-12)
    np.testing.assert_allclose(lpp.numpy(), lpj, rtol=1e-12)
    assert (ap.sum(dim=1) > 0).all()


# -- (f) the diagnostics -------------------------------------------------------

def test_diagnostics_equal_jax_f64():
    from cha1_mcmc_tpu.sampler import diagnostics as jd
    from cha1_mcmc_tpu_torch.sampler import diagnostics as pd

    rng = np.random.default_rng(3)
    chain = np.cumsum(rng.standard_normal((24, 400, 4)), axis=1) * 0.05 + rng.standard_normal(
        (24, 400, 4))
    for name in ("autocorr_time", "effective_sample_size", "gelman_rubin"):
        np.testing.assert_array_equal(getattr(pd, name)(chain), getattr(jd, name)(chain))
    a, b = pd.summarize_convergence(chain), jd.summarize_convergence(chain)
    assert set(a) == set(b) == {"tau", "ess", "r_hat", "nsteps_post_burn"}
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_diagnostics_on_gaussian_chain():
    """Twin of tests/test_convergence.py:135 on the port's sampler."""
    from cha1_mcmc_tpu_torch.sampler import (autocorr_time, effective_sample_size,
                                             gelman_rubin, run_ensemble,
                                             summarize_convergence)

    def lnprob(x):
        return -0.5 * (x * x).sum(dim=1)

    gen = torch.Generator().manual_seed(0)
    pos0 = torch.randn((32, 3), generator=gen, dtype=torch.float64) * 0.1
    chain, *_ = run_ensemble(lnprob, pos0, lnprob(pos0), gen, 3000)
    chain = chain.numpy().transpose(1, 0, 2)   # (W, S, D)
    tau = autocorr_time(chain[:, 500:, :])
    assert np.all(tau > 1) and np.all(tau < 200)
    assert np.all(effective_sample_size(chain[:, 500:, :]) > 500)
    np.testing.assert_allclose(gelman_rubin(chain[:, 500:, :]), 1.0, atol=0.05)
    assert set(summarize_convergence(chain)) == {"tau", "ess", "r_hat", "nsteps_post_burn"}


def test_diagnostics_flag_unconverged():
    """Twin of tests/test_convergence.py:154: walkers stuck in two
    separated modes show R-hat >> 1."""
    from cha1_mcmc_tpu_torch.sampler import gelman_rubin

    rng = np.random.default_rng(0)
    half = rng.normal(size=(8, 200, 1)) * 0.1
    assert gelman_rubin(np.concatenate([half - 5.0, half + 5.0], axis=0)).max() > 2.0


# -- (g) the retry -------------------------------------------------------------

class _Faulty:
    """A test double around a lnprob or a run_fn: raises `error` on calls
    [first, first + times) counted from 0, then calls through."""

    def __init__(self, fn, error, first, times=1):
        self.fn, self.error, self.first, self.times = fn, error, first, times
        self.calls = 0
        self.lnprob = getattr(fn, "lnprob", None)

    def __call__(self, *args, **kwargs):
        n, self.calls = self.calls, self.calls + 1
        if self.first <= n < self.first + self.times:
            raise self.error
        return self.fn(*args, **kwargs)


def _faulty_sampler(kind, k1_run, error=None, times=1):
    """(sampler, test double, start) for twelve steps in three blocks of 4
    through each sampler kind, whose second block meets `error` `times`
    times (None: no fault): the double wraps the lnprob of the general
    EnsembleSampler or MultiChainSampler, or the real K1 run_fn of a
    MultiChainSampler."""
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler, MultiChainSampler

    if kind == "multichain-run_fn":
        fn, first = k1_run, 1              # one run_fn call a block
    else:
        # lnp0 (one call, or one a chain), then 8 half-steps a block a
        # chain; the fault a few half-steps into block 2
        fn = _toy_lnprob
        first = (1 + 8 if kind == "general" else 2 + 2 * 8) + 3
    faulty = _Faulty(fn, error, first, times if error is not None else 0)
    if kind == "general":
        return (EnsembleSampler(lnprob_fn=faulty, nwalkers=16, ndim=3, dtype=torch.float64,
                                device="cpu"), faulty, _toy_pos(1, 16)[0])
    if kind == "multichain":
        return _multichain(2, 16, lnprob_fn=faulty), faulty, _toy_pos(2, 8)
    return (MultiChainSampler(lnprob_fn=None, nwalkers=2 * W, ndim=4, dtype=torch.float64,
                              device="cpu", n_chains=2, run_fn=faulty, k_steps=K_STEPS),
            faulty, _k1_pos(2))


def _run_blocks(sampler, pos0, path):
    sampler.run_mcmc(pos0, 12, torch.Generator().manual_seed(8), checkpoint_every=4,
                     chain_file=path)


KINDS = ["general", "multichain", "multichain-run_fn"]


@pytest.mark.parametrize("error", ["DeviceError", "AcceleratorError"])
@pytest.mark.parametrize("kind", KINDS)
def test_device_error_is_retried_with_the_same_randomness(k1_run, tmp_path, kind, error):
    """A block that raises a device error once is run again from its saved
    generator state: the chain and the sidecar equal an unfaulted run's
    bitwise. The run_fn double raises once and then calls the real K1."""
    from cha1_mcmc_tpu_torch.utils import DeviceError

    err = DeviceError("injected") if error == "DeviceError" else torch.AcceleratorError("x")
    clean, _, pos0 = _faulty_sampler(kind, k1_run)
    _run_blocks(clean, pos0, str(tmp_path / "clean.npy"))
    faulted, double, pos0 = _faulty_sampler(kind, k1_run, err)
    _run_blocks(faulted, pos0, str(tmp_path / "faulted.npy"))
    assert double.calls > double.first + 1     # the fault was met and passed
    np.testing.assert_array_equal(faulted.chain, clean.chain)
    np.testing.assert_array_equal(faulted.lnprobability, clean.lnprobability)
    assert faulted.accepted == clean.accepted > 0
    a, b = (np.load(str(tmp_path / f"{n}.state.npz")) for n in ("faulted", "clean"))
    assert set(a.files) == set(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("error", ["DeviceError", "AcceleratorError"])
@pytest.mark.parametrize("kind", KINDS)
def test_device_error_at_a_wait_throws_away_the_block_queued_behind(k1_run, tmp_path,
                                                                    monkeypatch, kind, error):
    """A device error that surfaces at the wait for block 1's copies, once,
    while block 2 is queued behind it: block 2 is thrown away and both run
    again from block 1's saved generator state, so the chain, the
    lnprobability and the sidecar equal an unfaulted run's bitwise."""
    from cha1_mcmc_tpu_torch.sampler.stretch import HostCopies
    from cha1_mcmc_tpu_torch.utils import DeviceError

    err = DeviceError("injected") if error == "DeviceError" else torch.AcceleratorError("x")
    clean, clean_double, pos0 = _faulty_sampler(kind, k1_run)
    _run_blocks(clean, pos0, str(tmp_path / "clean.npy"))
    faulted, double, pos0 = _faulty_sampler(kind, k1_run)
    real, calls_at_wait = HostCopies.wait, []

    def wait(self, queued, counted):
        calls_at_wait.append(double.calls)
        if len(calls_at_wait) == 2:        # the wait for block 1
            raise err
        return real(self, queued, counted)

    monkeypatch.setattr(HostCopies, "wait", wait)
    _run_blocks(faulted, pos0, str(tmp_path / "faulted.npy"))
    assert len(calls_at_wait) == 4             # blocks 0, 1, 1 again, 2
    # at the fault all three blocks had been queued, block 2 behind block 1,
    # and both ran again
    assert calls_at_wait[1] == clean_double.calls < double.calls
    np.testing.assert_array_equal(faulted.chain, clean.chain)
    np.testing.assert_array_equal(faulted.lnprobability, clean.lnprobability)
    np.testing.assert_array_equal(np.load(str(tmp_path / "faulted.npy")), clean.chain)
    assert faulted.accepted == clean.accepted > 0
    a, b = (np.load(str(tmp_path / f"{n}.state.npz")) for n in ("faulted", "clean"))
    assert set(a.files) == set(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("kind", KINDS)
def test_third_device_error_is_raised(k1_run, tmp_path, kind):
    """max_retries=2: a block that faults three times raises the third
    error; the chain file holds the blocks before it."""
    from cha1_mcmc_tpu_torch.utils import DeviceError

    sampler, double, pos0 = _faulty_sampler(kind, k1_run, DeviceError("injected"), times=3)
    with pytest.raises(DeviceError, match="injected"):
        _run_blocks(sampler, pos0, str(tmp_path / "run.npy"))
    assert double.calls == double.first + 3
    assert np.load(str(tmp_path / "run.npy")).shape[1] == 4


@pytest.mark.parametrize("kind", KINDS)
def test_other_errors_are_not_retried(k1_run, tmp_path, kind):
    """A ValueError (a program fault) propagates from its first
    occurrence: the block is not run again."""
    sampler, double, pos0 = _faulty_sampler(kind, k1_run, ValueError("bad shape"), times=3)
    with pytest.raises(ValueError, match="bad shape"):
        _run_blocks(sampler, pos0, str(tmp_path / "run.npy"))
    assert double.calls == double.first + 1


# -- (h) the fits with n_chains = 2 on the CPU; P13 -----------------------------

def _fit_kw(problem, tmp_path, **kw):
    return dict(mol_name="hc5n_hfs", cat_folder=problem["cat_folder"],
                data_path=problem["data_path"], fit_folder=str(tmp_path), nwalkers=16,
                nruns=20, checkpoint_every=10, seed=0, device="cpu", **kw)


def test_spectral_fit_with_two_chains_cpu(problem, tmp_path):
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit
    from cha1_mcmc_tpu_torch.sampler import MultiChainSampler

    fit = SpectralFit(FitConfig(n_chains=2, **_fit_kw(problem, tmp_path)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chain = fit.run()
    assert type(fit.sampler) is MultiChainSampler and fit.sampler.run_fn is None
    assert chain.shape == (16, 20, 4) and np.isfinite(chain).all()
    np.testing.assert_array_equal(np.load(fit.config.chain_path), chain)
    assert "Cross-chain R-hat (2 chains): " in out.getvalue()
    assert fit.convergence["r_hat"].shape == (4,)
    assert 0.05 < fit.sampler.acceptance_fraction < 0.95


def test_multicomponent_fit_with_two_chains_cpu(gotham_problem, tmp_path):
    from cha1_mcmc_tpu_torch import MultiComponentFit, MultiFitConfig
    from cha1_mcmc_tpu_torch.sampler import MultiChainSampler

    fit = MultiComponentFit(MultiFitConfig(
        mol_name="hc9n_hfs", template_run=True, cat_folder=gotham_problem["cat_folder"],
        data_path=gotham_problem["data_path"], fit_folder=str(tmp_path), nwalkers=32,
        nruns=20, checkpoint_every=10, seed=0, device="cpu", n_chains=2))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chain = fit.run()
    assert type(fit.sampler) is MultiChainSampler and fit.sampler.run_fn is None
    assert chain.shape == (32, 20, 14) and np.isfinite(chain).all()
    assert "Cross-chain R-hat (2 chains):" in out.getvalue()
    assert fit.convergence["r_hat"].shape == (14,)


def test_profile_dir_writes_a_trace(problem, tmp_path):
    """P13: FitConfig.profile_dir wraps the sampling in a torch.profiler
    trace written there (utils/metrics.py:trace_profile)."""
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

    trace_dir = tmp_path / "trace"
    fit = SpectralFit(FitConfig(profile_dir=str(trace_dir),
                                **_fit_kw(problem, tmp_path / "fit", MLE_for_Ncol=False)))
    with contextlib.redirect_stdout(io.StringIO()):
        fit.fit(fit.init_setup())
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(trace_dir / traces[0]) > 0


# -- (i) n_chains with n_devices on gloo ranks ---------------------------------

def _rank_chains_fit(rank, out, kw):
    from cha1_mcmc_tpu_torch import FitConfig, SpectralFit

    fit = SpectralFit(FitConfig(fit_folder=os.path.join(out, f"rank{rank}"), n_devices=2,
                                n_chains=2, **kw))
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.fit(fit.init_setup())
    mesh = fit.sampler.mesh
    np.savez(os.path.join(out, f"chains-rank{rank}.npz"), chain=chain,
             sampler=type(fit.sampler).__name__,
             shape=[mesh.shape["chains"], mesh.shape["walkers"], mesh.shape["lines"]],
             coords=list(mesh.coords), r_hat=fit.convergence["r_hat"])


def test_two_chains_on_two_ranks_take_the_chains_axis(problem, tmp_path):
    """SpectralFit(n_devices=2, n_chains=2) on two gloo ranks reaches
    make_sharded_sampler(n_chains=2): a mesh of 2 chains x 1 walker shard,
    rank r running chain r, the same pooled chain on both ranks."""
    kw = _fit_kw(problem, tmp_path, MLE_for_Ncol=False)
    kw.pop("fit_folder")
    spawn(_rank_chains_fit, 2, tmp_path, str(tmp_path), kw)
    ranks = [np.load(tmp_path / f"chains-rank{r}.npz") for r in range(2)]
    for r, res in enumerate(ranks):
        assert str(res["sampler"]) == "ShardedEnsembleSampler"
        assert list(res["shape"]) == [2, 1, 1] and list(res["coords"]) == [r, 0, 0]
        assert res["chain"].shape == (16, 20, 4) and np.isfinite(res["chain"]).all()
        np.testing.assert_array_equal(res["chain"], ranks[0]["chain"])
        assert res["r_hat"].shape == (4,)


def test_kernel_wrappers_raise_device_error():
    """Every wrapper's CUDA error code becomes a DeviceError, a
    RuntimeError the retry catches (and existing `pytest.raises(
    RuntimeError)` checks still see)."""
    from cha1_mcmc_tpu_torch.sampler.cluster import raise_on
    from cha1_mcmc_tpu_torch.utils import DEVICE_ERRORS, DeviceError

    raise_on(0, None, "fused_steps")
    with pytest.raises(DeviceError, match="K2 multi_steps launch failed: CUDA error 700 "
                                          r"\(an illegal memory access\)"):
        raise_on(700, lambda err: b"an illegal memory access", "multi_steps", "K2")
    assert issubclass(DeviceError, RuntimeError)
    assert DEVICE_ERRORS == (DeviceError, torch.AcceleratorError)
