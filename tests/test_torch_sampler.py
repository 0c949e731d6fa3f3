"""The port's general stretch-move sampler (cha1_mcmc_tpu_torch/sampler/
stretch.py) against the JAX package's run_ensemble under jax.enable_x64(),
fed the same randomness (rebuilt exactly as stretch.py:98-104 draws it),
and the EnsembleSampler's checkpoint / resume / thin contract.

Tolerances: chains and acceptances bitwise, lnps rtol 1e-12."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import (TRUTH_4, TRUTH_5, jax_model, jax_randomness,
                                jax_reduce, port_model, problem, spec_and_prior,
                                to_torch, walker_ball)

torch.set_num_threads(1)

W, NSTEPS = 16, 24


@pytest.fixture(scope="module")
def reduced(problem):
    return jax_reduce(problem)


def _lnprobs(reduced, ndim):
    """(JAX scalar lnprob, port batched lnprob) in float64 on identical
    constants."""
    from cha1_mcmc_tpu.inference import (ParamSpec, build_lnprob,
                                         single_component_lnprior)
    from cha1_mcmc_tpu_torch import inference as port_inf

    cat, grid = reduced
    ss, means, stds, bounds = spec_and_prior(ndim)
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
        spec = ParamSpec(ncomp=1, fixed_source_size=ss)
        jl = build_lnprob(jm, spec, grid.ints, grid.yerrs,
                          single_component_lnprior(spec, bounds, means, stds))
    pspec = port_inf.ParamSpec(ncomp=1, fixed_source_size=ss)
    pl = port_inf.build_lnprob(
        port_model(jm, torch.float64), pspec, grid.ints, grid.yerrs,
        port_inf.single_component_lnprior(pspec, bounds, means, stds,
                                          dtype=torch.float64))
    return jl, pl


@pytest.mark.parametrize("ndim,thin", [(4, 1), (5, 1), (4, 2)])
def test_run_ensemble_matches_jax(reduced, ndim, thin):
    from cha1_mcmc_tpu.sampler import run_ensemble as jax_run
    from cha1_mcmc_tpu_torch.sampler import run_ensemble

    jl, pl = _lnprobs(reduced, ndim)
    nsteps = NSTEPS // thin
    with jax.enable_x64():
        pos0 = jnp.asarray(walker_ball(TRUTH_4 if ndim == 4 else TRUTH_5, W, 11),
                           jnp.float64)
        lnp0 = jax.vmap(jl)(pos0)
        key = jax.random.PRNGKey(21)
        cj, lj, aj, (pj, lpj) = jax_run(jl, pos0, lnp0, key, nsteps=nsteps,
                                        thin=thin)
        rnd = jax_randomness(key, nsteps * thin, W, "float64")
        cj, lj, aj, pj, lpj, pos0, lnp0 = map(np.array,
                                              (cj, lj, aj, pj, lpj, pos0, lnp0))
    np.testing.assert_allclose(pl(torch.from_numpy(pos0)).numpy(), lnp0, rtol=1e-12)
    cp, lp, ap, (pp, lpp) = run_ensemble(pl, torch.from_numpy(pos0),
                                         torch.from_numpy(lnp0), nsteps,
                                         thin=thin, randomness=to_torch(rnd))
    # F5: run_ensemble's layout is (nsteps, W, D)
    assert cp.shape == (nsteps, W, ndim) and lp.shape == (nsteps, W)
    assert ap.shape == (nsteps,)
    np.testing.assert_array_equal(cp.numpy(), cj)
    np.testing.assert_array_equal(ap.numpy(), aj)
    np.testing.assert_array_equal(pp.numpy(), pj)
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-12)
    np.testing.assert_allclose(lpp.numpy(), lpj, rtol=1e-12)
    assert 0 < ap.sum() < nsteps * thin * W


def _toy_lnprob(theta):
    """A cheap batched lnprob (correlated Gaussian) for contract tests."""
    x = theta - torch.arange(theta.shape[1], dtype=theta.dtype)
    return -0.5 * (x * x).sum(dim=1) - 0.3 * x[:, 0] * x[:, 1]


def _sampler(**kw):
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler

    return EnsembleSampler(lnprob_fn=_toy_lnprob, nwalkers=8, ndim=3,
                           dtype=torch.float64, device="cpu", **kw)


def _pos(seed=0):
    return np.random.default_rng(seed).standard_normal((8, 3)) * 0.1 + np.arange(3)


def test_checkpoint_files_and_layouts(tmp_path):
    """Block checkpoints write the cumulative (W, S, D) chain and a tagged
    .state.npz sidecar; sampler.chain is (W, S, D) while a block is
    (nsteps, W, D) (F5); the last recorded step is the final position."""
    s = _sampler()
    path = str(tmp_path / "chain.npy")
    pos, lnp = s.run_mcmc(_pos(), 10, torch.Generator().manual_seed(0),
                          checkpoint_every=4, chain_file=path)
    assert s.chain.shape == (8, 10, 3)
    assert s.lnprobability.shape == (8, 10)
    np.testing.assert_array_equal(np.load(path), s.chain)
    state = np.load(str(tmp_path / "chain.state.npz"))
    assert str(state["package"]) == "cha1_mcmc_tpu_torch"
    assert set(state.files) >= {"pos", "lnp", "rng_state", "accepted",
                                "total_proposals"}
    np.testing.assert_array_equal(state["pos"], s.chain[:, -1, :])
    np.testing.assert_array_equal(pos, s.chain[:, -1, :])
    np.testing.assert_array_equal(lnp, s.lnprobability[:, -1])
    assert int(state["total_proposals"]) == 10 * 8 == s.total_proposals
    assert 0 < s.acceptance_fraction < 1


def test_split_resume_equals_unsplit_run(tmp_path):
    full = _sampler()
    full.run_mcmc(_pos(), 12, torch.Generator().manual_seed(3), checkpoint_every=4)

    path = str(tmp_path / "chain.npy")
    first = _sampler()
    first.run_mcmc(_pos(), 8, torch.Generator().manual_seed(3),
                   checkpoint_every=4, chain_file=path)
    second = _sampler()
    second.preload(np.load(path))
    pos, lnp0, rng_state = second.load_state(path)
    gen = torch.Generator()
    gen.set_state(rng_state)
    second.run_mcmc(pos, 4, gen, checkpoint_every=4, chain_file=path, lnp0=lnp0)
    np.testing.assert_array_equal(second.chain, full.chain)
    np.testing.assert_array_equal(second.lnprobability[:, 8:],
                                  full.lnprobability[:, 8:])
    assert second.accepted == full.accepted
    assert second.total_proposals == full.total_proposals


def test_sidecar_without_package_tag_is_refused(tmp_path):
    path = str(tmp_path / "chain.npy")
    np.save(path, np.zeros((8, 2, 3)))
    np.savez(str(tmp_path / "chain.state.npz"), pos=np.zeros((8, 3)),
             lnp=np.zeros(8), key=np.zeros(2, np.uint32), accepted=0,
             total_proposals=0)
    with pytest.raises(ValueError, match="cannot continue"):
        _sampler().load_state(path)
    assert _sampler().load_state(str(tmp_path / "none.npy")) is None


def test_thin_records_every_thin_th_state():
    s1, s2 = _sampler(), _sampler()
    s1.run_mcmc(_pos(1), 12, torch.Generator().manual_seed(4), checkpoint_every=12)
    s2.run_mcmc(_pos(1), 6, torch.Generator().manual_seed(4), checkpoint_every=6,
                thin=2)
    np.testing.assert_array_equal(s2.chain, s1.chain[:, 1::2])
    assert s2.accepted == s1.accepted and s2.total_proposals == s1.total_proposals


def test_preload_appends_and_validates():
    s = _sampler()
    prev = np.random.default_rng(0).standard_normal((8, 5, 3))
    pos = s.preload(prev)
    np.testing.assert_array_equal(pos, prev[:, -1])
    s.run_mcmc(pos, 2, torch.Generator().manual_seed(0), checkpoint_every=2)
    assert s.chain.shape == (8, 7, 3)
    np.testing.assert_array_equal(s.chain[:, :5], prev)
    with pytest.raises(ValueError):
        _sampler().preload(np.zeros((4, 5, 3)))


def test_draw_randomness_layout():
    from cha1_mcmc_tpu_torch.sampler import draw_randomness

    perms, z_u, pair, acc_u = draw_randomness(5, 8, torch.Generator().manual_seed(0),
                                              dtype=torch.float64)
    assert perms.shape == (5, 8) and z_u.shape == pair.shape == acc_u.shape == (5, 2, 4)
    assert z_u.dtype == acc_u.dtype == torch.float64
    assert torch.equal(torch.sort(perms, dim=1).values,
                       torch.arange(8).expand(5, 8))
    assert int(pair.min()) >= 0 and int(pair.max()) < 4


def test_minus_inf_walker_stays_minus_inf_not_nan():
    """A walker starting at -inf lnp whose proposals are all -inf keeps
    -inf and never turns NaN (ln u < -inf - (-inf) = NaN is False), while
    the rest of the ensemble moves on."""
    from cha1_mcmc_tpu_torch.sampler import run_ensemble

    def lnprob(theta):
        out = _toy_lnprob(theta)
        return torch.where(theta[:, 0] > 5.0, torch.full_like(out, -torch.inf), out)

    pos0 = torch.as_tensor(_pos(2))
    pos0[0, 0] = 50.0
    lnp0 = lnprob(pos0)
    chain, lnps, acc, (pos, lnp) = run_ensemble(
        lnprob, pos0, lnp0, 20, generator=torch.Generator().manual_seed(1))
    assert not torch.isnan(lnps).any()
    assert torch.all(lnps[:, 0] == -torch.inf)
    assert torch.isfinite(lnps[:, 1:]).all()
    assert torch.equal(chain[:, 0], pos0[0].expand(20, 3))
