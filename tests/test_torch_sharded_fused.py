"""The sharded half-step kernels K5a, K5b and K5c of the torch port
(cha1_mcmc_tpu_torch/parallel/sharded_fused.py): their plain versions
against the JAX package's fused sharded runners
(cha1_mcmc_tpu/parallel/sharded_fused.py) run in Pallas interpret mode, on
a (1, 2, 1) mesh: two gloo ranks spawned on the CPU (tests/torch_ranks.py)
against two of the conftest's virtual CPU devices, each port shard handed
the randomness the JAX runner drew for it. Float64 chains, acceptances
and final positions bitwise, lnps rtol 1e-12, -inf positions equal.

At world size 1 the sharded split is the single-device one: on one rank
the K5 runners equal the whole-step kernels K1, K2 and K3 (their plain
versions here) bitwise on the same randomness and start. The CUDA kernels
themselves are held to these plain versions on the card (chip_smoke.py).

The rank functions are module-level and import only torch and the port.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tests.torch_ranks import spawn

torch.set_num_threads(1)

W, NSTEPS = 16, 8
STUCK = 3   # a walker started where it and every proposal it makes are -inf


# -- rank functions (spawned processes: torch and the port only) ---------------

def _port_problem(p, dtype=torch.float64):
    """(model, spec, lnprior) of one problem on the CPU."""
    from cha1_mcmc_tpu_torch.inference import (ParamSpec, ordered_velocity_lnprior,
                                               single_component_lnprior)
    from cha1_mcmc_tpu_torch.models.forward import model_from_arrays

    model = model_from_arrays(p["arrays"], p["q"], device="cpu", dtype=dtype,
                              **p["geometry"])
    if p["kind"] == "multi":
        spec = ParamSpec(ncomp=4)
        prior = ordered_velocity_lnprior(spec, p["means"], p["stds"], dv_max=p["dv_max"],
                                         dtype=dtype)
    else:
        spec = ParamSpec(ncomp=1, fixed_source_size=p["ss"])
        prior = single_component_lnprior(spec, p["bounds"], p["means"], p["stds"],
                                         dtype=dtype)
    return model, spec, prior


def _k5_runner(p, mesh):
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

    model, spec, prior = _port_problem(p)
    common = (model, spec, p["ints"], p["yerrs"])
    if p["kind"] == "grid":
        return sf.make_fused_sharded_runner(*common, prior, p["bounds"], p["means"],
                                            p["stds"], mesh, NSTEPS)
    if p["kind"] == "multi":
        return sf.make_fused_multi_sharded_runner(*common, prior, p["means"], p["stds"],
                                                  mesh, NSTEPS, nwalkers=W,
                                                  dv_max=p["dv_max"])
    return sf.make_fused_gather_sharded_runner(*common, p["bounds"], p["means"],
                                               p["stds"], mesh, NSTEPS, nwalkers=W,
                                               dv_max=p["dv_max"])


def _save(out, name, outputs):
    chain, lnps, acc, (pos, lnp) = outputs
    return {f"{name}/{k}": t.numpy() for k, t in (("chain", chain), ("lnps", lnps),
                                                  ("acc", acc), ("pos", pos),
                                                  ("lnp", lnp))}


def _rank_k5(rank, out, problems):
    """Each K5 runner's plain version on the (1, 2, 1) mesh over the JAX
    shard streams."""
    from cha1_mcmc_tpu_torch.parallel import make_mesh
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

    mesh = make_mesh(2, 1, devices="cpu")
    res = {}
    before = dict(sf.LAUNCHES)
    for name, p in problems.items():
        runner = _k5_runner(p, mesh)
        rnd = tuple(torch.from_numpy(x) for x in p["rnd"][mesh.w_idx])
        res.update(_save(out, name, runner(torch.from_numpy(p["pos0"]), randomness=rnd)))
    res["launches"] = np.array([sf.LAUNCHES[k] - before[k] for k in sorted(before)])
    np.savez(os.path.join(out, f"k5-rank{rank}.npz"), **res)


def _rank_world1(rank, out, problems):
    """One process with no group: make_mesh(1, 1) starts its own world;
    each K5 runner against its whole-step kernel on one stream and start;
    and make_sharded_sampler keeps the general runner on the CPU."""
    import torch.distributed as dist
    from cha1_mcmc_tpu_torch.parallel import make_mesh, make_sharded_sampler
    from cha1_mcmc_tpu_torch.sampler import fused, fused_gather, fused_multi
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    mesh = make_mesh(1, 1, devices="cpu")
    res = {"world": np.array([dist.get_world_size(), dist.get_backend() == "gloo"])}
    for name, p in problems.items():
        model, spec, prior = _port_problem(p)
        runner = _k5_runner(p, mesh)
        pos0 = torch.from_numpy(p["pos0"])
        lnp0 = runner.entry_lnprob(pos0)
        rnd = draw_randomness(NSTEPS, W, torch.Generator().manual_seed(5),
                              dtype=torch.float64)
        res.update(_save(out, f"{name}/k5", runner(pos0, lnp0=lnp0, randomness=rnd)))
        common = (model, spec, p["ints"], p["yerrs"])
        if p["kind"] == "grid":
            whole = fused.make_fused_ensemble(*common, p["bounds"], p["means"], p["stds"])
        elif p["kind"] == "multi":
            whole = fused_multi.make_fused_ensemble_multi(*common, p["means"], p["stds"],
                                                          dv_max=p["dv_max"])
        else:
            whole = fused_gather.make_fused_ensemble_gather(
                *common, p["bounds"], p["means"], p["stds"], dv_max=p["dv_max"],
                nwalkers=W)
        res.update(_save(out, f"{name}/whole", whole(pos0, lnp0, NSTEPS, 4,
                                                     randomness=rnd)))
        sampler = make_sharded_sampler(
            n_devices=1, n_line_shards=1, nwalkers=W, ndim=spec.ndim, a=2.0,
            dtype=torch.float32, model=model, spec=spec, grid_ints=p["ints"],
            grid_yerrs=p["yerrs"], lnprior_fn=prior, use_pallas=p["kind"] == "gather",
            dv_max=p["dv_max"], use_fused=True, bounds=p["bounds"],
            prior_means=p["means"], prior_stds=p["stds"], device="cpu", verbose=False)
        res[f"{name}/fused_flags"] = np.array([sampler.use_fused, sampler.use_fused_gather,
                                               sampler.use_fused_multi])
    np.savez(os.path.join(out, f"world1-rank{rank}.npz"), **res)


# -- the JAX side ---------------------------------------------------------------

def _ranks_view(jm, grid, kind, pos0, **prior):
    from tests.torch_parity import model_arrays, q_dict

    return dict(kind=kind, arrays=model_arrays(jm), q=q_dict(jm.q_model),
                geometry=dict(mask_center=jm.mask_center, dish_size=jm.dish_size,
                              Tbg=jm.Tbg, vel_offset=jm.vel_offset),
                ints=np.asarray(grid.ints), yerrs=np.asarray(grid.yerrs),
                pos0=np.asarray(pos0, dtype=np.float64), **prior)


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """The three problems as both packages see them, float64: the flagship
    (K5a), the small GOTHAM problem at K=4 (K5c) and the small dense
    problem with the Chebyshev Q surrogate (K5b). Returns {name: (JAX
    pieces, the ranks' view)}."""
    import jax
    from cha1_mcmc_tpu.catalogs.partition import _state_sum_model, fit_device_cheb
    from cha1_mcmc_tpu.inference import (ParamSpec, ordered_velocity_lnprior,
                                         single_component_lnprior)
    from cha1_mcmc_tpu_torch.pipeline.multifit import (_HC9N_MEANS, _HC9N_STDS,
                                                        _PERTURBATION)
    from tests.port_problems import (DENSE_BOUNDS, DENSE_CENTER, DENSE_SOURCE_SIZE,
                                     write_dense_problem, write_hc5n_problem,
                                     write_hc9n_problem)
    from tests.torch_parity import (BOUNDS, MEANS_4, STDS_4, TRUTH_4, jax_dense_model,
                                    jax_dense_reduce, jax_gotham_model,
                                    jax_gotham_reduce, jax_model, jax_reduce,
                                    walker_ball)

    tmp = tmp_path_factory.mktemp("k5")
    out = {}
    with jax.enable_x64():
        cat, grid = jax_reduce(write_hc5n_problem(str(tmp / "hc5n")))
        jm = jax_model(cat, grid, "float64")
        spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
        pos0 = walker_ball(TRUTH_4, W, 0)
        pos0[STUCK, 3] = 5.0        # dV far above the bound: so is every proposal
        prior = dict(bounds=BOUNDS, means=MEANS_4, stds=STDS_4, ss=52.0, dv_max=1.5)
        out["k5a"] = (dict(jm=jm, grid=grid, spec=spec,
                           lnprior=single_component_lnprior(spec, BOUNDS, MEANS_4,
                                                            STDS_4)),
                      _ranks_view(jm, grid, "grid", pos0, **prior))

        cat, grid = jax_gotham_reduce(write_hc9n_problem(str(tmp / "hc9n"),
                                                         n_multiplets=4))
        jm = jax_gotham_model(cat, grid, "float64")
        spec = ParamSpec(ncomp=4)
        means, stds = np.array(_HC9N_MEANS), np.array(_HC9N_STDS)
        rng = np.random.default_rng(7)
        pos0 = means + np.array(_PERTURBATION) * rng.standard_normal((W, means.size))
        pos0[STUCK, -1] = 0.5       # dV above the 0.3 bound, and every proposal
        prior = dict(bounds=None, means=means, stds=stds, ss=None, dv_max=0.3)
        out["k5c"] = (dict(jm=jm, grid=grid, spec=spec,
                           lnprior=ordered_velocity_lnprior(spec, means, stds,
                                                            dv_max=0.3)),
                      _ranks_view(jm, grid, "multi", pos0, **prior))

        with contextlib.redirect_stdout(io.StringIO()):
            dp = write_dense_problem(str(tmp / "dense"), scale="small")
            cat, grid = jax_dense_reduce(dp)
        jm = jax_dense_model(dp, cat, grid, "float64",
                             q_model=fit_device_cheb(_state_sum_model(cat), 3.5, 12.0))
        spec = ParamSpec(ncomp=1, fixed_source_size=DENSE_SOURCE_SIZE)
        ncol = dp["truth"][0]
        means = np.array([1.2 * ncol, 8.0, DENSE_CENTER, 0.7575])
        stds = np.array([0.5 * ncol, 3.0, 0.06, 0.22])
        center = np.array([ncol, 8.0, DENSE_CENTER, 0.7575])
        pos0 = center * (1 + 0.01 * np.random.default_rng(4).standard_normal((W, 4)))
        pos0[STUCK, 2] = 12.0       # vlsr 12: every proposal has vlsr > 7.5
        prior = dict(bounds=dict(DENSE_BOUNDS), means=means, stds=stds,
                     ss=DENSE_SOURCE_SIZE, dv_max=1.5)
        out["k5b"] = (dict(jm=jm, grid=grid, spec=spec), _ranks_view(jm, grid, "gather",
                                                                      pos0, **prior))
    return out


def _jax_k5(name, jax_side, view, mesh, key):
    from cha1_mcmc_tpu.parallel import (make_fused_gather_sharded_runner,
                                        make_fused_multi_sharded_runner,
                                        make_fused_sharded_runner)

    common = (jax_side["jm"], jax_side["spec"], jax_side["grid"].ints,
              jax_side["grid"].yerrs)
    if name == "k5a":
        run = make_fused_sharded_runner(*common, jax_side["lnprior"], view["bounds"],
                                        view["means"], view["stds"], mesh, NSTEPS,
                                        interpret=True)
    elif name == "k5c":
        run = make_fused_multi_sharded_runner(*common, jax_side["lnprior"], view["means"],
                                              view["stds"], mesh, NSTEPS, nwalkers=W,
                                              dv_max=view["dv_max"], interpret=True)
    else:
        run = make_fused_gather_sharded_runner(*common, view["bounds"], view["means"],
                                               view["stds"], mesh, NSTEPS, nwalkers=W,
                                               dv_max=view["dv_max"], interpret=True)
    chain, lnps, acc, (pos, lnp) = run(view["pos0"], key)
    return {k: np.asarray(v) for k, v in (("chain", chain), ("lnps", lnps), ("acc", acc),
                                          ("pos", pos), ("lnp", lnp))}


@pytest.fixture(scope="module")
def k5_runs(problems, tmp_path_factory):
    """The JAX K5 runners (interpret mode) on a (1, 2, 1) mesh, and the
    port's plain K5 runners on two gloo ranks over the same streams."""
    import jax
    from cha1_mcmc_tpu.parallel import make_mesh
    from tests.torch_parity import jax_shard_randomness

    key = jax.random.PRNGKey(3)
    jax_out, views = {}, {}
    with jax.enable_x64():
        mesh = make_mesh(2, 1)
        for name, (jax_side, view) in problems.items():
            jax_out[name] = _jax_k5(name, jax_side, view, mesh, key)
            view = dict(view, rnd=[jax_shard_randomness(key, NSTEPS, W // 2, W // 2, w,
                                                        "float64") for w in range(2)])
            views[name] = view
    tmp = tmp_path_factory.mktemp("k5_ranks")
    spawn(_rank_k5, 2, tmp, str(tmp), views)
    return jax_out, [dict(np.load(tmp / f"k5-rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def world1_runs(problems, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world1")
    spawn(_rank_world1, 1, tmp, str(tmp), {k: v[1] for k, v in problems.items()},
          init=False)
    return dict(np.load(tmp / "world1-rank0.npz"))


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("name,ndim", [("k5a", 4), ("k5c", 14), ("k5b", 4)])
def test_plain_k5_matches_jax_kernel_f64(k5_runs, name, ndim):
    """Plain K5a (flagship), K5c (GOTHAM, K=4) and K5b (dense) on two
    ranks against the JAX K5 runners on two devices: float64 chains,
    acceptances and final positions bitwise, lnps rtol 1e-12, on every
    rank (global outputs)."""
    jax_out, ranks = k5_runs
    want = jax_out[name]
    for res in ranks:
        assert res[f"{name}/chain"].shape == (NSTEPS, W, ndim)
        np.testing.assert_array_equal(res[f"{name}/chain"], want["chain"])
        np.testing.assert_array_equal(res[f"{name}/acc"], want["acc"])
        np.testing.assert_array_equal(res[f"{name}/pos"], want["pos"])
        fin = np.isfinite(want["lnps"])
        np.testing.assert_array_equal(np.isfinite(res[f"{name}/lnps"]), fin)
        np.testing.assert_allclose(res[f"{name}/lnps"][fin], want["lnps"][fin],
                                   rtol=1e-12)
    assert 0 < want["acc"].sum() < NSTEPS * W


@pytest.mark.parametrize("name", ["k5a", "k5c", "k5b"])
def test_never_accepting_walker_reports_minus_inf(k5_runs, name):
    """F4: the walker started outside the prior reports -inf at every step
    and at the end, where the JAX kernels report it after restoring their
    finfo.min clamp; its position never moves."""
    jax_out, ranks = k5_runs
    want = jax_out[name]
    assert not np.isfinite(want["lnps"][:, STUCK]).any()
    for res in ranks:
        assert np.all(res[f"{name}/lnps"][:, STUCK] == -np.inf)
        assert res[f"{name}/lnp"][STUCK] == -np.inf
        np.testing.assert_array_equal(res[f"{name}/chain"][:, STUCK],
                                      np.broadcast_to(res[f"{name}/pos"][STUCK],
                                                      (NSTEPS, want["pos"].shape[1])))


def test_plain_k5_launches_no_kernel_on_the_cpu(k5_runs):
    for res in k5_runs[1]:
        assert not res["launches"].any()


@pytest.mark.parametrize("name", ["k5a", "k5c", "k5b"])
def test_k5_at_world_size_one_equals_the_whole_step_kernel(world1_runs, name):
    """make_mesh(1, 1) with no group starts a world of one (gloo here), and
    there the K5 runner's chain, acceptances, lnps and final state equal
    K1's / K2's / K3's bitwise on the same randomness and start."""
    res = world1_runs
    assert res["world"].tolist() == [1, 1]
    for key in ("chain", "lnps", "acc", "pos", "lnp"):
        np.testing.assert_array_equal(res[f"{name}/k5/{key}"], res[f"{name}/whole/{key}"])


@pytest.mark.parametrize("name", ["k5a", "k5c", "k5b"])
def test_sharded_sampler_takes_no_fused_step_on_the_cpu(world1_runs, name):
    """The fused step's condition is a CUDA device and float32, as the
    single-device selection's: on the CPU the general runner runs."""
    assert not world1_runs[f"{name}/fused_flags"].any()


# -- single process: wrappers, eligibility -----------------------------------------

def _mesh(n_c=1, n_w=2, n_l=1):
    from cha1_mcmc_tpu_torch.parallel import Mesh

    return Mesh(shape={"chains": n_c, "walkers": n_w, "lines": n_l}, rank=0,
                coords=(0, 0, 0), device=torch.device("cpu"), walker_group=None,
                line_group=None, ensemble_group=None)


@pytest.fixture(scope="module")
def port_k5a(problems):
    from cha1_mcmc_tpu_torch.sampler.fused import single_statics_tables

    view = problems["k5a"][1]
    model, spec, _ = _port_problem(view)
    statics, tables = single_statics_tables(model, spec, view["ints"], view["yerrs"],
                                            view["bounds"], view["means"], view["stds"])
    return model, spec, tables, statics, torch.from_numpy(view["pos0"])


def _half_operands(pos0, lnp0, seed=0):
    h = pos0.shape[0] // 2
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(pos0.shape[0], generator=g)
    state = torch.cat([pos0, lnp0[:, None]], dim=1).contiguous()
    return state, (perm[:h].to(torch.int32), pos0[perm[h:]].contiguous(),
                   torch.rand(h, generator=g, dtype=pos0.dtype),
                   torch.randint(0, h, (h,), generator=g).to(torch.int32),
                   torch.rand(h, generator=g, dtype=pos0.dtype))


def test_k5_wrapper_takes_the_plain_version_on_the_cpu(port_k5a):
    """sharded_half on CPU tensors is sharded_half_plain (the state
    updated in place, the accepted count returned), and counts no launch."""
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf
    from cha1_mcmc_tpu_torch.sampler.fused import fused_lnprob_plain

    _, _, tables, st, pos0 = port_k5a
    lnp0 = fused_lnprob_plain(pos0, tables, st)
    state, ops = _half_operands(pos0, lnp0)
    before = dict(sf.LAUNCHES)
    got, want = state.clone(), state.clone()
    n = sf.sharded_half(got, *ops, tables, st)
    m = sf.sharded_half_plain(want, *ops, tables, st)
    assert sf.LAUNCHES == before
    assert n.dtype == torch.float32 and n.shape == (1,) and 0 < int(n) <= W // 2
    assert torch.equal(n, m) and torch.equal(got, want)
    moved = (got != state).any(dim=1)
    assert int(moved.sum()) == int(n)
    assert not moved[torch.isin(torch.arange(W), ops[0].long(), invert=True)].any()


def test_k5_wrappers_refuse_other_devices(port_k5a):
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

    _, _, tables, st, pos0 = port_k5a
    state, ops = _half_operands(pos0, torch.zeros(W, dtype=torch.float64))
    meta = [t.to("meta") for t in (state, *ops)]
    for fn, kernel in ((sf.sharded_half, "K5a"), (sf.sharded_multi_half, "K5c")):
        with pytest.raises(ValueError, match=f"{kernel} runs on CUDA"):
            fn(*meta, tables, st)
    with pytest.raises(ValueError, match="K5b runs on CUDA"):
        sf.sharded_gather_half(*meta, tables, st, None)


def test_eligibility_follows_the_mesh(problems, port_k5a):
    """One line shard, an ensemble that splits evenly, and the whole-step
    kernel's limits at the local walker count."""
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

    model, spec, *_ = port_k5a
    assert sf.fused_sharded_supported(model, _mesh(), 128)
    assert not sf.fused_sharded_supported(model, _mesh(n_l=2), 128)
    assert not sf.fused_sharded_supported(model, _mesh(n_c=2, n_w=2), 12)
    # K5a's cluster keeps the state in device memory: 8,192 local walkers
    # (4,096 proposals, 512 a CTA at 8 CTAs) fit; 2^18 (16,384 a CTA) do not
    assert sf.fused_sharded_supported(model, _mesh(n_w=1), 8192)
    assert not sf.fused_sharded_supported(model, _mesh(n_w=1), 1 << 18)   # shared memory
    view = problems["k5c"][1]
    gmodel, gspec, _ = _port_problem(view)
    assert sf.fused_multi_sharded_supported(gmodel, gspec, 0.3, _mesh(), W)
    assert not sf.fused_multi_sharded_supported(gmodel, gspec, 0.3, _mesh(n_l=2), W)
    assert not sf.fused_multi_sharded_supported(gmodel, gspec, 0.3, _mesh(), 6)
    view = problems["k5b"][1]
    dmodel, dspec, _ = _port_problem(view)
    plan = sf.plan_fused_gather_sharded(dmodel, dspec, _mesh(), W, 1.5)
    assert plan is not None and plan["geometry"].cb0 == 256
    assert sf.plan_fused_gather_sharded(dmodel, dspec, _mesh(n_l=2), W, 1.5) is None
    assert sf.plan_fused_gather_sharded(dmodel, ParamSpec(ncomp=2), _mesh(), W,
                                        1.5) is None


def test_fused_runners_refuse_line_sharded_meshes(problems, port_k5a):
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf

    model, spec, *_ = port_k5a
    view = problems["k5a"][1]
    with pytest.raises(ValueError, match="n_line_shards == 1"):
        sf.make_fused_sharded_runner(model, spec, view["ints"], view["yerrs"], None,
                                     view["bounds"], view["means"], view["stds"],
                                     _mesh(n_l=2), NSTEPS)
    with pytest.raises(ValueError, match="divisible by 2"):
        sf.make_fused_multi_sharded_runner(model, spec, view["ints"], view["yerrs"],
                                           None, view["means"], view["stds"], _mesh(),
                                           NSTEPS, nwalkers=6, dv_max=0.3)
