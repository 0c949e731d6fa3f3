"""The sharded path of the torch port (cha1_mcmc_tpu_torch/parallel/)
against the JAX package (cha1_mcmc_tpu/parallel/), on the CPU.

The port's ranks are gloo processes spawned by tests/torch_ranks.py; the
JAX side runs the same mesh shape over the conftest's 8 virtual CPU
devices, with its Pallas kernels in interpret mode as tests/test_parallel.py
runs them. Each shard of the port is handed the very randomness the JAX
runner drew for it (tests/torch_parity.py:jax_shard_randomness). Checks:
the rank -> (chain, walker, line) layout against the JAX mesh's device
layout; the general sharded runner walker- and line-sharded (float64:
chains and acceptances bitwise, lnps rtol 1e-12; the two-shard
all_reduce adds the same two partials as the psum, in either order, so it
rounds the same); the line-sharded run over K4a's plain version; the
ShardedEnsembleSampler's chain-file contract; SpectralFit and
MultiComponentFit with n_devices=2; and the port's entry points'
default device.

The rank functions are module-level and import only torch and the port:
each spawned rank imports this module, so JAX and tests/torch_parity.py
are imported inside the tests only.
"""

import contextlib
import inspect
import io
import os

import numpy as np
import pytest
import torch

from tests.torch_ranks import spawn

torch.set_num_threads(1)

W, NSTEPS = 16, 8
DV_MAX = 1.5


# -- rank functions (spawned processes: torch and the port only) ---------------

def _port_model(m, dtype=torch.float64):
    from cha1_mcmc_tpu_torch.models.forward import model_from_arrays

    return model_from_arrays(m["arrays"], m["q"], device="cpu", dtype=dtype,
                             **m["geometry"])


def _flagship_prior(m, dtype=torch.float64):
    from cha1_mcmc_tpu_torch.inference import ParamSpec, single_component_lnprior

    spec = ParamSpec(ncomp=1, fixed_source_size=m["ss"])
    return spec, single_component_lnprior(spec, *m["prior"], dtype=dtype)


def _rank_runners(rank, out, m, runs):
    """For each (name, (chains, walkers, lines), use_pallas, per-shard
    randomness or None): this rank's mesh coordinates and, with
    randomness, the general sharded runner's global outputs. Last, a mesh
    larger than the world must raise."""
    from cha1_mcmc_tpu_torch.parallel import make_mesh, make_sharded_runner

    model = _port_model(m)
    spec, lnprior = _flagship_prior(m)
    res = {}
    for name, (n_c, n_w, n_l), use_pallas, rnd in runs:
        mesh = make_mesh(n_w, n_l, devices="cpu", n_chain_shards=n_c)
        res[f"{name}/coords"] = np.array(mesh.coords)
        if rnd is None:
            continue
        runner = make_sharded_runner(model, spec, m["ints"], m["yerrs"], lnprior, mesh,
                                     NSTEPS, use_pallas=use_pallas, dv_max=DV_MAX)
        chain, lnps, acc, (pos, lnp) = runner(
            torch.from_numpy(m["pos0"]),
            randomness=tuple(torch.from_numpy(x) for x in rnd[mesh.w_idx]))
        for key, t in (("chain", chain), ("lnps", lnps), ("acc", acc), ("pos", pos),
                       ("lnp", lnp)):
            res[f"{name}/{key}"] = t.numpy()
    try:
        make_mesh(2 * torch.distributed.get_world_size(), 1, devices="cpu")
    except ValueError as e:
        res["mismatch"] = np.array(str(e))
    np.savez(os.path.join(out, f"runners-{len(runs)}-rank{rank}.npz"), **res)


def _rank_sampler(rank, out, m):
    """The ShardedEnsembleSampler's chain-file contract on a (1, 2, 1)
    mesh: 8 steps in two blocks with a chain file per rank (only rank 0's
    is written); the same 8 steps as two run_mcmc calls; a resume from
    rank 0's 4-step file and sidecar; a thin=2 run against an 8-step
    single block; a sidecar without the package tag, and one without
    per-rank generator states, refused."""
    import torch.distributed as dist
    from cha1_mcmc_tpu_torch.parallel import make_sharded_sampler

    model = _port_model(m)
    spec, lnprior = _flagship_prior(m)

    def sampler():
        return make_sharded_sampler(
            n_devices=2, n_line_shards=1, nwalkers=W, ndim=4, a=2.0,
            dtype=torch.float64, model=model, spec=spec, grid_ints=m["ints"],
            grid_yerrs=m["yerrs"], lnprior_fn=lnprior, device="cpu", verbose=False)

    def gen():
        return torch.Generator().manual_seed(7)

    pos0 = m["pos0"]
    res = {}
    full = sampler()
    full.run_mcmc(pos0, 8, gen(), checkpoint_every=4,
                  chain_file=os.path.join(out, f"full-rank{rank}.npy"))
    res["full"], res["full_lnp"] = full.chain, full.lnprobability
    res["acceptance"] = np.array(full.acceptance_fraction)

    split, g = sampler(), gen()
    pos, lnp = split.run_mcmc(pos0, 4, g, checkpoint_every=4)
    split.run_mcmc(pos, 4, g, checkpoint_every=4, lnp0=lnp)
    res["split"] = split.chain

    first = os.path.join(out, "first-rank0.npy")
    sampler().run_mcmc(pos0, 4, gen(), checkpoint_every=4,
                       chain_file=os.path.join(out, f"first-rank{rank}.npy"))
    dist.barrier()
    resumed = sampler()
    resumed.preload(np.load(first))
    pos, lnp, rng = resumed.load_state(first)
    g = torch.Generator()
    g.set_state(rng)
    resumed.run_mcmc(pos, 4, g, checkpoint_every=4, lnp0=lnp)
    res["resumed"] = resumed.chain

    raw = sampler()
    raw.run_mcmc(pos0, 8, gen(), checkpoint_every=8)
    thinned = sampler()
    thinned.run_mcmc(pos0, 4, gen(), checkpoint_every=4, thin=2)
    res["raw"], res["thinned"] = raw.chain, thinned.chain

    untagged = os.path.join(out, "untagged.npy")
    single = os.path.join(out, "single.npy")
    if rank == 0:
        np.save(untagged, full.chain)
        np.savez(untagged[:-4] + ".state.npz", pos=pos0, lnp=np.zeros(W),
                 rng_state=np.zeros(8, np.uint8), accepted=0, total_proposals=0)
        np.save(single, full.chain)
        np.savez(single[:-4] + ".state.npz", pos=pos0, lnp=np.zeros(W),
                 rng_state=np.zeros(8, np.uint8), accepted=0, total_proposals=0,
                 package="cha1_mcmc_tpu_torch")
    dist.barrier()
    for key, path in (("untagged", untagged), ("single", single)):
        try:
            sampler().load_state(path)
        except ValueError as e:
            res[f"refused_{key}"] = np.array(str(e))
    np.savez(os.path.join(out, f"sampler-rank{rank}.npz"), **res)


def _rank_fault(rank, out, m):
    """Twelve steps in three blocks of 4 of the ShardedEnsembleSampler on a
    (1, 2, 1) mesh, whose runner raises a DeviceError on rank 1 alone at
    the start of the second block. Each rank records what it raised, its
    runner calls and the steps its chain holds."""
    from cha1_mcmc_tpu_torch.parallel import make_sharded_sampler
    from cha1_mcmc_tpu_torch.utils import DeviceError

    model = _port_model(m)
    spec, lnprior = _flagship_prior(m)
    sampler = make_sharded_sampler(
        n_devices=2, n_line_shards=1, nwalkers=W, ndim=4, a=2.0, dtype=torch.float64,
        model=model, spec=spec, grid_ints=m["ints"], grid_yerrs=m["yerrs"],
        lnprior_fn=lnprior, device="cpu", verbose=False)
    runner_of, calls = sampler._runner, []

    def faulty_runner(nsteps):
        runner = runner_of(nsteps)

        def run(*args, **kwargs):
            calls.append(nsteps)
            if rank == 1 and len(calls) == 2:
                raise DeviceError("injected on rank 1")
            return runner(*args, **kwargs)
        return run

    sampler._runner = faulty_runner
    res = dict(raised="", device_error=False, runtime_error=False)
    try:
        sampler.run_mcmc(m["pos0"], 12, torch.Generator().manual_seed(7), checkpoint_every=4)
    except Exception as e:  # noqa: BLE001 - what each rank raised is the result
        res = dict(raised=f"{type(e).__name__}: {e}", device_error=isinstance(e, DeviceError),
                   runtime_error=isinstance(e, RuntimeError))
    np.savez(os.path.join(out, f"fault-rank{rank}.npz"), calls=len(calls),
             steps=sampler.chain.shape[1], **{k: np.array(v) for k, v in res.items()})


def _rank_fits(rank, out, flagship, gotham):
    """SpectralFit and MultiComponentFit with n_devices=2, each rank with
    its own fit folder (so a file in rank 1's shows a write); then
    n_devices=3 must raise, and n_chains=2 must be taken (the fit on the
    mesh's chains axis runs in tests/test_torch_multichain.py)."""
    from cha1_mcmc_tpu_torch import (FitConfig, MultiComponentFit, MultiFitConfig,
                                     SpectralFit)

    res = {}
    folder = os.path.join(out, f"rank{rank}")
    for key, cls, cfg_cls, kw in (("flagship", SpectralFit, FitConfig, flagship),
                                  ("gotham", MultiComponentFit, MultiFitConfig, gotham)):
        fit = cls(cfg_cls(fit_folder=os.path.join(folder, key), n_devices=2,
                          device="cpu", **kw))
        with contextlib.redirect_stdout(io.StringIO()):
            res[key] = fit.run()
        res[f"{key}_acceptance"] = np.array(fit.sampler.acceptance_fraction)
        res[f"{key}_sampler"] = np.array(type(fit.sampler).__name__)
    try:
        SpectralFit(FitConfig(fit_folder=folder, n_devices=3, device="cpu",
                              **flagship)).run()
    except ValueError as e:
        res["n_devices_3"] = np.array(str(e))
    res["n_chains_2"] = np.array(SpectralFit(FitConfig(
        fit_folder=folder, n_devices=2, n_chains=2, device="cpu", **flagship)).sharded)
    np.savez(os.path.join(out, f"fits-rank{rank}.npz"), **res)


# -- the JAX side and the spawns -----------------------------------------------

@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The flagship problem as both packages see it: the JAX model (float64)
    and its constants for the ranks, the walker ball, and the JAX prior."""
    import jax
    from cha1_mcmc_tpu.inference import ParamSpec, single_component_lnprior
    from tests.port_problems import write_hc5n_problem
    from tests.torch_parity import (BOUNDS, MEANS_4, STDS_4, TRUTH_4, jax_model,
                                    jax_reduce, model_arrays, q_dict, walker_ball)

    problem = write_hc5n_problem(str(tmp_path_factory.mktemp("hc5n")))
    cat, grid = jax_reduce(problem)
    with jax.enable_x64():
        jm = jax_model(cat, grid, "float64")
    spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
    m = dict(arrays=model_arrays(jm), q=q_dict(jm.q_model), ss=52.0,
             geometry=dict(mask_center=jm.mask_center, dish_size=jm.dish_size,
                           Tbg=jm.Tbg, vel_offset=jm.vel_offset),
             ints=np.asarray(grid.ints), yerrs=np.asarray(grid.yerrs),
             prior=(BOUNDS, MEANS_4, STDS_4), pos0=walker_ball(TRUTH_4, W, 0))
    return dict(problem=problem, jm=jm, grid=grid, spec=spec, m=m,
                lnprior=single_component_lnprior(spec, BOUNDS, MEANS_4, STDS_4))


def _jax_run(f, shape, use_pallas=False, key_seed=3):
    """The JAX general sharded runner on a (chains, walkers, lines) mesh of
    the virtual devices: (outputs as NumPy, each walker shard's stream)."""
    import jax
    import jax.numpy as jnp
    from cha1_mcmc_tpu.parallel import make_mesh, make_sharded_runner
    from tests.torch_parity import jax_shard_randomness

    n_c, n_w, n_l = shape
    key = jax.random.PRNGKey(key_seed)
    with jax.enable_x64():
        mesh = make_mesh(n_w, n_l, n_chain_shards=n_c)
        run = make_sharded_runner(f["jm"], f["spec"], f["grid"].ints, f["grid"].yerrs,
                                  f["lnprior"], mesh, NSTEPS, use_pallas=use_pallas,
                                  dv_max=DV_MAX, interpret=True)
        chain, lnps, acc, (pos, lnp) = run(jnp.asarray(f["m"]["pos0"]), key)
        out = {k: np.asarray(v) for k, v in (("chain", chain), ("lnps", lnps),
                                             ("acc", acc), ("pos", pos), ("lnp", lnp))}
        w_local = W // (n_c * n_w)
        rnd = [jax_shard_randomness(key, NSTEPS, w_local, w_local // 2 * n_w, w,
                                    "float64") for w in range(n_c * n_w)]
        layout = [tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
                  for d in jax.devices()[:n_c * n_w * n_l]]
    return out, rnd, layout


@pytest.fixture(scope="module")
def runs2(flagship, tmp_path_factory):
    """Two gloo ranks: the (1, 2, 1) and (1, 1, 2) meshes with the general
    runner, (1, 1, 2) over K4a's plain version; with the JAX runs."""
    cases = {"w": ((1, 2, 1), False), "l": ((1, 1, 2), False), "lp": ((1, 1, 2), True)}
    jax_out, runs = {}, []
    for name, (shape, use_pallas) in cases.items():
        out, rnd, layout = _jax_run(flagship, shape, use_pallas)
        jax_out[name] = (out, layout)
        runs.append((name, shape, use_pallas, rnd))
    tmp = tmp_path_factory.mktemp("runs2")
    spawn(_rank_runners, 2, tmp, str(tmp), flagship["m"], runs)
    return jax_out, [dict(np.load(tmp / f"runners-3-rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def runs4(flagship, tmp_path_factory):
    """Four gloo ranks: the layouts of (1, 2, 2) and (2, 2, 1), and the
    general runner on (1, 2, 2); with the JAX runs."""
    out, rnd, layout = _jax_run(flagship, (1, 2, 2))
    import jax
    from cha1_mcmc_tpu.parallel import make_mesh

    jmesh = make_mesh(2, 1, n_chain_shards=2)
    layout_c = [tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
                for d in jax.devices()[:4]]
    tmp = tmp_path_factory.mktemp("runs4")
    runs = [("wl", (1, 2, 2), False, rnd), ("cw", (2, 2, 1), False, None)]
    spawn(_rank_runners, 4, tmp, str(tmp), flagship["m"], runs)
    ranks = [dict(np.load(tmp / f"runners-2-rank{r}.npz")) for r in range(4)]
    return {"wl": (out, layout), "cw": (None, layout_c)}, ranks


def _assert_runner_matches(jax_out, ranks, name):
    for res in ranks:   # every rank returns the global arrays
        assert res[f"{name}/chain"].shape == (NSTEPS, W, 4)
        np.testing.assert_array_equal(res[f"{name}/chain"], jax_out["chain"])
        np.testing.assert_array_equal(res[f"{name}/acc"], jax_out["acc"])
        np.testing.assert_array_equal(res[f"{name}/pos"], jax_out["pos"])
        np.testing.assert_allclose(res[f"{name}/lnps"], jax_out["lnps"], rtol=1e-12)
        np.testing.assert_allclose(res[f"{name}/lnp"], jax_out["lnp"], rtol=1e-12)
    assert 0 < jax_out["acc"].sum() < NSTEPS * W


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["w", "l"])
def test_mesh_layout_matches_jax_two_ranks(runs2, name):
    """Rank r sits at the (chain, walker, line) index of JAX device r, for
    the (1, 2, 1) and (1, 1, 2) meshes."""
    jax_out, ranks = runs2
    layout = jax_out[name][1]
    assert [tuple(r[f"{name}/coords"]) for r in ranks] == layout


@pytest.mark.parametrize("name", ["wl", "cw"])
def test_mesh_layout_matches_jax_four_ranks(runs4, name):
    """The same for the (1, 2, 2) and (2, 2, 1) meshes on four ranks."""
    jax_out, ranks = runs4
    assert [tuple(r[f"{name}/coords"]) for r in ranks] == jax_out[name][1]


def test_mesh_larger_than_the_world_raises(runs2, runs4):
    for ranks, world in ((runs2[1], 2), (runs4[1], 4)):
        for res in ranks:
            assert f"the torch.distributed world holds {world}" in str(res["mismatch"])


def test_general_runner_walker_sharded_matches_jax(runs2):
    """(1, 2, 1), float64: the balanced per-shard split, the complement
    all_gathered over the walker group, pairs drawn over it."""
    _assert_runner_matches(runs2[0]["w"][0], runs2[1], "w")


def test_general_runner_line_sharded_matches_jax(runs2):
    """(1, 1, 2), float64: the partial opacities all_reduced over the line
    group, the JAX version's psum."""
    _assert_runner_matches(runs2[0]["l"][0], runs2[1], "l")


def test_general_runner_walkers_and_lines_match_jax(runs4):
    """(1, 2, 2) on four ranks, float64."""
    _assert_runner_matches(runs4[0]["wl"][0], runs4[1], "wl")


def test_line_sharded_block_opacity_matches_jax(runs2):
    """(1, 1, 2) with use_pallas: K4a (its plain version on the CPU) over
    each rank's line shard with the shard's own block mask
    (block_activity_mask_traced) vs the JAX kernel in interpret mode, and
    the general line-sharded run of the same stream: one trajectory."""
    _assert_runner_matches(runs2[0]["lp"][0], runs2[1], "lp")
    np.testing.assert_array_equal(runs2[1][0]["lp/chain"], runs2[1][0]["l/chain"])


def test_block_activity_mask_traced_matches_jax():
    from cha1_mcmc_tpu.models.pallas_kernels import block_activity_mask_traced as jmask
    from cha1_mcmc_tpu_torch.models.sparse_opacity import (block_activity_mask,
                                                           block_activity_mask_traced)

    rng = np.random.default_rng(0)
    vel = rng.uniform(-40.0, 40.0, (700, 300)) + 4.1
    for center, dv in ((4.1, 1.5), (0.0, 0.3)):
        got = block_activity_mask_traced(torch.from_numpy(vel), center, dv).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmask(vel, center, dv)))
        np.testing.assert_array_equal(got, block_activity_mask(vel, center, dv))


@pytest.fixture(scope="module")
def sampler_runs(flagship, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sampler")
    spawn(_rank_sampler, 2, tmp, str(tmp), flagship["m"])
    return tmp, [dict(np.load(tmp / f"sampler-rank{r}.npz")) for r in range(2)]


def test_sharded_sampler_chain_file_by_rank_zero(sampler_runs):
    """(W, S, D) chain file and sidecar from rank 0 only, equal to the
    sampler's chain on both ranks."""
    tmp, ranks = sampler_runs
    assert os.path.exists(tmp / "full-rank0.npy")
    assert os.path.exists(tmp / "full-rank0.state.npz")
    assert not os.path.exists(tmp / "full-rank1.npy")
    assert not os.path.exists(tmp / "full-rank1.state.npz")
    saved = np.load(tmp / "full-rank0.npy")
    assert saved.shape == (W, 8, 4)
    for res in ranks:
        np.testing.assert_array_equal(res["full"], saved)
    sidecar = np.load(tmp / "full-rank0.state.npz")
    assert sidecar["rng_states"].shape[0] == 2
    assert str(sidecar["package"]) == "cha1_mcmc_tpu_torch"
    assert 0.1 < float(ranks[0]["acceptance"]) < 0.9


def test_sharded_sampler_blocks_and_resume_are_exact(sampler_runs):
    """Two run_mcmc calls equal one run of two blocks, and a resume from
    the 4-step file and its sidecar continues each shard's stream: all
    bitwise."""
    _, ranks = sampler_runs
    for res in ranks:
        np.testing.assert_array_equal(res["split"], res["full"])
        np.testing.assert_array_equal(res["resumed"], res["full"])


def test_sharded_sampler_thin_keeps_every_second_raw_state(sampler_runs):
    _, ranks = sampler_runs
    for res in ranks:
        assert res["thinned"].shape == (W, 4, 4)
        np.testing.assert_array_equal(res["thinned"], res["raw"][:, 1::2])


@pytest.mark.parametrize("key,match", [("untagged", "was not written by"),
                                       ("single", "generator state for each of 2")])
def test_sharded_sampler_refuses_foreign_sidecars(sampler_runs, key, match):
    for res in sampler_runs[1]:
        assert match in str(res[f"refused_{key}"])


@pytest.fixture(scope="module")
def fit_runs(flagship, tmp_path_factory):
    from tests.port_problems import write_hc9n_problem

    tmp = tmp_path_factory.mktemp("fits")
    p, g = flagship["problem"], write_hc9n_problem(str(tmp / "hc9n"), n_multiplets=4)
    flag = dict(mol_name="hc5n_hfs", cat_folder=p["cat_folder"],
                data_path=p["data_path"], nwalkers=W, nruns=40, checkpoint_every=20,
                seed=0)
    gotham = dict(mol_name="hc9n_hfs", template_run=True, cat_folder=g["cat_folder"],
                  data_path=g["data_path"], nwalkers=W, nruns=40, checkpoint_every=20,
                  seed=0)
    spawn(_rank_fits, 2, tmp, str(tmp), flag, gotham)
    return tmp, [dict(np.load(tmp / f"fits-rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("key,ndim", [("flagship", 4), ("gotham", 14)])
def test_sharded_fits_on_two_ranks(fit_runs, key, ndim):
    """SpectralFit / MultiComponentFit with n_devices=2 on two gloo ranks:
    the same finite (W, S, D) chain on both, a sane acceptance, and the
    chain, sidecar and throughput files in rank 0's folder only."""
    tmp, ranks = fit_runs
    for res in ranks:
        assert str(res[f"{key}_sampler"]) == "ShardedEnsembleSampler"
        assert res[key].shape == (W, 40, ndim)
        assert np.isfinite(res[key]).all()
        np.testing.assert_array_equal(res[key], ranks[0][key])
        assert 0.1 < float(res[f"{key}_acceptance"]) < 0.9
    name = "hc5n_hfs" if key == "flagship" else "hc9n_hfs"
    for rank, present in ((0, True), (1, False)):
        folder = tmp / f"rank{rank}" / key / name
        for fname in ("chain.npy" if key == "gotham" else "chain_template.npy",
                      "throughput.json"):
            assert os.path.exists(folder / fname) == present, (rank, fname)


def test_sharded_fit_refusals(fit_runs):
    """n_devices must equal the world size; n_chains > 1 is no longer
    refused (P15 is ported): the sharded fit takes it."""
    for res in fit_runs[1]:
        assert "n_devices=3" in str(res["n_devices_3"])
        assert bool(res["n_chains_2"])


def test_sharded_sampler_raises_a_device_error_met_by_one_rank(flagship, tmp_path):
    """A DeviceError on one rank is not retried: a rank that reran the
    block alone would pair its collectives with the other ranks' next
    ones. Rank 1 raises it from the block's only runner call; rank 0, left
    waiting in the block's collectives, raises a RuntimeError (not a
    DeviceError, and not retried) once rank 1's group is gone, within the
    group's 60 s timeout. Both hold the first block's 4 steps."""
    spawn(_rank_fault, 2, tmp_path, str(tmp_path), flagship["m"], timeout=60)
    ranks = [dict(np.load(tmp_path / f"fault-rank{r}.npz")) for r in range(2)]
    assert str(ranks[1]["raised"]) == "DeviceError: injected on rank 1"
    assert bool(ranks[0]["runtime_error"]) and not bool(ranks[0]["device_error"])
    for res in ranks:
        assert int(res["calls"]) == 2 and int(res["steps"]) == 4


def test_multihost_without_a_launcher_is_one_process(monkeypatch):
    from cha1_mcmc_tpu.parallel.multihost import host_molecule_assignment as jassign
    from cha1_mcmc_tpu_torch.parallel import (host_molecule_assignment,
                                              initialize_multihost)

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() == (0, 1)
    mols = ["hc5n", "hc7n", "hc9n", "c4h", "hc3n"]
    for n in (1, 2, 3):
        for i in range(n):
            assert host_molecule_assignment(mols, i, n) == jassign(mols, i, n)


# -- the entry points run on the card unless asked for the CPU -------------------

def _defaults():
    from cha1_mcmc_tpu_torch.inference import estimate_ncol_mle
    from cha1_mcmc_tpu_torch.models.forward import SpectralModel, model_from_arrays
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler

    return {"EnsembleSampler": EnsembleSampler.__dataclass_fields__["device"].default,
            "SpectralModel": inspect.signature(SpectralModel).parameters["device"].default,
            "SpectralModel.build":
                inspect.signature(SpectralModel.build).parameters["device"].default,
            "model_from_arrays":
                inspect.signature(model_from_arrays).parameters["device"].default,
            "estimate_ncol_mle":
                inspect.signature(estimate_ncol_mle).parameters["device"].default}


def _build_with_defaults(name, m):
    from cha1_mcmc_tpu_torch.catalogs import QModel
    from cha1_mcmc_tpu_torch.inference import ParamSpec, estimate_ncol_mle
    from cha1_mcmc_tpu_torch.models.forward import SpectralModel, model_from_arrays
    from cha1_mcmc_tpu_torch.sampler import EnsembleSampler

    geometry = m["geometry"]
    if name == "EnsembleSampler":
        return EnsembleSampler(lnprob_fn=lambda x: x.sum(1), nwalkers=8, ndim=2)
    if name == "SpectralModel":
        return SpectralModel(m["arrays"], QModel(**m["q"]), **geometry)
    if name == "SpectralModel.build":
        from cha1_mcmc_tpu_torch.catalogs import load_catalog

        return SpectralModel.build(load_catalog(m["cat_path"]), np.arange(3),
                                   m["arrays"]["grid_freq"], ll=18000.0, ul=25000.0,
                                   dish_size=70.0, vel_offset=4.1, mask_center=4.1)
    if name == "model_from_arrays":
        return model_from_arrays(m["arrays"], m["q"], **geometry)
    spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
    return estimate_ncol_mle(lambda th: -th[:, 0], spec, [1e12, 7.5, 4.1, 0.8],
                             (1e8, 1e14))


@pytest.mark.parametrize("name", ["EnsembleSampler", "SpectralModel",
                                  "SpectralModel.build", "model_from_arrays",
                                  "estimate_ncol_mle"])
def test_entry_points_default_to_the_card(flagship, monkeypatch, name):
    """Each library entry point's device defaults to CUDA; called with no
    device where torch sees no CUDA device, it raises naming the way to
    the CPU."""
    assert torch.device(_defaults()[name]).type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = dict(flagship["m"], cat_path=flagship["problem"]["cat_path"])
    with pytest.raises(RuntimeError, match="no CUDA device is available: pass "
                                           "device='cpu'"):
        _build_with_defaults(name, m)
