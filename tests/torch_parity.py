"""Shared helpers for the parity tests of the torch port against the JAX
package (tests/test_torch_*.py): the synthetic flagship, GOTHAM and dense
problems as seen by both packages, the JAX model's constants as NumPy
arrays, and the JAX sampler's randomness rebuilt exactly as
cha1_mcmc_tpu/sampler/stretch.py draws it."""

from __future__ import annotations

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from tests.port_problems import (ALIGNED_VELOCITY, DENSE_CENTER, DENSE_DISH,
                                 DENSE_SOURCE_SIZE, DISH_SIZE, GOTHAM_CENTER,
                                 GOTHAM_DISH, GOTHAM_LL, GOTHAM_UL, LL, UL,
                                 SOURCE_SIZE, write_dense_problem,
                                 write_hc5n_problem, write_hc9n_problem)

BOUNDS = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
          "Tex": (3.5, 12.0), "vlsr": (3.0, 5.5), "dV": (0.4, 1.5)}
MEANS_4 = np.array([3.4e10, 8.0, 4.3, 0.7575])
STDS_4 = np.array([0.34e10, 3.0, 0.06, 0.22])
MEANS_5 = np.array([46.91, 3.4e10, 8.0, 4.3, 0.7575])
STDS_5 = np.array([6.5, 0.34e10, 3.0, 0.06, 0.22])
TRUTH_4 = np.array([3.24e12, 7.5, 4.11, 0.78])
TRUTH_5 = np.array([52.0, 3.24e12, 7.5, 4.11, 0.78])

_MODEL_FIELDS = ("line_freq", "line_elower", "line_aij", "line_gup",
                 "line_glow", "grid_freq", "vel_grid")


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The synthetic hc5n_hfs catalog and 561-channel spectrum on disk."""
    return write_hc5n_problem(str(tmp_path_factory.mktemp("hc5n")))


def jax_reduce(problem):
    """(catalog, datagrid) from the JAX package, reduction log silenced."""
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

    cat = load_catalog(problem["cat_path"])
    with contextlib.redirect_stdout(io.StringIO()):
        grid = reduce_spectrum(cat, problem["data_path"], ll=LL, ul=UL,
                               aligned_velocity=ALIGNED_VELOCITY,
                               dish_size=DISH_SIZE, source_size=SOURCE_SIZE)
    return cat, grid


def jax_model(cat, grid, dtype, q_model=None):
    """The JAX SpectralModel of the flagship geometry (build it inside
    jax.enable_x64() for float64)."""
    import jax.numpy as jnp
    from cha1_mcmc_tpu.models.forward import SpectralModel

    return SpectralModel.build(cat, grid.covered_trans, grid.freqs, ll=LL,
                               ul=UL, dish_size=DISH_SIZE,
                               vel_offset=ALIGNED_VELOCITY,
                               mask_center=ALIGNED_VELOCITY,
                               q_model=q_model, dtype=jnp.dtype(dtype))


@pytest.fixture(scope="module")
def gotham_problem(tmp_path_factory):
    """The synthetic GOTHAM hc9n_hfs catalog and spectrum at a small size
    (4 multiplets: 12 lines, ~200 channels)."""
    return write_hc9n_problem(str(tmp_path_factory.mktemp("hc9n")),
                              n_multiplets=4)


def jax_gotham_reduce(problem):
    """(catalog, datagrid) of the GOTHAM problem from the JAX package: the
    multifit's fiducial stick simulation, then read_spectrum_gotham."""
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.models.forward import simulate_sticks_host
    from cha1_mcmc_tpu.pipeline.multifit import MultiFitConfig
    from cha1_mcmc_tpu.reduce.datagrid import read_spectrum_gotham

    cfg = MultiFitConfig(mol_name="hc9n_hfs")
    cat = load_catalog(problem["cat_path"], name="hc9n_hfs")
    C, dV, T, ss = cfg.fiducial
    freq_sim, int_sim, _ = simulate_sticks_host(
        cat, C=[C], dV=[dV], T=[T], ll=[GOTHAM_LL], ul=[GOTHAM_UL],
        source_size=ss, dish_size=GOTHAM_DISH)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = read_spectrum_gotham(np.load(problem["data_path"]), freq_sim,
                                    int_sim)
    return cat, grid


def jax_gotham_model(cat, grid, dtype, q_model=None):
    """The JAX SpectralModel of the multifit geometry (mask center 5.8, no
    velocity offset, 100 m dish); build it inside jax.enable_x64() for
    float64. port_model carries its constants across."""
    import jax.numpy as jnp
    from cha1_mcmc_tpu.models.forward import SpectralModel

    return SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                               ll=GOTHAM_LL, ul=GOTHAM_UL, dish_size=GOTHAM_DISH,
                               vel_offset=0.0, mask_center=GOTHAM_CENTER,
                               q_model=q_model, dtype=jnp.dtype(dtype))


@pytest.fixture(scope="module")
def dense_problem(tmp_path_factory):
    """The synthetic dense asymmetric-top problem at the CPU tests' size
    (scale="small": 228 lines x 858 channels, a split gather table)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return write_dense_problem(str(tmp_path_factory.mktemp("dense")),
                                   scale="small")


def jax_dense_reduce(problem):
    """(catalog, datagrid) of the dense problem from the JAX package."""
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

    cat = load_catalog(problem["cat_path"])
    grid = reduce_spectrum(cat, problem["data_path"], ll=problem["ll"],
                           ul=problem["ul"], aligned_velocity=DENSE_CENTER,
                           dish_size=DENSE_DISH, source_size=DENSE_SOURCE_SIZE,
                           verbose=False)
    return cat, grid


def jax_dense_model(problem, cat, grid, dtype, q_model=None):
    """The JAX SpectralModel of the dense geometry (aligned velocity and
    mask center 5.8, 100 m dish); build it inside jax.enable_x64() for
    float64."""
    import jax.numpy as jnp
    from cha1_mcmc_tpu.models.forward import SpectralModel

    return SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                               ll=problem["ll"], ul=problem["ul"],
                               dish_size=DENSE_DISH, vel_offset=DENSE_CENTER,
                               mask_center=DENSE_CENTER, q_model=q_model,
                               dtype=jnp.dtype(dtype))


def jax_gather_plan(jmodel, spec, nwalkers, min_saving=1.3, dv_max=1.5):
    """The JAX package's K3 plan (plan_fused_gather) with the deviceless
    Mosaic probe off, as its CPU runs plan."""
    from cha1_mcmc_tpu.sampler.fused_gather import plan_fused_gather

    return plan_fused_gather(jmodel, spec, dv_max, nwalkers=nwalkers,
                             min_saving=min_saving, probe=False)


def model_arrays(jmodel) -> dict:
    return {k: np.asarray(getattr(jmodel, k)) for k in _MODEL_FIELDS}


def q_dict(qm) -> dict:
    return dataclasses.asdict(qm)


def port_model(jmodel, dtype):
    """The port's SpectralModel on the JAX model's exact constants."""
    from cha1_mcmc_tpu_torch.models.forward import model_from_arrays

    return model_from_arrays(model_arrays(jmodel), q_dict(jmodel.q_model),
                             mask_center=jmodel.mask_center,
                             dish_size=jmodel.dish_size, Tbg=jmodel.Tbg,
                             vel_offset=jmodel.vel_offset, device="cpu",
                             dtype=dtype)


def jax_randomness(key, n_raw: int, W: int, dtype):
    """(perms, z_u, pair, acc_u) as NumPy, drawn exactly as
    cha1_mcmc_tpu/sampler/stretch.py:98-104 (and fused.py:403-407) draw
    them from `key`."""
    import jax

    h = W // 2
    k_perm, k_z, k_pair, k_acc = jax.random.split(key, 4)
    perms = jax.numpy.argsort(jax.random.uniform(k_perm, (n_raw, W)), axis=1)
    z_u = jax.random.uniform(k_z, (n_raw, 2, h), dtype=dtype)
    pair = jax.random.randint(k_pair, (n_raw, 2, h), 0, h)
    acc_u = jax.random.uniform(k_acc, (n_raw, 2, h), dtype=dtype)
    return tuple(np.asarray(t) for t in (perms, z_u, pair, acc_u))


def jax_shard_randomness(key, nsteps: int, w_local: int, n_comp: int, w_idx: int,
                         dtype):
    """(perms, z_u, pair, acc_u) of walker shard `w_idx` as NumPy, drawn
    exactly as the JAX sharded runners draw them inside their mesh
    program (cha1_mcmc_tpu/parallel/sharded.py:220-230,
    sharded_fused.py:622-629): the key folded with the shard index, split
    in four; pair indexes the n_comp walkers of the gathered complement.
    Call it in the same jax.enable_x64() scope as the runner."""
    import jax

    h = w_local // 2
    k_perm, k_z, k_pair, k_acc = jax.random.split(jax.random.fold_in(key, w_idx), 4)
    perms = jax.numpy.argsort(jax.random.uniform(k_perm, (nsteps, w_local)), axis=1)
    z_u = jax.random.uniform(k_z, (nsteps, 2, h), dtype=dtype)
    pair = jax.random.randint(k_pair, (nsteps, 2, h), 0, n_comp)
    acc_u = jax.random.uniform(k_acc, (nsteps, 2, h), dtype=dtype)
    return tuple(np.asarray(t) for t in (perms, z_u, pair, acc_u))


def to_torch(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def walker_ball(center, W, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return np.asarray(center) * (1 + scale * rng.standard_normal((W, len(center))))


def spec_and_prior(ndim):
    """(fixed source size or None, means, stds, bounds) for 4/5 dims."""
    if ndim == 4:
        return SOURCE_SIZE, MEANS_4, STDS_4, BOUNDS
    return None, MEANS_5, STDS_5, BOUNDS
