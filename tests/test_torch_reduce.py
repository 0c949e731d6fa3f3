"""Data reduction of the torch port (NumPy host code) against the JAX
package on the synthetic flagship files: Datagrid arrays equal."""

import contextlib
import io

import numpy as np
import pytest
import torch

from tests.port_problems import write_hc5n_problem
from tests.torch_parity import problem

torch.set_num_threads(1)

_KW = dict(ll=18000.0, ul=25000.0, aligned_velocity=4.10, dish_size=70.0,
           source_size=52.0)


def _both(cat_path, data_path, **kw):
    from cha1_mcmc_tpu.catalogs import load_catalog as jload
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum as jreduce
    from cha1_mcmc_tpu_torch.catalogs import load_catalog as pload
    from cha1_mcmc_tpu_torch.reduce import reduce_spectrum as preduce

    with contextlib.redirect_stdout(io.StringIO()):
        gj = jreduce(jload(cat_path), data_path, **_KW, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gp = preduce(pload(cat_path), data_path, **_KW, **kw)
    return gj, gp, out.getvalue()


def _assert_grids_equal(gj, gp):
    for f in ("freqs", "ints", "yerrs", "covered_trans"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(gj, f))


def test_reduce_spectrum_matches_jax(problem):
    gj, gp, log = _both(problem["cat_path"], problem["data_path"])
    _assert_grids_equal(gj, gp)
    # the default problem keeps all 9 in-window lines and all 561 channels
    assert gp.covered_trans.size == 9 and gp.freqs.size == 561
    assert log.count("Line found.") == 9


@pytest.mark.parametrize("seed,block", [(0, True), (6, True), (6, False), (8, True)])
def test_reduce_spectrum_other_noise_draws(tmp_path, seed, block):
    """Noise draws where the interloper test blocks some windows (and the
    same draw with blocking off) reduce identically in both packages."""
    prob = write_hc5n_problem(str(tmp_path), seed=seed)
    gj, gp, log = _both(prob["cat_path"], prob["data_path"],
                        block_interlopers=block)
    _assert_grids_equal(gj, gp)
    if block:
        assert 5 <= gp.covered_trans.size < 9
        assert "Interloping line detected." in log
    else:
        assert gp.covered_trans.size == 9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noise_estimators_match_jax(seed):
    from cha1_mcmc_tpu.reduce.noise import calc_noise_std as jn, calc_noise_std_gotham as jg
    from cha1_mcmc_tpu_torch.reduce import calc_noise_std as pn, calc_noise_std_gotham as pg

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.01, 300)
    x[[5, 100, 101, 250]] += np.array([0.2, -0.15, 0.3, 0.08])
    assert pn(x) == jn(x)
    assert pg(x) == jg(x)


def test_save_load_datagrid_roundtrip(problem, tmp_path):
    from cha1_mcmc_tpu.reduce.datagrid import load_datagrid as jload_grid
    from cha1_mcmc_tpu_torch.reduce import load_datagrid, save_datagrid

    _, gp, _ = _both(problem["cat_path"], problem["data_path"])
    path = str(tmp_path / "sub" / "grid.npy")
    save_datagrid(path, gp)
    _assert_grids_equal(load_datagrid(path), gp)
    _assert_grids_equal(jload_grid(path), gp)   # same artifact format


def test_simulate_sticks_host_matches_jax(problem):
    from cha1_mcmc_tpu.catalogs import load_catalog as jload
    from cha1_mcmc_tpu.models.forward import simulate_sticks_host as jsim
    from cha1_mcmc_tpu_torch.catalogs import load_catalog as pload
    from cha1_mcmc_tpu_torch.models import simulate_sticks_host as psim

    kw = dict(C=[3.4e12, 1e12], dV=[0.89, 0.5], T=[7.0, 9.0], ll=[18000.0, 5000.0],
              ul=[25000.0, 6000.0], source_size=52.0, dish_size=70.0)
    for a, b in zip(psim(pload(problem["cat_path"]), **kw),
                    jsim(jload(problem["cat_path"]), **kw)):
        np.testing.assert_array_equal(a, b)
