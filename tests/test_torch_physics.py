"""Physics layer of the torch port against the JAX package: ops/lte
(torch float64 vs jnp float64 under jax.enable_x64), the partition
functions (analytic dispatch, state sum, Chebyshev surrogate) and the
SPCAT parser on the synthetic hc5n_hfs catalog.

Tolerances: float64 rtol 1e-14; host (NumPy) paths and catalog arrays
equal."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.torch_parity import problem

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
_N = 257
_ARGS = dict(
    freq=_RNG.uniform(18e3, 25e3, _N), T=_RNG.uniform(3.5, 12.0, _N),
    elower=_RNG.uniform(0.0, 30.0, _N), aij=10 ** _RNG.uniform(-8, -5, _N),
    gup=_RNG.integers(3, 60, _N).astype(float),
    glow=_RNG.integers(3, 60, _N).astype(float),
    Q=_RNG.uniform(50.0, 500.0, _N), Ncol=10 ** _RNG.uniform(10, 14, _N),
    dV=_RNG.uniform(0.4, 1.5, _N), ss=_RNG.uniform(30.0, 90.0, _N),
    tau=_RNG.uniform(0.0, 2.0, _N), ints=_RNG.uniform(0.0, 1.0, _N),
)

_LTE_CASES = {
    "planck_J": lambda m, xp, a: m.planck_J(xp, a["freq"], a["T"]),
    "planck_J_guard": lambda m, xp, a: m.planck_J(xp, a["freq"], a["T"], guard=1e-10),
    "beam_dilution": lambda m, xp, a: m.beam_dilution(xp, a["freq"], a["ss"], 70.0),
    "apply_beam": lambda m, xp, a: m.apply_beam(xp, a["freq"], a["ints"], a["ss"], 70.0),
    "get_beam": lambda m, xp, a: m.get_beam(xp, a["freq"], 70.0),
    "invert_beam": lambda m, xp, a: m.invert_beam(xp, a["freq"], a["ints"], a["ss"], 70.0),
    "tau_sticks": lambda m, xp, a: m.tau_sticks(xp, a["freq"], a["elower"], a["aij"],
                                                a["gup"], a["glow"], a["Q"], a["Ncol"],
                                                a["T"], a["dV"]),
    "stick_spectrum": lambda m, xp, a: m.stick_spectrum(xp, a["freq"], a["tau"], a["T"],
                                                        2.7, a["ss"], 70.0),
    "scale_temp": lambda m, xp, a: m.scale_temp(xp, a["ints"], a["elower"], a["T"],
                                                300.0, a["Q"], 400.0),
}


@pytest.mark.parametrize("name", sorted(_LTE_CASES))
def test_lte_torch_matches_jax_f64(name):
    from cha1_mcmc_tpu.ops import lte as jlte
    from cha1_mcmc_tpu_torch.ops import lte as plte

    fn = _LTE_CASES[name]
    with jax.enable_x64():
        ref = np.asarray(fn(jlte, jnp, {k: jnp.asarray(v) for k, v in _ARGS.items()}))
    out = fn(plte, torch, {k: torch.as_tensor(v) for k, v in _ARGS.items()})
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14)
    # the NumPy host instantiation is the same code in both packages
    np.testing.assert_array_equal(fn(plte, np, _ARGS), fn(jlte, np, _ARGS))


# One catalog name per analytic branch shape: linear x3, 7-term polynomial,
# pure power law, power law + constant, 4-term polynomial, linear / 3.
_Q_NAMES = ["hc5n_hfs.cat", "acetone.cat", "ch2nh.cat", "benzonitrile.cat",
            "13ch3oh.cat", "hc4nc.cat", "hc9n_hfs.cat", "pyrrole.cat"]


class _Named:
    def __init__(self, name):
        self.catalog_file = "/cat/" + name


@pytest.mark.parametrize("name", _Q_NAMES)
def test_analytic_q_dispatch_and_eval(name):
    from cha1_mcmc_tpu.catalogs.partition import q_model_for_catalog as jq
    from cha1_mcmc_tpu_torch.catalogs.partition import q_model_for_catalog as pq

    qj, qp = jq(_Named(name)), pq(_Named(name))
    assert qp.kind == qj.kind == "analytic"
    assert (qp.coeffs, qp.power, qp.scale) == (qj.coeffs, qj.power, qj.scale)
    T = np.linspace(3.5, 300.0, 101)
    np.testing.assert_array_equal(qp.host_eval(T), qj.host_eval(T))
    with jax.enable_x64():
        ref = np.asarray(qj(jnp.asarray(T)))
    np.testing.assert_allclose(qp(torch.as_tensor(T)).numpy(), ref, rtol=1e-14)


@pytest.fixture(scope="module")
def catalogs(problem):
    from cha1_mcmc_tpu.catalogs import load_catalog as jload
    from cha1_mcmc_tpu_torch.catalogs import load_catalog as pload

    return jload(problem["cat_path"]), pload(problem["cat_path"])


_CAT_FIELDS = ["frequency", "error", "logint", "dof", "elower", "eupper", "gup",
               "glow", "tag", "qnformat", "qn", "intensity", "sijmu", "aij"]


@pytest.mark.parametrize("field", _CAT_FIELDS)
def test_parse_spcat_matches_jax(catalogs, field):
    cj, cp = catalogs
    np.testing.assert_array_equal(getattr(cp, field), getattr(cj, field))


def test_synthetic_catalog_shape(catalogs):
    """63 transitions, 9 inside (18 000, 25 000] MHz whose lower states the
    glow hash match finds (glow = 2F_low + 1 > 1)."""
    cj, cp = catalogs
    assert len(cp) == 63 and cp.qns == cj.qns == 2 and cp.name == "hc5n_hfs"
    i, i2 = cp.trim_indices(18000.0, 25000.0)
    assert (i, i2) == cj.trim_indices(18000.0, 25000.0) and i2 - i == 9
    assert np.all(cp.glow[i:i2] > 1)
    # a window above every line is empty as (0, 0) (reference trim_array)
    assert cp.trim_indices(1e6, 2e6) == cj.trim_indices(1e6, 2e6) == (0, 0)


def test_state_sum_q_matches_jax(catalogs):
    from cha1_mcmc_tpu.catalogs.partition import _state_sum_model as jss
    from cha1_mcmc_tpu_torch.catalogs.partition import _state_sum_model as pss

    cj, cp = catalogs
    qj, qp = jss(cj), pss(cp)
    np.testing.assert_array_equal(qp.g, qj.g)
    np.testing.assert_array_equal(qp.E, qj.E)
    T = np.linspace(3.5, 12.0, 64)
    np.testing.assert_array_equal(qp.host_eval(T), qj.host_eval(T))
    with jax.enable_x64():
        ref = np.asarray(qj(jnp.asarray(T)))
    np.testing.assert_allclose(qp(torch.as_tensor(T)).numpy(), ref, rtol=1e-14)


def test_chebyshev_q_matches_jax(catalogs):
    from cha1_mcmc_tpu.catalogs.partition import (_state_sum_model as jss,
                                                  device_n_states as jn,
                                                  fit_device_cheb as jfit)
    from cha1_mcmc_tpu_torch.catalogs.partition import (_state_sum_model as pss,
                                                        device_n_states as pn,
                                                        fit_device_cheb as pfit)

    cj, cp = catalogs
    qj, qp = jfit(jss(cj), 3.5, 12.0), pfit(pss(cp), 3.5, 12.0)
    assert qp.cheb_coeffs is not None
    assert qp.cheb_coeffs == qj.cheb_coeffs
    assert qp.cheb_interval == qj.cheb_interval
    assert pn(qp) == jn(qj) == 0 and pn(pss(cp)) == jn(jss(cj)) > 0
    T = np.linspace(3.6, 11.9, 64)
    with jax.enable_x64():
        ref = np.asarray(qj(jnp.asarray(T)))
    np.testing.assert_allclose(qp(torch.as_tensor(T)).numpy(), ref, rtol=1e-14)
    # the surrogate is within its fit tolerance of the exact state sum
    np.testing.assert_allclose(qp(torch.as_tensor(T)).numpy(), qp.host_eval(T),
                               rtol=1e-9)
    # analytic models and already-fitted ones are returned unchanged
    assert pfit(qp, 3.5, 12.0) is qp
    analytic = dataclasses.replace(qp, kind="analytic", cheb_coeffs=None)
    assert pfit(analytic, 3.5, 12.0) is analytic


def test_int_pow_matches_integer_pow_order():
    from cha1_mcmc_tpu_torch.catalogs.partition import int_pow

    x = torch.as_tensor(_ARGS["T"])
    for n in range(8):
        with jax.enable_x64():
            ref = np.asarray(jax.lax.integer_pow(jnp.asarray(_ARGS["T"]), n))
        np.testing.assert_array_equal(int_pow(x, n).numpy(), ref)
