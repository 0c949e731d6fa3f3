"""The posterior gate and the JAX package's posterior goldens
(tests/golden/port_posterior_*.json, scripts/make_posterior_goldens.py),
on the CPU.

* Each golden belongs to its problem: the JAX package's float64 lnprob
  at the golden's 16 probe thetas equals the recorded values (rtol
  1e-12) and the reduced datagrid's sha256 and fingerprint are the
  recorded ones; the port's float64 CPU lnprob equals them too.
* The gate (tests/posterior_gate.py) on seeded AR(1) chains of known
  tau: its tau is the port's estimator's; it passes two independent
  chains, fails a mean shifted by 6
  combined standard errors and a std scaled by 1.15, and refuses a chain
  shorter than 50 tau.
* The port's SpectralFit(device="cpu") on the flagship (the general
  sampler, float32, 32 walkers x 4,400 steps) held to the flagship golden
  at CPU_FLOORS. Its chain is 1/15 of the card's: too short to measure
  its own tau (the estimator runs low on a chain of 20 tau, which would
  shrink its standard errors), so its tau is floored at the golden's,
  and its floors are 10 tau_max after a burn of 10 tau_max and
  a combined mean SE of 0.1 sigma. The card's CARD_FLOORS are not
  loosened; chip_smoke.py holds the card's fits to them.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import pytest

from tests import posterior_gate as pg
from tests.posterior_probe import (JAX, PORT, PROBLEMS, build_lnprob64, datagrid_fingerprint,
                                   datagrid_sha256, load_golden as golden, make_fit,
                                   write_problem)

NAMES = tuple(PROBLEMS)
#: The CPU fit's size and its own floors (its tau floored at the golden's).
CPU_FLOORS = pg.Floors(post_tau=10.0, burn_tau=10.0, mean_se=0.1)
CPU_WALKERS, CPU_STEPS = 32, 4_400


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """Each problem written once: name -> (writer dict, folder)."""
    out = {}
    for name in NAMES:
        folder = str(tmp_path_factory.mktemp(name))
        with contextlib.redirect_stdout(io.StringIO()):
            out[name] = (write_problem(name, os.path.join(folder, "problem")), folder)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_golden_belongs_to_its_problem(name, problems):
    """The JAX package's f64 lnprob at the golden's probes equals the
    recorded values, and the reduced datagrid is the golden's."""
    import jax

    g = golden(name)
    prob, folder = problems[name]
    with jax.enable_x64():
        grid, lnprob = build_lnprob64(JAX, name, prob, os.path.join(folder, "jax"))
        got = lnprob(np.asarray(g["probe"]["thetas"]))
    assert datagrid_sha256(grid) == g["datagrid_sha256"]
    assert datagrid_fingerprint(grid) == g["datagrid_fingerprint"]
    assert len(got) == 16 and np.isfinite(got).all()
    np.testing.assert_allclose(got, g["probe"]["lnprob"], rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_port_lnprob_matches_golden(name, problems):
    """The port's f64 CPU lnprob at the golden's probes equals the JAX
    values recorded there, on the same reduced datagrid."""
    g = golden(name)
    prob, folder = problems[name]
    grid, lnprob = build_lnprob64(PORT, name, prob, os.path.join(folder, "port"))
    assert datagrid_sha256(grid) == g["datagrid_sha256"]
    np.testing.assert_allclose(lnprob(np.asarray(g["probe"]["thetas"])),
                               g["probe"]["lnprob"], rtol=1e-12, atol=0)


def ar1(seed, W=32, S=4_000, D=2, phi=0.9):
    """(W, S, D) AR(1) chains with unit stationary variance, started in
    the stationary law: tau = (1 + phi) / (1 - phi) = 19 at phi 0.9."""
    rng = np.random.default_rng(seed)
    x = np.empty((W, S, D))
    x[:, 0] = rng.standard_normal((W, D))
    eps = rng.standard_normal((W, S, D)) * np.sqrt(1 - phi ** 2)
    for t in range(1, S):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return x


def summary(chain):
    return pg.summarize(chain, pg.pick_burn(chain))


def stat_rows(rows, stat):
    return [r for r in rows if r["stat"] == stat]


def test_gate_tau_equals_the_port_estimator():
    """The gate's batched tau is the port's sampler/diagnostics.py
    autocorr_time on the same chain (the summaries of both sides and of
    the goldens count ESS with it)."""
    from cha1_mcmc_tpu_torch.sampler.diagnostics import autocorr_time

    chain = ar1(3, W=16, S=2_000, D=3)
    np.testing.assert_allclose(pg.autocorr_time(chain), autocorr_time(chain), rtol=1e-9)


def test_gate_passes_independent_chains():
    a, b = summary(ar1(1)), summary(ar1(2))
    assert 14 < max(a["tau"]) < 26          # tau of AR(1) at phi 0.9: 19
    rows = pg.compare(a, b)
    assert not pg.failures(rows), pg.format_rows(pg.failures(rows))


def test_gate_fails_a_mean_shifted_by_six_se():
    a, chain = summary(ar1(1)), ar1(2)
    b = summary(chain)
    (row, _) = stat_rows(pg.compare(a, b), "mean")
    shifted = summary(chain + (6 * row["se"] - row["diff"]) * np.array([1.0, 0.0]))
    rows = pg.compare(a, shifted)
    (row, other) = stat_rows(rows, "mean")
    assert row["z"] == pytest.approx(6.0, rel=1e-6) and not row["ok"]
    assert other["ok"]
    assert not all(r["ok"] for r in stat_rows(rows, "p50"))


def test_gate_fails_a_std_scaled_by_1_15():
    a, chain = summary(ar1(1)), ar1(2)
    centre = chain.mean(axis=(0, 1))
    rows = pg.compare(a, summary(centre + 1.15 * (chain - centre)))
    assert [r["ok"] for r in stat_rows(rows, "std")] == [False, False]
    assert all(r["ok"] for r in stat_rows(rows, "mean"))


def test_gate_refuses_a_chain_shorter_than_50_tau():
    a, short = summary(ar1(1)), summary(ar1(2, S=800))
    rows = pg.compare(a, short)
    bad = pg.failures(rows)
    assert [r["stat"] for r in bad if r["param"] == "*"] == \
        ["ours steps after burn / tau_max"], pg.format_rows(bad)
    assert all(r["ok"] for r in rows if "z" in r)     # refused, not judged


def test_gate_tau_floor_bounds_tau_from_below():
    """summarize / pick_burn with tau_floor: tau is the larger of the
    estimate and the floor, the ESS and the burn follow it."""
    chain = ar1(2)
    own = summary(chain)
    floor = [4 * max(own["tau"]), 0.0]
    burn = pg.pick_burn(chain, tau_floor=floor)
    floored = pg.summarize(chain, burn, tau_floor=floor)
    assert burn >= 20 * floor[0] and floored["tau"][0] == floor[0]
    assert floored["tau"][1] == pytest.approx(own["tau"][1], rel=0.2)
    assert floored["ess"][0] == pytest.approx(32 * (4_000 - burn) / floor[0])


def test_port_cpu_flagship_fit_matches_golden(problems, tmp_path):
    """The port's SpectralFit(device="cpu") on the flagship (general
    sampler, float32, MLE start; init_setup and fit, run() less its corner
    plot) against the JAX f64 golden at CPU_FLOORS, its tau floored at
    the golden's. The sampler's small tensors gain nothing from threads,
    so it runs on one."""
    import torch

    g = golden("flagship")
    prob, _ = problems["flagship"]
    fit = make_fit(PORT, "flagship", prob, str(tmp_path), nwalkers=CPU_WALKERS,
                   nruns=CPU_STEPS, checkpoint_every=CPU_STEPS, seed=5, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            chain = fit.fit(fit.init_setup())
    finally:
        torch.set_num_threads(threads)
    assert type(fit.sampler).__name__ == "EnsembleSampler"
    assert chain.shape == (CPU_WALKERS, CPU_STEPS, 4) and chain.dtype == np.float32
    burn = pg.pick_burn(chain, burn_tau=CPU_FLOORS.burn_tau, tau_floor=g["tau"])
    ours = pg.summarize(chain, burn, fit.spec.labels, tau_floor=g["tau"])
    rows = pg.compare(g, ours, floors=CPU_FLOORS)
    assert not pg.failures(rows), pg.format_rows(pg.failures(rows))
