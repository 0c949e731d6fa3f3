"""The comparison that decides `correct` is shown to fail: on the CPU, at
a test's size, the lower-precision control (the reference in bfloat16 put
in the program's place on the same steps) and the reference whose
acceptance leaves out the stretch move's (D - 1) ln z term each fail a
limit of the configuration on every seed while the program passes; and a
whole run, the chip's look skipped and the program's sampler broken
underneath, comes out not correct for each fault a cell can have: a step
that returns its state unchanged, half of the walkers left out of their
half-step, an lnprob or a position altered where it is produced, an
acceptance without the (D - 1) ln z term. (One card: there is no
exchange between chips to leave out.)"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.calibrate import calibrate  # noqa: E402
from benchmark.tests.small_cells import run_small, small  # noqa: E402


@pytest.mark.parametrize("cell", ["hc5n-cha1:chains-64k", "dense-rotor:chains-16k",
                                  "hc9n-gotham:chains-64k"])
def test_control_fails_where_the_program_passes(cell):
    bench, cell, config, traffic = small(cell)
    limits = config["limits"]
    lines = calibrate(bench, cell, [1, 2 ** 31 + 3, 77], 0.3, 3, device="cpu",
                      config=config, traffic=traffic)
    for line in lines:
        assert all(v <= limits[k] for k, v in line["program"].items()), line
        for stand_in in ("bfloat16", "no_lnz"):
            assert any(v > limits[k] for k, v in line[stand_in].items()), (stand_in, line)


def _unchanged(real):
    def run(lnprob_fn, pos0, lnp0, generator, nsteps, a=2.0, thin=1, *, randomness=None):
        chain, lnps, acc, _ = real(lnprob_fn, pos0, lnp0, generator, nsteps, a, thin,
                                   randomness=randomness)
        return (pos0.expand_as(chain).clone(), lnp0.expand_as(lnps).clone(),
                torch.zeros_like(acc), (pos0.clone(), lnp0.clone()))
    return run


def _altered(real, what):
    def run(*args, **kwargs):
        chain, lnps, acc, final = real(*args, **kwargs)
        if what == "lnp":
            lnps = lnps * (1.0 + 1e-3)
        else:
            chain = chain.clone()
            chain[:, 0, 2] += 1e-2
        return chain, lnps, acc, final
    return run


def _no_lnz(real):
    def half(lnprob_batch, ndim, *args):
        return real(lnprob_batch, 1, *args)     # (ndim - 1) ln z = 0
    return half


def _half_left_out(real):
    def half(lnprob_batch, ndim, a, coords, lnp, active_idx, comp, z_u, pair, acc_u):
        k = len(active_idx) // 2
        return real(lnprob_batch, ndim, a, coords, lnp, active_idx[:k], comp, z_u[:k],
                    pair[:k], acc_u[:k])
    return half


FAULTS = ["unchanged", "half_left_out", "lnp_altered", "position_altered", "no_lnz"]


CASES = [(cell, fault) for cell in ("hc5n-cha1:chains-64k", "dense-rotor:chains-16k",
                                    "hc9n-gotham:chains-64k")
         for fault in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_sampler_is_not_correct(cell, fault, monkeypatch):
    from cha1_mcmc_tpu_torch.sampler import stretch

    if fault == "no_lnz":
        monkeypatch.setattr(stretch, "half_step", _no_lnz(stretch.half_step))
    elif fault == "half_left_out":
        monkeypatch.setattr(stretch, "half_step", _half_left_out(stretch.half_step))
    elif fault == "unchanged":
        monkeypatch.setattr(stretch, "run_ensemble", _unchanged(stretch.run_ensemble))
    else:
        monkeypatch.setattr(stretch, "run_ensemble",
                            _altered(stretch.run_ensemble, fault.split("_")[0]))
    result = run_small(cell, seconds=0.5)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


def test_the_unbroken_sampler_is_correct():
    result = run_small("hc5n-cha1:chains-64k", seconds=0.5)
    assert result["correct"] is True, result["checks"]
