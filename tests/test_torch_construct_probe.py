"""T3, the construct probe of the torch port
(cha1_mcmc_tpu_torch/utils/construct_probe.py), against the TPU tool it
ports (tools/mosaic_construct_probe.py): the JAX probe, run in Pallas
interpret mode, passes its own checks on this machine; the port's plain
version computes the values those checks expect (float64 NumPy, rtol
1e-4, the tool's tolerance; the band sums A-F exactly as float32 sums in
band order). The CUDA probe is held to the plain version on the card
(chip_smoke.py)."""

import contextlib
import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_jax_probe_passes_in_interpret_mode(monkeypatch):
    import tools.mosaic_construct_probe as tool

    monkeypatch.setattr(tool, "INTERPRET", True)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tool.main()
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[")]
    assert [ln[1] for ln in lines] == list("ABDCEFG")
    assert all(ln.endswith("OK") for ln in lines), lines


def test_plain_probes_match_the_tool_expectations():
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    before = dict(t3.LAUNCHES)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        ok = t3.run_probes("cpu")
    assert ok == dict.fromkeys("ABCDEFG", True)
    assert t3.LAUNCHES == before
    assert len(log.getvalue().splitlines()) == 7


def test_plain_band_sums_are_float32_sums_in_band_order():
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    xa, xc, xf = t3.probe_inputs("cpu", seed=3)
    got = t3.probes(xa, xc, xf)
    a = np.zeros((8, 128), np.float32)
    for i in range(6):
        a = a + xa.numpy()[8 * i:8 * i + 8]
    for k in "ABD":
        np.testing.assert_array_equal(got[k].numpy(), a)
    c = np.zeros((10, 128), np.float32)
    for i in range(6):
        s = np.zeros((10, 128), np.float32)
        for j in range(5):
            s = s + xc.numpy()[56 * i + 10 * j:56 * i + 10 * j + 10]
        c = c + s
    for k in "CE":
        np.testing.assert_array_equal(got[k].numpy(), c)
    np.testing.assert_array_equal(got["F"].numpy(), 2 * xf.numpy())
    assert got["G"].dtype == torch.float32 and (got["G"] >= 0).all()


def test_probe_refuses_other_devices():
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    xs = [t.to("meta") for t in t3.probe_inputs("cpu")]
    with pytest.raises(ValueError, match="T3 runs on CUDA"):
        t3.probes(*xs)
