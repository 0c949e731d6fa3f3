"""The readers of the program's spans on the CPU: a small copy of the
flagship chain cell run with --trace 1 reports the set-up phases'
seconds and 3 host synchronisations a block, and no CUDA-event metric
(the CPU records no device time).

    python -m pytest benchmark/tests -q"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402
from benchmark.tests.small_cells import small  # noqa: E402


def test_span_readers_on_a_small_traced_cell():
    bench, cell, config, traffic = small("hc5n-cha1:chains-64k")
    cell = dict(cell, name="hc5n-chain")     # the cell whose per-layer metrics it reports
    result = harness.run_cell(bench, cell, 2 ** 33 + 5, 1.0, True, device="cpu",
                              config=config, traffic=traffic)
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    for name in ("setup.catalog_s", "setup.model_s", "setup.mle_s"):
        assert metrics[name]["value"] > 0.0 and metrics[name]["unit"] == "s"
    assert metrics["sampler.syncs_per_block"]["value"] == 3.0
    # a reader's None leaves its metric out of the line
    assert "sampler.device_idle_pct" not in metrics
    assert "sampler.block_gap_us" not in metrics
