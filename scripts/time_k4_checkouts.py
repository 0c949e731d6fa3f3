#!/usr/bin/env python3
"""Time the K4 opacity kernels of several checkouts of this repository on
one GPU, in turns, on the same inputs.

    python3 scripts/time_k4_checkouts.py OTHER_CHECKOUT .

Run from the repository root. It writes the inputs once, with this
checkout: the full-size synthetic dense problem of tests/port_problems.py
(chip_smoke.dense_cases: 2,232 lines x 10,924 channels), 128 in-box
walkers in float32 (chip_smoke.opacity_inputs), K4a's block mask and K4b's
compacted tables at the prior's dV bound, and the plain versions' results.
Then, for the checkouts in the order given and again in reverse, a fresh
process with that checkout first on sys.path builds its K4 library (into
its own build/ directory) and times its public wrappers on the inputs:
opacity_pallas_mxu (K4a, masked exp2) and opacity_pallas_csr (K4b,
masked): each call with its host time (CUDA events around 20 calls after
a warm-up, median of 5 runs) and its device time (torch.profiler's CUDA
events of kernels named *opacity_kernel*, over 20 calls), after checking
the result against the plain version (rtol 1e-5, atol 1e-30). Each
process prints one JSON line; the last line is a JSON summary with the
card's name and power limit. The inputs go to build/k4_checkouts/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "build", "k4_checkouts", "inputs.pt")


def write_inputs():
    """The inputs and the plain versions' results, saved with torch."""
    import tempfile

    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok
    from tests.port_problems import write_dense_problem

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    with tempfile.TemporaryDirectory() as tmp:
        case = cs.dense_cases(write_dense_problem(os.path.join(tmp, "dense"),
                                                  scale="full"))[0]
    taus, vlsr, dV, m = cs.opacity_inputs(case, gen, torch.float32)
    mask, (lt, vc, tc) = cs.opacity_tables(m, torch.float32)
    mc, C = m.mask_center, m.n_channels
    want = {"K4a": ok.opacity_block_plain(taus, vlsr, dV, m.vel_grid, mask, mask_center=mc,
                                          form="exp2"),
            "K4b": ok.opacity_csr_plain(taus, vlsr, dV, lt, vc, tc, mask_center=mc,
                                        n_channels=C)}
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({"taus": taus, "vlsr": vlsr, "dV": dV, "vel": m.vel_grid, "mask": mask,
                "lt": lt, "vc": vc, "tc": tc, "mc": mc, "C": C, "want": want}, INPUTS)


def worker(checkout: str):
    """Time one checkout's public K4 wrappers; print one JSON line."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok

    assert os.path.dirname(ok.__file__).startswith(os.path.abspath(checkout)), ok.__file__
    d = torch.load(INPUTS)
    _, log = ok.load_kernel_library()
    args = (d["taus"], d["vlsr"], d["dV"])
    calls = {"K4a": lambda: ok.opacity_pallas_mxu(*args, d["vel"], d["mask"],
                                                  mask_center=d["mc"]),
             "K4b": lambda: ok.opacity_pallas_csr(*args, d["lt"], d["vc"], d["tc"],
                                                  mask_center=d["mc"], n_channels=d["C"])}
    out = {"checkout": checkout}
    for name, fn in calls.items():
        got = fn().cpu().numpy()
        np.testing.assert_allclose(got, d["want"][name].cpu().numpy(), rtol=1e-5,
                                   atol=1e-30, err_msg=f"{checkout} {name}")
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                fn()
            t1.record()
            torch.cuda.synchronize()
            runs.append(1e3 * t0.elapsed_time(t1) / 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        dev = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "opacity_kernel" in e.name]
        assert len(dev) == 20, (name, len(dev))
        out[name] = {"call_us": float(np.median(runs)), "device_us": sum(dev) / 20}
    print(json.dumps(out), flush=True)


def main(checkouts) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_k4_checkouts: no CUDA device", file=sys.stderr)
        return 1
    write_inputs()
    rows = []
    for checkout in list(checkouts) + list(checkouts)[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               checkout], capture_output=True, text=True, cwd=REPO)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    summary = {}
    for row in rows:
        for name in ("K4a", "K4b"):
            s = summary.setdefault(row["checkout"], {}).setdefault(name, {})
            for key, val in row[name].items():
                s.setdefault(key, []).append(val)
    print(json.dumps({"card": card, "runs": summary}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
