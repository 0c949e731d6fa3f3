#!/usr/bin/env python3
"""On-card smoke test of the torch port (cha1_mcmc_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
last line):
  1. device  — a CUDA device must be present; prints its name and the
     `nvidia-smi` name / power limit;
  2. build   — builds K1 (csrc/fused_step.cu) and K2 (csrc/multi_step.cu)
     with nvcc, one process each, started together;
  3. check   — each kernel against its plain PyTorch version on the card.
     K1 on the synthetic flagship problem (tests/port_problems.py), for
     analytic, Chebyshev and state-sum Q(T), 4- and 5-dim: the f32 lnprob
     entry on 512 thetas (rtol 2e-5), the f64 whole-step kernel over 64
     steps (chain and acceptances bitwise, lnps rtol 1e-12) and the f32
     whole-step kernel over 2048 steps (acceptance within 0.02). K2 on the
     full-size synthetic GOTHAM problem (22 multiplets, 66 lines, ~1,133
     channels) at 128 walkers, K=4 for the three Q kinds and the K=1
     ordered family: the same three checks, the f32 run over 1024 steps;
  4. time    — each kernel and its plain version in us per ensemble step
     (128 walkers, k=16) and per lnprob call of 128 thetas, CUDA events
     after warm-up, in turns (plain, kernel, kernel, plain), median and
     quartiles;
  5. slice   — SpectralFit(...).run() at 128 walkers x 4096 steps through
     FusedEnsembleSampler (K1), then MultiComponentFit(...).run() at 128
     walkers x 4096 steps through FusedEnsembleSampler (K2), each with the
     launch counts of that run, and MultiComponentFit with
     use_fused_step=False (the general gather path) on the card;
then one JSON line of per-kernel results and, last, the device JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CU_SOURCE = "cha1_mcmc_tpu_torch/csrc/fused_step.cu"
STEP_KERNEL_TPU = "cha1_mcmc_tpu/sampler/fused.py:204"
LNPROB_KERNEL_TPU = "cha1_mcmc_tpu/sampler/fused.py:168"
CU_SOURCE_K2 = "cha1_mcmc_tpu_torch/csrc/multi_step.cu"
STEP_KERNEL_TPU_K2 = "cha1_mcmc_tpu/sampler/fused_multi.py:370"
LNPROB_KERNEL_TPU_K2 = "cha1_mcmc_tpu/sampler/fused_multi.py:227"
W, K_STEPS = 128, 16
TIMING_PAIRS = 5
DEVICE = "cuda"
DV_BOUND = 0.3            # MultiFitConfig.dv_bound


def phase(n, name, msg):
    print(f"[phase {n} {name}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cases(problem_dir):
    """(label, model_f32, model_f64, spec, means, stds) per Q kind x dims."""
    import torch
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.catalogs.partition import (_state_sum_model,
                                                        fit_device_cheb)
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.models import SpectralModel
    from cha1_mcmc_tpu_torch.pipeline import FitConfig
    from cha1_mcmc_tpu_torch.reduce import reduce_spectrum

    cat = load_catalog(problem_dir["cat_path"])
    grid = reduce_spectrum(cat, problem_dir["data_path"], ll=18000.0, ul=25000.0,
                           aligned_velocity=4.10, dish_size=70.0,
                           source_size=52.0, verbose=False)
    states = _state_sum_model(cat)
    qs = {"analytic": None, "states": states,
          "cheb": fit_device_cheb(states, 3.5, 12.0)}
    out = []
    for ndim in (4, 5):
        cfg = FitConfig(mol_name="hc5n_hfs",
                        fixed_source_size=52.0 if ndim == 4 else None)
        spec = ParamSpec(ncomp=1, fixed_source_size=cfg.fixed_source_size)
        for qname, q in qs.items():
            models = [SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                                          ll=18000.0, ul=25000.0, dish_size=70.0,
                                          vel_offset=4.10, mask_center=4.10,
                                          q_model=q, device=DEVICE, dtype=dt)
                      for dt in (torch.float32, torch.float64)]
            out.append((f"{qname}-{ndim}d", *models, spec, cfg, grid))
    return out


def in_box_thetas(n, ndim, bounds, gen):
    """Random thetas inside the prior box around the posterior's region:
    log-uniform Ncol in [1e12, 1e13], the rest uniform in the box (vlsr
    within 0.2 km/s of the lines)."""
    import torch

    u = torch.rand((n, ndim), generator=gen, device=DEVICE, dtype=torch.float64)
    cols = []
    if ndim == 5:
        lo, hi = bounds["source_size"]
        cols.append(lo + (hi - lo) * u[:, 0])
    off = ndim - 4
    cols.append(10.0 ** (12.0 + u[:, off]))
    for i, (lo, hi) in enumerate((bounds["Tex"], (3.91, 4.31), bounds["dV"])):
        cols.append(lo + (hi - lo) * u[:, off + 1 + i])
    return torch.stack(cols, dim=1)


def blocks(rnd, nb):
    """Randomness of nb * K_STEPS raw steps in the kernels' block layout:
    (perm (nb, k*W) int32, z_u, pair int32, acc_u (nb, 2k, h))."""
    import torch

    perms, z_u, pair, acc_u = rnd
    return (perms.to(torch.int32).reshape(nb, K_STEPS * W),
            z_u.reshape(nb, 2 * K_STEPS, W // 2),
            pair.to(torch.int32).reshape(nb, 2 * K_STEPS, W // 2),
            acc_u.reshape(nb, 2 * K_STEPS, W // 2))


def run_blocks(step, pos0, lnp0, rnd, nb, tables, st):
    """nb blocks of K_STEPS steps through `step` (a kernel wrapper or its
    plain version): (chain, lnps, acc) per block, concatenated."""
    import torch

    pb, zb, prb, ab = blocks(rnd, nb)
    c, l, out = pos0, lnp0, []
    for b in range(nb):
        cb, lb, acc = step(c, l, pb[b], zb[b], prb[b], ab[b], tables, st)
        c, l = cb[(K_STEPS - 1) * W:], lb[(K_STEPS - 1) * W:]
        out.append((cb, lb, acc))
    return [torch.cat(t) for t in zip(*out)]


def check_kernel(label, fns, t32, t64, th, pos0, yerrs, gen, errs, n_f32_steps):
    """The three checks of a whole-step kernel against its plain version:
    fns = (lnprob, lnprob_plain, step_block, steps_plain) wrappers; t32 /
    t64 = (statics, tables) per dtype; th (N, D) f32 thetas mostly inside
    the prior; pos0 (W, D) f64 start; yerrs the channels' sigmas. Returns
    the f32 acceptance fractions {'kernel': .., 'plain': ..}; records max
    |kernel - plain| in errs."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    lnprob, lnprob_plain, step, step_plain = fns
    (st32, tb32), (st64, tb64) = t32, t64

    # f32 lnprob entry vs plain: the channel reduction order and the exp2
    # implementations differ, so agreement is to f32 rounding of a sum over
    # the channels: rtol 2e-5, with atol 2e-5 x |0.5 sum ln(1/sigma^2)| (the
    # chi^2 sum's scale) for values that cancel to near 0.
    k = lnprob(th, tb32, st32).cpu().numpy()
    p = lnprob_plain(th, tb32, st32).cpu().numpy()
    assert np.array_equal(np.isfinite(k), np.isfinite(p)), label
    assert np.isfinite(p).mean() > 0.9, f"{label}: thetas should be in the prior"
    fin = np.isfinite(p)
    scale = 2e-5 * abs(0.5 * float(np.log(1.0 / np.asarray(yerrs) ** 2).sum()))
    np.testing.assert_allclose(k[fin], p[fin], rtol=2e-5, atol=scale,
                               err_msg=f"{label} f32 lnprob")
    errs["lnprob"] = max(errs.get("lnprob", 0.0), float(np.max(np.abs(k[fin] - p[fin]))))

    # f64 whole-step kernel vs plain, 64 steps in blocks of 16, one stream.
    lnp0 = lnprob_plain(pos0, tb64, st64)
    rnd = draw_randomness(64, W, gen, device=DEVICE, dtype=torch.float64)
    ck, lk, ak = (t.cpu().numpy() for t in run_blocks(step, pos0, lnp0, rnd, 4, tb64, st64))
    cp, lp, ap = (t.cpu().numpy() for t in run_blocks(step_plain, pos0, lnp0, rnd, 4,
                                                      tb64, st64))
    assert np.array_equal(ck, cp), f"{label}: f64 chains differ"
    assert np.array_equal(ak, ap), f"{label}: f64 acceptances differ"
    assert np.array_equal(np.isfinite(lk), np.isfinite(lp))
    np.testing.assert_allclose(lk, lp, rtol=1e-12, err_msg=f"{label} f64 lnps")
    errs["steps"] = max(errs.get("steps", 0.0),
                        float(np.max(np.abs(lk[np.isfinite(lp)] - lp[np.isfinite(lp)]))))

    # f32 whole-step kernel vs plain over n_f32_steps: a marginal acceptance
    # may flip on an ulp, so compare acceptance fractions (within 0.02).
    fracs = {}
    rnd = draw_randomness(n_f32_steps, W, gen, device=DEVICE, dtype=torch.float32)
    pos32 = pos0.to(torch.float32)
    lnp32 = lnprob_plain(pos32, tb32, st32)
    for name, fn in (("kernel", step), ("plain", step_plain)):
        c, _, acc = run_blocks(fn, pos32, lnp32, rnd, n_f32_steps // K_STEPS, tb32, st32)
        fracs[name] = float(acc.sum()) / (n_f32_steps * W)
        assert bool(torch.isfinite(c[-W:]).all()), f"{label}: non-finite f32 {name} walkers"
    assert abs(fracs["kernel"] - fracs["plain"]) < 0.02, (label, fracs)
    return fracs


def check_case(label, m32, m64, spec, cfg, grid, gen, errs):
    """K1's checks on one flagship case (see check_kernel)."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import (fused_lnprob, fused_lnprob_plain,
                                                   fused_step_block,
                                                   fused_steps_plain,
                                                   single_statics_tables)

    ndim = spec.ndim
    t32, t64 = (single_statics_tables(m, spec, grid.ints, grid.yerrs, cfg.bounds,
                                      cfg.template_means, cfg.template_stds)
                for m in (m32, m64))
    th = in_box_thetas(512, ndim, cfg.bounds, gen).to(torch.float32)
    center = np.array(([52.0] if ndim == 5 else []) + [3.24e12, 7.5, 4.11, 0.78])
    rng = np.random.default_rng(0)
    pos0 = torch.as_tensor(center * (1 + 0.01 * rng.standard_normal((W, ndim))),
                           dtype=torch.float64, device=DEVICE)
    fns = (fused_lnprob, fused_lnprob_plain, fused_step_block, fused_steps_plain)
    return check_kernel(label, fns, t32, t64, th, pos0, grid.yerrs, gen, errs, 2048)


def multi_cases(problem_dir):
    """(label, model_f32, model_f64, spec, means, stds, perturbation, grid)
    for K2 on the GOTHAM problem: K=4 with analytic, Chebyshev and
    state-sum Q; the K=1 ordered family with analytic Q."""
    import contextlib
    import io

    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.catalogs import load_catalog
    from cha1_mcmc_tpu_torch.catalogs.partition import (_state_sum_model,
                                                        fit_device_cheb)
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.models import SpectralModel, simulate_sticks_host
    from cha1_mcmc_tpu_torch.pipeline import MultiFitConfig
    from cha1_mcmc_tpu_torch.reduce.datagrid import read_spectrum_gotham

    cfg = MultiFitConfig(mol_name="hc9n_hfs")
    cat = load_catalog(problem_dir["cat_path"], name="hc9n_hfs")
    C, dV, T, ss = cfg.fiducial
    freq_sim, int_sim, _ = simulate_sticks_host(
        cat, C=[C], dV=[dV], T=[T], ll=[cfg.lower_limit], ul=[cfg.upper_limit],
        source_size=ss, dish_size=cfg.dish_size)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = read_spectrum_gotham(np.load(problem_dir["data_path"]), freq_sim,
                                    int_sim)
    states = _state_sum_model(cat)
    k1_family = (np.array([37.0, 2.47e12, 6.7, 5.79, 0.117]),
                 np.array([2.5, 0.30e12, 0.1, 0.0015, 0.002]),
                 np.array([1e-1, 1e10, 1e-3, 1e-3, 1e-3]))
    k4 = tuple(np.asarray(v) for v in (cfg.template_means, cfg.template_stds,
                                       cfg.perturbation))
    out = []
    for label, ncomp, q, prior in (
            ("analytic-4c", 4, None, k4),
            ("cheb-4c", 4, fit_device_cheb(states, 2.7, 60.0), k4),
            ("states-4c", 4, states, k4),
            ("analytic-1c", 1, None, k1_family)):
        models = [SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                                      ll=cfg.lower_limit, ul=cfg.upper_limit,
                                      dish_size=cfg.dish_size, vel_offset=0.0,
                                      mask_center=cfg.source_velocity, q_model=q,
                                      device=DEVICE, dtype=dt)
                  for dt in (torch.float32, torch.float64)]
        out.append((label, *models, ParamSpec(ncomp=ncomp), *prior, grid))
    return out


def multi_thetas(n, ncomp, means, gen):
    """Random thetas inside the ordered-velocity prior around the GOTHAM
    posterior's region: ss uniform in [10, 80], log-uniform Ncol in
    [10^11.5, 10^13], Tex in [4, 10], each vlsr within 0.03 km/s of its
    template mean (the ordering then holds), dV in [0.08, 0.25]."""
    import torch

    u = torch.rand((n, 3 * ncomp + 2), generator=gen, device=DEVICE,
                   dtype=torch.float64)
    cols = [10.0 + 70.0 * u[:, :ncomp], 10.0 ** (11.5 + 1.5 * u[:, ncomp:2 * ncomp]),
            4.0 + 6.0 * u[:, 2 * ncomp:2 * ncomp + 1],
            torch.as_tensor(means[2 * ncomp + 1:3 * ncomp + 1], device=DEVICE)
            + 0.06 * (u[:, 2 * ncomp + 1:3 * ncomp + 1] - 0.5),
            0.08 + 0.17 * u[:, -1:]]
    return torch.cat(cols, dim=1)


def multi_tables(m32, m64, spec, means, stds, grid):
    """(statics, tables) of K2 for the f32 and the f64 model."""
    from cha1_mcmc_tpu_torch.sampler.fused_multi import multi_statics_tables

    return tuple(multi_statics_tables(m, spec, grid.ints, grid.yerrs, means, stds,
                                      dv_max=DV_BOUND) for m in (m32, m64))


def multi_pos0(means, pert, seed=0):
    """The multifit's walker ball at W walkers, f64 on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.as_tensor(means + pert * rng.standard_normal((W, means.size)),
                           dtype=torch.float64, device=DEVICE)


def check_multi_case(label, m32, m64, spec, means, stds, pert, grid, gen, errs):
    """K2's checks on one GOTHAM case (see check_kernel)."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused_multi import (multi_lnprob,
                                                         multi_lnprob_plain,
                                                         multi_step_block,
                                                         multi_steps_plain)

    t32, t64 = multi_tables(m32, m64, spec, means, stds, grid)
    th = multi_thetas(512, spec.ncomp, means, gen).to(torch.float32)
    fns = (multi_lnprob, multi_lnprob_plain, multi_step_block, multi_steps_plain)
    return check_kernel(label, fns, t32, t64, th, multi_pos0(means, pert),
                        grid.yerrs, gen, errs, 1024)


def time_kernel(fns, tables, st, pos0, th, gen, kernel_blocks=64, plain_blocks=4):
    """(kernel us/step, plain us/step, kernel ms/lnprob, plain ms/lnprob)
    lists: whole steps at W walkers, k=K_STEPS, and the lnprob of the
    thetas `th`; CUDA events after a warm-up, in turns plain, kernel,
    kernel, plain, TIMING_PAIRS times. fns as in check_kernel."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    lnprob, lnprob_plain, step, step_plain = fns
    lnp0 = lnprob_plain(pos0, tables, st)

    def run(fn, nblocks):
        rnd = draw_randomness(nblocks * K_STEPS, W, gen, device=DEVICE)
        pb, zb, prb, ab = blocks(rnd, nblocks)
        fn(pos0, lnp0, pb[0], zb[0], prb[0], ab[0], tables, st)   # warm-up
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        c, l = pos0, lnp0
        t0.record()
        for b in range(nblocks):
            cb, lb, _ = fn(c, l, pb[b], zb[b], prb[b], ab[b], tables, st)
            c, l = cb[(K_STEPS - 1) * W:], lb[(K_STEPS - 1) * W:]
        t1.record()
        torch.cuda.synchronize()
        return 1e3 * t0.elapsed_time(t1) / (nblocks * K_STEPS)   # us / step

    def time_lnprob(fn, reps=50):
        fn(th, tables, st)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn(th, tables, st)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps   # ms / call

    plain, kern, lnp_plain, lnp_kern = [], [], [], []
    for _ in range(TIMING_PAIRS):   # in turns: plain, kernel, kernel, plain
        plain.append(run(step_plain, plain_blocks))
        kern.append(run(step, kernel_blocks))
        kern.append(run(step, kernel_blocks))
        plain.append(run(step_plain, plain_blocks))
        lnp_plain.append(time_lnprob(lnprob_plain))
        lnp_kern.append(time_lnprob(lnprob))
        lnp_kern.append(time_lnprob(lnprob))
        lnp_plain.append(time_lnprob(lnprob_plain))
    return kern, plain, lnp_kern, lnp_plain


def time_steps(m32, spec, cfg, grid, gen):
    """K1 and its plain version at 128 walkers, k=16, f32 analytic 4-dim
    (time_kernel)."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import (fused_lnprob, fused_lnprob_plain,
                                                   fused_step_block,
                                                   fused_steps_plain,
                                                   single_statics_tables)

    st, tb = single_statics_tables(m32, spec, grid.ints, grid.yerrs, cfg.bounds,
                                   cfg.template_means, cfg.template_stds)
    rng = np.random.default_rng(1)
    pos0 = torch.as_tensor(np.array([3.24e12, 7.5, 4.11, 0.78])
                           * (1 + 0.01 * rng.standard_normal((W, 4))),
                           dtype=torch.float32, device=DEVICE)
    th = in_box_thetas(W, 4, cfg.bounds, gen).to(torch.float32)
    fns = (fused_lnprob, fused_lnprob_plain, fused_step_block, fused_steps_plain)
    return time_kernel(fns, tb, st, pos0, th, gen)


def time_multi(case, gen):
    """K2 and its plain version at 128 walkers, k=16, f32, K=4 analytic
    (time_kernel); fewer kernel launches per run than K1's, as each K2
    step does several times K1's work."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused_multi import (multi_lnprob,
                                                         multi_lnprob_plain,
                                                         multi_step_block,
                                                         multi_steps_plain)

    label, m32, m64, spec, means, stds, pert, grid = case
    (st, tb), _ = multi_tables(m32, m64, spec, means, stds, grid)
    pos0 = multi_pos0(means, pert, seed=1).to(torch.float32)
    th = multi_thetas(W, spec.ncomp, means, gen).to(torch.float32)
    fns = (multi_lnprob, multi_lnprob_plain, multi_step_block, multi_steps_plain)
    return time_kernel(fns, tb, st, pos0, th, gen, kernel_blocks=16)


def quartiles(xs):
    """(median, 25th, 75th percentile) of a list of timings."""
    import numpy as np

    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return float(med), float(q1), float(q3)


def build_kernels():
    """Build K1 and K2 at once (one nvcc process each) and load them:
    {kernel: (seconds, nvcc log)}."""
    from concurrent.futures import ThreadPoolExecutor
    from cha1_mcmc_tpu_torch.sampler import fused, fused_multi

    def timed(load):
        t0 = time.perf_counter()
        _, log = load()
        return time.perf_counter() - t0, log

    with ThreadPoolExecutor(2) as ex:
        futures = {"K1": ex.submit(timed, fused.load_kernel_library),
                   "K2": ex.submit(timed, fused_multi.load_kernel_library)}
        return {k: f.result() for k, f in futures.items()}


def report_times(kname, times, shape, runs, device):
    """Print the phase-4 lines of one kernel; returns the medians
    (kernel us/step, plain us/step, kernel ms/lnprob, plain ms/lnprob)."""
    kern, plain, lnp_kern, lnp_plain = times
    (k_us, k1, k3), (p_us, p1, p3) = quartiles(kern), quartiles(plain)
    (lk_ms, lk1, lk3), (lp_ms, lp1, lp3) = quartiles(lnp_kern), quartiles(lnp_plain)
    n = len(kern)
    phase(4, "time", f"{kname} whole step, {W} walkers, k={K_STEPS}, f32, {shape}, "
          f"median [q1, q3] of {n} runs: {kname} {k_us:.2f} [{k1:.2f}, {k3:.2f}] "
          f"us/step ({runs}), plain torch {p_us:.2f} [{p1:.2f}, {p3:.2f}] us/step "
          f"(4 blocks a run); {device}")
    phase(4, "time", f"{kname} lnprob of {W} thetas, median [q1, q3] of {n} runs of "
          f"50 calls: {kname} {lk_ms * 1e3:.2f} [{lk1 * 1e3:.2f}, {lk3 * 1e3:.2f}] us, "
          f"plain torch {lp_ms * 1e3:.2f} [{lp1 * 1e3:.2f}, {lp3 * 1e3:.2f}] us; {device}")
    return k_us, p_us, lk_ms, lp_ms


def zero_launches():
    from cha1_mcmc_tpu_torch.sampler import fused, fused_multi

    for counts in (fused.LAUNCHES, fused_multi.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches():
    from cha1_mcmc_tpu_torch.sampler import fused, fused_multi

    return {**fused.LAUNCHES, **fused_multi.LAUNCHES}


def slice_flagship(prob, tmp, device):
    """SpectralFit.run() through K1: returns the launch counts of the run."""
    import numpy as np
    import cha1_mcmc_tpu_torch as port
    from cha1_mcmc_tpu_torch.reduce import load_datagrid
    from tests.port_problems import TRUTH

    zero_launches()
    fit = port.SpectralFit(port.FitConfig(
        mol_name="hc5n_hfs", cat_folder=prob["cat_folder"],
        data_path=prob["data_path"], fit_folder=os.path.join(tmp, "fit"),
        nwalkers=W, nruns=4096, checkpoint_every=1024, seed=0, device="cuda"))
    chain = fit.run()
    launches = read_launches()
    cfg = fit.config
    assert type(fit.sampler) is port.FusedEnsembleSampler, type(fit.sampler)
    assert launches["fused_steps"] > 0 and launches["fused_lnprob"] > 0, launches
    assert chain.shape == (W, 4096, 4), chain.shape
    assert np.isfinite(chain).all()
    acc = fit.sampler.acceptance_fraction
    assert 0.1 < acc < 0.9, acc
    assert os.path.exists(cfg.chain_path)
    assert os.path.exists(cfg.chain_path[:-4] + ".state.npz")
    n_lines = load_datagrid(cfg.datagrid_path).covered_trans.size
    assert n_lines >= 5, n_lines
    rate = fit.throughput.walker_steps_per_sec
    med = np.median(chain[:, chain.shape[1] // 5:, :].reshape(-1, 4), axis=0)
    phase(5, "slice", f"SpectralFit.run(): {type(fit.sampler).__name__}, "
          f"launches {launches}, chain {chain.shape}, acceptance {acc:.3f}, "
          f"{n_lines} lines, {rate:,.0f} walker-steps/s (sampling wall "
          f"time incl. checkpoints; {device})")
    phase(5, "slice", "posterior medians vs injected truth: " + ", ".join(
        f"{lbl} {m:.4g} ({t:.4g})" for lbl, m, t in
        zip(("Ncol", "Tex", "vlsr", "dV"), med, TRUTH)))
    return launches


def slice_gotham(prob, tmp, device, fused_step=True, nruns=4096):
    """MultiComponentFit.run() on the card, through K2 (fused_step) or
    the general gather path: returns the launch counts of the run."""
    import numpy as np
    import cha1_mcmc_tpu_torch as port
    from cha1_mcmc_tpu_torch.reduce import load_datagrid
    from tests.port_problems import GOTHAM_TRUTH

    zero_launches()
    fit = port.MultiComponentFit(port.MultiFitConfig(
        mol_name="hc9n_hfs", template_run=True, cat_folder=prob["cat_folder"],
        data_path=prob["data_path"],
        fit_folder=os.path.join(tmp, "gotham" if fused_step else "gotham_general"),
        nwalkers=W, nruns=nruns, checkpoint_every=1024, seed=0, device="cuda",
        use_fused_step=fused_step))
    chain = fit.run()
    launches = read_launches()
    cfg = fit.config
    kind = port.FusedEnsembleSampler if fused_step else port.EnsembleSampler
    assert type(fit.sampler) is kind, type(fit.sampler)
    if fused_step:
        assert launches["multi_steps"] > 0 and launches["multi_lnprob"] > 0, launches
    else:
        assert not any(launches.values()), launches
    assert chain.shape == (W, nruns, 14), chain.shape
    assert np.isfinite(chain).all()
    acc = fit.sampler.acceptance_fraction
    assert 0.1 < acc < 0.9, acc
    assert os.path.exists(cfg.chain_path)
    assert os.path.exists(cfg.chain_path[:-4] + ".state.npz")
    grid = load_datagrid(cfg.datagrid_path)
    assert grid.covered_trans.size == prob["n_lines"], grid.covered_trans.size
    rate = fit.throughput.walker_steps_per_sec
    phase(5, "slice", f"MultiComponentFit.run() use_fused_step={fused_step}: "
          f"{type(fit.sampler).__name__}, launches {launches}, chain {chain.shape}, "
          f"acceptance {acc:.3f}, {grid.covered_trans.size} lines x "
          f"{grid.freqs.size} channels, {rate:,.0f} walker-steps/s (sampling wall "
          f"time incl. checkpoints; {device})")
    if fused_step:
        med = np.median(chain[:, chain.shape[1] // 5:, :].reshape(-1, 14), axis=0)
        phase(5, "slice", "posterior medians vs injected truth: " + ", ".join(
            f"{lbl.split(' [')[0]} {m:.4g} ({t:.4g})" for lbl, m, t in
            zip(fit.spec.labels, med, GOTHAM_TRUTH)))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tests.port_problems import write_hc5n_problem, write_hc9n_problem

    name = torch.cuda.get_device_name(0)
    card = card_line()
    device = card                       # "<name>, <power limit>"
    phase(1, "device", f"{name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build_kernels()
    phase(2, "build", f"K1 and K2 built and loaded in {time.perf_counter() - t0:.1f} s "
          "(one nvcc each, in parallel)")
    for kname, (secs, log) in built.items():
        print(f"    {kname}: {secs:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"    {kname} ptxas: {ln.strip()}")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    errs, errs2 = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        prob = write_hc5n_problem(os.path.join(tmp, "problem"))
        prob9 = write_hc9n_problem(os.path.join(tmp, "problem9"))
        all_cases = cases(prob)
        for label, m32, m64, spec, cfg, grid in all_cases:
            fracs = check_case(label, m32, m64, spec, cfg, grid, gen, errs)
            phase(3, "check", f"K1 {label}: f32 lnprob ok, f64 64-step chain "
                  f"bitwise, f32 2048-step acceptance kernel "
                  f"{fracs['kernel']:.4f} vs plain {fracs['plain']:.4f}")
        phase(3, "check", f"K1 max |kernel - plain|: f32 lnprob {errs['lnprob']:.3e}, "
              f"f64 step lnps {errs['steps']:.3e} ({device})")
        gotham = multi_cases(prob9)
        for case in gotham:
            fracs = check_multi_case(*case, gen, errs2)
            phase(3, "check", f"K2 {case[0]}: f32 lnprob ok, f64 64-step chain "
                  f"bitwise, f32 1024-step acceptance kernel "
                  f"{fracs['kernel']:.4f} vs plain {fracs['plain']:.4f}")
        phase(3, "check", f"K2 max |kernel - plain|: f32 lnprob {errs2['lnprob']:.3e}, "
              f"f64 step lnps {errs2['steps']:.3e} ({device})")

        label, m32, m64, spec, cfg, grid = all_cases[0]
        t1 = report_times("K1", time_steps(m32, spec, cfg, grid, gen),
                          f"{m32.n_lines} lines x {m32.n_channels} channels",
                          "64 launches a run", device)
        m9 = gotham[0][1]
        t2 = report_times("K2", time_multi(gotham[0], gen),
                          f"K=4, {m9.n_lines} lines x {m9.n_channels} channels",
                          "16 launches a run", device)

        launches = slice_flagship(prob, tmp, device)
        launches.update((k, v) for k, v in slice_gotham(prob9, tmp, device).items()
                        if k.startswith("multi"))
        slice_gotham(prob9, tmp, device, fused_step=False, nruns=512)

    entries = []
    for (k_us, p_us, lk_ms, lp_ms), e, src, (steps_name, steps_tpu), (lnp_name, lnp_tpu) in (
            (t1, errs, CU_SOURCE, ("fused_steps", STEP_KERNEL_TPU),
             ("fused_lnprob", LNPROB_KERNEL_TPU)),
            (t2, errs2, CU_SOURCE_K2, ("multi_steps", STEP_KERNEL_TPU_K2),
             ("multi_lnprob", LNPROB_KERNEL_TPU_K2))):
        entries += [
            {"name": steps_name, "route": "cuda", "source": src, "replaces": steps_tpu,
             "launches": launches[steps_name], "max_abs_err": e["steps"],
             "ms": k_us * K_STEPS / 1e3, "plain_ms": p_us * K_STEPS / 1e3},
            {"name": lnp_name, "route": "cuda", "source": src, "replaces": lnp_tpu,
             "launches": launches[lnp_name], "max_abs_err": e["lnprob"],
             "ms": lk_ms, "plain_ms": lp_ms}]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
