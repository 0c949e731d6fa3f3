#!/usr/bin/env python3
"""On-card smoke test of the torch port (cha1_mcmc_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
last line):
  1. device  — a CUDA device must be present; prints its name and the
     `nvidia-smi` name / power limit;
  2. build   — builds the K1 kernel (csrc/fused_step.cu) with nvcc;
  3. check   — K1 against its plain PyTorch version on the card, on the
     synthetic flagship problem (tests/port_problems.py), for analytic,
     Chebyshev and state-sum Q(T), 4- and 5-dim: the f32 lnprob entry on
     512 thetas (rtol 2e-5), the f64 whole-step kernel over 64 steps
     (chain and acceptances bitwise, lnps rtol 1e-12) and the f32
     whole-step kernel over 2048 steps (acceptance within 0.02);
  4. time    — K1 and the plain version in us per ensemble step (128
     walkers, k=16) and per lnprob call, CUDA events after warm-up, in
     turns (plain, kernel, kernel, plain), median and quartiles;
  5. slice   — SpectralFit(...).run() at 128 walkers x 4096 steps through
     FusedEnsembleSampler, with the K1 launch counts of that run;
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
W, K_STEPS = 128, 16
TIMING_PAIRS = 5
DEVICE = "cuda"


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


def check_case(label, m32, m64, spec, cfg, grid, gen, errs):
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import (fused_lnprob, fused_lnprob_plain,
                                                   fused_step_block,
                                                   fused_steps_plain,
                                                   single_statics_tables)
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    ndim = spec.ndim
    st32, tb32 = single_statics_tables(m32, spec, grid.ints, grid.yerrs, cfg.bounds,
                                       cfg.template_means, cfg.template_stds)
    st64, tb64 = single_statics_tables(m64, spec, grid.ints, grid.yerrs, cfg.bounds,
                                       cfg.template_means, cfg.template_stds)

    # f32 lnprob entry vs plain: the channel reduction order and the exp2
    # implementations differ, so agreement is to f32 rounding of a sum of
    # <= 561 terms: rtol 2e-5, with atol 2e-5 x |0.5 sum ln(1/sigma^2)| (the
    # chi^2 sum's scale) for values that cancel to near 0.
    th = in_box_thetas(512, ndim, cfg.bounds, gen).to(torch.float32)
    k = fused_lnprob(th, tb32, st32)
    p = fused_lnprob_plain(th, tb32, st32)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.array_equal(np.isfinite(k), np.isfinite(p)), label
    assert np.isfinite(p).mean() > 0.9, f"{label}: thetas should be in the box"
    fin = np.isfinite(p)
    scale = 2e-5 * abs(0.5 * float(torch.log(tb32[2][2]).sum()))
    np.testing.assert_allclose(k[fin], p[fin], rtol=2e-5, atol=scale,
                               err_msg=f"{label} f32 lnprob")
    errs["lnprob"] = max(errs.get("lnprob", 0.0), float(np.max(np.abs(k[fin] - p[fin]))))

    # f64 whole-step kernel vs plain, 64 steps in blocks of 16, one stream.
    center = np.array(([52.0] if ndim == 5 else []) + [3.24e12, 7.5, 4.11, 0.78])
    rng = np.random.default_rng(0)
    pos0 = torch.as_tensor(center * (1 + 0.01 * rng.standard_normal((W, ndim))),
                           dtype=torch.float64, device=DEVICE)
    lnp0 = fused_lnprob_plain(pos0, tb64, st64)
    perms, z_u, pair, acc_u = draw_randomness(64, W, gen, device=DEVICE,
                                              dtype=torch.float64)
    perm_b = perms.to(torch.int32).reshape(4, K_STEPS * W)
    pair_b = pair.to(torch.int32).reshape(4, 2 * K_STEPS, W // 2)
    z_b = z_u.reshape(4, 2 * K_STEPS, W // 2)
    a_b = acc_u.reshape(4, 2 * K_STEPS, W // 2)
    outs = {}
    for name, fn in (("kernel", fused_step_block), ("plain", fused_steps_plain)):
        c, l = pos0, lnp0
        chain, lnps, acc = [], [], []
        for b in range(4):
            cb, lb, ab = fn(c, l, perm_b[b], z_b[b], pair_b[b], a_b[b], tb64, st64)
            c, l = cb[(K_STEPS - 1) * W:], lb[(K_STEPS - 1) * W:]
            chain.append(cb)
            lnps.append(lb)
            acc.append(ab)
        outs[name] = [torch.cat(t).cpu().numpy() for t in (chain, lnps, acc)]
    (ck, lk, ak), (cp, lp, ap) = outs["kernel"], outs["plain"]
    assert np.array_equal(ck, cp), f"{label}: f64 chains differ"
    assert np.array_equal(ak, ap), f"{label}: f64 acceptances differ"
    assert np.array_equal(np.isfinite(lk), np.isfinite(lp))
    np.testing.assert_allclose(lk, lp, rtol=1e-12, err_msg=f"{label} f64 lnps")
    errs["steps"] = max(errs.get("steps", 0.0),
                        float(np.max(np.abs(lk[np.isfinite(lp)] - lp[np.isfinite(lp)]))))

    # f32 whole-step kernel vs plain over 2048 steps: a marginal acceptance
    # may flip on an ulp, so compare acceptance fractions (within 0.02).
    fracs = {}
    rnd = draw_randomness(2048, W, gen, device=DEVICE, dtype=torch.float32)
    pos32 = pos0.to(torch.float32)
    lnp32 = fused_lnprob_plain(pos32, tb32, st32)
    for name, fn in (("kernel", fused_step_block), ("plain", fused_steps_plain)):
        c, l, total = pos32, lnp32, 0.0
        nb = 2048 // K_STEPS
        pb = rnd[0].to(torch.int32).reshape(nb, K_STEPS * W)
        zb = rnd[1].reshape(nb, 2 * K_STEPS, W // 2)
        prb = rnd[2].to(torch.int32).reshape(nb, 2 * K_STEPS, W // 2)
        ab = rnd[3].reshape(nb, 2 * K_STEPS, W // 2)
        for b in range(nb):
            cb, lb, acc = fn(c, l, pb[b], zb[b], prb[b], ab[b], tb32, st32)
            c, l = cb[(K_STEPS - 1) * W:], lb[(K_STEPS - 1) * W:]
            total += float(acc.sum())
        fracs[name] = total / (2048 * W)
        assert bool(torch.isfinite(c).all()), f"{label}: non-finite f32 {name} walkers"
    assert abs(fracs["kernel"] - fracs["plain"]) < 0.02, (label, fracs)
    return fracs


def time_steps(m32, spec, cfg, grid, gen):
    """(kernel us/step, plain us/step) at 128 walkers, k=16, f32 analytic
    4-dim, CUDA events after warm-up, in turns plain, kernel, kernel,
    plain; plus one-launch times of both lnprob versions at 128 thetas."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import (fused_lnprob, fused_lnprob_plain,
                                                   fused_step_block,
                                                   fused_steps_plain,
                                                   single_statics_tables)
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    st, tb = single_statics_tables(m32, spec, grid.ints, grid.yerrs, cfg.bounds,
                                   cfg.template_means, cfg.template_stds)
    rng = np.random.default_rng(1)
    pos0 = torch.as_tensor(np.array([3.24e12, 7.5, 4.11, 0.78])
                           * (1 + 0.01 * rng.standard_normal((W, 4))),
                           dtype=torch.float32, device=DEVICE)
    lnp0 = fused_lnprob_plain(pos0, tb, st)

    def run(fn, nblocks):
        perms, z_u, pair, acc_u = draw_randomness(nblocks * K_STEPS, W, gen,
                                                  device=DEVICE)
        pb = perms.to(torch.int32).reshape(nblocks, K_STEPS * W)
        prb = pair.to(torch.int32).reshape(nblocks, 2 * K_STEPS, W // 2)
        zb = z_u.reshape(nblocks, 2 * K_STEPS, W // 2)
        ab = acc_u.reshape(nblocks, 2 * K_STEPS, W // 2)
        fn(pos0, lnp0, pb[0], zb[0], prb[0], ab[0], tb, st)   # warm-up
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        c, l = pos0, lnp0
        t0.record()
        for b in range(nblocks):
            cb, lb, _ = fn(c, l, pb[b], zb[b], prb[b], ab[b], tb, st)
            c, l = cb[(K_STEPS - 1) * W:], lb[(K_STEPS - 1) * W:]
        t1.record()
        torch.cuda.synchronize()
        return 1e3 * t0.elapsed_time(t1) / (nblocks * K_STEPS)   # us / step

    def time_lnprob(fn, reps=50):
        th = in_box_thetas(W, 4, cfg.bounds, gen).to(torch.float32)
        fn(th, tb, st)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn(th, tb, st)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps   # ms / call

    plain, kern, lnp_plain, lnp_kern = [], [], [], []
    for _ in range(TIMING_PAIRS):   # in turns: plain, kernel, kernel, plain
        plain.append(run(fused_steps_plain, 4))
        kern.append(run(fused_step_block, 64))
        kern.append(run(fused_step_block, 64))
        plain.append(run(fused_steps_plain, 4))
        lnp_plain.append(time_lnprob(fused_lnprob_plain))
        lnp_kern.append(time_lnprob(fused_lnprob))
        lnp_kern.append(time_lnprob(fused_lnprob))
        lnp_plain.append(time_lnprob(fused_lnprob_plain))
    return kern, plain, lnp_kern, lnp_plain


def quartiles(xs):
    """(median, 25th, 75th percentile) of a list of timings."""
    import numpy as np

    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return float(med), float(q1), float(q3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import cha1_mcmc_tpu_torch as port
    from cha1_mcmc_tpu_torch.sampler import fused
    from tests.port_problems import TRUTH, write_hc5n_problem

    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase(1, "device", f"{name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _, log = fused.load_kernel_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase(2, "build", f"K1 built and loaded in {build_s:.1f} s")
    for ln in ptxas:
        print(f"    ptxas: {ln}")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        prob = write_hc5n_problem(os.path.join(tmp, "problem"))
        all_cases = cases(prob)
        for label, m32, m64, spec, cfg, grid in all_cases:
            fracs = check_case(label, m32, m64, spec, cfg, grid, gen, errs)
            phase(3, "check", f"{label}: f32 lnprob ok, f64 64-step chain "
                  f"bitwise, f32 2048-step acceptance kernel "
                  f"{fracs['kernel']:.4f} vs plain {fracs['plain']:.4f}")
        phase(3, "check", f"max |kernel - plain|: f32 lnprob {errs['lnprob']:.3e}, "
              f"f64 step lnps {errs['steps']:.3e} ({name}, {card})")

        label, m32, m64, spec, cfg, grid = all_cases[0]
        kern, plain, lnp_kern, lnp_plain = time_steps(m32, spec, cfg, grid, gen)
        (k_us, k1, k3), (p_us, p1, p3) = quartiles(kern), quartiles(plain)
        (lk_ms, lk1, lk3), (lp_ms, lp1, lp3) = quartiles(lnp_kern), quartiles(lnp_plain)
        n = len(kern)
        phase(4, "time", f"whole step, {W} walkers, k={K_STEPS}, f32, {m32.n_lines} "
              f"lines x {m32.n_channels} channels, median [q1, q3] of {n} runs: "
              f"K1 {k_us:.2f} [{k1:.2f}, {k3:.2f}] us/step (64 launches a run), "
              f"plain torch {p_us:.2f} [{p1:.2f}, {p3:.2f}] us/step (4 blocks a run); "
              f"{name}, {card}")
        phase(4, "time", f"lnprob of {W} thetas, median [q1, q3] of {n} runs of 50 "
              f"calls: K1 {lk_ms * 1e3:.2f} [{lk1 * 1e3:.2f}, {lk3 * 1e3:.2f}] us, "
              f"plain torch {lp_ms * 1e3:.2f} [{lp1 * 1e3:.2f}, {lp3 * 1e3:.2f}] us; "
              f"{name}, {card}")

        for key in fused.LAUNCHES:
            fused.LAUNCHES[key] = 0
        fit_dir = os.path.join(tmp, "fit")
        fit = port.SpectralFit(port.FitConfig(
            mol_name="hc5n_hfs", cat_folder=prob["cat_folder"],
            data_path=prob["data_path"], fit_folder=fit_dir, nwalkers=W,
            nruns=4096, checkpoint_every=1024, seed=0, device="cuda"))
        chain = fit.run()
        launches = dict(fused.LAUNCHES)
        cfg = fit.config
        assert type(fit.sampler) is port.FusedEnsembleSampler, type(fit.sampler)
        assert launches["fused_steps"] > 0 and launches["fused_lnprob"] > 0, launches
        assert chain.shape == (W, 4096, 4), chain.shape
        assert np.isfinite(chain).all()
        acc = fit.sampler.acceptance_fraction
        assert 0.1 < acc < 0.9, acc
        assert os.path.exists(cfg.chain_path)
        assert os.path.exists(cfg.chain_path[:-4] + ".state.npz")
        from cha1_mcmc_tpu_torch.reduce import load_datagrid
        n_lines = load_datagrid(cfg.datagrid_path).covered_trans.size
        assert n_lines >= 5, n_lines
        rate = fit.throughput.walker_steps_per_sec
        med = np.median(chain[:, chain.shape[1] // 5:, :].reshape(-1, 4), axis=0)
        phase(5, "slice", f"SpectralFit.run(): {type(fit.sampler).__name__}, "
              f"K1 launches {launches}, chain {chain.shape}, acceptance {acc:.3f}, "
              f"{n_lines} lines, {rate:,.0f} walker-steps/s (sampling wall "
              f"time incl. checkpoints; {name}, {card})")
        phase(5, "slice", "posterior medians vs injected truth: " + ", ".join(
            f"{lbl} {m:.4g} ({t:.4g})" for lbl, m, t in
            zip(("Ncol", "Tex", "vlsr", "dV"), med, TRUTH)))

    print(json.dumps({"kernels": [
        {"name": "fused_steps", "route": "cuda", "source": CU_SOURCE,
         "replaces": STEP_KERNEL_TPU, "launches": launches["fused_steps"],
         "max_abs_err": errs["steps"], "ms": k_us * K_STEPS / 1e3,
         "plain_ms": p_us * K_STEPS / 1e3},
        {"name": "fused_lnprob", "route": "cuda", "source": CU_SOURCE,
         "replaces": LNPROB_KERNEL_TPU, "launches": launches["fused_lnprob"],
         "max_abs_err": errs["lnprob"], "ms": lk_ms, "plain_ms": lp_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
