#!/usr/bin/env python3
"""On-card smoke test of the torch port (cha1_mcmc_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
last line):
  1. device  — a CUDA device must be present; prints its name and the
     `nvidia-smi` name / power limit;
  2. build   — builds K1 and K5a (csrc/fused_step.cu), K2 and K5c
     (csrc/multi_step.cu), K3 and K5b (csrc/gather_step.cu), K4a/K4b
     (csrc/opacity.cu) and T3 (csrc/construct_probe.cu) with nvcc, one
     process per source, started together; prints each build's registers
     and spills, K3's launch geometry at the dense size, K1's entry tables
     at the flagship size (lines in reach, the most and the mean entries a
     channel), and the cluster geometry K1 / K5a (flagship) and K2 / K5c
     (GOTHAM) take on the card (cluster size, proposals per CTA, shared
     bytes, staged tables or not, cudaOccupancyMaxActiveClusters at 16 and
     8 CTAs) with the channel counts up to which K2 stages its tables;
     prints K3 / K5b's launch at channel blocks of 128, 256 and 512
     (tiles a half-step, the grid, the CTAs the card keeps resident, the
     most lines a block references and their shared taus); starts the
     world-1 mesh (make_mesh(1, 1): an NCCL group of one rank), destroyed
     at the end;
  3. check   — each kernel against its plain PyTorch version on the card.
     K1 on the synthetic flagship problem (tests/port_problems.py), for
     analytic, Chebyshev and state-sum Q(T), 4- and 5-dim, at the main
     path's geometry: the f32 lnprob entry on 512 thetas (rtol 2e-5), the
     f64 whole-step kernel over 64 steps (chain and acceptances bitwise,
     lnps rtol 1e-12) and the f32 whole-step kernel over 1024 steps
     (acceptance within 0.02). K2 on the full-size synthetic GOTHAM
     problem (22 multiplets, 66 lines, ~1,133 channels) at 128 walkers,
     K=4 for the three Q kinds and the K=1 ordered family: the same three
     checks, the f32 run over 512 steps. Then the cluster kernels off the
     main path's geometry (f64 64-step chains bitwise vs plain, K5a vs K1
     and K5c vs K2, the lnprob entry vs the in-chain lnps): 8 CTAs and 16
     CTAs with the tables in device memory, K1 / K5a on the flagship's
     analytic 4-dim case and K2 / K5c on the GOTHAM case, and the geometry
     the card takes for K2 on a wide GOTHAM-shaped problem (39
     multiplets, ~2,100 channels) whose f64 tables do not fit shared
     memory.
     K3 on the full-size dense problem (write_dense_problem: ~2,200 lines
     x ~10,900 channels) at 128 walkers, for Chebyshev and state-sum Q on
     the split tables, Chebyshev on the rectangular table and analytic Q
     in 5 dims: the same three checks (the f32 run over 1024 steps), the
     lnprob entry also against the port's plain batched gather lnprob;
     then each case at channel blocks of 128, 256 and 512, each at the
     card's grid, at 37 CTAs and with the taus in device memory: f64
     64-step chains bitwise vs plain, the lnprob entry equal to the
     in-chain lnps, K5b bitwise vs K3 off the card's grid.
     K4a / K4b on the same problem, through their plans: K4a in the exp
     form and the exp2 form masked and unmasked, K4b masked and unmasked,
     against the plain versions (f64 rtol 1e-12, f32 1e-5) at 64, 100,
     128 and 256 in-box walkers, every walker at the prior's dV bound,
     narrow windows (channel tiles with no candidate) and walkers outside
     the prior box; two calls bitwise, and the two geometries (32 and 64
     channels a CTA) bitwise. K5a, K5c
     and K5b (the sharded half-steps) on the flagship, GOTHAM and dense
     cases at world size 1: the f64 64-step chain of the sharded runner
     bitwise against its plain version and against K1 / K2 / K3 on the
     same randomness, the f32 lnprob of a half-step (rtol 2e-5), the f32
     acceptance over 1024 (K5c: 512) steps within 0.02. T3's probes
     against their plain version (A-F bitwise, G rtol 1e-6). K chains in
     one launch (grid (n, K), one cluster a chain): K1 on the flagship's
     analytic 4-dim case and K2 on the GOTHAM K=4 case, 128 walkers a
     chain, 64 steps, at K = 1, 3 and one past the clusters the card holds
     at once: each chain bitwise equal to it launched alone in f32 and
     f64 and to the plain version in f64 (lnps rtol 1e-12), a walker per
     chain kept at lnp = -inf (F4), one launch a block;
  4. time    — K1, K2 and K3 and their plain versions in us per ensemble
     step (128 walkers, k=16) and per lnprob call of 128 thetas; K1 and
     K2 at 16 CTAs, 8 CTAs and 16 CTAs with the tables in device memory;
     K3's lnprob with Q replaced by ones, on thetas outside the prior box
     (the floor: no channel walk) and at channel blocks of 128, 256 and
     512, with their bounds (T2); K3 per step at channel blocks of 128
     (the card's grid, 37 and 132 CTAs, taus in device memory), 256 and
     512; the batched gather lnprob of 128 thetas; K4a / K4b per opacity
     evaluation of 128 walkers in each form and geometry, K4a at the dV
     bound and in f64 at 64 walkers, per call (host time included) and in
     device time (torch.profiler), with their bounds (the least work,
     beside the old count);
     each K5 per half-step call against its plain version, and the
     world-1 sharded runner per ensemble step beside K1 / K2 / K3; T3 per
     launch into a packed output made once and with a fresh output, beside
     the library's empty kernel launched through the same host path (the
     floor), and both in device time (torch.profiler) against T3's bound;
     K1 and K2 at K = 1, 2, 4 and 8 chains of 128 walkers, one
     launch a block against K single-chain launches a block, per ensemble
     step of all K chains, with the bound (K x one chain's). CUDA events
     after warm-up, in turns (plain, kernel, kernel, plain; for the chains
     sequential, one launch, one launch, sequential), median and
     quartiles;
  5. slice   — SpectralFit(...).run() at 128 walkers x 4096 steps through
     FusedEnsembleSampler (K1), MultiComponentFit(...).run() at 128
     walkers x 4096 steps through K2, each followed by the time of its
     checkpoint path (the device-to-host copies, the chain
     concatenations, np.save of the cumulative chain and the .state.npz
     sidecars, repeated on the fit's own arrays) beside the fit's wall
     time less its kernel time, then for K2 a torch.profiler window over
     1024 more steps of its sampler (the device-idle share), and with
     use_fused_step=False (the general gather path), and
     SpectralFit(...).run() on the full-size dense problem (the sparse
     path auto-selected) at 128 walkers x 2048 steps through K3 and, for
     256 steps, with use_fused_step=False;
     make_sharded_sampler(n_devices=1, use_fused=True) with
     ShardedEnsembleSampler.run_mcmc and a chain file in two blocks at 128
     walkers through K5a (flagship), K5c (GOTHAM) and K5b (dense), for
     SHARDED_POSTERIOR's steps, each chain held to its problem's JAX
     golden as phase 8 holds its fits;
     SpectralFit(...).run() (K1) and MultiComponentFit(...).run() (K2)
     with n_chains=4, 512 walkers, FIT_STEPS (K1) or 1024 (K2) steps in 4
     checkpoint blocks, through MultiChainSampler and the kernel's
     chain-batched run_fn (one launch a 16-step block for all 4 chains;
     walker-steps/s, checkpoint split, cross-chain R-hat, per-chain
     acceptance, K1's pooled chain held to the JAX golden as in phase 8),
     each run again with
     one DeviceError injected into block 2 by a run_fn double and
     recovered by the retry, bitwise equal to the unfaulted chain; the
     general sharded runner (make_sharded_sampler(n_devices=1,
     use_pallas=True) in float64, which leaves K5b out) on the dense
     problem for 256 steps through K4a (2 launches a step + 1), with its
     us/step and K4a's share; and T3's run_probes — each with the launch
     counts of that run;
  6. toolkit — the native SPCAT tokenizer built from the port's copy of
     the source (g++), its fields on the full dense catalog (21,481
     lines) bitwise equal to the Python tokenizer's, both timed; the
     command line in subprocesses on the card (`python -m
     cha1_mcmc_tpu_torch`): `fit` on the flagship and `fit
     --all-molecules` over two copies of it (128 walkers x 1,024 steps
     through K1), `multifit` on GOTHAM (128 x 1,024 through K2), each
     chain bitwise equal to the first 1,024 steps of phase 5's in-process
     fit, the same files, the launches its throughput.json reports equal to
     the in-process fit's scaled to its steps, and `diagnose` on the fit's
     chain; `analysis.grid_chi2` over a 16 x 16 x 64 x 64 (1,048,576-point)
     flagship grid around the injected truth, f32 in batches of 65,536
     (points/s; the minimum near the truth in vlsr and dV and inside the
     K1 posterior's box in Ncol and Tex), and a 625-point f64 sub-grid
     equal to the CPU's to 1e-12 relative; `analysis.run_adaptive_metropolis`
     over the flagship (128 chains, 8 x 128 warm-up and 2,400 frozen
     steps) held to phase 5's K1 chain with tests/test_convergence.py's
     tolerances (the spreads as central 68% half-widths; the posterior gate),
     and over the full dense problem
     through the K4a block lnprob (acceptance, one K4a launch a proposal
     batch), each in steps/s;
  7. workbench — the workbench slice, host code as in the JAX package:
     run_repl fed tests/workbench_session.py's command script on the
     flagship (load, mutate, set, store / purge / sum, obs, stack, matched
     filter, baseline, residual, write, upper limits, save, restore), the
     transcript equal to the JAX golden and the saved session's arrays at
     rtol 1e-12 (tests/golden/workbench*, scripts/make_workbench_golden.py);
     the plot commands where matplotlib imports; a gauss-mode session over
     the full dense problem's band at res 0.01 MHz against the golden's
     summaries, with run_sim's host ms; graft_entry.entry() on the card and
     dryrun_multichip(1) in phase 2's world-1 group; no kernel launches;
  8. posterior — the card's posteriors against the JAX package's: K1
     (SpectralFit on the flagship), K2 (MultiComponentFit on GOTHAM) and
     K3 (SpectralFit on the full dense problem), each a dedicated fit at
     128 walkers in float32 for POSTERIOR_FITS' steps in one checkpoint
     block, through FusedEnsembleSampler with its kernel launched; the
     reduced datagrid held to the golden's (its sha256 on the flagship and
     GOTHAM; on the dense problem, whose data differ in the last bits from
     one machine to another, the exactly rounded sums of each array at
     rtol 1e-12) and the port's f64 lnprob at the golden's 16 probe thetas
     equal to the JAX values (rtol 1e-12); the chain, its burn picked in
     its own tau floored at the golden's, summarised and held to the JAX
     package's float64 golden (tests/golden/port_posterior_*.json, written by
     scripts/make_posterior_goldens.py) by tests/posterior_gate.py: mean,
     std, p16, p50 and p84 of every parameter at |z| <= 4.5, standard
     errors from each side's ESS, and the gate's floors (50 tau_max after
     the burn, a burn of 20 tau_max, a combined mean SE of at most 0.05
     sigma) met, else it fails; one line per parameter, then ESS, tau,
     steps and seconds;
  9. bench   — `python -m cha1_mcmc_tpu_torch bench` (bench_torch.py) in a
     subprocess, its CHA1_BENCH_DEADLINE_S what is left of the script's
     1200 s less a margin: every streamed section line and the artifact
     parsed; every section but the baseline ok (the baseline fails without
     the reference tree, with bench.py's message), its kernels launched
     (tpu: K1 and the K3 formulation; gotham: K2; dense: K4b and K3;
     dense_full_fit: K3 through SpectralFit), its error fields null, the
     artifact's value K1's rate on the card the probe names; each section's
     sizes and numbers printed;
then one JSON line of per-kernel results (with, beside the main path's
launches, the command-line fits' K1 / K2 launches, K4a's on the dense
Metropolis run, the posterior phase's K1 / K2 / K3 launches, the largest
|z| against the JAX golden of the fits through K1-K3 and K5a-c, and each
kernel's launches in the bench), the card's name
and power limit, and, last, the device JSON line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

from cha1_mcmc_tpu_torch.utils.device import card_line
from cha1_mcmc_tpu_torch.utils.roofline import (SFU_RATE, bound, in_window, k1_work,
                                               k2_work, k3_work, k4_work, probe_work)

REPO = os.path.dirname(os.path.abspath(__file__))
CU_SOURCE = "cha1_mcmc_tpu_torch/csrc/fused_step.cu"
STEP_KERNEL_TPU = "cha1_mcmc_tpu/sampler/fused.py:204"
LNPROB_KERNEL_TPU = "cha1_mcmc_tpu/sampler/fused.py:168"
CU_SOURCE_K2 = "cha1_mcmc_tpu_torch/csrc/multi_step.cu"
STEP_KERNEL_TPU_K2 = "cha1_mcmc_tpu/sampler/fused_multi.py:370"
LNPROB_KERNEL_TPU_K2 = "cha1_mcmc_tpu/sampler/fused_multi.py:227"
CU_SOURCE_K3 = "cha1_mcmc_tpu_torch/csrc/gather_step.cu"
STEP_KERNEL_TPU_K3 = "cha1_mcmc_tpu/sampler/fused_gather.py:706"
LNPROB_KERNEL_TPU_K3 = "cha1_mcmc_tpu/sampler/fused_gather.py:539"
CU_SOURCE_K4 = "cha1_mcmc_tpu_torch/csrc/opacity.cu"
BLOCK_KERNEL_TPU = "cha1_mcmc_tpu/models/pallas_kernels.py:136"
CSR_KERNEL_TPU = "cha1_mcmc_tpu/models/pallas_kernels.py:344"
CU_SOURCE_T3 = "cha1_mcmc_tpu_torch/csrc/construct_probe.cu"
PROBE_TPU = "tools/mosaic_construct_probe.py:52"
K5_SOURCE = {"sharded_half": CU_SOURCE, "sharded_multi_half": CU_SOURCE_K2,
             "sharded_gather_half": CU_SOURCE_K3}
K5_TPU = {"sharded_half": "cha1_mcmc_tpu/parallel/sharded_fused.py:137",
          "sharded_gather_half": "cha1_mcmc_tpu/parallel/sharded_fused.py:147",
          "sharded_multi_half": "cha1_mcmc_tpu/parallel/sharded_fused.py:320"}
W, K_STEPS = 128, 16
TIMING_PAIRS = 5
DEVICE = "cuda"
DV_BOUND = 0.3            # MultiFitConfig.dv_bound
DENSE_DV_MAX = 1.5        # the dense prior's dV upper bound
#: A GOTHAM-shaped problem whose f64 K2 / K5c tables do not fit a CTA's
#: shared memory (~2,100 channels; the most multiplets the synthetic
#: catalog lets pass the reduction is 39).
WIDE_MULTIPLETS = 39


#: The time each phase first printed (phase_seconds reads it).
_PHASE_START = {}


def phase(n, name, msg):
    _PHASE_START.setdefault(n, time.perf_counter())
    print(f"[phase {n} {name}] {msg}", flush=True)


def phase_seconds(end):
    """{phase: seconds from its first line to the next phase's first line
    (the last phase's: to `end`)}."""
    starts = sorted(_PHASE_START.items())
    return {n: round((starts[i + 1][1] if i + 1 < len(starts) else end) - t, 1)
            for i, (n, t) in enumerate(starts)}


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


def step_blocks(step, pos0, lnp0, rb, tables, st):
    """Yield (chain, lnps, acc) of each block of K_STEPS steps through
    `step` (a step kernel's wrapper or its plain version) from the walkers
    pos0 (W, D), or (K, W, D) for K chains, on the randomness `rb` in the
    kernels' block layout (fused.block_randomness)."""
    w = pos0.shape[-2]
    c, l = pos0.contiguous(), lnp0.contiguous()
    for b in range(rb[0].shape[0]):
        cb, lb, acc = step(c, l, *(t[b] for t in rb), tables, st)
        c = cb[..., (K_STEPS - 1) * w:, :].contiguous()
        l = lb[..., (K_STEPS - 1) * w:].contiguous()
        yield cb, lb, acc


def run_blocks(step, pos0, lnp0, rnd, tables, st):
    """The blocks of K_STEPS steps of `rnd` (run_ensemble's layout, with a
    leading chain axis for K chains) through `step` from pos0 (W, D) or
    (K, W, D) (step_blocks): chain, lnps and acc of the blocks,
    concatenated on the step axis."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness

    chain, lnps, acc = zip(*step_blocks(step, pos0, lnp0, block_randomness(rnd, K_STEPS),
                                        tables, st))
    return torch.cat(chain, dim=-2), torch.cat(lnps, dim=-1), torch.cat(acc, dim=-1)


def event_ms(fn, warm=None, lead=None):
    """ms of one fn() call by CUDA events, after a warm() call where one is
    given; `lead` is queued on the card just before the first event."""
    import torch

    if warm is not None:
        warm()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead is not None:
        lead()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def block_us(step, pos0, lnp0, rb, tables, st, queued=False):
    """us per step of the blocks `rb` through `step` from pos0 (W, D) or
    (K, W, D) (step_blocks), by CUDA events after a warm-up block. With
    `queued`, the card first sleeps for ~20 ms, long enough for the host to
    queue every launch: the events then time the card alone, not the
    host's launch path where a launch takes less than its enqueue."""
    import torch

    def run():
        for _ in step_blocks(step, pos0, lnp0, rb, tables, st):
            pass

    def warm():
        step(pos0, lnp0, *(t[0] for t in rb), tables, st)

    nb = rb[0].shape[0]
    lead = (lambda: torch.cuda._sleep(40_000_000)) if queued else None
    return 1e3 * event_ms(run, warm, lead) / (nb * K_STEPS)


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
    ck, lk, ak = (t.cpu().numpy() for t in run_blocks(step, pos0, lnp0, rnd, tb64, st64))
    cp, lp, ap = (t.cpu().numpy() for t in run_blocks(step_plain, pos0, lnp0, rnd,
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
        c, _, acc = run_blocks(fn, pos32, lnp32, rnd, tb32, st32)
        fracs[name] = float(acc.sum()) / (n_f32_steps * W)
        assert bool(torch.isfinite(c[-W:]).all()), f"{label}: non-finite f32 {name} walkers"
    assert abs(fracs["kernel"] - fracs["plain"]) < 0.02, (label, fracs)
    return fracs


def check_case(label, m32, m64, spec, cfg, grid, gen, errs):
    """K1's checks on one flagship case (see check_kernel), at the main
    path's geometry."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import (fused_lnprob, fused_lnprob_plain,
                                                   fused_step_block, fused_steps_plain)

    t32, t64 = flagship_tables((label, m32, m64, spec, cfg, grid))
    th = in_box_thetas(512, spec.ndim, cfg.bounds, gen).to(torch.float32)
    fns = (fused_lnprob, fused_lnprob_plain, fused_step_block, fused_steps_plain)
    return check_kernel(label, fns, t32, t64, th, flagship_pos0(spec.ndim), grid.yerrs, gen,
                        errs, 1024)


def multi_cases(problem_dir, labels=("analytic-4c", "cheb-4c", "states-4c", "analytic-1c")):
    """(label, model_f32, model_f64, spec, means, stds, perturbation, grid)
    for K2 on the GOTHAM problem, for each of `labels`: K=4 with analytic,
    Chebyshev and state-sum Q; the K=1 ordered family with analytic Q."""
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
            ("analytic-4c", 4, lambda: None, k4),
            ("cheb-4c", 4, lambda: fit_device_cheb(states, 2.7, 60.0), k4),
            ("states-4c", 4, lambda: states, k4),
            ("analytic-1c", 1, lambda: None, k1_family)):
        if label not in labels:
            continue
        q = q()
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
                        grid.yerrs, gen, errs, 512)


def cluster_family(kind):
    """What the cluster checks and timings drive for a cluster step kernel
    and its sharded half-step: "K1" (with K5a, sampler/fused.py) or "K2"
    (with K5c, sampler/fused_multi.py). `family` is its declaration of the
    cluster binding (sampler/cluster.py), `sizes(tb)` (La, M, C) of its
    tables, `plan(tb, st, nwalkers, cluster, stage,
    resident)` a plan of the binding's planners (cluster="wide": the wide
    step path), `lnprob(theta, tb, st, plan)` its lnprob entry (K1's with
    the plan's staging)."""
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf
    from cha1_mcmc_tpu_torch.sampler import cluster, fused, fused_multi as fm

    if kind == "K1":
        family, out = fused.FAMILY, dict(
            lnprob_plain=fused.fused_lnprob_plain,
            steps_plain=fused.fused_steps_plain, step=fused.fused_step_block,
            half_fn=sf.sharded_half, half_plain=sf.sharded_half_plain,
            lnprob=lambda th, tb, st, p: fused.fused_lnprob(th, tb, st, plan=p))

        def sizes(tb):
            return (tb[2].shape[1], *tb[3].shape)
    else:
        family, out = fm.FAMILY, dict(
            lnprob_plain=fm.multi_lnprob_plain, steps_plain=fm.multi_steps_plain,
            step=fm.multi_step_block, half_fn=sf.sharded_multi_half,
            half_plain=sf.sharded_multi_half_plain,
            lnprob=lambda th, tb, st, p: fm.multi_lnprob(th, tb, st))

        def sizes(tb):
            return (tb[0].shape[1], *tb[1].shape)

    def plan(tb, st, nwalkers, n, stage, resident):
        La, M, C = sizes(tb)
        args = (family, nwalkers, st.ncomp, st.ndim, La, C, M, tb[0].dtype)
        if n == "wide":   # the wide path: a step launch only
            return cluster.plan_wide(*args, stage=stage)
        return cluster.plan_cluster(*args, cluster=n, resident_state=resident, stage=stage)

    return dict(out, family=family, half=family.half, steps_key=family.counters[0],
                half_key=family.counters[2], sizes=sizes, plan=plan)


def cluster_plans(kind, tb, st, nwalkers, cluster, stage):
    """The step kernel's and the half-step's plans of `kind` (K1 / K2) for
    `nwalkers` walkers on the tables `tb` at `cluster` CTAs, tables staged
    (True), read from device memory (False) or as they fit (None); (None,
    None) for cluster=None: the card's choice. cluster="wide": the wide
    step path beside the half-step's own choice (K5a and K5c have no wide
    path)."""
    if cluster is None:
        return None, None
    fam = cluster_family(kind)
    if cluster == "wide":
        return fam["plan"](tb, st, nwalkers, cluster, stage, True), None
    return tuple(fam["plan"](tb, st, nwalkers, cluster, stage, r) for r in (True, False))


def check_cluster_chains(kind, label, tb, st, pos0, seed, geometries, errs):
    """A cluster step kernel (K1 or K2, `kind`) and its sharded half-step
    (K5a / K5c) at each of `geometries` ((name, step plan, half plan),
    None: cluster_plan's) on f64 tables, from the walkers pos0 over 64
    steps: the step kernel's chain and acceptances bitwise against the
    plain version's (lnps rtol 1e-12), its lnprob entry (K1's at the
    plan's staging) equal to the in-chain lnps of every walker that moved,
    and the half-step's chain at world size 1 bitwise against its plain
    version and against the step kernel. One plain run of each serves
    every geometry."""
    import functools

    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    fam = cluster_family(kind)
    counts = fam["family"].launches
    nw, D = pos0.shape
    lnp0 = fam["lnprob_plain"](pos0, tb, st)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rnd = draw_randomness(64, nw, gen, device=DEVICE, dtype=torch.float64)
    cp, lp, ap = (t.cpu().numpy() for t in
                  run_blocks(fam["steps_plain"], pos0, lnp0, rnd, tb, st))
    c5p, l5p, a5p, _ = run_k5(fam["half_plain"], (tb, st), pos0, lnp0, rnd)
    c5p, l5p, a5p = (t.cpu().numpy() for t in (c5p, l5p, a5p))
    fin = np.isfinite(lp)
    assert 0 < ap.sum() < 64 * nw, f"{label}: the chain should accept some proposals"
    for name, step_plan, half_plan in geometries:
        where = f"{kind} {label}, {name}"
        before = counts[fam["steps_key"]]
        step = functools.partial(fam["step"], plan=step_plan)
        ck, lk, ak = (t.cpu().numpy() for t in run_blocks(step, pos0, lnp0, rnd, tb, st))
        assert counts[fam["steps_key"]] == before + 4, where
        assert np.array_equal(ck, cp), f"{where}: f64 chains differ"
        assert np.array_equal(ak, ap), f"{where}: f64 acceptances differ"
        assert np.array_equal(np.isfinite(lk), fin), where
        np.testing.assert_allclose(lk[fin], lp[fin], rtol=1e-12, err_msg=f"{where} f64 lnps")
        key = f"{kind} {name}"
        errs[key] = max(errs.get(key, 0.0), float(np.max(np.abs(lk[fin] - lp[fin]))))
        moved = (ck[-nw:] != pos0.cpu().numpy()).any(axis=1)
        assert moved.any(), where
        entry = fam["lnprob"](torch.as_tensor(ck[-nw:], device=DEVICE), tb, st, step_plan)
        assert np.array_equal(entry.cpu().numpy()[moved], lk[-nw:][moved]), \
            f"{where}: the lnprob entry differs from the in-chain lnps"
        where = f"{fam['half']} {label}, {name}"
        before = sf.LAUNCHES[fam["half_key"]]
        half = functools.partial(fam["half_fn"], plan=half_plan)
        c5, l5, a5, _ = run_k5(half, (tb, st), pos0, lnp0, rnd)
        assert sf.LAUNCHES[fam["half_key"]] == before + 128, where
        c5, l5, a5 = (t.cpu().numpy() for t in (c5, l5, a5))
        assert np.array_equal(c5, c5p) and np.array_equal(a5, a5p), \
            f"{where}: f64 chains differ from the plain version's"
        f5 = np.isfinite(l5p)
        assert np.array_equal(np.isfinite(l5), f5), where
        np.testing.assert_allclose(l5[f5], l5p[f5], rtol=1e-12, err_msg=f"{where} f64 lnps")
        assert np.array_equal(c5.reshape(-1, D), ck) and np.array_equal(a5, ak), \
            f"{where}: f64 chains differ from {kind}'s at world size 1"
        assert np.array_equal(l5.reshape(-1), lk), f"{where}: lnps differ from {kind}'s"


def check_f32_paths(kind, case, errs, nwalkers=W, seed=7):
    """Phase 3: a cluster step kernel's float32 paths against each other
    (`kind` K1 on a flagship case, K2 on a GOTHAM case), 64 steps from the
    walker ball: the wide path (one group of 16 warps, a lnprob lane a
    thread), the 16- and 8-CTA clusters and the sharded half-step (K5a /
    K5c) at world size 1 (groups of four warps, four lanes a thread),
    chains, lnps and acceptances bitwise, and the lnprob entry equal to
    the in-chain lnps of every walker that moved: one float32 lnprob
    whatever runs it. Returns the runs compared."""
    import functools

    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    fam = cluster_family(kind)
    label = case[0]
    if kind == "K1":
        (st, tb), _ = flagship_tables(case)
        pos0 = flagship_pos0(case[3].ndim, nwalkers=nwalkers, seed=seed, dtype=torch.float32)
    else:
        (st, tb), _ = multi_tables(*case[1:6], case[7])
        pos0 = multi_pos0(case[4], case[6], seed=seed)[:nwalkers].to(torch.float32)
    lnp0 = fam["lnprob"](pos0, tb, st, None)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    rnd = draw_randomness(64, nwalkers, gen, device=DEVICE, dtype=torch.float32)
    runs = {}
    for name, n in (("wide", "wide"), ("16 CTAs", 16), ("8 CTAs", 8)):
        plan = cluster_plans(kind, tb, st, nwalkers, n, None)[0]
        runs[name] = [t.cpu().numpy() for t in run_blocks(
            functools.partial(fam["step"], plan=plan), pos0, lnp0, rnd, tb, st)]
    c5, l5, a5, _ = run_k5(fam["half_fn"], (tb, st), pos0, lnp0, rnd)
    runs[fam["half"]] = [c5.reshape(-1, pos0.shape[1]).cpu().numpy(),
                         l5.reshape(-1).cpu().numpy(), a5.cpu().numpy()]
    cw, lw, aw = runs["wide"]
    where = f"{kind} {label} f32"
    assert 0 < aw.sum() < 64 * nwalkers, f"{where}: no proposal or every one accepted"
    for name, (c, l, a) in runs.items():
        assert np.array_equal(c, cw) and np.array_equal(a, aw), f"{where} {name}"
        assert np.array_equal(l, lw), f"{where} {name}: lnps differ from the wide path's"
    moved = (cw[-nwalkers:] != pos0.cpu().numpy()).any(axis=1)
    entry = fam["lnprob"](torch.as_tensor(cw[-nwalkers:], device=DEVICE), tb, st, None)
    assert np.array_equal(entry.cpu().numpy()[moved], lw[-nwalkers:][moved]), \
        f"{where}: the lnprob entry differs from the in-chain lnps"
    errs[f"{kind} f32 paths"] = float(moved.mean())
    return list(runs)


def flagship_pos0(ndim, nwalkers=W, seed=0, dtype=None):
    """The flagship's walker ball: 1% around the injected truth (source
    size 52 in 5 dims), f64 (or `dtype`) on the card."""
    import numpy as np
    import torch

    center = np.array(([52.0] if ndim == 5 else []) + [3.24e12, 7.5, 4.11, 0.78])
    rng = np.random.default_rng(seed)
    return torch.as_tensor(center * (1 + 0.01 * rng.standard_normal((nwalkers, ndim))),
                           dtype=dtype or torch.float64, device=DEVICE)


def flagship_tables(case):
    """((st32, tb32), (st64, tb64)) of K1 for one flagship case."""
    from cha1_mcmc_tpu_torch.sampler.fused import single_statics_tables

    label, m32, m64, spec, cfg, grid = case
    return tuple(single_statics_tables(m, spec, grid.ints, grid.yerrs, cfg.bounds,
                                       cfg.template_means, cfg.template_stds)
                 for m in (m32, m64))


def check_geometries(flagship_case, gotham_case, wide_case, errs):
    """Phase 3: the cluster kernels off the main path's geometry, f64
    64-step chains at W walkers (check_cluster_chains). K1 and K5a on the
    flagship case, K2 and K5c on the GOTHAM case: 16 CTAs staged (the
    cluster path, off the main path where one chain takes the wide one),
    8 CTAs (the size taken where a card places no cluster of 16), 16 CTAs
    with the tables read from device memory, and the wide path with the
    tables in device memory. On the wide GOTHAM-shaped problem
    (WIDE_MULTIPLETS multiplets), whose f64 tables do not fit a cluster
    CTA: the card's own choice for K2 (the wide path, whose CTA holds no
    state and stages them) and K5c (which must read them from device
    memory), the lnprob entry (device memory too) and the wide path
    unstaged."""
    import torch
    from cha1_mcmc_tpu_torch.sampler import cluster, fused_multi as fm

    off_main = (("8 CTAs, staged", 8, True), ("16 CTAs, unstaged", 16, False))
    wide_unstaged = ("wide, unstaged", "wide", False)
    cluster_off_main = (("16 CTAs, staged", 16, True),) + off_main + (wide_unstaged,)
    label = flagship_case[0]
    _, (st, tb) = flagship_tables(flagship_case)
    plans = [(name, *cluster_plans("K1", tb, st, W, n, stage))
             for name, n, stage in cluster_off_main]
    check_cluster_chains("K1", label, tb, st, flagship_pos0(len(st.bounds_lo)), 5, plans, errs)
    La, M, C = cluster_family("K1")["sizes"](tb)
    phase(3, "check", f"K1 and K5a {label} ({La} lines x {C} channels x {M} entries, f64, "
          f"{W} walkers) at " + ", ".join(n for n, _, _ in plans) + ": 64-step chains "
          "bitwise vs plain and K5a vs K1, lnprob entry = in-chain lnps")
    for case, geometries in ((gotham_case, cluster_off_main),
                             (wide_case, (("the card's choice", None, None), wide_unstaged))):
        label, m32, m64, spec, means, stds, pert, grid = case
        _, (st, tb) = multi_tables(m32, m64, spec, means, stds, grid)
        (M, C), La = tb[1].shape, tb[0].shape[1]
        if case is wide_case:
            staged = [cluster.cluster_plan(fm.FAMILY, e, W, st.ncomp, st.ndim, La, C, M,
                                           torch.float64, tb[0].device)[0].staged
                      for e in ("steps", "half")]
            staged.append(cluster.smem_layout(fm.FAMILY, torch.float64, st.ncomp, La, C,
                                              M).staged)
            assert not any(staged), f"{label}: {C} f64 channels should not be staged"
        plans = [(name, *cluster_plans("K2", tb, st, W, n, stage))
                 for name, n, stage in geometries]
        check_cluster_chains("K2", label, tb, st, multi_pos0(means, pert), 5, plans, errs)
        phase(3, "check", f"K2 and K5c {label} ({La} lines x {C} channels x {M} entries, f64, "
              f"{W} walkers) at " + ", ".join(n for n, _, _ in plans) + ": 64-step chains "
              "bitwise vs plain and K5c vs K2, lnprob entry = in-chain lnps")


def staging_limits(tb, ncomp):
    """The largest channel count whose tables K2 (and K5c) stage at W
    walkers and 8 CTAs, per dtype, with the active lines and the entries
    a channel in the proportion of the tables `tb`; and the most active
    lines K2's unstaged layout holds (it has no channel limit)."""
    import torch
    from cha1_mcmc_tpu_torch.sampler import cluster
    from cha1_mcmc_tpu_torch.sampler.fused_multi import FAMILY

    (M, C0), La0 = tb[1].shape, tb[0].shape[1]
    out = {}
    for dt in (torch.float32, torch.float64):
        def fits(C, La, stage):
            return cluster.plan_cluster(FAMILY, W, ncomp, 3 * ncomp + 2, La, C, M, dt,
                                        cluster=8, stage=stage).fits

        lo, hi = 1, 1 << 20            # largest C with a staged plan that fits
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if fits(mid, max(1, mid * La0 // C0), True) else (lo, mid)
        la_lo, la_hi = 1, 1 << 20      # most lines of an unstaged plan
        while la_lo + 1 < la_hi:
            mid = (la_lo + la_hi) // 2
            la_lo, la_hi = (mid, la_hi) if fits(1 << 30, mid, False) else (la_lo, mid)
        out[str(dt).split(".")[-1]] = (lo, la_lo)
    return out


#: The geometries phase 4 times a cluster step kernel at: (name, CTAs,
#: staged): its wide path, then its cluster path.
TIMED_GEOMETRIES = (("wide", "wide", None), ("16 CTAs, staged", 16, True),
                    ("8 CTAs, staged", 8, True), ("16 CTAs, unstaged", 16, False))


def time_geometries(kind, label, tb, st, pos0, gen, device, nb=16,
                    geometries=TIMED_GEOMETRIES, rb=None, where="", queued=False):
    """Phase 4: a cluster step kernel (`kind`, K1 or K2) in f32 from the
    walkers pos0 at each of `geometries` (the wide path, the main path of
    one chain of 128 walkers; 16 CTAs; 8 CTAs; 16 CTAs with the tables
    read from device memory), in turns over `nb` launches of 16 steps of the block
    randomness `rb` (drawn where None), by block_us (`queued`: the card's
    time alone): (name, median, q1, q3 us/step) per geometry."""
    import functools

    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    fam = cluster_family(kind)
    lnp0 = fam["lnprob_plain"](pos0, tb, st)
    w = pos0.shape[0]
    steps = {name: functools.partial(fam["step"], plan=cluster_plans(
        kind, tb, st, w, n, stage)[0]) for name, n, stage in geometries}
    if rb is None:
        rb = block_randomness(draw_randomness(nb * K_STEPS, w, gen, device=DEVICE), K_STEPS)
    nb = rb[0].shape[0]
    times = {name: [] for name in steps}
    order = list(steps)
    for _ in range(TIMING_PAIRS):   # in turns, forwards then backwards
        for name in order + order[::-1]:
            times[name].append(block_us(steps[name], pos0, lnp0, rb, tb, st, queued))
    out = [(name, *quartiles(ts)) for name, ts in times.items()]
    phase(4, "time", f"{kind} {label} by geometry{where}, {w} walkers, f32, median [q1, q3] "
          f"of {2 * TIMING_PAIRS} runs of {nb} launches: " + "; ".join(
              f"{n} {m:.2f} [{a:.2f}, {b:.2f}] us/step" for n, m, a, b in out) + f"; {device}")
    return out


#: The steps of a `hc9n-chain` chain: the state K2's paths are timed from
#: besides the walker ball.
CELL_STEPS = 65_536


def k2_cell_state(tb, st, pos0, gen, nsteps=CELL_STEPS, block=512):
    """The walkers after `nsteps` f32 steps of K2's main path from pos0 (a
    chain of the benchmark cell's length), in blocks of `block` steps of
    which only the state is kept."""
    import torch
    from cha1_mcmc_tpu_torch.sampler import MultiFusedEnsemble

    run = MultiFusedEnsemble(tb, st)
    pos, lnp = pos0, run.lnprob(pos0)
    for _ in range(nsteps // block):
        _, _, _, (pos, lnp) = run(pos, lnp, block, K_STEPS, generator=gen)
    torch.cuda.synchronize()
    return pos


def k2_refusal_share(tb, st, pos0, rb, nb=2):
    """The share of the proposals of the first `nb` launches of the block
    randomness `rb` from pos0 that the ordered-velocity prior refuses
    before the likelihood runs: the plain version's steps in f32 on the
    host, each proposal batch counted by multi_prior_plain."""
    from cha1_mcmc_tpu_torch.sampler.fused import steps_plain
    from cha1_mcmc_tpu_torch.sampler.fused_multi import multi_lnprob_plain, multi_prior_plain

    tables = tuple(t.cpu() for t in tb)
    counts = [0, 0]

    def counted(theta):
        ok, _ = multi_prior_plain(theta, st)
        counts[0] += int((~ok).sum())
        counts[1] += theta.shape[0]
        return multi_lnprob_plain(theta, tables, st)

    pos = pos0.cpu()
    lnp = multi_lnprob_plain(pos, tables, st)
    w = pos.shape[0]
    for b in range(nb):
        chain, lnps, _ = steps_plain(counted, st.a, pos, lnp, *(t[b].cpu() for t in rb))
        pos, lnp = chain[-w:].contiguous(), lnps[-w:].contiguous()
    return counts[0] / counts[1]


def time_k2_paths(case, gen, device, nb=16):
    """Phase 4: K2 on a GOTHAM case in f32 at W walkers, each path and
    cluster geometry (wide; 16 and 8 CTAs staged; 16 CTAs unstaged) timed in
    turns (time_geometries) from the walker ball, from the state after a
    chain of the cell's length (CELL_STEPS steps) and from walkers all
    outside the prior box (dV near 1 against the 0.3 bound: every proposal
    refused before its likelihood, so a step is the grid barriers or
    cluster syncs, the row loads and the acceptance alone: the floor); the
    prior's refusal share of each start's first two launches on the host.
    Returns {start: (refusal share, [(name, median, q1, q3 us/step)])}."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    label, m32, m64, spec, means, stds, pert, grid = case
    (st, tb), _ = multi_tables(m32, m64, spec, means, stds, grid)
    ball = multi_pos0(means, pert, seed=1).to(torch.float32)
    t0 = time.perf_counter()
    cell = k2_cell_state(tb, st, ball, gen)
    chain_s = time.perf_counter() - t0
    floor = ball.clone()
    floor[:, -1] = 1.0 + 0.1 * torch.rand(W, generator=gen, device=DEVICE)
    out = {}
    for name, pos0, geometries in (
            ("the walker ball", ball, TIMED_GEOMETRIES),
            (f"a {CELL_STEPS}-step chain's state", cell, TIMED_GEOMETRIES),
            ("walkers outside the prior box (the floor)", floor,
             (TIMED_GEOMETRIES[0], TIMED_GEOMETRIES[1]))):
        rb = block_randomness(draw_randomness(nb * K_STEPS, W, gen, device=DEVICE), K_STEPS)
        refused = k2_refusal_share(tb, st, pos0, rb)
        times = time_geometries("K2", label, tb, st, pos0, gen, device, geometries=geometries,
                                rb=rb, queued=True, where=f" from {name} (prior refuses "
                                f"{refused:.4f} of the proposals; the card's time alone)")
        out[name] = (refused, times)
    phase(4, "time", f"K2 {label}: the {CELL_STEPS}-step chain to the second start took "
          f"{chain_s:.2f} s on the main path ({steps_path("K2", tb, st, W, 1)}); {device}")
    return out


def time_kernel(fns, tables, st, pos0, th, gen, kernel_blocks=64, plain_blocks=4):
    """(kernel us/step, plain us/step, kernel ms/lnprob, plain ms/lnprob)
    lists: whole steps at W walkers, k=K_STEPS, and the lnprob of the
    thetas `th`; CUDA events after a warm-up, in turns plain, kernel,
    kernel, plain, TIMING_PAIRS times. fns as in check_kernel."""
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    lnprob, lnprob_plain, step, step_plain = fns
    lnp0 = lnprob_plain(pos0, tables, st)

    def run(fn, nblocks):   # us / step
        rnd = draw_randomness(nblocks * K_STEPS, W, gen, device=DEVICE)
        return block_us(fn, pos0, lnp0, block_randomness(rnd, K_STEPS), tables, st)

    def time_lnprob(fn, reps=50):   # ms / call
        return event_ms(lambda: [fn(th, tables, st) for _ in range(reps)],
                        lambda: fn(th, tables, st)) / reps

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


def time_steps(case, gen):
    """K1 and its plain version at 128 walkers, k=16, f32 (time_kernel) on
    a flagship case. Returns the times, the work of each entry for its
    bound, and the f32 (statics, tables, walkers) the geometry timing
    reuses."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import (fused_lnprob, fused_lnprob_plain,
                                                   fused_step_block, fused_steps_plain)

    (st, tb), _ = flagship_tables(case)
    ndim = len(st.bounds_lo)
    pos0 = flagship_pos0(ndim, seed=1, dtype=torch.float32)
    th = in_box_thetas(W, ndim, case[4].bounds, gen).to(torch.float32)
    fns = (fused_lnprob, fused_lnprob_plain, fused_step_block, fused_steps_plain)
    work = {"fused_steps": k1_work(tb, st, pos0[:, -1], evaluations=K_STEPS),
            "fused_lnprob": k1_work(tb, st, th[:, -1])}
    return time_kernel(fns, tb, st, pos0, th, gen), work, (st, tb, pos0)


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
    K, mc = spec.ncomp, st.mask_center
    work = {"multi_steps": k2_work(tb, K, pos0[:, -1], mc, evaluations=K_STEPS),
            "multi_lnprob": k2_work(tb, K, th[:, -1], mc)}
    return time_kernel(fns, tb, st, pos0, th, gen, kernel_blocks=16), work


def dense_cases(prob):
    """(label, model_f32, model_f64, spec, bounds, means, stds, grid,
    min_saving) for K3 on the dense problem: Chebyshev and state-sum Q on
    the split tables, Chebyshev on the rectangular table (min_saving
    1e9), and the analytic power-law Q(T) of 1-cyanonaphthalene in 5
    dims (free source size)."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.catalogs import QModel, load_catalog
    from cha1_mcmc_tpu_torch.catalogs.partition import (_state_sum_model,
                                                        fit_device_cheb)
    from cha1_mcmc_tpu_torch.inference import ParamSpec
    from cha1_mcmc_tpu_torch.models import SpectralModel
    from cha1_mcmc_tpu_torch.reduce import reduce_spectrum
    from tests.port_problems import (DENSE_BOUNDS, DENSE_CENTER, DENSE_DISH,
                                     DENSE_SOURCE_SIZE)

    cat = load_catalog(prob["cat_path"])
    grid = reduce_spectrum(cat, prob["data_path"], ll=prob["ll"], ul=prob["ul"],
                           aligned_velocity=DENSE_CENTER, dish_size=DENSE_DISH,
                           source_size=DENSE_SOURCE_SIZE, verbose=False)
    states = _state_sum_model(cat)
    cheb = fit_device_cheb(states, *DENSE_BOUNDS["Tex"])
    power = QModel(kind="analytic", coeffs=(0.0,), power=(560.39, 1.4984))
    ncol = prob["truth"][0]
    means5 = np.array([DENSE_SOURCE_SIZE, 1.2 * ncol, 8.0, DENSE_CENTER, 0.7575])
    stds5 = np.array([6.5, 0.5 * ncol, 3.0, 0.06, 0.22])
    out = []
    for label, q, ndim, min_saving in (("cheb-split-4d", cheb, 4, 1.3),
                                       ("states-split-4d", states, 4, 1.3),
                                       ("cheb-rect-4d", cheb, 4, 1e9),
                                       ("analytic-split-5d", power, 5, 1.3)):
        models = [SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                                      ll=prob["ll"], ul=prob["ul"], dish_size=DENSE_DISH,
                                      vel_offset=DENSE_CENTER, mask_center=DENSE_CENTER,
                                      q_model=q, device=DEVICE, dtype=dt)
                  for dt in (torch.float32, torch.float64)]
        spec = ParamSpec(ncomp=1,
                         fixed_source_size=DENSE_SOURCE_SIZE if ndim == 4 else None)
        cut = 5 - ndim
        out.append((label, *models, spec, dict(DENSE_BOUNDS), means5[cut:], stds5[cut:],
                    grid, min_saving))
    return out


def dense_thetas(n, ndim, ncol, gen):
    """Random thetas inside the dense prior around the posterior's region:
    source size uniform in [40, 70] (5 dims), log-uniform Ncol within 3x
    of the injected one, Tex in [5, 11], vlsr within 0.2 km/s of 5.8, dV
    in [0.5, 1.2]."""
    import math

    import torch

    u = torch.rand((n, ndim), generator=gen, device=DEVICE, dtype=torch.float64)
    cols = [40.0 + 30.0 * u[:, 0]] if ndim == 5 else []
    off = ndim - 4
    cols += [ncol * torch.exp(math.log(3.0) * (2.0 * u[:, off] - 1.0)),
             5.0 + 6.0 * u[:, off + 1], 5.6 + 0.4 * u[:, off + 2],
             0.5 + 0.7 * u[:, off + 3]]
    return torch.stack(cols, dim=1)


def dense_tables(case, cblock=128):
    """(fns, (st32, tb32), (st64, tb64), plans) of K3 for one dense case
    at channel blocks of `cblock`: plans = {dtype: GatherPlan}, and fns =
    (lnprob, lnprob_plain, step_block, steps_plain), each taking the plan
    of its tables' dtype, as check_kernel / time_kernel call them."""
    from cha1_mcmc_tpu_torch.sampler.fused_gather import (
        gather_lnprob, gather_lnprob_plain, gather_statics_tables, gather_step_block,
        gather_steps_plain, plan_fused_gather)

    label, m32, m64, spec, bounds, means, stds, grid, min_saving = case
    out, plans = [], {}
    for m in (m32, m64):
        plan = plan_fused_gather(m, spec, DENSE_DV_MAX, W, min_saving=min_saving,
                                 cblock=cblock)
        st, tb, plans[m.dtype] = gather_statics_tables(m, spec, grid.ints, grid.yerrs,
                                                       bounds, means, stds, plan)
        out.append((st, tb))
    fns = tuple(by_dtype(f, plans) for f in (gather_lnprob, gather_lnprob_plain,
                                             gather_step_block, gather_steps_plain))
    return fns, out[0], out[1], plans


def by_dtype(fn, plans):
    """fn(*args, tables, st, geom=plan) with `plans`' GatherPlan of the
    tables' dtype (K3's and K5b's wrappers and plain versions)."""
    def call(*args):
        return fn(*args, geom=plans[args[-2][1].dtype])
    return call


def dense_pos0(case, seed=0):
    """The dense fit's walker ball at W walkers, f64 on the card: 1%
    around the injected truth, and in 5 dims the source size spread by its
    prior sigma (the data barely constrain it, so a 1% ball would keep the
    ensemble expanding along it through the whole check)."""
    import numpy as np
    import torch

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    center = np.asarray(means, dtype=np.float64).copy()
    center[spec.ndim - 4] = means[spec.ndim - 4] / 1.2      # the injected Ncol
    scale = 0.01 * center
    if spec.ndim == 5:
        scale[0] = stds[0]
    rng = np.random.default_rng(seed)
    return torch.as_tensor(center + scale * rng.standard_normal((W, spec.ndim)),
                           dtype=torch.float64, device=DEVICE)


def check_dense_case(case, gen, errs):
    """K3's checks on one dense case (check_kernel), and the T1 check: the
    f32 lnprob entry against the port's plain batched gather lnprob."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.inference import (build_lnprob_batched,
                                               single_component_lnprior)

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    fns, t32, t64, plans = dense_tables(case)
    th = dense_thetas(512, spec.ndim, means[spec.ndim - 4] / 1.2, gen).to(torch.float32)
    fracs = check_kernel(label, fns, t32, t64, th, dense_pos0(case), grid.yerrs, gen,
                         errs, 1024)
    prior = single_component_lnprior(spec, bounds, means, stds, dtype=torch.float32)
    general = build_lnprob_batched(m32, spec, grid.ints, grid.yerrs, prior,
                                   use_pallas=True, dv_max=DENSE_DV_MAX)(th)
    k = fns[0](th, t32[1], t32[0]).cpu().numpy()
    g = general.cpu().numpy()
    assert np.array_equal(np.isfinite(k), np.isfinite(g)), label
    fin = np.isfinite(g)
    scale = 2e-5 * abs(0.5 * float(np.log(1.0 / np.asarray(grid.yerrs) ** 2).sum()))
    np.testing.assert_allclose(k[fin], g[fin], rtol=2e-5, atol=scale,
                               err_msg=f"{label} K3 vs batched gather lnprob")
    errs["general"] = max(errs.get("general", 0.0), float(np.max(np.abs(k[fin] - g[fin]))))
    return fracs, plans[torch.float32]


#: The channel blocks K3 is checked and timed at (T2), and the second grid
#: size of its checks: a few CTAs, so each walks many tiles.
CBLOCKS = (128, 256, 512)
SMALL_GRID = 37


def k3_plans(geom):
    """(name, GatherPlan) of K3's checks at one channel block: the grid
    launch_grid takes, SMALL_GRID CTAs, and the taus in device memory (the
    path of a problem whose block lines do not fit a CTA's shared
    memory)."""
    import dataclasses

    assert geom.tau_shared, "the dense problem's taus should fit shared memory"
    return (("card's grid", geom), (f"{SMALL_GRID} CTAs", dataclasses.replace(
        geom, grid=SMALL_GRID)), ("taus in device memory", dataclasses.replace(
            geom, tau_shared=False)))


def check_dense_geometries(case, errs, cblocks=CBLOCKS):
    """Phase 3: K3 on one dense case at each of `cblocks` (channel blocks
    of 128, 256 and 512), each at k3_plans' three plans, f64, 64 steps
    from the dense walker ball: chains and acceptances bitwise against
    gather_steps_plain at the same block (lnps rtol 1e-12), the lnprob
    entry equal to the in-chain lnps of every walker that moved (also
    beside a row group outside the prior box), one launch per call; and
    K5b at world size 1 at the small grid and with the taus in device
    memory, bitwise against K3. One plain run per channel block serves
    its plans."""
    import functools

    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf
    from cha1_mcmc_tpu_torch.sampler import fused_gather as fg
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    label = case[0]
    pos0 = dense_pos0(case, seed=3)
    D = pos0.shape[1]
    for cb in cblocks:
        fns, _, (st, tb), plans = dense_tables(case, cblock=cb)
        geom = plans[torch.float64]
        lnp0 = fns[1](pos0, tb, st)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(cb)
        rnd = draw_randomness(64, W, gen, device=DEVICE, dtype=torch.float64)
        cp, lp, ap = (t.cpu().numpy() for t in run_blocks(fns[3], pos0, lnp0, rnd, tb, st))
        fin = np.isfinite(lp)
        assert 0 < ap.sum() < 64 * W, f"{label}: the chain should accept some proposals"
        for name, plan in k3_plans(geom):
            where = f"K3 {label}, cblock {cb}, {name}"
            before = fg.LAUNCHES["gather_steps"]
            step = functools.partial(fg.gather_step_block, geom=plan)
            ck, lk, ak = (t.cpu().numpy() for t in run_blocks(step, pos0, lnp0, rnd, tb, st))
            assert fg.LAUNCHES["gather_steps"] == before + 4, where
            assert np.array_equal(ck, cp), f"{where}: f64 chains differ"
            assert np.array_equal(ak, ap), f"{where}: f64 acceptances differ"
            assert np.array_equal(np.isfinite(lk), fin), where
            np.testing.assert_allclose(lk[fin], lp[fin], rtol=1e-12, err_msg=f"{where} lnps")
            errs[f"cblock {cb}"] = max(errs.get(f"cblock {cb}", 0.0),
                                       float(np.max(np.abs(lk[fin] - lp[fin]))))
            moved = (ck[-W:] != pos0.cpu().numpy()).any(axis=1)
            assert moved.any(), where
            entry = fg.gather_lnprob(torch.as_tensor(ck[-W:], device=DEVICE), tb, st, plan)
            assert np.array_equal(entry.cpu().numpy()[moved], lk[-W:][moved]), \
                f"{where}: the lnprob entry differs from the in-chain lnps"
            # one row group wholly outside the prior box (dV twice its
            # bound), whose tiles skip the channel walk, beside the others
            mixed = torch.as_tensor(ck[-W:], device=DEVICE).clone()
            mixed[:fg.ROWS, -1] = 2.0 * case[4]["dV"][1]
            got = fg.gather_lnprob(mixed, tb, st, plan).cpu().numpy()
            rest = moved[fg.ROWS:]
            assert np.isneginf(got[:fg.ROWS]).all() and np.array_equal(
                got[fg.ROWS:][rest], lk[-W:][fg.ROWS:][rest]), \
                f"{where}: the lnprob entry beside thetas outside the box"
            if plan is geom:
                continue
            before = sf.LAUNCHES["sharded_gather_half"]
            half = functools.partial(sf.sharded_gather_half, geom=plan)
            c5, l5, a5, _ = run_k5(half, (tb, st), pos0, lnp0, rnd)
            assert sf.LAUNCHES["sharded_gather_half"] == before + 128, where
            assert np.array_equal(c5.cpu().numpy().reshape(-1, D), ck) and np.array_equal(
                a5.cpu().numpy(), ak), f"K5b {label}, cblock {cb}, {name}: differs from K3"
            assert np.array_equal(l5.cpu().numpy().reshape(-1), lk), \
                f"K5b {label}, cblock {cb}, {name}: lnps differ from K3's"
        phase(3, "check", f"K3 {label} at channel blocks of {cb} ({geom.n_blk} blocks, "
              f"u_max {geom.u_max}), f64: 64-step chains bitwise vs plain at " + ", ".join(
                  n for n, _ in k3_plans(geom)) + "; lnprob entry = in-chain "
              "lnps; K5b = K3 at world size 1 off the card's grid")


def opacity_inputs(case, gen, dtype, n=W, vlsr=None, dV=None):
    """(taus (n, L), vlsr, dV) of n in-box dense thetas, and the model, for
    the opacity kernels; `vlsr` / `dV` (tensors of n) replace the thetas'
    before the taus are computed."""
    import torch
    from cha1_mcmc_tpu_torch.ops.lte import tau_sticks

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    m = m32 if dtype == torch.float32 else m64
    th = dense_thetas(n, spec.ndim, means[spec.ndim - 4] / 1.2, gen).to(dtype)
    if vlsr is not None:
        th[:, -2] = vlsr.to(dtype)
    if dV is not None:
        th[:, -1] = dV.to(dtype)
    ss, Ncol, Tex, v, d = spec.unpack(th)
    taus = tau_sticks(torch, m.line_freq, m.line_elower, m.line_aij, m.line_gup,
                      m.line_glow, m.q(Tex)[:, None], Ncol, Tex[:, None], d[:, None])
    return taus.contiguous(), v[:, 0].contiguous(), d.contiguous(), m


_OPACITY_TABLES = {}


def opacity_tables(m, dtype):
    """(block_mask, (line_table, vel_compact, tile_counts)) of the dense
    model's velocity grid at the prior's dV bound, on the card (built once
    a model)."""
    import torch
    from cha1_mcmc_tpu_torch.models.sparse_opacity import (block_activity_mask,
                                                           build_opacity_csr)

    key = (id(m), dtype)
    if key not in _OPACITY_TABLES:
        vg = m.vel_grid.cpu().numpy()
        mask = torch.as_tensor(block_activity_mask(vg, m.mask_center, DENSE_DV_MAX),
                               device=DEVICE)
        lt, vc, tc = build_opacity_csr(vg, m.mask_center, DENSE_DV_MAX)
        _OPACITY_TABLES[key] = (m, mask, (torch.as_tensor(lt, device=DEVICE),
                                          torch.as_tensor(vc, dtype=dtype, device=DEVICE),
                                          torch.as_tensor(tc, device=DEVICE)))
    return _OPACITY_TABLES[key][1:]


#: K4's forms: (kernel, form, masked) — K4a in the exp form (always
#: masked) and the exp2 form masked and unmasked, K4b masked and unmasked.
K4_FORMS = {"block-exp-masked": ("block", "exp", True),
            "block-exp2-masked": ("block", "exp2", True),
            "block-exp2-unmasked": ("block", "exp2", False),
            "csr-exp2-masked": ("csr", "exp2", True),
            "csr-exp2-unmasked": ("csr", "exp2", False)}


def opacity_calls(m, dtype):
    """{name: (kernel call, plain call, masked)} over the dense model's
    tables for each of K4_FORMS: the kernel through its plan
    (opacity_planned, as the lnprob paths call it), the plain version on
    the same tables; each call takes (taus, vlsr, dV)."""
    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok

    mask, csr = opacity_tables(m, dtype)
    plans = {"block": ok.plan_opacity_block(m.vel_grid, mask, mask_center=m.mask_center),
             "csr": ok.plan_opacity_csr(*csr, mask_center=m.mask_center,
                                        n_channels=m.n_channels)}
    out = {}
    for name, (kind, form, masked) in K4_FORMS.items():
        plan = plans[kind]

        def kern(t, v, d, plan=plan, form=form, masked=masked):
            return ok.opacity_planned(plan, t, v, d, form=form, masked=masked)

        if kind == "block":
            def plain(t, v, d, form=form, masked=masked):
                return ok.opacity_block_plain(t, v, d, m.vel_grid, mask,
                                              mask_center=m.mask_center, form=form,
                                              masked=masked)
        else:
            def plain(t, v, d, masked=masked):
                return ok.opacity_csr_plain(t, v, d, *csr, mask_center=m.mask_center,
                                            n_channels=m.n_channels, masked=masked)
        out[name] = (kern, plain, masked)
    return out


#: K4's walker counts besides the main path's 128 (64: a half-step of the
#: sharded runner; 100: a walker group cut short; 256: two groups).
K4_WALKERS = (64, 100, 128, 256)


def k4_cases(case, gen, dtype):
    """{label: (taus, vlsr, dV)} of K4's checks on the dense problem: in-box
    walkers at each of K4_WALKERS; every walker at the prior's dV bound
    (the widest window of any call); narrow windows (dV 0.0005-0.001 and
    vlsr within 0.002 km/s of the centre: windows of 0.005-0.01 km/s leave
    ~25-40 of the 86 channel tiles with no candidate); walkers outside the
    prior box (vlsr up to 40 km/s off the centre, dV from 0.005 to 6),
    which the unmasked forms must still sum as the plain version does."""
    import torch

    def uniform():
        return torch.rand(W, generator=gen, device=DEVICE, dtype=torch.float64)

    out = {f"W={n}": opacity_inputs(case, gen, dtype, n=n)[:3] for n in K4_WALKERS}
    out["dV at the bound"] = opacity_inputs(
        case, gen, dtype, dV=torch.full((W,), DENSE_DV_MAX, device=DEVICE))[:3]
    mc = case[1].mask_center
    out["narrow windows"] = opacity_inputs(case, gen, dtype,
                                           vlsr=mc + 0.002 * (2.0 * uniform() - 1.0),
                                           dV=0.0005 + 0.0005 * uniform())[:3]
    vlsr = mc + 40.0 * (2.0 * uniform() - 1.0)
    dv = 0.005 * torch.exp(torch.log(torch.tensor(1200.0)) * uniform())
    out["outside the prior box"] = opacity_inputs(case, gen, dtype, vlsr=vlsr, dV=dv)[:3]
    out[CUT] = opacity_inputs(case, gen, dtype)[:3]
    return out


#: k4_cases' label of the in-box walkers over cut_model's grid.
CUT = "C - 1 channels"

#: The labels of k4_cases.
K4_CASES = tuple(f"W={n}" for n in K4_WALKERS) + ("dV at the bound", "narrow windows",
                                                  "outside the prior box", CUT)

_CUT_MODELS = {}


def cut_model(m):
    """The dense model's velocity grid less its last channel (10,923
    channels): its rows (43,692 bytes in f32, 87,384 in f64) are no
    multiple of 16 bytes, so K4a's plan copies them to a padded pitch
    (opacity_kernels.kernel_rows), and K4b's output ends inside a tile.
    Built once a model; opacity_tables builds its tables."""
    if id(m) not in _CUT_MODELS:
        C = m.n_channels - 1
        _CUT_MODELS[id(m)] = (m, types.SimpleNamespace(
            vel_grid=m.vel_grid[:, :C].contiguous(), mask_center=m.mask_center,
            n_channels=C))
    return _CUT_MODELS[id(m)][1]


def check_opacity(case, gen, errs, labels=K4_CASES):
    """K4a / K4b against their plain versions on the dense problem, for
    each of K4_FORMS on each of k4_cases (those of `labels`): f64 rtol
    1e-12, f32 rtol 1e-5 (sums of positive terms in another order), each
    with atol 1e-30 for terms deep in the Gaussians' tails, where the
    kernels keep subnormals. Also: a second call gives the same bits. The
    narrow windows must leave some channel tile with no candidate (its
    output all 0, as the plain version's); the case CUT runs over
    cut_model's grid, whose rows the plan pads. Returns the most channel
    tiles without a candidate."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.models import opacity_kernels as ok

    empty_tiles = 0
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        m_full = case[1] if dtype == torch.float32 else case[2]
        cases = {k: v for k, v in k4_cases(case, gen, dtype).items() if k in labels}
        for label, (taus, vlsr, dV) in cases.items():
            m = cut_model(m_full) if label == CUT else m_full
            C = m.n_channels
            if label == CUT:
                assert ok.kernel_rows(m.vel_grid)[1] > C, "the cut grid's rows are not padded"
            for name, (kern, plain, masked) in opacity_calls(m, dtype).items():
                where = f"{name} {dtype} {label}"
                k = kern(taus, vlsr, dV)
                assert torch.equal(kern(taus, vlsr, dV), k), f"{where}: two calls differ"
                p = plain(taus, vlsr, dV)
                if label == "narrow windows":
                    cand = ok.candidates(m.vel_grid, vlsr, dV, m.mask_center,
                                         masked=masked).any(dim=0)
                    cand = torch.nn.functional.pad(cand, (0, -C % 128)).reshape(-1, 128)
                    empty = ~cand.any(dim=1)
                    assert empty.any() and not empty.all(), where
                    tiles = torch.nn.functional.pad(k, (0, -C % 128)).reshape(
                        k.shape[0], -1, 128)
                    assert not tiles[:, empty].any(), f"{where}: a tile with no candidate"
                    empty_tiles = max(empty_tiles, int(empty.sum()))
                k, p = k.cpu().numpy(), p.cpu().numpy()
                assert k.shape == p.shape == (taus.shape[0], C), where
                assert np.array_equal(np.isfinite(k), np.isfinite(p)) and p.max() > 0, where
                np.testing.assert_allclose(k, p, rtol=rtol, atol=1e-30, err_msg=where)
                key = name.split("-")[0]
                errs[key] = max(errs.get(key, 0.0), float(np.max(np.abs(k - p))))
        phase(3, "check", f"K4a/K4b {dtype}: {', '.join(K4_FORMS)} match the plain versions "
              f"(rtol {rtol:g}, atol 1e-30) on {', '.join(cases)}; two calls bitwise")
    return empty_tiles


def time_calls(calls, reps=20):
    """Median [q1, q3] ms per call of each of `calls` {name: fn()}, CUDA
    events after a warm-up, in turns (forward, backward) TIMING_PAIRS
    times."""
    def once(fn):
        return event_ms(lambda: [fn() for _ in range(reps)], fn) / reps

    times = {k: [] for k in calls}
    names = list(calls)
    for _ in range(TIMING_PAIRS):
        for k in names + names[::-1]:
            times[k].append(once(calls[k]))
    return {k: quartiles(v) for k, v in times.items()}


def time_k3_geometries(case, pos0, gen, device, nb=16):
    """Phase 4 (T2): K3 in f32 from the walkers pos0 at channel blocks of
    128 (the card's grid, SMALL_GRID CTAs, 132 CTAs, the taus in device
    memory), 256 and 512, and the step's floor (channel blocks of 128,
    every walker and so every proposal outside the prior box, dV twice
    its bound: the launch runs prepare, the barriers, tiles that walk no
    channel and accept), in turns over `nb` calls of K_STEPS steps. Returns ({name:
    (median, q1, q3) us/step}, {name: (plan, tables, statics)})."""
    import dataclasses
    import functools

    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.fused_gather import gather_step_block
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    FLOOR = "cblock 128, walkers outside the prior box (floor)"
    plans = {}
    for cb in CBLOCKS:
        fns, (st, tb), _, by = dense_tables(case, cblock=cb)
        geom = by[torch.float32]
        plans[f"cblock {cb}"] = (geom, tb, st)
        if cb == CBLOCKS[0]:
            lnp0 = fns[1](pos0, tb, st)
            for name, plan in k3_plans(geom)[1:] + (
                    ("132 CTAs", dataclasses.replace(geom, grid=132)),):
                plans[f"cblock {cb}, {name}"] = (plan, tb, st)
            plans[FLOOR] = (geom, tb, st)
            out_of_box = pos0.clone()
            out_of_box[:, -1] = 2.0 * case[4]["dV"][1] * (1.0 + 0.01 * torch.rand(
                W, generator=gen, device=DEVICE, dtype=pos0.dtype))
            lnp_out = fns[1](out_of_box, tb, st)
            assert not torch.isfinite(lnp_out).any()
    rb = block_randomness(draw_randomness(nb * K_STEPS, W, gen, device=DEVICE), K_STEPS)
    times = {name: [] for name in plans}

    def run(name, plan, tb, st):
        step = functools.partial(gather_step_block, geom=plan)
        c, l = (out_of_box, lnp_out) if name == FLOOR else (pos0, lnp0)
        return block_us(step, c, l, rb, tb, st)

    floor, tb_f, st_f = plans[FLOOR]
    assert not any(bool(acc.any()) for *_, acc in step_blocks(
        functools.partial(gather_step_block, geom=floor), out_of_box, lnp_out, rb, tb_f,
        st_f)), "the floor's walkers should not move"
    order = list(plans)
    for _ in range(TIMING_PAIRS):   # in turns, forwards then backwards
        for name in order + order[::-1]:
            times[name].append(run(name, *plans[name]))
    out = {name: quartiles(ts) for name, ts in times.items()}
    phase(4, "time", f"K3 by geometry, dense {case[0]}, {W} walkers, f32, median [q1, q3] "
          f"of {2 * TIMING_PAIRS} runs of {nb} calls: " + "; ".join(
              f"{n} (grid {launch_grid_of(plans[n][0])}, u_max {plans[n][0].u_max}) "
              f"{m:.2f} [{a:.2f}, {b:.2f}] us/step" for n, (m, a, b) in out.items())
          + f"; {device}")
    return out, plans


def launch_grid_of(plan, rows=W // 2):
    """The CTAs of a K3 launch over `rows` rows at `plan` (f32)."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused_gather import launch_grid

    return launch_grid(plan, rows, torch.float32, plan.lines.device)


def time_dense(case, gen, device):
    """Phase 4 for K3 (T2): K3 and its plain version per step and per
    lnprob of W thetas (time_kernel), K3's lnprob with Q replaced by ones
    and at channel blocks of 128, 256 and 512, and the batched gather
    lnprob of W thetas. Returns ({name: ms}, bound inputs)."""
    import dataclasses

    import torch
    from cha1_mcmc_tpu_torch.inference import (build_lnprob_batched,
                                               single_component_lnprior)
    from cha1_mcmc_tpu_torch.sampler.fused_gather import gather_lnprob

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    fns, (st, tb), _, plans = dense_tables(case)
    geom = plans[torch.float32]
    pos0 = dense_pos0(case, seed=1).to(torch.float32)
    th = dense_thetas(W, spec.ndim, means[spec.ndim - 4] / 1.2, gen).to(torch.float32)
    k3 = report_times("K3", time_kernel(fns, tb, st, pos0, th, gen, kernel_blocks=16,
                                        plain_blocks=2),
                      f"{m32.n_lines} lines x {m32.n_channels} channels", "16 calls a run",
                      device, plain_blocks=2)
    steps, steps_plans = time_k3_geometries(case, pos0, gen, device)
    ones = dataclasses.replace(st, q_kind="analytic", q_coeffs=(1.0,), q_power=None,
                               q_scale=1.0)
    # the floor: every theta outside the prior box (dV twice its bound), so
    # the launch runs prepare, the barriers and combine but no channel walk
    out_of_box = th.clone()
    out_of_box[:, -1] = 2.0 * bounds["dV"][1]
    calls = {"Q(T)": lambda: gather_lnprob(th, tb, st, geom),
             "Q = 1": lambda: gather_lnprob(th, tb, ones, geom),
             "floor (thetas outside the prior box)":
                 lambda: gather_lnprob(out_of_box, tb, st, geom)}
    for cb in CBLOCKS[1:]:
        _, (st_c, tb_c), _, g_c = dense_tables(case, cblock=cb)
        calls[f"cblock {cb}"] = (lambda s=st_c, t=tb_c, g=g_c[torch.float32]:
                                 gather_lnprob(th, t, s, g))
    prior = single_component_lnprior(spec, bounds, means, stds, dtype=torch.float32)
    general = build_lnprob_batched(m32, spec, grid.ints, grid.yerrs, prior,
                                   use_pallas=True, dv_max=DENSE_DV_MAX)
    calls["batched gather lnprob"] = lambda: general(th)
    t = time_calls(calls)
    for name, (med, q1, q3) in t.items():
        phase(4, "time", f"{name}, {W} thetas / walkers, f32, median [q1, q3] of "
              f"{2 * TIMING_PAIRS} runs of 20 calls: {med * 1e3:.2f} [{q1 * 1e3:.2f}, "
              f"{q3 * 1e3:.2f}] us; {device}")
    phase(4, "time", "T2: Q(T) {:.2f} us vs Q = 1 {:.2f} us; channel blocks 128 / 256 / "
          "512: {:.2f} / {:.2f} / {:.2f} us (K3 lnprob of {} thetas; {})".format(
              t["Q(T)"][0] * 1e3, t["Q = 1"][0] * 1e3, t["Q(T)"][0] * 1e3,
              t["cblock 256"][0] * 1e3, t["cblock 512"][0] * 1e3, W, device))
    phase(4, "time", "no single PyTorch call computes K3's step or lnprob: library_ms "
          "is null")

    # the work this run's inputs need, for the bounds (k3_work); the same
    # count bounds a three-kernel K3 (prepare / evaluate / accept launches,
    # tau per in-window entry), which computes the same function
    C = m32.n_channels
    work = {"gather_steps": k3_work(geom, tb, st, pos0[:, -1], evaluations=K_STEPS),
            "gather_lnprob": k3_work(geom, tb, st, th[:, -1])}
    old_count = (7 * (in_window(tb[1], pos0[:, -1], st.mask_center)
                      + in_window(tb[3], pos0[:, -1], st.mask_center)) + 5 * W * C) * K_STEPS
    phase(4, "time", "K3 bound per ensemble step (k3_work: tau per (row, active line), "
          "an exp2 per in-window entry, per (row, channel) J(Tex), 1 - exp(-opac) [and the "
          "5-dim dilution], the per-channel constants once per call, the tables read "
          "once): {:.4f} us ({}); the three-kernel K3's count (tau per in-window "
          "entry, 7 special functions, 5 per (row, channel)): {:.4f} us ({} "
          "special-function results a step); K3 at {} us/step is {:.2%} of the new "
          "bound; {}".format(
              bound(*work["gather_steps"])[0] * 1e3 / K_STEPS,
              bound(*work["gather_steps"])[1], old_count / SFU_RATE * 1e6 / K_STEPS,
              old_count // K_STEPS, round(k3[0], 2),
              bound(*work["gather_steps"])[0] * 1e3 / K_STEPS / k3[0], device))
    for name, (med, q1, q3) in steps.items():
        if "floor" in name:      # no channel work to bound
            continue
        work_c = k3_work(*steps_plans[name], pos0[:, -1], evaluations=K_STEPS)
        phase(4, "time", f"K3 step bound at {name}: {bound(*work_c)[0] * 1e3 / K_STEPS:.4f} "
              f"us/step ({bound(*work_c)[1]}); measured {med:.2f} us/step; {device}")
    # T2: K3's lnprob at its inputs with Q(T) (its series or state sum on
    # top of the channel work) and with Q = 1 (none); the channel-block
    # ablations do the Q(T) call's work.
    q_sfu, q_flops = q_work(st, W, tb[-1].shape[1])
    sfu, flops, nbytes = work["gather_lnprob"]
    t2_bounds = {"Q(T)": bound(sfu + q_sfu, flops + q_flops, nbytes),
                 "Q = 1": bound(sfu, flops, nbytes)}
    phase(4, "time", "T2 bounds: Q(T) {:.4f} us ({}), Q = 1 {:.4f} us ({}); channel "
          "blocks 128 / 256 / 512 as Q(T) (K3 lnprob of {} thetas, Q kind {!r})".format(
              t2_bounds["Q(T)"][0] * 1e3, t2_bounds["Q(T)"][1], t2_bounds["Q = 1"][0] * 1e3,
              t2_bounds["Q = 1"][1], W, st.q_kind))
    return k3, t, work, steps


def kernel_events(fn, kernel, calls, tries=6, lead=8):
    """Durations (us) of the CUDA kernel events whose name holds `kernel`
    in a torch.profiler window over `calls` calls of fn, each of which
    must launch one such kernel. On the H100 a window's first kernel
    records can go missing once other windows have run in the process (a
    window of one K4 call held only the host's cudaLaunchKernel; with two
    torch kernels ahead of the call, those two were missing and the K4
    kernel was there; once, T3's windows held 11 of 20 probe kernels,
    three windows in a row). So each window opens with `lead` small torch
    kernels to take that loss, and a window with another count is taken
    again, up to `tries` windows; then it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lead_in = torch.zeros(1, device=DEVICE)
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                lead_in.add_(1.0)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(us) == calls:
            return us
        counts.append(len(us))
    raise RuntimeError(f"torch.profiler shows {counts} {kernel} events for {calls} calls "
                       f"in {tries} windows")


def device_ms(fn, kernel, reps=20):
    """Device time (ms) a call of fn takes: its `reps` calls' kernel events
    (kernel_events), summed and divided by `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    return sum(kernel_events(fn, kernel, reps)) / reps / 1e3


def time_opacity(case, gen, device):
    """Phase 4 for K4a / K4b, f32, W in-box walkers unless named: each of
    K4_FORMS through its plan (as the lnprob paths call it), the plain
    versions of the masked exp2 forms, K4a masked exp2 with every walker
    at the prior's dV bound,
    the floor of both (dV 1e-6: the rows streamed and filtered, no
    candidate), and K4a masked exp2 in f64 at W/2 walkers with its plain
    version (the
    general sharded runner's half-step call). Per call, host time
    included (time_calls, in turns), and each kernel call's device time
    (device_ms: the kernel's torch.profiler events), median of 3 rounds
    in turns.
    Returns ({name: (median, q1, q3) ms per call}, {name: device ms},
    K4's work)."""
    import numpy as np
    import torch

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    taus, vlsr, dV, _ = opacity_inputs(case, gen, torch.float32)
    wide = opacity_inputs(case, gen, torch.float32,
                          dV=torch.full((W,), DENSE_DV_MAX, device=DEVICE))[:3]
    half64 = opacity_inputs(case, gen, torch.float64, n=W // 2)[:3]
    floor = opacity_inputs(case, gen, torch.float32,
                           dV=torch.full((W,), 1e-6, device=DEVICE))[:3]
    k4 = opacity_calls(m32, torch.float32)
    k64 = opacity_calls(m64, torch.float64)["block-exp2-masked"]
    calls = {f"{name} kernel": (lambda f=kern: f(taus, vlsr, dV))
             for name, (kern, _, _) in k4.items()}
    for name in ("block-exp2-masked", "csr-exp2-masked"):
        calls[f"{name} plain"] = lambda f=k4[name][1]: f(taus, vlsr, dV)
    calls["block-exp2-masked kernel, dV at the bound"] = (
        lambda f=k4["block-exp2-masked"][0]: f(*wide))
    calls["block-exp2-masked kernel, floor (dV 1e-6: no candidate)"] = (
        lambda f=k4["block-exp2-masked"][0]: f(*floor))
    calls["csr-exp2-masked kernel, floor (dV 1e-6: no candidate)"] = (
        lambda f=k4["csr-exp2-masked"][0]: f(*floor))
    calls["block-exp2-masked kernel, f64, W/2"] = lambda f=k64[0]: f(*half64)
    calls["block-exp2-masked plain, f64, W/2"] = lambda f=k64[1]: f(*half64)
    t = time_calls(calls)
    kernels = [k for k in calls if "plain" not in k]
    dev = {k: [] for k in kernels}
    for _ in range(3):
        for name in kernels + kernels[::-1]:
            dev[name].append(device_ms(calls[name], "opacity_kernel"))
    dev = {k: float(np.median(v)) for k, v in dev.items()}
    for name, (med, q1, q3) in t.items():
        phase(4, "time", f"K4 {name}: call (host time included) median [q1, q3] of "
              f"{2 * TIMING_PAIRS} runs of 20 calls {med * 1e3:.2f} [{q1 * 1e3:.2f}, "
              f"{q3 * 1e3:.2f}] us" + (f", device {dev[name] * 1e3:.2f} us" if name in dev
                                       else "") + f"; {device}")
    phase(4, "time", "K4 device times by torch.profiler; no single PyTorch call "
          "computes K4a / K4b's opacity: library_ms is null")

    work, counts = k4_work(m32, taus, vlsr, dV, opacity_tables(m32, taus.dtype))
    for kname, key in (("opacity_block", "block-exp2-masked"),
                       ("opacity_csr", "csr-exp2-masked")):
        new, old = bound(*work[kname]), bound(*work[f"{kname} old"])
        phase(4, "time", f"{kname} bound (least work: the rows read once, a compare per "
              f"element, per walker a compare per candidate and an exp2 per in-window "
              f"term) {new[0] * 1e3:.4f} us ({new[1]}); the old count (every walker "
              f"testing every element) {old[0] * 1e3:.4f} us ({old[1]}); device time "
              f"{dev[key + ' kernel'] * 1e3:.2f} us is {new[0] / dev[key + ' kernel']:.2%} "
              f"of the new bound; {counts}; {device}")
    return t, dev, work


def slice_general_sharded(case, gen, k4a_ms, device, nruns=256):
    """Phase 5: the general sharded runner on the full-size dense problem
    at world size 1 in float64 — make_sharded_sampler(n_devices=1,
    use_pallas=True, use_fused=True): float64 leaves K5b out, so each
    half-step evaluates its W/2 proposals through K4a (shard_lnprob) —
    ShardedEnsembleSampler.run_mcmc for `nruns` steps: K4a launches 2 a
    step + 1 (the entry lnp), no other kernel; then the runner itself per
    step (CUDA events, 3 runs of 64 steps) and K4a's share of it at
    `k4a_ms` (its f64 W/2 device time). Returns the launch counts."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.inference import single_component_lnprior
    from cha1_mcmc_tpu_torch.parallel import make_sharded_runner, make_sharded_sampler
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    f64 = torch.float64
    prior = single_component_lnprior(spec, bounds, means, stds, dtype=f64)
    pos0 = dense_pos0(case)
    zero_launches()
    sampler = make_sharded_sampler(
        n_devices=1, n_line_shards=1, nwalkers=W, ndim=spec.ndim, a=2.0, dtype=f64,
        model=m64, spec=spec, grid_ints=grid.ints, grid_yerrs=grid.yerrs,
        lnprior_fn=prior, use_pallas=True, dv_max=DENSE_DV_MAX, use_fused=True,
        bounds=bounds, prior_means=means, prior_stds=stds, verbose=False)
    assert not (sampler.use_fused or sampler.use_fused_gather or sampler.use_fused_multi)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(5)
    t0 = time.perf_counter()
    sampler.run_mcmc(pos0, nruns, g, checkpoint_every=1024)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    assert launches["opacity_block"] == 2 * nruns + 1, launches
    assert sum(launches.values()) == launches["opacity_block"], launches
    chain = sampler.chain
    assert chain.shape == (W, nruns, spec.ndim) and np.isfinite(chain).all(), label
    acc = sampler.acceptance_fraction
    assert 0.1 < acc < 0.9, (label, acc)

    runner = make_sharded_runner(m64, spec, grid.ints, grid.yerrs, prior, MESH, 64,
                                 use_pallas=True, dv_max=DENSE_DV_MAX)
    pos = torch.as_tensor(chain[:, -1], device=DEVICE)
    lnp = runner.entry_lnprob(pos)
    rnd = draw_randomness(64, W, gen, device=DEVICE, dtype=f64)
    runner(pos, lnp0=lnp, randomness=rnd)   # warm-up
    runs = [1e3 * event_ms(lambda: runner(pos, lnp0=lnp, randomness=rnd)) / 64
            for _ in range(3)]
    us = float(np.median(runs))
    # where a step goes: one torch.profiler window over the 64 steps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner(pos, lnp0=lnp, randomness=rnd)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 64
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    phase(5, "slice", f"general sharded runner, f64: device busy {busy:.2f} us of "
          f"{us:.2f} us a step (idle share {1 - busy / us:.4f}); by kernel: " + "; ".join(
              f"{n[:60]} {t:.2f} us" for n, t in top) + f"; {device}")
    phase(5, "slice", f"general sharded runner, dense {label}, f64, world size 1: "
          f"ShardedEnsembleSampler.run_mcmc {nruns} steps, launches {launches} (K4a: 2 a "
          f"step + 1), acceptance {acc:.3f}, {W * nruns / secs:,.0f} walker-steps/s; the "
          f"runner {us:.2f} us/step (median of 3 runs of 64), of which K4a's 2 calls at "
          f"{k4a_ms * 1e3:.2f} us device time each are {2e3 * k4a_ms / us:.2%}; {device}")
    return launches


def q_work(st, rows, n_states):
    """(special-function results, flops) of Q(T) for `rows` thetas: a
    state sum pays an exp and a divide per state (~3 flops), a Chebyshev
    series ~3 flops per coefficient, the analytic form ~2 flops per term
    and, with a power term, a pow (a log and an exp)."""
    if st.q_kind == "states":
        return 2 * n_states * rows, 3 * n_states * rows
    if st.q_kind == "cheb":
        return 0, 3 * len(st.q_coeffs) * rows
    return (2 * rows if st.q_power is not None else 0), 2 * len(st.q_coeffs) * rows

def cluster_geometry(kind, label, tb, st, device):
    """Phase 2: the cluster geometry a cluster step kernel (`kind`: K1 or
    K2) and its sharded half-step take on this card for W walkers on a
    case's f32 tables (cluster_plan), with the card's
    cudaOccupancyMaxActiveClusters answer at 16 and at 8 CTAs, and the
    step kernel's wide path with the CTAs the card keeps resident."""
    from cha1_mcmc_tpu_torch.sampler import cluster

    fam = cluster_family(kind)
    La, M, C = fam["sizes"](tb)
    dtype, dev = tb[0].dtype, tb[0].device
    for entry, kname in (("steps", kind), ("half", fam["half"])):
        plan, _ = cluster.cluster_plan(fam["family"], entry, W, st.ncomp, st.ndim, La, C, M,
                                       dtype, dev)
        answers = {n: cluster.occupancy(
            fam["family"], entry, fam["plan"](tb, st, W, n, None, entry == "steps"), dtype,
            dev) for n in (16, 8)}
        phase(2, "build", f"{kname} cluster geometry, {label}, {W} walkers, {La} lines x "
              f"{C} channels x {M} entries, f32: one cluster of {plan.cluster} CTAs x 512 "
              f"threads, {plan.proposals} proposals a half-step, at most {plan.per_cta} "
              f"per CTA, {plan.warps_per_proposal} warps a proposal, {plan.smem_bytes} B "
              f"shared memory a CTA, tables "
              f"{'staged' if plan.staged else 'in device memory'}; "
              f"cudaOccupancyMaxActiveClusters: 16 CTAs {answers[16]}, "
              f"8 CTAs {answers[8]} ({device})")
    wide = fam["plan"](tb, st, W, "wide", None, True)
    capacity = cluster.wide_capacity(fam["family"], wide.layout, dtype, dev)
    phase(2, "build", f"{kind} wide path, {label}, {W} walkers, f32: {wide.cluster} CTAs a "
          f"chain x 512 threads in one cooperative launch, one proposal a CTA "
          f"({wide.warps_per_proposal} warps), {wide.smem_bytes} B shared memory a CTA, "
          f"tables {'staged' if wide.staged else 'in device memory'}; the card keeps "
          f"{capacity} such CTAs resident, so a launch of up to "
          f"{capacity // wide.cluster} chains of {W} walkers takes it ({device})")


def k1_entries(case, device):
    """Phase 2: K1's entry tables on a flagship case (f32): the lines any
    window at the widened dV bound reaches, and the most and the mean
    entries a channel walks, against the lines the one-CTA kernel walked.
    Returns the f32 (statics, tables)."""
    (st, tb), _ = flagship_tables(case)
    La, M, C = cluster_family("K1")["sizes"](tb)
    L = tb[0].shape[1]
    mean = float((tb[3] < 1e29).sum()) / C
    phase(2, "build", f"K1 entry tables, {case[0]}: {La} of {L} lines in reach at dV < "
          f"{st.bounds_hi[-1]:g}, M = {M} entries a channel at most, {mean:.3f} on average "
          f"over {C} channels (the one-CTA kernel walked all {L} lines a channel); {device}")
    return st, tb


def k2_staging(case):
    """Phase 2: the channel counts up to which K2 stages a GOTHAM case's
    tables, and the lines its unstaged layout holds (staging_limits).
    Returns the f32 (statics, tables)."""
    label, m32, m64, spec, means, stds, pert, grid = case
    (st, tb), _ = multi_tables(m32, m64, spec, means, stds, grid)
    limits = staging_limits(tb, spec.ncomp)
    phase(2, "build", f"K2 at {W} walkers, 8 CTAs, {spec.ncomp} components, lines and "
          f"entries in {label}'s proportion: tables staged up to " + ", ".join(
              f"{c} channels in {dt}" for dt, (c, _) in limits.items()) + "; above, read "
          "from device memory with no channel limit, up to " + ", ".join(
              f"{la} active lines in {dt}" for dt, (_, la) in limits.items()))
    return st, tb


def device_idle(sampler, pos, nsteps, device):
    """Phase 5: one torch.profiler window over `nsteps` steps of
    sampler.run_mcmc from `pos` (one block, no chain file), after a
    warm-up block: the union of the device's activity intervals (kernels,
    copies) against the host wall time of the window, and the device time
    by name. Returns (idle share, wall s, busy s), the idle share None
    where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    sampler.run_mcmc(pos, K_STEPS, gen, checkpoint_every=K_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.run_mcmc(pos, nsteps, gen, checkpoint_every=nsteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (b - a))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy *= 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    idle = 1.0 - busy / wall if spans else None
    phase(5, "slice", f"torch.profiler window, {nsteps} steps of run_mcmc: host wall "
          f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms, device-idle share "
          + (f"{idle:.4f}" if idle is not None else "not measured (no device activity "
             "in the trace)") + "; by device time: " + "; ".join(
              f"{name[:60]} x{n} {t / 1e3:.3f} ms" for name, (n, t) in top) + f" ({device})")
    return idle, wall, busy


def quartiles(xs):
    """(median, 25th, 75th percentile) of a list of timings."""
    import numpy as np

    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return float(med), float(q1), float(q3)


def build_kernels():
    """Build K1 (+ K5a), K2 (+ K5c), K3 (+ K5b), K4 and T3 at once (one
    nvcc process per source) and load them: {source's kernel: (seconds,
    nvcc log)}."""
    from concurrent.futures import ThreadPoolExecutor
    from cha1_mcmc_tpu_torch.models import opacity_kernels
    from cha1_mcmc_tpu_torch.sampler import cluster, fused, fused_gather, fused_multi
    from cha1_mcmc_tpu_torch.utils import construct_probe

    def timed(load):
        t0 = time.perf_counter()
        log = load()[-1]
        return time.perf_counter() - t0, log

    loads = {"K1": lambda: cluster.load_library(fused.FAMILY),
             "K2": lambda: cluster.load_library(fused_multi.FAMILY),
             "K3": fused_gather.load_kernel_library,
             "K4": opacity_kernels.load_kernel_library,
             "T3": construct_probe.load_kernel_library}
    with ThreadPoolExecutor(len(loads)) as ex:
        futures = {k: ex.submit(timed, f) for k, f in loads.items()}
        return {k: f.result() for k, f in futures.items()}


def report_times(kname, times, shape, runs, device, plain_blocks=4):
    """Print the phase-4 lines of one kernel; returns the medians
    (kernel us/step, plain us/step, kernel ms/lnprob, plain ms/lnprob)."""
    kern, plain, lnp_kern, lnp_plain = times
    (k_us, k1, k3), (p_us, p1, p3) = quartiles(kern), quartiles(plain)
    (lk_ms, lk1, lk3), (lp_ms, lp1, lp3) = quartiles(lnp_kern), quartiles(lnp_plain)
    n = len(kern)
    phase(4, "time", f"{kname} whole step, {W} walkers, k={K_STEPS}, f32, {shape}, "
          f"median [q1, q3] of {n} runs: {kname} {k_us:.2f} [{k1:.2f}, {k3:.2f}] "
          f"us/step ({runs}), plain torch {p_us:.2f} [{p1:.2f}, {p3:.2f}] us/step "
          f"({plain_blocks} blocks a run); {device}")
    phase(4, "time", f"{kname} lnprob of {W} thetas, median [q1, q3] of {n} runs of "
          f"50 calls: {kname} {lk_ms * 1e3:.2f} [{lk1 * 1e3:.2f}, {lk3 * 1e3:.2f}] us, "
          f"plain torch {lp_ms * 1e3:.2f} [{lp1 * 1e3:.2f}, {lp3 * 1e3:.2f}] us; {device}")
    return k_us, p_us, lk_ms, lp_ms


def kernel_modules():
    """Import every kernel module of the port, each registering its launch
    counters with utils.metrics.register_launches at import."""
    from cha1_mcmc_tpu_torch.models import opacity_kernels
    from cha1_mcmc_tpu_torch.parallel import sharded_fused
    from cha1_mcmc_tpu_torch.sampler import fused, fused_gather, fused_multi
    from cha1_mcmc_tpu_torch.utils import construct_probe

    return fused, fused_multi, fused_gather, opacity_kernels, sharded_fused, construct_probe


def zero_launches():
    from cha1_mcmc_tpu_torch.utils.metrics import launch_counters

    kernel_modules()
    for counts in launch_counters():
        for key in counts:
            counts[key] = 0


def read_launches():
    from cha1_mcmc_tpu_torch.utils.metrics import kernel_launches

    kernel_modules()
    return kernel_launches()


def checkpoint_split(fit, kernel_s, tmp, device, reps=3):
    """Phase 5: the checkpoint path of a finished fit
    (sampler/stretch.py:EnsembleSampler.run_mcmc), each part repeated on
    the fit's own arrays at the sizes the fit wrote them, median of `reps`
    on the host clock: per block the device-to-host copy and transpose of
    the block's chain and lnps (:243-244); per checkpoint the
    concatenation of the cumulative chain (`chain`, :184-189), its
    np.save (:251) and the .state.npz sidecar (:252-256). Prints their sums
    beside the fit's sampling wall time less `kernel_s`, the time of its
    kernel launches at phase 4's rate; returns ({part: s}, wall s)."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import PACKAGE_TAG

    sampler = fit.sampler
    blocks, lnp_blocks = sampler._chain_blocks, sampler._lnp_blocks
    path = os.path.join(tmp, "checkpoint_probe.npy")

    def median_s(fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    on_card = [(torch.as_tensor(np.ascontiguousarray(c.transpose(1, 0, 2)), device=DEVICE),
                torch.as_tensor(np.ascontiguousarray(lp.T), device=DEVICE))
               for c, lp in zip(blocks, lnp_blocks)]
    cumulative = [np.concatenate(blocks[:i + 1], axis=1) for i in range(len(blocks))]
    gen = torch.Generator(device=DEVICE)
    pos, lnp = on_card[-1][0][-1], on_card[-1][1][-1]
    parts = {
        "device-to-host copies": sum(median_s(lambda c=c, lp=lp: (
            c.cpu().numpy().transpose(1, 0, 2), lp.cpu().numpy().T)) for c, lp in on_card),
        "chain concatenations": sum(median_s(lambda i=i: np.concatenate(blocks[:i + 1],
                                                                          axis=1))
                                    for i in range(len(blocks))),
        "np.save of the chain": sum(median_s(lambda c=c: np.save(path, c))
                                    for c in cumulative),
        "state sidecars": len(blocks) * median_s(lambda: np.savez(
            path[:-4] + ".state.npz", pos=pos.cpu().numpy(), lnp=lnp.cpu().numpy(),
            accepted=sampler.accepted, total_proposals=sampler.total_proposals,
            package=PACKAGE_TAG, rng_state=gen.get_state().numpy()))}
    total = sum(parts.values())
    wall = fit.throughput.elapsed
    phase(5, "slice", f"checkpoint path of {type(fit).__name__}.run() ({len(blocks)} blocks, "
          f"chain {cumulative[-1].shape} {cumulative[-1].dtype}), median of {reps}: " + ", ".join(
              f"{k} {v * 1e3:.3f} ms" for k, v in parts.items()) + f"; sum {total * 1e3:.3f} ms "
          f"against the fit's sampling wall time {wall * 1e3:.3f} ms less its kernel time "
          f"{kernel_s * 1e3:.3f} ms = {(wall - kernel_s) * 1e3:.3f} ms ({device})")
    return parts, wall


def slice_flagship(prob, tmp, device, k1_times):
    """SpectralFit.run() through K1, then its checkpoint path
    (checkpoint_split, the kernel time from K1's phase-4 medians
    `k1_times`): returns the launch counts of the run."""
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
    checkpoint_split(fit, kernel_seconds(launches, "fused", k1_times), tmp, device)
    return launches


def kernel_seconds(launches, prefix, times):
    """The kernel time of a fit's launches of <prefix>_steps and
    <prefix>_lnprob at phase 4's medians (times = (us per step, _, ms per
    lnprob call, _))."""
    k_us, _, lk_ms, _ = times
    return (launches[f"{prefix}_steps"] * K_STEPS * k_us * 1e-6
            + launches[f"{prefix}_lnprob"] * lk_ms * 1e-3)


def slice_gotham(prob, tmp, device, fused_step=True, nruns=4096, k2_times=None):
    """MultiComponentFit.run() on the card, through K2 (fused_step) or
    the general gather path: returns the launch counts of the run. Through
    K2 also the device-idle share of a window of its sampler and the
    fit's checkpoint path (checkpoint_split, the kernel time from K2's
    phase-4 medians `k2_times`)."""
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
        checkpoint_split(fit, kernel_seconds(launches, "multi", k2_times), tmp, device)
        device_idle(fit.sampler, chain[:, -1, :], 1024, device)
    return launches


# -- K chains in one K1 / K2 launch (MultiChainSampler) -------------------------

#: The chain counts phase 4 times and the fits' chains in phase 5.
CHAIN_COUNTS = (1, 2, 4, 8)
#: K1's K-chain fit is long enough for the card's floors (70 x the
#: flagship golden's tau_max of 215); K2's takes its own steps at its call.
FIT_CHAINS, FIT_WALKERS, FIT_STEPS = 4, 512, 20_480


def chain_occupancy(kind, tb, st):
    """cudaOccupancyMaxActiveClusters of the step kernel `kind` (K1 / K2)
    at W walkers on the tables `tb`, at cluster_plan's geometry: the
    chains one launch runs at once; the rest run in later waves."""
    from cha1_mcmc_tpu_torch.sampler import cluster

    fam = cluster_family(kind)
    La, M, C = fam["sizes"](tb)
    return cluster.cluster_plan(fam["family"], "steps", W, st.ncomp, st.ndim, La, C, M,
                                tb[0].dtype, tb[0].device)[1]


def chain_starts(kind, case, n_chains, stuck=True):
    """(K, W, D) f64 starts of `n_chains` chains of a flagship (K1) or
    GOTHAM (K2) case, chain c from seed c; with `stuck`, walker 3 of every
    chain outside the prior box so that no proposal of it can enter it
    (K1: vlsr 9 km/s against the box's 5.5, so with a partner inside the
    box every proposal lies above 6; K2: dV 0.7, every proposal above 0.35
    against the 0.3 bound): it keeps lnp = -inf (F4)."""
    import torch

    if kind == "K1":
        ndim = case[3].ndim
        pos = torch.stack([flagship_pos0(ndim, seed=c) for c in range(n_chains)])
        if stuck:
            pos[:, 3, ndim - 2] = 9.0
    else:
        means, pert = case[4], case[6]
        pos = torch.stack([multi_pos0(means, pert, seed=c) for c in range(n_chains)])
        if stuck:
            pos[:, 3, -1] = 0.7
    return pos


def steps_path(kind, tb, st, nwalkers, chains):
    """'wide' or 'cluster': the path a step launch of the cluster step
    kernel `kind` (K1 / K2) of `chains` chains of nwalkers walkers takes on
    the tables `tb` (cluster.steps_plan)."""
    from cha1_mcmc_tpu_torch.sampler import cluster

    fam = cluster_family(kind)
    La, M, C = fam["sizes"](tb)
    plan = cluster.steps_plan(fam["family"], nwalkers, chains, st.ncomp, st.ndim, La, C, M,
                              tb[0].dtype, tb[0].device)
    return "wide" if plan.wide else "cluster"


def check_chains(kind, case, errs, ks=None):
    """Phase 3: K independent chains in one launch of a cluster step kernel
    (K1 on a flagship case, K2 on a GOTHAM case) at W walkers a chain, 64
    steps in blocks of 16, at K = 1, 3 and one past the clusters the card
    holds at once (a second wave). Chain c draws its randomness after
    chains 0..c-1 from one generator, so it is the same at every K. Each
    chain of a K-chain launch equals that chain launched alone (K = 1)
    bitwise in f32 and f64 — chain, lnps and acceptances — and, in f64, the
    plain version chain by chain (chain and acceptances bitwise, lnps rtol
    1e-12). Walker 3 of every chain starts outside the prior box and keeps
    lnp = -inf at every step, never NaN (F4). One launch a block for all K
    chains. `ks`: other chain counts instead. Returns the chain counts
    checked."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_chain_randomness

    fam = cluster_family(kind)
    counts = fam["family"].launches
    label = case[0]
    tabs = dict(zip((torch.float32, torch.float64),
                    flagship_tables(case) if kind == "K1" else multi_tables(*case[1:6],
                                                                           case[7])))
    if ks is None:
        occupancy = max(chain_occupancy(kind, tb, st) for st, tb in tabs.values())
        ks = (1, 3, occupancy + 1)
    ks = tuple(sorted(set(ks)))
    n = ks[-1]
    for dtype in (torch.float64, torch.float32):
        st, tb = tabs[dtype]
        where = f"{kind} {label} {str(dtype)[6:]}"
        pos0 = chain_starts(kind, case, n).to(dtype)
        lnp0 = torch.stack([fam["lnprob_plain"](p, tb, st) for p in pos0])
        assert bool((lnp0[:, 3] == -torch.inf).all()), where
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(11)
        rnd = draw_chain_randomness(n, 64, W, gen, device=DEVICE, dtype=dtype)
        alone = [run_blocks(fam["step"], pos0[c], lnp0[c], tuple(t[c] for t in rnd),
                                  tb, st) for c in range(n)]
        if dtype == torch.float64:
            for c in range(n):
                cp, lp, ap = run_blocks(fam["steps_plain"], pos0[c], lnp0[c],
                                              tuple(t[c] for t in rnd), tb, st)
                ck, lk, ak = alone[c]
                assert torch.equal(ck, cp), f"{where} chain {c}: differs from plain"
                assert torch.equal(ak, ap), f"{where} chain {c}: acceptances differ"
                fin = torch.isfinite(lp)
                assert torch.equal(torch.isfinite(lk), fin), where
                np.testing.assert_allclose(lk[fin].cpu().numpy(), lp[fin].cpu().numpy(),
                                           rtol=1e-12, err_msg=f"{where} chain {c} lnps")
                errs[kind] = max(errs.get(kind, 0.0), float((lk[fin] - lp[fin]).abs().max()))
        for K in ks:
            before = counts[fam["steps_key"]]
            ck, lk, ak = run_blocks(fam["step"], pos0[:K], lnp0[:K],
                                          tuple(t[:K] for t in rnd), tb, st)
            assert counts[fam["steps_key"]] == before + 4, f"{where}: not one launch a block"
            assert not bool(torch.isnan(lk).any()), f"{where} K={K}: NaN lnps"
            stuck = lk.reshape(K, 64, W)[:, :, 3]
            assert bool((stuck == -torch.inf).all()), f"{where} K={K}: F4"
            for c in range(K):
                for x, y in zip((ck[c], lk[c], ak[c]), alone[c]):
                    assert torch.equal(x, y), f"{where} K={K} chain {c}: differs from alone"
            assert 0 < float(ak.sum()) < K * 64 * (W - 1), where
    return ks


def time_chains(kind, case, gen, device, nb=16):
    """Phase 4: K chains of W walkers in f32, at each of CHAIN_COUNTS, in
    one launch a block against K single-chain launches a block, in turns
    (sequential, one launch, one launch, sequential) TIMING_PAIRS times
    over nb blocks of K_STEPS steps: {K: (one launch's us per ensemble step
    of all K chains, (median, q1, q3)), the sequential launches' (median,
    q1, q3), the bound (K x the single-chain bound), one chain's work}."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_chain_randomness

    fam = cluster_family(kind)
    st, tb = (flagship_tables(case) if kind == "K1"
              else multi_tables(*case[1:6], case[7]))[0]
    out = {}
    for K in CHAIN_COUNTS:
        pos0 = chain_starts(kind, case, K, stuck=False).to(torch.float32)
        lnp0 = torch.stack([fam["lnprob_plain"](p, tb, st) for p in pos0])
        rnd = draw_chain_randomness(K, nb * K_STEPS, W, gen, device=DEVICE)
        rb = block_randomness(rnd, K_STEPS)

        def one_launch():
            return block_us(fam["step"], pos0, lnp0, rb, tb, st)

        def sequential():
            return sum(block_us(fam["step"], pos0[c], lnp0[c], tuple(t[:, c] for t in rb),
                                tb, st) for c in range(K))

        one, seq = [], []
        for _ in range(TIMING_PAIRS):
            seq.append(sequential())
            one.append(one_launch())
            one.append(one_launch())
            seq.append(sequential())
        if kind == "K1":
            work = k1_work(tb, st, pos0[0, :, -1], evaluations=K_STEPS)
        else:
            work = k2_work(tb, st.ncomp, pos0[0, :, -1], st.mask_center, evaluations=K_STEPS)
        b_us = K * bound(*work)[0] * 1e3 / K_STEPS
        out[K] = (quartiles(one), quartiles(seq), b_us, work)
    phase(4, "time", f"{kind} K chains of {W} walkers in one launch a block (grid (n, K)) "
          f"vs K single-chain launches a block, f32, {case[0]}, median [q1, q3] of "
          f"{2 * TIMING_PAIRS} runs of {nb} blocks, us per ensemble step of all K chains: "
          + "; ".join(f"K={K} one launch {a[0]:.2f} [{a[1]:.2f}, {a[2]:.2f}], sequential "
                      f"{s[0]:.2f} [{s[1]:.2f}, {s[2]:.2f}], bound {b:.4f} (K x one chain's)"
                      for K, (a, s, b, _) in out.items()) + f"; {device}")
    return out


class FaultOnce:
    """A test double of a MultiChainSampler's run_fn: raises one
    DeviceError on its `at`-th call (0-based: the `at`-th checkpoint
    block), then calls the real chain-batched K1 / K2 runner. Its calls
    run on the same path; only the fault is injected."""

    def __init__(self, run_fn, at):
        self.run_fn, self.at, self.calls, self.raised = run_fn, at, 0, 0
        self.lnprob = run_fn.lnprob

    def __getattr__(self, name):
        # the rest of the runner's interface (a K2 runner's plan_counts)
        return getattr(self.run_fn, name)

    def __call__(self, *args, **kwargs):
        from cha1_mcmc_tpu_torch.utils import DeviceError

        n, self.calls = self.calls, self.calls + 1
        if n == self.at:
            self.raised += 1
            raise DeviceError("injected by chip_smoke: K-chain block fault")
        return self.run_fn(*args, **kwargs)


def per_chain_acceptance(chain, n_chains):
    """Each chain's acceptance fraction from its pooled (K*W, S, D) rows:
    the share of (walker, step) moves that changed the walker's row."""
    moved = (chain[:, 1:] != chain[:, :-1]).any(axis=-1)
    return moved.reshape(n_chains, -1).mean(axis=1)


def slice_chains(kind, prob, tmp, device, chain_times, lnp_ms, steps=FIT_STEPS,
                 golden=None):
    """Phase 5: SpectralFit (K1, flagship) or MultiComponentFit (K2,
    GOTHAM).run() with n_chains=FIT_CHAINS, FIT_WALKERS walkers in all,
    `steps` steps in 4 checkpoint blocks, through MultiChainSampler with
    the kernel's chain-batched run_fn: one launch a k-step block for all
    chains. Prints its launches, walker-steps/s, checkpoint split (kernel
    time at phase 4's FIT_CHAINS-chain median `chain_times` and the
    lnprob's `lnp_ms`), cross-chain R-hat and pooled chain; checks each
    chain finite with acceptance in (0.1, 0.9), and holds the pooled
    chain to problem `golden`'s JAX golden (gate_posterior) where one is
    named. Then the same fit again
    with a run_fn double that raises one DeviceError in block 2
    (FaultOnce), recovered by the retry: its chain equals the first
    run's bitwise. Returns (the launch counts of the first run, max |z| or
    None)."""
    import numpy as np
    import cha1_mcmc_tpu_torch as port
    from cha1_mcmc_tpu_torch.pipeline import fit as fit_mod, multifit as multifit_mod
    from cha1_mcmc_tpu_torch.sampler import FusedEnsemble, MultiChainSampler
    from cha1_mcmc_tpu_torch.sampler.fused_multi import MultiFusedEnsemble

    every = steps // 4
    common = dict(nwalkers=FIT_WALKERS, nruns=steps, checkpoint_every=every, seed=0,
                  device=DEVICE, n_chains=FIT_CHAINS, cat_folder=prob["cat_folder"],
                  data_path=prob["data_path"])
    if kind == "K1":
        module, maker, prefix = fit_mod, "make_fused_ensemble", "fused"

        def make(folder):
            return port.SpectralFit(port.FitConfig(mol_name="hc5n_hfs", fit_folder=folder,
                                                   **common))
    else:
        module, maker, prefix = multifit_mod, "make_fused_ensemble_multi", "multi"

        def make(folder):
            return port.MultiComponentFit(port.MultiFitConfig(
                mol_name="hc9n_hfs", template_run=True, fit_folder=folder, **common))

    zero_launches()
    fit = make(os.path.join(tmp, f"chains_{kind}"))
    chain = fit.run()
    launches = read_launches()
    sampler, run_fn = fit.sampler, fit.sampler.run_fn
    assert type(sampler) is MultiChainSampler, type(sampler)
    want = MultiFusedEnsemble if kind == "K2" else FusedEnsemble
    assert type(run_fn) is want, type(run_fn)
    steps_key, lnp_key = f"{prefix}_steps", f"{prefix}_lnprob"
    assert launches[steps_key] == steps // K_STEPS, launches   # not K a block
    assert launches[lnp_key] == FIT_CHAINS, launches
    D = fit.spec.ndim
    assert chain.shape == (FIT_WALKERS, steps, D), chain.shape
    assert np.isfinite(chain).all()
    acc = per_chain_acceptance(chain, FIT_CHAINS)
    assert ((0.1 < acc) & (acc < 0.9)).all(), acc
    rate = fit.throughput.walker_steps_per_sec
    r_hat = fit.convergence["r_hat"]
    phase(5, "slice", f"{type(fit).__name__}.run() n_chains={FIT_CHAINS}: "
          f"{type(sampler).__name__} with run_fn {type(run_fn).__name__} ({kind}), launches "
          f"{ {k: v for k, v in launches.items() if v} } ({steps // K_STEPS} {kind} "
          f"launches for {steps} steps of {FIT_CHAINS} chains: one a {K_STEPS}-step "
          f"block), pooled chain {chain.shape}, per-chain acceptance "
          + ", ".join(f"{a:.3f}" for a in acc) + f", {rate:,.0f} walker-steps/s (sampling "
          f"wall time incl. checkpoints); cross-chain R-hat "
          + ", ".join(f"{lbl.split(' [')[0]}={r:.3f}" for lbl, r in zip(fit.spec.labels, r_hat))
          + f" ({device})")
    kernel_s = (launches[steps_key] * K_STEPS * chain_times[FIT_CHAINS][0][0] * 1e-6
                + launches[lnp_key] * lnp_ms * 1e-3)
    checkpoint_split(fit, kernel_s, tmp, device)
    zmax = None
    if golden is not None:
        zmax = gate_posterior(f"{kind} {FIT_CHAINS} chains {golden}", golden, chain,
                              fit.spec.labels, steps, fit.throughput.elapsed, device,
                              phase_no=5)

    real = getattr(module, maker)
    doubles = []

    def faulty_maker(*args, **kwargs):
        doubles.append(FaultOnce(real(*args, **kwargs), at=1))
        return doubles[-1]

    setattr(module, maker, faulty_maker)
    try:
        again = make(os.path.join(tmp, f"chains_{kind}_fault")).run()
    finally:
        setattr(module, maker, real)
    (double,) = doubles
    assert double.raised == 1 and double.calls == 5, (double.raised, double.calls)
    assert np.array_equal(again, chain), f"{kind}: the recovered chain differs"
    phase(5, "slice", f"{type(fit).__name__}.run() n_chains={FIT_CHAINS} with one "
          f"DeviceError injected into block 2 of 4 (a run_fn double that raises once, then "
          f"calls {kind}): retried from the block's generator state, pooled chain bitwise "
          f"equal to the unfaulted run's ({device})")
    return launches, zmax


def slice_dense(prob, tmp, device, fused_step=True, nruns=2048):
    """SpectralFit.run() on the full-size dense problem with use_pallas
    left to auto-select: through K3 (fused_step) or the general gather
    path. Returns the launch counts of the run."""
    import numpy as np
    import cha1_mcmc_tpu_torch as port
    from tests.port_problems import (DENSE_BOUNDS, DENSE_CENTER, DENSE_DISH,
                                     DENSE_NAME, DENSE_SOURCE_SIZE)

    ncol = prob["truth"][0]
    zero_launches()
    fit = port.SpectralFit(port.FitConfig(
        mol_name=DENSE_NAME, cat_folder=prob["cat_folder"], data_path=prob["data_path"],
        fit_folder=os.path.join(tmp, "dense" if fused_step else "dense_general"),
        nwalkers=W, nruns=nruns, checkpoint_every=1024, seed=11, device="cuda",
        lower_limit=prob["ll"], upper_limit=prob["ul"], dish_size=DENSE_DISH,
        aligned_velocity=DENSE_CENTER, fixed_source_size=DENSE_SOURCE_SIZE,
        bounds=dict(DENSE_BOUNDS),
        template_means=(DENSE_SOURCE_SIZE, 1.2 * ncol, 8.0, DENSE_CENTER, 0.7575),
        template_stds=(6.5, 0.5 * ncol, 3.0, 0.06, 0.22), use_fused_step=fused_step))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):   # the reduction logs ~4,500 lines
        chain = fit.run()
    launches = read_launches()
    for ln in log.getvalue().splitlines():
        if any(w in ln for w in ("Dense catalog", "MLE", "Sampler", "Acceptance")):
            print(f"    {ln.strip()}")
    kind = port.FusedEnsembleSampler if fused_step else port.EnsembleSampler
    assert type(fit.sampler) is kind, type(fit.sampler)
    assert fit.config.use_pallas is None
    if fused_step:
        assert launches["gather_steps"] > 0 and launches["gather_lnprob"] > 0, launches
    else:
        assert not any(launches.values()), launches
    assert chain.shape == (W, nruns, 4), chain.shape
    assert np.isfinite(chain).all()
    acc = fit.sampler.acceptance_fraction
    assert 0.1 < acc < 0.9, acc
    rate = fit.throughput.walker_steps_per_sec
    phase(5, "slice", f"SpectralFit.run() dense, use_fused_step={fused_step}: "
          f"{type(fit.sampler).__name__}, launches {launches}, chain {chain.shape}, "
          f"acceptance {acc:.3f}, {rate:,.0f} walker-steps/s (sampling wall time "
          f"incl. checkpoints; {device})")
    if fused_step:
        med = np.median(chain[:, chain.shape[1] // 5:, :].reshape(-1, 4), axis=0)
        phase(5, "slice", "posterior medians vs injected truth: " + ", ".join(
            f"{lbl} {m:.4g} ({t:.4g})" for lbl, m, t in
            zip(("Ncol", "Tex", "vlsr", "dV"), med, prob["truth"])))
    return launches


def slice_opacity(case, gen):
    """build_lnprob_batched(..., pallas_kernel="csr" / "block") on the
    full-size dense problem, as a user calls it: each over W in-box
    thetas through K4b / K4a, against the "gather" formulation (rtol
    2e-5, as the lnprob checks). Returns the launch counts of the calls."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.inference import (build_lnprob_batched,
                                               single_component_lnprior)

    label, m32, m64, spec, bounds, means, stds, grid, _ = case
    prior = single_component_lnprior(spec, bounds, means, stds, dtype=torch.float32)
    th = dense_thetas(W, spec.ndim, means[spec.ndim - 4] / 1.2, gen).to(torch.float32)
    kw = dict(use_pallas=True, dv_max=DENSE_DV_MAX, dv_min=bounds["dV"][0],
              vlsr_bounds=bounds["vlsr"])
    ref = build_lnprob_batched(m32, spec, grid.ints, grid.yerrs, prior, **kw)(th)
    ref = ref.cpu().numpy()
    scale = 2e-5 * abs(0.5 * float(np.log(1.0 / np.asarray(grid.yerrs) ** 2).sum()))
    zero_launches()
    for kernel in ("csr", "block"):
        got = build_lnprob_batched(m32, spec, grid.ints, grid.yerrs, prior,
                                   pallas_kernel=kernel, **kw)(th).cpu().numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(ref)), kernel
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=2e-5, atol=scale,
                                   err_msg=f"pallas_kernel={kernel!r}")
    launches = read_launches()
    assert launches["opacity_csr"] > 0 and launches["opacity_block"] > 0, launches
    phase(5, "slice", f"build_lnprob_batched(pallas_kernel='csr' / 'block') on the "
          f"dense problem, {W} thetas: match 'gather' (rtol 2e-5); launches "
          f"{launches}")
    return {k: launches[k] for k in ("opacity_csr", "opacity_block")}


# -- K5: the sharded half-step kernels at world size 1 -------------------------

#: The world-1 mesh (make_mesh(1, 1): an NCCL group of one rank), set in main.
MESH = None


def k5_cases(flagship, gotham, dense_case):
    """The three K5 cases, each {name, label, kernel, plain, args32, args64,
    step, lnprob, pos0, work}: K5a on the flagship's analytic 4-dim case
    beside K1, K5c on the GOTHAM K=4 analytic case beside K2, K5b on the
    dense Chebyshev split-table case beside K3. `args*` are the wrappers'
    trailing (tables, statics) per dtype, `step` the whole-step kernel
    over the same args, `lnprob` the plain lnprob for the entry lnp, and
    `work` the (special-function results, flops, bytes) of one half-step
    call: K1's, K2's and K3's work for half the walkers plus their
    per-call constants (k1_work, k2_work, k3_work)."""
    import torch
    from cha1_mcmc_tpu_torch.parallel import sharded_fused as sf
    from cha1_mcmc_tpu_torch.sampler.fused import fused_lnprob_plain, fused_step_block
    from cha1_mcmc_tpu_torch.sampler.fused_multi import (multi_lnprob_plain,
                                                         multi_step_block)

    label = flagship[0]
    t1 = [x[::-1] for x in flagship_tables(flagship)]
    pos1 = flagship_pos0(flagship[3].ndim)
    k1w = k1_work(t1[0][0], t1[0][1], pos1[:, -1].to(torch.float32), evaluations=0.5)

    glabel, g32, g64, gspec, means, stds, pert, ggrid = gotham
    t2 = [tuple(x)[::-1] for x in multi_tables(g32, g64, gspec, means, stds, ggrid)]
    pos2 = multi_pos0(means, pert)
    k2w = k2_work(t2[0][0], gspec.ncomp, pos2[:, -1].to(torch.float32), t2[0][1].mask_center,
                  evaluations=0.5)

    fns, (st3, tb3), (st3d, tb3d), plans = dense_tables(dense_case)
    pos3 = dense_pos0(dense_case)
    k3w = k3_work(plans[torch.float32], tb3, st3, pos3[:, -1].to(torch.float32),
                  evaluations=0.5)
    return [
        dict(name="sharded_half", label=f"K5a flagship {label}", kernel=sf.sharded_half,
             plain=sf.sharded_half_plain, args32=t1[0], args64=t1[1],
             step=fused_step_block, lnprob=fused_lnprob_plain, pos0=pos1,
             work=k1w, n_f32=1024, whole="K1"),
        dict(name="sharded_multi_half", label=f"K5c GOTHAM {glabel}",
             kernel=sf.sharded_multi_half, plain=sf.sharded_multi_half_plain,
             args32=t2[0], args64=t2[1], step=multi_step_block, lnprob=multi_lnprob_plain,
             pos0=pos2, work=k2w, n_f32=512, whole="K2"),
        dict(name="sharded_gather_half", label=f"K5b dense {dense_case[0]}",
             kernel=by_dtype(sf.sharded_gather_half, plans),
             plain=by_dtype(sf.sharded_gather_half_plain, plans), args32=(tb3, st3),
             args64=(tb3d, st3d), step=fns[2], lnprob=fns[1], pos0=pos3,
             work=k3w,
             n_f32=1024, whole="K3")]


def run_k5(half, args, pos0, lnp0, rnd):
    """The world-1 sharded runner over len(rnd[0]) steps with `half` (a K5
    wrapper or its plain version) as its half-update: (chain, lnps,
    accepted, (pos, lnp))."""
    from cha1_mcmc_tpu_torch.parallel.sharded import ShardedRunner

    runner = ShardedRunner(MESH, rnd[0].shape[0], pos0.dtype, None,
                           lambda s, *ops: (s, half(s, *ops, *args)))
    return runner(pos0, lnp0=lnp0, randomness=rnd)


def check_sharded(case, gen, errs):
    """K5 against its plain version on the card, at world size 1: the f64
    64-step chains bitwise (lnps rtol 1e-12) and equal to the whole-step
    kernel's (K1 / K2 / K3) on the same randomness and lnp0, where the
    sharded split degenerates to the single-device one; the f32 lnprob of
    one half-step whose every finite proposal is accepted (acc_u = 0),
    rtol 2e-5; the f32 acceptance within 0.02 over case['n_f32'] steps.
    Returns the f32 acceptance fractions."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    label, kernel, plain = case["label"], case["kernel"], case["plain"]
    (tb64, st64), (tb32, st32) = case["args64"], case["args32"]
    pos0 = case["pos0"]
    D, h = pos0.shape[1], W // 2
    lnp0 = case["lnprob"](pos0, tb64, st64)
    rnd = draw_randomness(64, W, gen, device=DEVICE, dtype=torch.float64)
    ck, lk, ak, _ = (t.cpu().numpy() if i < 3 else t for i, t in
                     enumerate(run_k5(kernel, case["args64"], pos0, lnp0, rnd)))
    cp, lp, ap, _ = (t.cpu().numpy() if i < 3 else t for i, t in
                     enumerate(run_k5(plain, case["args64"], pos0, lnp0, rnd)))
    assert np.array_equal(ck, cp), f"{label}: f64 chains differ"
    assert np.array_equal(ak, ap), f"{label}: f64 acceptances differ"
    assert np.array_equal(np.isfinite(lk), np.isfinite(lp)), label
    fin = np.isfinite(lp)
    np.testing.assert_allclose(lk[fin], lp[fin], rtol=1e-12, err_msg=f"{label} f64 lnps")
    errs[case["name"]] = float(np.max(np.abs(lk[fin] - lp[fin])))
    cw, lw, aw = (t.cpu().numpy() for t in
                  run_blocks(case["step"], pos0, lnp0, rnd, tb64, st64))
    assert np.array_equal(ck.reshape(-1, D), cw), \
        f"{label}: f64 chain differs from {case['whole']}'s at world size 1"
    assert np.array_equal(ak, aw), f"{label}: acceptances differ from {case['whole']}'s"

    # f32 lnprob through one half-step that accepts every finite proposal
    pos32 = pos0.to(torch.float32)
    lnp32 = case["lnprob"](pos32, tb32, st32)
    perms, z_u, pair, _ = draw_randomness(1, W, gen, device=DEVICE, dtype=torch.float32)
    ops = (perms[0, :h].to(torch.int32).contiguous(), pos32[perms[0, h:]].contiguous(),
           z_u[0, 0].contiguous(), pair[0, 0].to(torch.int32).contiguous(),
           torch.zeros(h, dtype=torch.float32, device=DEVICE))
    state0 = torch.cat([pos32, lnp32[:, None]], dim=1).contiguous()
    sk, sp = state0.clone(), state0.clone()
    kernel(sk, *ops, tb32, st32)
    plain(sp, *ops, tb32, st32)
    k, p = sk[ops[0].long(), D].cpu().numpy(), sp[ops[0].long(), D].cpu().numpy()
    assert np.array_equal(np.isfinite(k), np.isfinite(p)), label
    assert np.isfinite(p).mean() > 0.9, f"{label}: proposals should be in the prior"
    scale = 2e-5 * abs(0.5 * float(torch.log(tb32[-2][2]).sum()))
    fin = np.isfinite(p)
    np.testing.assert_allclose(k[fin], p[fin], rtol=2e-5, atol=scale,
                               err_msg=f"{label} f32 lnprob")

    # f32 acceptance over n_f32 steps
    rnd = draw_randomness(case["n_f32"], W, gen, device=DEVICE, dtype=torch.float32)
    fracs = {}
    for name, fn in (("kernel", kernel), ("plain", plain)):
        c, _, acc, _ = run_k5(fn, case["args32"], pos32, lnp32, rnd)
        fracs[name] = float(acc.sum()) / (case["n_f32"] * W)
        assert bool(torch.isfinite(c[-1]).all()), f"{label}: non-finite f32 {name} walkers"
    assert abs(fracs["kernel"] - fracs["plain"]) < 0.02, (label, fracs)
    return fracs


def time_sharded(case, gen, device):
    """Phase 4 for one K5: the wrapper per half-step call (kernel and
    plain, time_calls) at W walkers in f32, and the world-1 sharded runner
    per ensemble step (2 index_selects, 2 all_gathers and 2 K5 calls a
    step), median and quartiles of 10 runs of 64 steps. Returns ({kernel,
    plain: (median, q1, q3) ms per call}, runner (median, q1, q3) us per
    step)."""
    import torch
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness

    tb32, st32 = case["args32"]
    pos32 = case["pos0"].to(torch.float32)
    lnp32 = case["lnprob"](pos32, tb32, st32)
    h = W // 2
    perms, z_u, pair, acc_u = draw_randomness(1, W, gen, device=DEVICE,
                                              dtype=torch.float32)
    ops = (perms[0, :h].to(torch.int32).contiguous(), pos32[perms[0, h:]].contiguous(),
           z_u[0, 0].contiguous(), pair[0, 0].to(torch.int32).contiguous(),
           acc_u[0, 0].contiguous())
    state0 = torch.cat([pos32, lnp32[:, None]], dim=1).contiguous()
    states = {"kernel": state0.clone(), "plain": state0.clone()}
    calls = {name: (lambda f=fn, s=states[name]: f(s, *ops, tb32, st32))
             for name, fn in (("kernel", case["kernel"]), ("plain", case["plain"]))}
    per_call = time_calls(calls, reps=20)

    rnd = draw_randomness(64, W, gen, device=DEVICE, dtype=torch.float32)
    run_k5(case["kernel"], case["args32"], pos32, lnp32, rnd)   # warm-up
    runs = [1e3 * event_ms(lambda: run_k5(case["kernel"], case["args32"], pos32, lnp32,
                                          rnd)) / 64 for _ in range(2 * TIMING_PAIRS)]
    return per_call, quartiles(runs)


#: The sharded fits' lengths (two checkpoint blocks each) and the golden
#: each is held to: K5 entry -> (problem, steps); the steps are 1.26-2.5x
#: 70 x the golden's tau_max (the runner takes 0.9-1.5 ms a step).
SHARDED_POSTERIOR = {"sharded_half": ("flagship", 20_480),
                     "sharded_multi_half": ("gotham", 49_152),
                     "sharded_gather_half": ("dense", 8_192)}


def slice_sharded(case, model, spec, grid, lnprior, bounds, means, stds, dv_max,
                  use_pallas, tmp, device):
    """make_sharded_sampler(n_devices=1, use_fused=True) and
    ShardedEnsembleSampler.run_mcmc with a chain file in two checkpoint
    blocks, through the case's K5 at W walkers in f32, for
    SHARDED_POSTERIOR's steps; the chain held to its problem's JAX golden
    (gate_posterior). Returns (the launch counts of the run, max |z|)."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.parallel import make_sharded_sampler

    zero_launches()
    sampler = make_sharded_sampler(
        n_devices=1, n_line_shards=1, nwalkers=W, ndim=spec.ndim, a=2.0,
        dtype=torch.float32, model=model, spec=spec, grid_ints=grid.ints,
        grid_yerrs=grid.yerrs, lnprior_fn=lnprior, use_pallas=use_pallas, dv_max=dv_max,
        use_fused=True, bounds=bounds, prior_means=means, prior_stds=stds)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    chain_file = os.path.join(tmp, f"{case['name']}.npy")
    name, nruns = SHARDED_POSTERIOR[case["name"]]
    t0 = time.perf_counter()
    sampler.run_mcmc(case["pos0"].to(torch.float32), nruns, gen,
                     checkpoint_every=nruns // 2, chain_file=chain_file)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    assert launches[case["name"]] == 2 * nruns, (case["name"], launches)
    chain = sampler.chain
    assert chain.shape == (W, nruns, spec.ndim), chain.shape
    assert np.isfinite(chain).all(), case["label"]
    acc = sampler.acceptance_fraction
    assert 0.1 < acc < 0.9, (case["label"], acc)
    assert np.array_equal(np.load(chain_file), chain)
    assert os.path.exists(chain_file[:-4] + ".state.npz")
    phase(5, "slice", f"{case['label']}: make_sharded_sampler(n_devices=1) -> "
          f"ShardedEnsembleSampler.run_mcmc, launches {launches}, chain {chain.shape}, "
          f"acceptance {acc:.3f}, {W * nruns / secs:,.0f} walker-steps/s (wall time "
          f"incl. checkpoints; {device})")
    zmax = gate_posterior(case["label"].split(" ")[0] + f" {name}", name, chain,
                          spec.labels, nruns, secs, device, phase_no=5)
    return launches, zmax


# -- T3: the construct probe -----------------------------------------------------

def check_probe(errs):
    """T3 against its plain version on the card: the band sums A-F bitwise
    (the same float32 additions in the same order), G (exp2 / where) rtol
    1e-6; a call into a given packed output (out=) bitwise equal to a
    fresh call, its values views of that one buffer."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    inputs = t3.probe_inputs(DEVICE, seed=5)
    k, p = t3.probes(*inputs), t3.probes_plain(*inputs)
    for name in "ABCDEF":
        assert np.array_equal(k[name].cpu().numpy(), p[name].cpu().numpy()), name
    np.testing.assert_allclose(k["G"].cpu().numpy(), p["G"].cpu().numpy(), rtol=1e-6,
                               err_msg="T3 probe G")
    out = t3.empty_outputs(DEVICE)
    packed = t3.probes(*inputs, out=out)
    for name in t3.PROBES:
        assert torch.equal(packed[name], k[name]), f"T3 out= {name}"
        assert packed[name].untyped_storage().data_ptr() == out.data_ptr(), name
    errs["construct_probe"] = max(float((k[n] - p[n]).abs().max()) for n in "ABCDEFG")
    return inputs


def time_probe(inputs, device):
    """T3 per launch of the seven probes, in one set of turns
    (time_calls): into a packed output made once (the timed loop
    allocates nothing), with a fresh output a call, the library's empty
    kernel through the same host path (the floor), and the plain version;
    then the kernel's and the empty kernel's device time (torch.profiler
    kernel events, device_ms). Returns ({name: (median, q1, q3) ms},
    {name: device ms})."""
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    out = t3.empty_outputs(DEVICE)
    t = time_calls({"kernel": lambda: t3.probes(*inputs, out=out),
                    "fresh": lambda: t3.probes(*inputs),
                    "empty": lambda: t3.empty_launch(*inputs, out=out),
                    "plain": lambda: t3.probes_plain(*inputs)})
    dev = {"kernel": device_ms(lambda: t3.probes(*inputs, out=out), "probe_kernel"),
           "empty": device_ms(lambda: t3.empty_launch(*inputs, out=out), "t3_empty_kernel")}
    b_ms, b_by = bound(*probe_work())
    phase(4, "time", "T3 one launch of the seven probes, median [q1, q3] of {} runs of 20 "
          "(host time included): kernel into a packed output {:.2f} [{:.2f}, {:.2f}] us, "
          "with a fresh output {:.2f} us; the empty kernel through the same path (the "
          "floor) {:.2f} [{:.2f}, {:.2f}] us: {:.2f}x the floor; plain torch {:.2f} us. "
          "Device time (torch.profiler): kernel {:.2f} us, empty {:.2f} us; bound {:.4f} us "
          "({}); {}".format(
              2 * TIMING_PAIRS, *(x * 1e3 for x in t["kernel"]), t["fresh"][0] * 1e3,
              *(x * 1e3 for x in t["empty"]), t["kernel"][0] / t["empty"][0],
              t["plain"][0] * 1e3, dev["kernel"] * 1e3, dev["empty"] * 1e3, b_ms * 1e3,
              b_by, device))
    return t, dev


def slice_probe(device):
    """The probe tool as a user runs it (run_probes on the card): every
    probe OK against the float64 reference; returns the launch counts."""
    from cha1_mcmc_tpu_torch.utils import construct_probe as t3

    zero_launches()
    ok = t3.run_probes(DEVICE)
    launches = read_launches()
    assert all(ok.values()), ok
    assert launches["construct_probe"] == 1, launches
    phase(5, "slice", f"T3 run_probes: {', '.join(f'{k} OK' for k in ok)}; launches "
          f"{launches['construct_probe']} ({device})")
    return launches


# -- 6: the toolkit: native tokenizer, command line, grid chi^2, Metropolis -------

#: Steps of each command-line fit: phase 5's first checkpoint block, so a
#: CLI chain equals the first block of the in-process fit's chain bitwise.
CLI_STEPS = 1024
#: The independent engine's schedule (tests/test_convergence.py:335-345):
#: 8 warm-up rounds of 128 steps, then 2,400 frozen steps (the dense run).
MH_ROUNDS, MH_ROUND_LEN, MH_STEPS = 8, 128, 2400
#: The flagship gate's frozen steps: 4 x 2,400. The synthetic Ncol marginal
#: has a heavy upper tail that the frozen diagonal random walk reaches
#: slowly, so its Ncol std at 2,400 steps falls short of the posterior's
#: (the grid integral, slice_metropolis) and grows toward it with the run's
#: length; the std ratio at each prefix is printed.
MH_GATE_STEPS = 4 * MH_STEPS
#: The posterior integrated over a grid (Ncol x Tex x vlsr x dV points, f64
#: on the card), the gate's third witness.
POSTERIOR_GRID = (128, 96, 24, 24)


def check_native(prob_d, device):
    """The native SPCAT tokenizer, built from the port's copy of the
    source: its fields on the full dense catalog equal the Python
    tokenizer's bitwise; prints both times."""
    import numpy as np
    from cha1_mcmc_tpu_torch.catalogs import native, spcat

    t0 = time.perf_counter()
    lib = native.build_native()             # raises where g++ fails
    build_s = time.perf_counter() - t0
    assert native.native_available(), "the native tokenizer does not load"
    with open(prob_d["cat_path"], "rb") as fh:
        raw = fh.read()
    t0 = time.perf_counter()
    nat = native.tokenize_native(raw)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = spcat._tokenize_python([ln for ln in raw.decode().splitlines() if ln.strip()])
    t_py = time.perf_counter() - t0
    assert nat.keys() == py.keys()
    for k in nat:
        assert nat[k].dtype == py[k].dtype, k
        np.testing.assert_array_equal(nat[k], py[k], err_msg=k)
    phase(6, "toolkit", f"native SPCAT tokenizer ({os.path.basename(lib)}, g++ "
          f"{' '.join(native.CXX_FLAGS)}, {build_s:.2f} s to build or load): the full "
          f"dense catalog, {nat['frequency'].size:,} lines, fields bitwise equal to the "
          f"Python tokenizer's; native {t_nat * 1e3:.2f} ms, Python {t_py * 1e3:.2f} ms "
          f"(host; {device})")


def run_cli(tmp, name, *args, config=None):
    """`python -m cha1_mcmc_tpu_torch <args>` in a subprocess from the
    repository root (config: written to tmp/cli/<name>.json and passed as
    --config); raises unless it exits 0. Returns (stdout, seconds)."""
    folder = os.path.join(tmp, "cli")
    os.makedirs(folder, exist_ok=True)
    if config is not None:
        path = os.path.join(folder, f"{name}.json")
        with open(path, "w") as fh:
            json.dump(config, fh)
        args = (*args, "--config", path)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "cha1_mcmc_tpu_torch", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"python -m cha1_mcmc_tpu_torch {' '.join(args)} exited "
                           f"{out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t0


def check_cli_fit(mol_dir, ref_dir, chain_name, ref_launches, ref_steps):
    """One CLI fit's folder against the in-process fit's: the same files,
    the chain equal to the first CLI_STEPS steps of the in-process chain,
    and the kernel launches its throughput.json reports equal to the
    in-process fit's, scaled to its steps. Returns throughput.json."""
    import numpy as np

    assert sorted(os.listdir(mol_dir)) == sorted(os.listdir(ref_dir)), (
        os.listdir(mol_dir), os.listdir(ref_dir))
    chain = np.load(os.path.join(mol_dir, chain_name))
    ref = np.load(os.path.join(ref_dir, chain_name))
    assert chain.shape == (W, CLI_STEPS, ref.shape[2]), chain.shape
    np.testing.assert_array_equal(chain, ref[:, :CLI_STEPS])
    with open(os.path.join(mol_dir, "throughput.json")) as fh:
        tp = json.load(fh)
    assert tp["sampler"] == "FusedEnsembleSampler", tp["sampler"]
    want = {k: (v * CLI_STEPS // ref_steps if k.endswith("_steps") else v)
            for k, v in ref_launches.items() if v}
    assert tp["launches"] == want, (tp["launches"], want)
    return tp


def slice_cli(prob, prob9, tmp, device, k1_launches, k2_launches):
    """Phase 6: the command line on the card, each in a subprocess: `fit`
    on the flagship, `fit --all-molecules` over two copies of it, `multifit`
    on GOTHAM, each 128 walkers x CLI_STEPS steps, held to phase 5's
    in-process fits (k1_launches / k2_launches: their launch counts over
    4096 steps); then `diagnose` on the fit's chain. Returns the CLI
    fits' launches (entry -> count, summed over the runs)."""
    import shutil
    import numpy as np

    common = dict(nwalkers=W, nruns=CLI_STEPS, checkpoint_every=CLI_STEPS, seed=0,
                  device="cuda")
    fit_cfg = dict(mol_name="hc5n_hfs", cat_folder=prob["cat_folder"],
                   data_path=prob["data_path"], fit_folder=os.path.join(tmp, "cli", "fit"),
                   **common)
    _, secs = run_cli(tmp, "fit", "fit", config=fit_cfg)
    fit_dir = os.path.join(fit_cfg["fit_folder"], "hc5n_hfs")
    tp = check_cli_fit(fit_dir, os.path.join(tmp, "fit", "hc5n_hfs"), "chain_template.npy",
                       k1_launches, 4096)
    totals = dict(tp["launches"])
    phase(6, "toolkit", f"CLI fit: exit 0 in {secs:.1f} s (process included), "
          f"{tp['walker_steps_per_sec']:,.0f} walker-steps/s (its throughput.json; set-up "
          f"{tp['setup_s'] * 1e3:.2f} ms apart), launches "
          f"{tp['launches']} vs the in-process fit's {k1_launches} for 4096 steps; chain "
          f"{W} x {CLI_STEPS} x 4 bitwise equal to the in-process fit's first {CLI_STEPS} "
          f"steps, the same files ({device})")

    cat_folder = os.path.join(tmp, "cli", "catalog")
    os.makedirs(cat_folder, exist_ok=True)
    for mol in ("hc5n_hfs", "hc5n_hfs_copy"):
        shutil.copy(prob["cat_path"], os.path.join(cat_folder, f"{mol}.cat"))
    batch_cfg = dict(fit_cfg, cat_folder=cat_folder, fit_folder=os.path.join(tmp, "cli", "batch"),
                     data_paths={"hc5n_hfs": prob["data_path"],
                                 "hc5n_hfs_copy": prob["data_path"]})
    _, secs = run_cli(tmp, "batch", "fit", "--all-molecules", config=batch_cfg)
    rates = []
    for mol in ("hc5n_hfs", "hc5n_hfs_copy"):
        mol_dir = os.path.join(batch_cfg["fit_folder"], mol)
        files = sorted(f.replace(mol, "hc5n_hfs") for f in os.listdir(mol_dir))
        assert files == sorted(os.listdir(fit_dir)), (files, os.listdir(fit_dir))
        np.testing.assert_array_equal(np.load(os.path.join(mol_dir, "chain_template.npy")),
                                      np.load(os.path.join(fit_dir, "chain_template.npy")))
        with open(os.path.join(mol_dir, "throughput.json")) as fh:
            btp = json.load(fh)
        assert btp["launches"] == tp["launches"], btp["launches"]
        rates.append((btp["walker_steps_per_sec"], btp["setup_s"]))
        for k, v in btp["launches"].items():
            totals[k] += v
    phase(6, "toolkit", f"CLI fit --all-molecules (two copies of the flagship): exit 0 in "
          f"{secs:.1f} s, {rates[0][0]:,.0f} / {rates[1][0]:,.0f} walker-steps/s (set-up "
          f"{rates[0][1] * 1e3:.2f} / {rates[1][1] * 1e3:.2f} ms apart), launches "
          f"{tp['launches']} each; both chains bitwise equal to the CLI fit's ({device})")

    multi_cfg = dict(mol_name="hc9n_hfs", template_run=True, cat_folder=prob9["cat_folder"],
                     data_path=prob9["data_path"], fit_folder=os.path.join(tmp, "cli", "gotham"),
                     **common)
    _, secs = run_cli(tmp, "multifit", "multifit", config=multi_cfg)
    mtp = check_cli_fit(os.path.join(multi_cfg["fit_folder"], "hc9n_hfs"),
                        os.path.join(tmp, "gotham", "hc9n_hfs"), "chain.npy", k2_launches,
                        4096)
    totals.update(mtp["launches"])
    phase(6, "toolkit", f"CLI multifit: exit 0 in {secs:.1f} s, "
          f"{mtp['walker_steps_per_sec']:,.0f} walker-steps/s (set-up {mtp['setup_s'] * 1e3:.2f} "
          f"ms apart), launches {mtp['launches']} vs "
          f"the in-process fit's {k2_launches} for 4096 steps; chain {W} x {CLI_STEPS} x 14 "
          f"bitwise equal to the in-process fit's first {CLI_STEPS} steps ({device})")

    out, secs = run_cli(tmp, "diagnose", "diagnose",
                        os.path.join(fit_dir, "chain_template.npy"))
    assert "R-hat" in out and "converged" in out, out
    phase(6, "toolkit", f"CLI diagnose on the fit's chain: exit 0 in {secs:.1f} s:")
    for ln in out.strip().splitlines():
        print(f"    {ln}")
    return totals


def cpu_copy(model):
    """The same SpectralModel with its buffers on the CPU."""
    import copy

    return copy.deepcopy(model).cpu()


def slice_grid_chi2(case, ref_chain, device):
    """Phase 6: grid_chi2 over a 16 x 16 x 64 x 64 (1,048,576-point) grid
    around the injected truth, f32 on the card in batches of 65,536: the
    minimum near the truth in vlsr and dV and inside the K1 posterior's box
    in Ncol and Tex, and the f64 scan's minimum; a 625-point sub-grid in
    f64 on the card equal to the CPU's to 1e-12 relative. Returns the
    points/s of the timed call."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.analysis import grid_chi2
    from tests.port_problems import TRUTH

    label, m32, m64, spec, cfg, grid = case
    truth = np.asarray(TRUTH)
    # Tex inside the prior's box (3.5, 12): the chi^2 falls toward high Tex
    # along the Ncol-Tex degeneracy, and the box's edge is outside the posterior
    grids = {"Ncol": truth[0] * np.linspace(0.5, 1.5, 16), "Tex": np.linspace(4.0, 11.5, 16),
             "vlsr": truth[2] + np.linspace(-0.16, 0.16, 64),
             "dV": truth[3] + np.linspace(-0.32, 0.32, 64)}
    args = (spec, grid.ints, grid.yerrs)
    grid_chi2(m32, *args, {k: v[:4] for k, v in grids.items()})       # warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thetas, chi2, best = grid_chi2(m32, *args, grids, batch=65536)
    secs = time.perf_counter() - t0
    assert not any(read_launches().values()), read_launches()  # the dense lnlike only
    assert thetas.shape == (1_048_576, 4) and np.isfinite(chi2).all()
    post = ref_chain[:, ref_chain.shape[1] // 4:].reshape(-1, 4).astype(np.float64)
    sd, lo, hi = post.std(0), post.min(0), post.max(0)
    steps = {k: v[1] - v[0] for k, v in grids.items()}
    for i, k in ((2, "vlsr"), (3, "dV")):
        # the noise of the synthetic spectrum moves its chi^2 minimum ~1
        # posterior sigma off the truth: the check allows one grid step or
        # two posterior sigmas, whichever is larger
        assert abs(best[i] - truth[i]) <= max(steps[k], 2 * sd[i]) * (1 + 1e-9), (k, best, sd)
    for i in (0, 1):
        assert lo[i] <= best[i] <= hi[i], (best, lo, hi)
    # the physical check above is a sanity check; grid_chi2's correctness
    # rests on the f64 comparisons: the f32 scan finds the f64 scan's
    # minimum (the same point, or one within 1e-5 relative of its chi^2),
    # and f64 on the card equals the CPU's (below) and JAX's (the tests)
    _, c64, b64 = grid_chi2(m64, *args, grids, batch=65536)
    i32 = int(np.argmin(chi2))
    same = bool(np.array_equal(best, b64))
    gap = float((c64[i32] - c64.min()) / c64.min())
    assert same or gap <= 1e-5, (best, b64, gap)
    sub = {k: v[::len(v) // 5][:5] for k, v in grids.items()}
    _, c_card, b_card = grid_chi2(m64, *args, sub)
    _, c_cpu, b_cpu = grid_chi2(cpu_copy(m64), *args, sub)
    np.testing.assert_allclose(c_card, c_cpu, rtol=1e-12)
    assert np.array_equal(b_card, b_cpu)
    err = float(np.max(np.abs(c_card - c_cpu) / np.abs(c_cpu)))
    rate = thetas.shape[0] / secs
    phase(6, "toolkit", f"grid_chi2 {label}, 16 x 16 x 64 x 64 = {thetas.shape[0]:,} points, "
          f"f32, batches of 65,536: {secs:.3f} s, {rate:,.0f} points/s; minimum at Ncol "
          f"{best[0]:.4g}, Tex {best[1]:.4g}, vlsr {best[2]:.4f}, dV {best[3]:.4f} (truth "
          f"{truth[2]}, {truth[3]}: {abs(best[2] - truth[2]) / steps['vlsr']:.2f} / "
          f"{abs(best[3] - truth[3]) / steps['dV']:.2f} grid steps, "
          f"{abs(best[2] - truth[2]) / sd[2]:.2f} / {abs(best[3] - truth[3]) / sd[3]:.2f} "
          f"K1 posterior sigmas); Ncol, Tex inside the K1 posterior's box; the f64 scan's "
          f"minimum {'the same point' if same else f'{gap:.3e} relative below'}; 625-point "
          f"f64 sub-grid card vs CPU max rel {err:.3e}, same argmin ({device})")
    return rate


def posterior_grid_moments(lnprob, lo, hi, shape=POSTERIOR_GRID, batch=65536):
    """The posterior's marginal means and stds, (4,) each, integrated over
    a grid of `shape` points spaced evenly inside (lo, hi) (f64 thetas
    through `lnprob`, weights exp(lnp - max)); and the probability mass on
    each axis's two outer planes, (4,)."""
    import numpy as np
    import torch

    axes = [np.linspace(a, b, n + 2)[1:-1] for a, b, n in zip(lo, hi, shape)]
    mesh = torch.stack(torch.meshgrid(
        *(torch.as_tensor(a, dtype=torch.float64, device=DEVICE) for a in axes),
        indexing="ij"), -1).reshape(-1, len(shape))
    lnp = torch.cat([lnprob(mesh[i:i + batch]) for i in range(0, mesh.shape[0], batch)])
    w = torch.nan_to_num(torch.exp(lnp - lnp.max()), nan=0.0)
    w = (w / w.sum()).reshape(shape)
    means, stds, edge = [], [], []
    for d, a in enumerate(axes):
        marg = w.sum(tuple(i for i in range(len(shape)) if i != d)).cpu().numpy()
        mu = float((marg * a).sum())
        means.append(mu)
        stds.append(float(np.sqrt((marg * (a - mu) ** 2).sum())))
        edge.append(float(marg[0] + marg[-1]))
    return np.array(means), np.array(stds), np.array(edge)


def slice_metropolis(case, ref_chain, dense_case, device):
    """Phase 6: run_adaptive_metropolis over the flagship (128 chains,
    init_sigma = stds / 10, MH_ROUNDS x MH_ROUND_LEN warm-up steps,
    MH_GATE_STEPS frozen) held to the phase-5 K1 fit's chain with
    tests/test_convergence.py:360-365's checks and tolerances, and both
    engines held to the posterior integrated over a grid (posterior_grid_
    moments) with the same tolerances; then over the full dense problem
    through the K4a block lnprob (MH_STEPS frozen), one K4a launch a
    proposal batch. Returns ({engine: steps/s}, K4a launches)."""
    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch.analysis import run_adaptive_metropolis
    from cha1_mcmc_tpu_torch.inference import (build_lnprob, build_lnprob_batched,
                                               single_component_lnprior)

    def run(lnprob, pos0, stds, seed, nsteps):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain, _, acc = run_adaptive_metropolis(
            lnprob, pos0, gen, nsteps=nsteps, init_sigma=stds / 10,
            warmup_rounds=MH_ROUNDS, round_len=MH_ROUND_LEN, batched=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return chain.cpu().numpy(), acc, read_launches(), secs

    def check(name, s, m):
        """tests/test_convergence.py:360-365: means within 0.15 of s's
        std, stds to rtol 0.25 (relative to m's)."""
        dmean = np.abs(s.mean(0) - m.mean(0)) / s.std(0)
        assert np.all(dmean < 0.15), (name, dmean)
        np.testing.assert_allclose(s.std(0), m.std(0), rtol=0.25, err_msg=name)
        return dmean

    label, m32, m64, spec, cfg, grid = case
    means, stds = np.asarray(cfg.template_means), np.asarray(cfg.template_stds)
    lnprob = build_lnprob(m32, spec, grid.ints, grid.yerrs,
                          single_component_lnprior(spec, cfg.bounds, means, stds))
    rng = np.random.default_rng(11)
    pos0 = torch.as_tensor(means + (stds / 10) * rng.standard_normal((W, 4)),
                           dtype=torch.float32, device=DEVICE)
    mchain, acc, launches, secs = run(lnprob, pos0, stds, 6, MH_GATE_STEPS)
    assert not any(launches.values()), launches
    assert mchain.shape == (MH_GATE_STEPS, W, 4) and np.isfinite(mchain).all()
    assert 0.1 < acc < 0.6, acc
    s = ref_chain[:, ref_chain.shape[1] // 4:].reshape(-1, 4).astype(np.float64)
    m = mchain[600:].reshape(-1, 4).astype(np.float64)
    dmean = check("Metropolis vs K1", s, m)
    rates = {"flagship": (MH_ROUNDS * MH_ROUND_LEN + MH_GATE_STEPS + 1) / secs}
    prefixes = ", ".join(
        f"{n:,} {mchain[600:n, :, 0].astype(np.float64).std() / s.std(0)[0]:.3f}"
        for n in (MH_STEPS, 2 * MH_STEPS, MH_GATE_STEPS))
    phase(6, "toolkit", f"run_adaptive_metropolis {label}, {W} chains, f32, "
          f"{MH_ROUNDS} x {MH_ROUND_LEN} warm-up + {MH_GATE_STEPS} frozen steps: {secs:.2f} s, "
          f"{rates['flagship']:,.0f} steps/s, acceptance {acc:.3f}; against the phase-5 K1 "
          f"chain (after 1024 steps), tests/test_convergence.py:360-365's checks: |mean "
          f"difference| / K1 std {', '.join(f'{x:.3f}' for x in dmean)} (< 0.15), std ratio "
          f"Metropolis / K1 {', '.join(f'{x:.3f}' for x in m.std(0) / s.std(0))} (K1 within "
          f"rtol 0.25 of it); Ncol std ratio after the first n frozen steps: {prefixes} "
          f"({device})")

    # the third witness: the posterior integrated over a grid spanning both
    # chains (10% past their range, inside the prior's box), in f64
    both = np.concatenate([s, m])
    span = both.max(0) - both.min(0)
    box = np.array([cfg.bounds[k] for k in ("Ncol", "Tex", "vlsr", "dV")])
    lo = np.maximum(both.min(0) - 0.1 * span, box[:, 0])
    hi = np.minimum(both.max(0) + 0.1 * span, box[:, 1])
    lnprob64 = build_lnprob(m64, spec, grid.ints, grid.yerrs, single_component_lnprior(
        spec, cfg.bounds, means, stds, dtype=torch.float64))
    t0 = time.perf_counter()
    g_mean, g_std, edge = posterior_grid_moments(lnprob64, lo, hi)
    g_secs = time.perf_counter() - t0
    for name, x in (("K1", s), ("Metropolis", m)):
        dm = np.abs(x.mean(0) - g_mean) / g_std
        assert np.all(dm < 0.15), (name, dm)
        np.testing.assert_allclose(x.std(0), g_std, rtol=0.25, err_msg=name)
    phase(6, "toolkit", f"the posterior on a {' x '.join(map(str, POSTERIOR_GRID))} grid "
          f"(f64, {np.prod(POSTERIOR_GRID):,} points in {g_secs:.2f} s; mass on the outer "
          f"planes {', '.join(f'{x:.1e}' for x in edge)}): std "
          f"{', '.join(f'{x:.5g}' for x in g_std)}; std ratio K1 / grid "
          f"{', '.join(f'{x:.3f}' for x in s.std(0) / g_std)}, Metropolis / grid "
          f"{', '.join(f'{x:.3f}' for x in m.std(0) / g_std)} (rtol 0.25), |mean difference| "
          f"/ grid std K1 {', '.join(f'{x:.3f}' for x in np.abs(s.mean(0) - g_mean) / g_std)}, "
          f"Metropolis {', '.join(f'{x:.3f}' for x in np.abs(m.mean(0) - g_mean) / g_std)} "
          f"(< 0.15) ({device})")

    label, d32, _, dspec, dbounds, dmeans, dstds, dgrid, _ = dense_case
    lnprob = build_lnprob_batched(
        d32, dspec, dgrid.ints, dgrid.yerrs,
        single_component_lnprior(dspec, dbounds, dmeans, dstds),
        use_pallas=True, pallas_kernel="block", dv_max=DENSE_DV_MAX,
        dv_min=dbounds["dV"][0], vlsr_bounds=dbounds["vlsr"])
    dchain, acc, launches, secs = run(lnprob, dense_pos0(dense_case, seed=2).to(torch.float32),
                                      np.asarray(dstds), 7, MH_STEPS)
    n_batches = MH_ROUNDS * MH_ROUND_LEN + MH_STEPS + 1     # + the initial lnprob
    assert launches["opacity_block"] == n_batches, launches
    assert not any(v for k, v in launches.items() if k != "opacity_block"), launches
    assert np.isfinite(dchain).all()
    assert 0.1 < acc < 0.6, acc
    rates["dense"] = n_batches / secs
    phase(6, "toolkit", f"run_adaptive_metropolis dense {label} ({d32.n_lines} lines x "
          f"{d32.n_channels} channels) through the K4a block lnprob, {W} chains, f32: "
          f"{secs:.2f} s, {rates['dense']:,.0f} steps/s, acceptance {acc:.3f}, K4a launches "
          f"{launches['opacity_block']} = one a proposal batch ({device})")
    return rates, launches["opacity_block"]


def slice_workbench(prob_d, tmp, device):
    """Phase 7: the workbench slice (host float64 NumPy, as in the JAX
    package) and the entry-point twins. Drives run_repl with
    tests/workbench_session.py's command script on the synthetic flagship,
    the transcript equal to the JAX golden (tests/golden/
    workbench_transcript.txt, paths as <TMP>) and the saved session's
    arrays at rtol 1e-12 (tests/golden/workbench.npz); the plot commands
    where matplotlib imports, else says so; the gauss-mode session over the
    full dense problem's band at res 0.01 MHz, its stick and rendered
    spectra's length / sum / max / argmax at rtol 1e-12, with run_sim's
    host ms; graft_entry.entry() on the card and dryrun_multichip(1) in the
    world-1 group phase 2 started. The launch counts are zeroed before and
    read after: the slice has no kernel and launches none."""
    import importlib.util

    import numpy as np
    import torch
    from cha1_mcmc_tpu_torch import graft_entry
    from cha1_mcmc_tpu_torch.pipeline.repl import run_repl
    from cha1_mcmc_tpu_torch.pipeline.workbench import Workbench
    from tests import workbench_session as ws
    from tests.port_problems import write_hc5n_problem

    with open(ws.GOLDEN_TRANSCRIPT) as fh:
        golden_text = fh.read()
    golden = dict(np.load(ws.GOLDEN_ARRAYS))
    zero_launches()
    t_all = time.perf_counter()
    folder = os.path.join(tmp, "workbench")
    os.makedirs(folder)
    t0 = time.perf_counter()
    text, arrays = ws.run_flagship(run_repl, Workbench,
                                   write_hc5n_problem(os.path.join(folder, "problem")), folder)
    flagship_s = time.perf_counter() - t0
    if text != golden_text:
        diff = [(a, b) for a, b in zip(text.splitlines(), golden_text.splitlines()) if a != b]
        raise AssertionError(f"workbench transcript differs from the JAX golden: {diff[:3]}")
    faults = ws.compare({k: v for k, v in golden.items() if not k.startswith("dense_")},
                        arrays)
    assert not faults, faults
    phase(7, "workbench", f"run_repl, {len(ws.COMMANDS.splitlines())} commands on the "
          f"flagship ({flagship_s * 1e3:.1f} ms host): transcript equal to the JAX golden "
          f"({len(text.splitlines())} lines), {len(arrays)} arrays at rtol {ws.RTOL:g} "
          f"(matched filter peak {np.nanmax(arrays['mf_response']):.4f} sigma, upper-limit C "
          f"{arrays['C'][0]:.6e}); {device}")
    if importlib.util.find_spec("matplotlib") is None:
        phase(7, "workbench", "matplotlib is not installed: the plot commands were not run")
    else:
        out = io.StringIO()
        run_repl(session=os.path.join(folder, "session"),
                 stdin=io.StringIO("\n".join(ws.PLOTS).format(TMP=folder) + "\nquit\n"),
                 stdout=out)
        assert "error" not in out.getvalue(), out.getvalue()
        pngs = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
        assert len(pngs) == len(ws.PLOTS), pngs
        phase(7, "workbench", f"matplotlib imports: {len(pngs)} plot commands wrote "
              f"{', '.join(pngs)}")

    dense, ms = ws.run_dense(Workbench, prob_d)
    faults = ws.compare({k: v for k, v in golden.items() if k.startswith("dense_")}, dense)
    assert not faults, faults
    n, total, peak, at = dense["dense_gauss_int"]
    phase(7, "workbench", f"dense gauss-mode session, {int(dense['dense_tau'][0]):,} of the "
          f"catalog's lines in ({prob_d['ll']:.0f}, {prob_d['ul']:.0f}] MHz at res 0.01 MHz: "
          f"{int(n):,} rendered points, sum {total:.12e}, max {peak:.12e} at {int(at):,}, "
          f"equal to the JAX golden at rtol {ws.RTOL:g}; run_sim median of 3, host: stick "
          f"{ms['stick']:.2f} ms, gauss {ms['gauss']:.2f} ms; {device}")

    fn, (pos,) = graft_entry.entry()
    with torch.no_grad():
        out = fn(pos)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (128,) and bool(torch.isfinite(out).all()), out
    assert out.device.type == "cuda" and out.dtype == torch.float32
    lines = graft_entry.dryrun_multichip(1)
    assert len(lines) == 1 and lines[0].startswith(
        "dryrun_multichip OK: mesh={'walkers': 1, 'lines': 1}, chain=(1, 4, 4)"), lines
    launches = read_launches()
    assert not any(launches.values()), launches
    phase(7, "workbench", f"graft_entry.entry() on {out.device}: lnprob of {pos.shape[0]} "
          f"walkers, float32, finite; dryrun_multichip(1) in the world-1 group: "
          f"{lines[0]}; kernel launches in phase 7: none; the phase took "
          f"{time.perf_counter() - t_all:.1f} s; {device}")


# -- 8: the posterior gate against the JAX package's goldens ----------------------

#: The posterior phase's fits: problem -> (kernel entry prefix, steps), 128
#: walkers, float32, one checkpoint block. The goldens' tau_max are 215
#: (flagship), 556 (GOTHAM) and ~47 (dense), so each length is 1.7-5x the
#: card's floors (70 tau_max).
POSTERIOR_FITS = {"flagship": ("fused", 65_536), "gotham": ("multi", 65_536),
                  "dense": ("gather", 16_384)}
POSTERIOR_SEED = 13


def gate_posterior(label, name, chain, labels, steps, secs, device, phase_no=8):
    """Hold a card chain (W, S, D) to problem `name`'s golden with
    tests/posterior_gate.py at the card's floors: its burn picked in its
    own tau, floored at the golden's (a card chain is shorter than the
    golden's runs, and a shorter chain's tau estimate runs low), one
    line per parameter (golden, card, SE, z and ok per statistic), ESS,
    tau, steps and seconds; raises if any row fails. Returns the
    largest |z|."""
    from tests import posterior_gate as pg
    from tests.posterior_probe import load_golden

    golden = load_golden(name)
    t0 = time.perf_counter()
    burn = pg.pick_burn(chain, tau_floor=golden["tau"])
    ours = pg.summarize(chain, burn, labels, tau_floor=golden["tau"])
    rows = pg.compare(golden, ours)
    reduce_s = time.perf_counter() - t0
    for d, lbl in enumerate(labels):
        mine = [r for r in rows if r["param"] == lbl and "z" in r]
        phase(phase_no, "posterior", f"{label} {lbl.split(' [')[0]}: " + "; ".join(
            f"{r['stat']} {r['golden']:.5g} / {r['ours']:.5g} se {r['se']:.3g} "
            f"z {r['z']:+.2f}{'' if r['ok'] else ' FAIL'}" for r in mine)
            + f"; ESS {ours['ess'][d]:,.0f} tau {ours['tau'][d]:.1f}")
    bad = pg.failures(rows)
    zmax = pg.max_abs_z(rows)
    phase(phase_no, "posterior", f"{label}: {chain.shape[0]} walkers x {steps} steps, burn "
          f"{burn} ({burn / max(ours['tau']):.1f} tau_max), {steps - burn} after it "
          f"({(steps - burn) / max(ours['tau']):.1f} tau_max; the golden's "
          f"{(golden['S'] - golden['burn']) / max(golden['tau']):.1f}), ESS min "
          f"{min(ours['ess']):,.0f} (golden {min(golden['ess']):,.0f}), max |z| {zmax:.2f} "
          f"of {pg.Z}; sampled in {secs:.2f} s, summarised and compared in "
          f"{reduce_s:.1f} s; {len(bad)} failed rows ({device})")
    if bad:
        raise AssertionError(f"{label}: the posterior differs from the JAX golden:\n"
                             + pg.format_rows(bad))
    return zmax


def slice_posterior(name, tmp, device):
    """Phase 8: the port's fit of problem `name` on the card (K1 flagship
    SpectralFit, K2 GOTHAM MultiComponentFit, K3 dense SpectralFit),
    f32, W walkers x POSTERIOR_FITS steps in one checkpoint block,
    through FusedEnsembleSampler; the problem the golden's: the reduced
    datagrid held to the golden's (posterior_probe.check_datagrid: its
    sha256, or on the dense problem, whose writer's sums differ in the
    last bits from one machine to another, its fingerprint at rtol
    1e-12), and the port's f64 lnprob at the golden's probe thetas equal
    to the JAX package's values there (rtol 1e-12); its chain held to the
    JAX package's f64 golden (gate_posterior). Returns (launches, max
    |z|)."""
    import numpy as np
    import cha1_mcmc_tpu_torch as port
    from cha1_mcmc_tpu_torch.reduce import load_datagrid
    from tests.posterior_probe import (PORT, build_lnprob64, check_datagrid, load_golden,
                                       make_fit, write_problem)

    prefix, steps = POSTERIOR_FITS[name]
    prob = write_problem(name, os.path.join(tmp, f"posterior_{name}"))
    fit = make_fit(PORT, name, prob, os.path.join(tmp, f"posterior_{name}", "fit"),
                   nwalkers=W, nruns=steps, checkpoint_every=steps, seed=POSTERIOR_SEED,
                   device="cuda")
    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    launches = read_launches()
    assert type(fit.sampler) is port.FusedEnsembleSampler, type(fit.sampler)
    assert launches[f"{prefix}_steps"] > 0 and launches[f"{prefix}_lnprob"] > 0, launches
    assert chain.shape == (W, steps, fit.spec.ndim) and np.isfinite(chain).all()
    golden = load_golden(name)
    held = check_datagrid(name, load_datagrid(fit.config.datagrid_path), golden)
    _, lnprob = build_lnprob64(PORT, name, prob, os.path.join(tmp, f"posterior_{name}",
                                                               "probe"))
    want = np.asarray(golden["probe"]["lnprob"])
    rel = float(np.max(np.abs(lnprob(np.asarray(golden["probe"]["thetas"])) / want - 1)))
    assert rel <= 1e-12, f"{name}: f64 lnprob at the golden's probes off by {rel:.3e}"
    phase(8, "posterior", f"{type(fit).__name__}.run() {name}: {type(fit.sampler).__name__}, "
          f"launches { {k: v for k, v in launches.items() if v} }, acceptance "
          f"{fit.sampler.acceptance_fraction:.3f}; the reduced {held}; the port's f64 lnprob "
          f"(CPU) at the golden's {want.size} probe thetas within {rel:.2e} of the JAX "
          f"package's (rtol 1e-12)")
    label = {"fused": "K1", "multi": "K2", "gather": "K3"}[prefix] + f" {name}"
    zmax = gate_posterior(label, name, chain, fit.spec.labels, steps,
                          fit.throughput.elapsed, device)
    return launches, zmax


# -- 9: the benchmark command -------------------------------------------------------

#: The script's time limit; phase 9 gives the bench what is left of it, less
#: BENCH_MARGIN_S, as its CHA1_BENCH_DEADLINE_S.
SMOKE_LIMIT_S, BENCH_MARGIN_S = 1200.0, 90.0
BENCH_SECTIONS = ("baseline", "tpu", "large", "gotham", "dense", "dense_full_fit")
#: The kernel entries each bench section must launch (its "launches"):
#: K1 and the K3 formulation on the flagship, K2, K4b and K3, K3 through
#: SpectralFit.
BENCH_KERNELS = {"tpu": ("fused_steps", "gather_steps"), "gotham": ("multi_steps",),
                 "dense": ("opacity_csr", "gather_steps"),
                 "dense_full_fit": ("gather_steps",)}
#: Each section's error fields that must stay null.
BENCH_ERRORS = {"tpu": ("fused_error", "gather_kernel_error", "unfused_error"),
                "gotham": ("fused_error", "general_error"),
                "dense": ("fused_chain_error", "general_chain_error")}


def slice_bench(tmp, device, deadline_s):
    """Phase 9: `python -m cha1_mcmc_tpu_torch bench` in a subprocess under
    CHA1_BENCH_DEADLINE_S = deadline_s, its chatter and partial artifact
    under `tmp`: every streamed section line and the artifact parsed; every
    section but the baseline ok (the baseline carries bench.py's message for
    a missing reference tree), each section's kernels launched
    (BENCH_KERNELS), its error fields null, the artifact's value K1's
    rate. Returns ({section: line}, artifact, seconds)."""
    phase(9, "bench", f"python -m cha1_mcmc_tpu_torch bench under CHA1_BENCH_DEADLINE_S="
          f"{deadline_s:.0f} (what is left of the script's {SMOKE_LIMIT_S:.0f} s less "
          f"{BENCH_MARGIN_S:.0f})")
    env = dict(os.environ, CHA1_BENCH_DEADLINE_S=f"{deadline_s:.0f}",
               CHA1_BENCH_LOG=os.path.join(tmp, "bench_chatter.log"),
               CHA1_BENCH_PARTIAL=os.path.join(tmp, "bench_partial.json"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cha1_mcmc_tpu_torch", "bench"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=deadline_s + 60)
    secs = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"bench exited {proc.returncode} after {secs:.1f} s:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    sections = {}
    for ln in lines[:-1]:
        entry = json.loads(ln)
        sections[entry.pop("bench_section")] = entry
    art = json.loads(lines[-1])
    assert tuple(sections) == BENCH_SECTIONS, tuple(sections)
    assert not art.get("watchdog_fired"), art
    for name, entry in sections.items():
        if name != "baseline":
            assert entry["ok"], (name, entry.get("error"))
        for key in BENCH_ERRORS.get(name, ()):
            assert entry[key] is None, (name, key, entry[key])
        for kernel in BENCH_KERNELS.get(name, ()):
            assert entry["launches"].get(kernel, 0) > 0, (name, kernel, entry["launches"])
    base = sections["baseline"]
    assert base["ok"] or "reference tree required" in base["error"], base
    tpu = sections["tpu"]
    assert art["value"] == round(tpu["rate"], 1) > 0 and art["fused_error"] is None, art
    assert art["backend_probe"]["card"] == device, art["backend_probe"]
    phase(9, "bench", f"python -m cha1_mcmc_tpu_torch bench: exit 0 in {secs:.1f} s "
          f"(artifact wall_seconds {art['wall_seconds']}), {len(sections)} sections and the "
          f"artifact parsed; baseline: {base.get('error') or base['rate']}; {device}")
    import bench_torch

    dense, fit, gotham = sections["dense"], sections["dense_full_fit"], sections["gotham"]
    gen, mgen = bench_torch.TPU_GENERAL_STEPS, bench_torch.MULTIFIT_GENERAL_STEPS
    sizes = {"tpu": f"{tpu['nwalkers']} walkers x {tpu['steps']} / {4 * tpu['steps']} steps, "
                    f"the general path {gen} / {4 * gen}; {bench_torch.SLOPE_REPS} pairs",
             "large": f"{sections['large']['nwalkers']} walkers, the general path",
             "gotham": f"{gotham['nwalkers']} walkers, {gotham['n_covered']} lines x "
                       f"{gotham['n_channels']} channels, the general path {mgen} / "
                       f"{4 * mgen} steps",
             "dense": f"{dense['nwalkers']} walkers, {dense['n_lines']} lines x "
                      f"{dense['n_channels']} channels",
             "dense_full_fit": f"{fit['nwalkers']} walkers x {fit['nruns']} steps, "
                               f"{fit['n_lines_covered']} lines x {fit['n_channels']} "
                               "channels"}
    rates = {"tpu": f"K1 {tpu['rate']:,.0f} walker-steps/s ({tpu['pct_of_bound']}% of its "
                    f"bound), general {tpu['unfused_rate']:,.0f}, K3 formulation "
                    f"{tpu['gather_kernel_rate']:,.0f}",
             "large": f"{sections['large']['walker_steps_per_sec']:,.0f} walker-steps/s",
             "gotham": f"K2 {gotham['walker_steps_per_sec']:,.0f} walker-steps/s "
                       f"({gotham['us_per_step']} us a step, {gotham['pct_of_bound']}% of "
                       f"its bound), general {gotham['general_us_per_step']} us a step",
             "dense": f"K3 chain {dense['chain_walker_steps_per_sec']:,.0f} walker-steps/s "
                      f"({dense['chain_us_per_step']} us a step), general "
                      f"{dense['general_chain_us_per_step']} us a step; lnprob ms: gather "
                      f"{dense['gather_ms_per_eval']}, csr (K4b) {dense['csr_ms_per_eval']}, "
                      f"torch {dense['torch_ms_per_eval']}",
             "dense_full_fit": f"{fit['sampler']} {fit['walker_steps_per_sec']:,.0f} "
                               f"walker-steps/s, wall {fit['wall_seconds']} s, acceptance "
                               f"{fit['acceptance']}, recovery z max {fit['recovery_z_max']}"}
    for name in BENCH_SECTIONS[1:]:
        entry = sections[name]
        phase(9, "bench", f"{name} ({entry['problem']}; {sizes[name]}): {rates[name]}; "
              f"{entry['seconds']} s; launches {entry['launches']}")
    return sections, art, secs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cha1_mcmc_tpu_torch.sampler.fused_gather import ROWS, resident_ctas
    from tests.port_problems import (write_dense_problem, write_hc5n_problem,
                                     write_hc9n_problem)

    start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    device = card                       # "<name>, <power limit>"
    phase(1, "device", f"{name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build_kernels()
    phase(2, "build", f"K1 + K5a, K2 + K5c, K3 + K5b, K4 and T3 built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for kname, (secs, log) in built.items():
        print(f"    {kname}: {secs:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"    {kname} ptxas: {ln.strip()}")

    global MESH
    import torch.distributed as dist
    from cha1_mcmc_tpu_torch.inference import (ordered_velocity_lnprior,
                                               single_component_lnprior)
    from cha1_mcmc_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    MESH = make_mesh(1, 1)
    phase(2, "build", f"world-1 mesh {MESH.shape} on {MESH.device}: torch.distributed "
          f"backend {dist.get_backend()}, started in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    errs, errs2, errs3, errs4, errs5 = {}, {}, {}, {}, {}
    post_launches, phase5_z = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        prob = write_hc5n_problem(os.path.join(tmp, "problem"))
        prob9 = write_hc9n_problem(os.path.join(tmp, "problem9"))
        prob_w = write_hc9n_problem(os.path.join(tmp, "problem_wide"),
                                    n_multiplets=WIDE_MULTIPLETS)
        prob_d = write_dense_problem(os.path.join(tmp, "dense"), scale="full")
        dense = dense_cases(prob_d)
        m_d = dense[0][1]
        _, (_, tb_d), _, plans = dense_tables(dense[0])
        geom = plans[torch.float32]
        phase(2, "build", f"dense problem: {m_d.n_lines} lines x {m_d.n_channels} "
              f"channels (n_lines x n_channels {m_d.n_lines * m_d.n_channels:,}), "
              f"M1 {tb_d[1].shape[0]}, M2 {tb_d[3].shape[0]} on cb0 {geom.cb0} "
              f"heavy-first channels, {dense[1][1].q_model.g.size} partition states, "
              f"injected Ncol {prob_d['truth'][0]:.4e}")
        for cb in CBLOCKS:
            g = dense_tables(dense[0], cblock=cb)[-1][torch.float32]
            tiles = g.n_blk * -(-W // 2 // ROWS)
            grid = launch_grid_of(g)
            resident = resident_ctas(g, torch.float32, g.lines.device)
            phase(2, "build", f"K3 / K5b launch at {W} walkers, channel blocks of {cb}: "
                  f"one cooperative launch a call, {tiles} tiles a half-step ({g.n_blk} "
                  f"blocks x {-(-W // 2 // ROWS)} groups of {ROWS} proposals) over "
                  f"{grid} CTAs of {cb} threads ({-(-tiles // grid)} rounds; "
                  f"{resident} resident at most), u_max {g.u_max} lines a block, "
                  f"taus in shared memory ({g.tau_smem_bytes(torch.float32)} B f32, "
                  f"{g.tau_smem_bytes(torch.float64)} B f64), 3 grid barriers a "
                  f"half-step; {device}")

        all_cases = cases(prob)
        st1, tb1 = k1_entries(all_cases[0], device)
        cluster_geometry("K1", all_cases[0][0], tb1, st1, device)
        gotham = multi_cases(prob9)
        st2, tb2 = k2_staging(gotham[0])
        cluster_geometry("K2", gotham[0][0], tb2, st2, device)

        for label, m32, m64, spec, cfg, grid in all_cases:
            fracs = check_case(label, m32, m64, spec, cfg, grid, gen, errs)
            phase(3, "check", f"K1 {label}: f32 lnprob ok, f64 64-step chain "
                  f"bitwise, f32 1024-step acceptance kernel "
                  f"{fracs['kernel']:.4f} vs plain {fracs['plain']:.4f}")
        phase(3, "check", f"K1 max |kernel - plain|: f32 lnprob {errs['lnprob']:.3e}, "
              f"f64 step lnps {errs['steps']:.3e} ({device})")
        for case in gotham:
            fracs = check_multi_case(*case, gen, errs2)
            phase(3, "check", f"K2 {case[0]}: f32 lnprob ok, f64 64-step chain "
                  f"bitwise, f32 512-step acceptance kernel "
                  f"{fracs['kernel']:.4f} vs plain {fracs['plain']:.4f}")
        phase(3, "check", f"K2 max |kernel - plain|: f32 lnprob {errs2['lnprob']:.3e}, "
              f"f64 step lnps {errs2['steps']:.3e} ({device})")
        errs_g = {}
        check_geometries(all_cases[0], gotham[0],
                         multi_cases(prob_w, labels=("analytic-4c",))[0], errs_g)
        phase(3, "check", "K1 / K2 max |kernel - plain| f64 step lnps by geometry: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs_g.items()) + f" ({device})")
        errs_c = {}
        occ1 = chain_occupancy("K1", tb1, st1)
        ks1 = check_chains("K1", all_cases[0], errs_c, ks=(1, 2, 3, 4, occ1 + 1))
        occ2 = chain_occupancy("K2", tb2, st2)
        ks2 = check_chains("K2", gotham[0], errs_c, ks=(1, 2, 3, 4, occ2 + 1))
        paths1 = ", ".join(f"K={K} {steps_path('K1', tb1, st1, W, K)}" for K in ks1)
        paths2 = ", ".join(f"K={K} {steps_path('K2', tb2, st2, W, K)}" for K in ks2)
        phase(3, "check", f"K chains of {W} walkers in one launch, 64 steps: K1 "
              f"{all_cases[0][0]} at K = {ks1} ({paths1}), K2 {gotham[0][0]} at K = {ks2} "
              f"({paths2}; "
              "the last past the clusters the card holds at once): each chain bitwise equal "
              "to it launched alone in f32 and f64 and to the plain version in f64 (lnps "
              "rtol 1e-12; max "
              f"|kernel - plain| K1 {errs_c['K1']:.3e}, K2 {errs_c['K2']:.3e}), walker 3 of "
              f"every chain at lnp = -inf every step (F4), one launch a block ({device})")
        for case in dense:
            fracs, g = check_dense_case(case, gen, errs3)
            phase(3, "check", f"K3 {case[0]} ({g.n_blk} blocks, cb0 {g.cb0}): f32 "
                  f"lnprob ok (also vs the batched gather lnprob), f64 64-step chain "
                  f"bitwise, f32 1024-step acceptance kernel {fracs['kernel']:.4f} vs "
                  f"plain {fracs['plain']:.4f}")
        errs_k3 = {}
        for case in dense:
            check_dense_geometries(case, errs_k3)
        phase(3, "check", f"K3 max |kernel - plain|: f32 lnprob {errs3['lnprob']:.3e} "
              f"(vs batched gather {errs3['general']:.3e}), f64 step lnps "
              f"{errs3['steps']:.3e}; by channel block " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs_k3.items()) + f" ({device})")
        empty = check_opacity(dense[0], gen, errs4)
        phase(3, "check", f"K4 max |kernel - plain|: block {errs4['block']:.3e}, csr "
              f"{errs4['csr']:.3e}; up to {empty} channel tiles with no candidate ({device})")
        k5 = k5_cases(all_cases[0], gotham[0], dense[0])
        for case in k5:
            fracs = check_sharded(case, gen, errs5)
            phase(3, "check", f"{case['label']} at world size 1: f64 64-step chain "
                  f"bitwise vs plain and vs {case['whole']}, f32 lnprob ok, f32 "
                  f"{case['n_f32']}-step acceptance kernel {fracs['kernel']:.4f} vs "
                  f"plain {fracs['plain']:.4f}")
        phase(3, "check", "K5 max |kernel - plain| f64 lnps: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs5.items()) + f" ({device})")
        probe_in = check_probe(errs5)
        phase(3, "check", f"T3 probes A-F bitwise, G rtol 1e-6 vs the plain version; max "
              f"|kernel - plain| {errs5['construct_probe']:.3e} ({device})")

        label, m32, m64, spec, cfg, grid = all_cases[0]
        t1, w1, (st1, tb1, pos1) = time_steps(all_cases[0], gen)
        t1 = report_times("K1", t1, f"{m32.n_lines} lines x {m32.n_channels} channels",
                          "64 launches a run", device)
        time_geometries("K1", label, tb1, st1, pos1, gen, device, nb=64)
        m9 = gotham[0][1]
        t2, w2 = time_multi(gotham[0], gen)
        t2 = report_times("K2", t2, f"K=4, {m9.n_lines} lines x {m9.n_channels} channels",
                          "16 launches a run", device)
        time_k2_paths(gotham[0], gen, device)
        tc1 = time_chains("K1", all_cases[0], gen, device)
        tc2 = time_chains("K2", gotham[0], gen, device)
        t3, _, w3, _ = time_dense(dense[0], gen, device)
        t4, d4, w4 = time_opacity(dense[0], gen, device)
        t5 = {}
        for case, whole_us in zip(k5, (t1[0], t2[0], t3[0])):
            per_call, (r_us, r1, r3) = time_sharded(case, gen, device)
            t5[case["name"]] = per_call
            (k_ms, k1, k3), (p_ms, p1, p3) = per_call["kernel"], per_call["plain"]
            phase(4, "time", f"{case['label']}, {W} walkers, f32: one half-step "
                  f"call median [q1, q3] of {2 * TIMING_PAIRS} runs of 20: kernel "
                  f"{k_ms * 1e3:.2f} [{k1 * 1e3:.2f}, {k3 * 1e3:.2f}] us, plain torch "
                  f"{p_ms * 1e3:.2f} [{p1 * 1e3:.2f}, {p3 * 1e3:.2f}] us; the world-1 "
                  f"sharded runner {r_us:.2f} [{r1:.2f}, {r3:.2f}] us/step (2 "
                  f"kernel launches, 2 gathers and 2 NCCL all_gathers a step) vs "
                  f"{case['whole']} {whole_us:.2f} us/step; {device}")

        t5["construct_probe"] = time_probe(probe_in, device)

        launches = slice_flagship(prob, tmp, device, t1)
        k1_fit = dict(launches)
        k2_fit = slice_gotham(prob9, tmp, device, k2_times=t2)
        launches.update((k, v) for k, v in k2_fit.items() if k.startswith("multi"))
        slice_gotham(prob9, tmp, device, fused_step=False, nruns=512)
        chain_launches, phase5_z["K1 4 chains"] = slice_chains(
            "K1", prob, tmp, device, tc1, t1[2], golden="flagship")
        # not held to the GOTHAM golden: the floors need 40,960 steps (70 x
        # its tau_max of 556), whose cumulative checkpoints write ~9 GB at the
        # 50-73 MB/s np.save reaches here (PERF.md §6)
        k2_chains, _ = slice_chains("K2", prob9, tmp, device, tc2, t2[2], steps=1_024)
        chain_launches.update((k, v) for k, v in k2_chains.items() if k.startswith("multi"))
        launches.update((k, v) for k, v in slice_dense(prob_d, tmp, device).items()
                        if k.startswith("gather"))
        slice_dense(prob_d, tmp, device, fused_step=False, nruns=256)
        # the opacity kernels run on the "csr" / "block" formulations of the
        # batched lnprob: drive each once through build_lnprob_batched; K4a's
        # launches are those of the general sharded runner, where a fit
        # reaches it (float64, world size 1)
        launches["opacity_csr"] = slice_opacity(dense[0], gen)["opacity_csr"]
        launches["opacity_block"] = slice_general_sharded(
            dense[0], gen, d4["block-exp2-masked kernel, f64, W/2"], device)["opacity_block"]
        # the sharded path at world size 1, through each K5
        f32 = torch.float32
        _, m32, _, spec, cfg, grid = all_cases[0]
        prior = single_component_lnprior(spec, cfg.bounds, cfg.template_means,
                                         cfg.template_stds, dtype=f32)
        runs = [(m32, spec, grid, prior, cfg.bounds, cfg.template_means,
                 cfg.template_stds, cfg.bounds["dV"][1], False)]
        _, g32, _, gspec, gmeans, gstds, _, ggrid = gotham[0]
        runs.append((g32, gspec, ggrid, ordered_velocity_lnprior(
            gspec, gmeans, gstds, dv_max=DV_BOUND, dtype=f32), None, gmeans, gstds,
            DV_BOUND, False))
        _, d32, _, dspec, dbounds, dmeans, dstds, dgrid, _ = dense[0]
        runs.append((d32, dspec, dgrid, single_component_lnprior(
            dspec, dbounds, dmeans, dstds, dtype=f32), dbounds, dmeans, dstds,
            DENSE_DV_MAX, True))
        for case, run in zip(k5, runs):
            counts, phase5_z[case["label"].split(" ")[0]] = slice_sharded(case, *run, tmp,
                                                                          device)
            launches[case["name"]] = counts[case["name"]]
        launches.update((k, v) for k, v in slice_probe(device).items()
                        if k == "construct_probe")

        import numpy as np
        check_native(prob_d, device)
        cli_launches = slice_cli(prob, prob9, tmp, device, k1_fit, k2_fit)
        k1_chain = np.load(os.path.join(tmp, "fit", "hc5n_hfs", "chain_template.npy"))
        slice_grid_chi2(all_cases[0], k1_chain, device)
        _, mh_k4a = slice_metropolis(all_cases[0], k1_chain, dense[0], device)
        slice_workbench(prob_d, tmp, device)
        posterior = {}
        for pname in POSTERIOR_FITS:
            counts, posterior[pname] = slice_posterior(pname, tmp, device)
            post_launches.update((k, v) for k, v in counts.items() if v)
        phase(8, "posterior", "K1 / K2 / K3 posteriors against the JAX f64 goldens, max "
              "|z| " + ", ".join(f"{k} {v:.2f}" for k, v in posterior.items())
              + "; sharded and 4-chain fits (phase 5) " + ", ".join(
                  f"{k} {v:.2f}" for k, v in phase5_z.items()) + f" ({device})")
        bench, _, _ = slice_bench(tmp, device, SMOKE_LIMIT_S - BENCH_MARGIN_S
                                  - (time.perf_counter() - start))
    dist.destroy_process_group()

    work = {**w1, **w2, **w3, **w4}
    entries = []
    for (k_us, p_us, lk_ms, lp_ms), e, src, (steps_name, steps_tpu), (lnp_name, lnp_tpu) in (
            (t1, errs, CU_SOURCE, ("fused_steps", STEP_KERNEL_TPU),
             ("fused_lnprob", LNPROB_KERNEL_TPU)),
            (t2, errs2, CU_SOURCE_K2, ("multi_steps", STEP_KERNEL_TPU_K2),
             ("multi_lnprob", LNPROB_KERNEL_TPU_K2)),
            (t3, errs3, CU_SOURCE_K3, ("gather_steps", STEP_KERNEL_TPU_K3),
             ("gather_lnprob", LNPROB_KERNEL_TPU_K3))):
        entries += [
            {"name": steps_name, "route": "cuda", "source": src, "replaces": steps_tpu,
             "launches": launches[steps_name], "max_abs_err": e["steps"],
             "ms": k_us * K_STEPS / 1e3, "plain_ms": p_us * K_STEPS / 1e3},
            {"name": lnp_name, "route": "cuda", "source": src, "replaces": lnp_tpu,
             "launches": launches[lnp_name], "max_abs_err": e["lnprob"],
             "ms": lk_ms, "plain_ms": lp_ms}]
    for kname, key, tpu in (("opacity_block", "block-exp2-masked", BLOCK_KERNEL_TPU),
                            ("opacity_csr", "csr-exp2-masked", CSR_KERNEL_TPU)):
        entries.append({"name": kname, "route": "cuda", "source": CU_SOURCE_K4,
                        "replaces": tpu, "launches": launches[kname],
                        "max_abs_err": errs4[kname.split("_")[1]],
                        "ms": t4[f"{key} kernel"][0], "plain_ms": t4[f"{key} plain"][0],
                        "device_ms": d4[f"{key} kernel"]})
    for case in k5:   # per half-step call
        kname = case["name"]
        work[kname] = case["work"]
        entries.append({"name": kname, "route": "cuda",
                        "source": K5_SOURCE[kname], "replaces": K5_TPU[kname],
                        "launches": launches[kname], "max_abs_err": errs5[kname],
                        "ms": t5[kname]["kernel"][0], "plain_ms": t5[kname]["plain"][0]})
    work["construct_probe"] = probe_work()
    t3_calls, t3_device = t5["construct_probe"]
    entries.append({"name": "construct_probe", "route": "cuda", "source": CU_SOURCE_T3,
                    "replaces": PROBE_TPU, "launches": launches["construct_probe"],
                    "max_abs_err": errs5["construct_probe"],
                    "ms": t3_calls["kernel"][0], "plain_ms": t3_calls["plain"][0],
                    "device_ms": t3_device["kernel"], "fresh_output_ms": t3_calls["fresh"][0],
                    "empty_launch_ms": t3_calls["empty"][0],
                    "empty_device_ms": t3_device["empty"]})
    for entry in entries:
        entry["bound_ms"], entry["bound_by"] = bound(*work[entry["name"]])
        entry["library_ms"] = None
    # K1 and K2 on the multi-chain path: its launches, and per launch of K
    # chains (16 steps) the one-launch and sequential times and the bound
    for entry in entries:
        times = {"fused_steps": tc1, "multi_steps": tc2}.get(entry["name"])
        if times is not None:
            entry["multichain_launches"] = chain_launches[entry["name"]]
            entry["chains"] = {str(K): {"ms": a[0] * K_STEPS / 1e3,
                                        "sequential_ms": s[0] * K_STEPS / 1e3,
                                        "bound_ms": b * K_STEPS / 1e3}
                               for K, (a, s, b, _) in times.items()}
    # the toolkit's paths (phase 6): the command-line fits' launches (from
    # their throughput.json) and K4a's on the dense Metropolis run
    for entry in entries:
        if entry["name"] in cli_launches:
            entry["cli_launches"] = cli_launches[entry["name"]]
        if entry["name"] == "opacity_block":
            entry["metropolis_launches"] = mh_k4a
    # the posterior phase's launches (phase 8): its K1 / K2 / K3 fits; the
    # largest |z| of the fits held to the JAX goldens through each entry
    gated = {"fused_steps": posterior["flagship"], "multi_steps": posterior["gotham"],
             "gather_steps": posterior["dense"], "sharded_half": phase5_z["K5a"],
             "sharded_multi_half": phase5_z["K5c"], "sharded_gather_half": phase5_z["K5b"]}
    for entry in entries:
        entry["posterior_launches"] = post_launches.get(entry["name"], 0)
        if entry["name"] in gated:
            entry["posterior_max_abs_z"] = gated[entry["name"]]
    # the bench's launches (phase 9), by kernel entry over its sections
    for entry in entries:
        entry["bench_launches"] = sum(sec["launches"].get(entry["name"], 0)
                                      for sec in bench.values())
    end = time.perf_counter()
    phase(9, "bench", f"all phases passed in {end - start:.1f} s; seconds a phase: "
          + ", ".join(f"{n} {t}" for n, t in phase_seconds(end).items()))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
