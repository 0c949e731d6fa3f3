#!/usr/bin/env python3
"""Times the three-kernel K3 of commit 67cb25c (csrc/gather_step.cu as it
was before K3 became one cooperative launch) kernel by kernel, beside
this tree's K3, on one GPU. It is the script behind PERF.md's "before"
split of a K3 half-step (prepare, evaluate, accept); it builds only
against that commit's source, whose kernels and tables<T> it names.

Run from the repository root, with DIR a checkout of that commit:

    mkdir -p build/parent && git archive 67cb25c | tar -x -C build/parent
    python3 cha1_mcmc_tpu_torch/utils/k3_parent_split.py build/parent

It builds this tree's K3 and DIR's gather_step.cu with one extra entry
(SPLIT_SOURCE), then prints, on the full-size dense problem of
tests/port_problems.py (Chebyshev Q, split tables, 128 walkers, f32,
channel blocks of 128) in turns, the median and quartiles of each
kernel launched alone, the three in sequence, and a K3 step of each
tree, with the card's name and power limit (chip_smoke.py's timing
helpers).
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from chip_smoke import (CU_SOURCE_K3, DEVICE, K_STEPS, TIMING_PAIRS, W,  # noqa: E402
                        card_line, dense_cases, dense_pos0, dense_tables, phase,
                        quartiles)

#: A C source that includes the three-kernel csrc/gather_step.cu of DIR
#: and adds one entry that launches one of its kernels alone: `which` 0
#: prepare, 1 evaluate, 2 accept, 3 the three in sequence (one half-step
#: as that source launched it), for half 0 of step 0 of the inputs, `reps`
#: times on the caller's stream.
SPLIT_SOURCE = r"""
#include "{source}"

namespace {{
template <typename T>
int phase_alone(int which, int reps, void* state, const void* perm, const void* zu,
                const void* pair, const void* au, const void* lines1, const void* vel1,
                const void* lines2, const void* vel2, const void* chans, const void* qst,
                void* prop, void* zz, void* scal, void* partial, void* acc,
                const void* statics, int W, int D, int M1, int M2, int C, int cb0, int S,
                int cblock, int n_blk, void* stream) {{
  const int h = W / 2;
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const GatherTables<T> tb = tables<T>(lines1, vel1, lines2, vel2, chans, qst, M1, M2, C,
                                       cb0, S);
  const auto s = static_cast<cudaStream_t>(stream);
  const int32_t* act = static_cast<const int32_t*>(perm);
  for (int i = 0; i < reps; ++i) {{
    if (which == 0 || which == 3)
      prepare_kernel<T><<<(h + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
          nullptr, static_cast<T*>(state), act, act + h, nullptr,
          static_cast<const int32_t*>(pair), static_cast<const T*>(zu),
          static_cast<T*>(prop), static_cast<T*>(zz), static_cast<T*>(scal), tb, h, D, st);
    if (which == 1 || which == 3)
      evaluate_kernel<T><<<dim3(n_blk, (h + kRows - 1) / kRows), cblock, 0, s>>>(
          static_cast<T*>(scal), static_cast<T*>(partial), tb, h, n_blk, st);
    if (which == 2 || which == 3)
      accept_kernel<T><<<1, (h + 31) / 32 * 32, 0, s>>>(
          static_cast<T*>(state), act, static_cast<const T*>(au), static_cast<T*>(prop),
          static_cast<T*>(zz), static_cast<T*>(scal), static_cast<T*>(partial),
          static_cast<int*>(acc), nullptr, nullptr, nullptr, W, D, n_blk, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }}
  return 0;
}}
}}  // namespace

extern "C" int k3_phase_f32(int which, int reps, void* state, const void* perm,
                            const void* zu, const void* pair, const void* au,
                            const void* lines1, const void* vel1, const void* lines2,
                            const void* vel2, const void* chans, const void* qst,
                            void* prop, void* zz, void* scal, void* partial, void* acc,
                            const void* statics, int W, int D, int M1, int M2, int C,
                            int cb0, int S, int cblock, int n_blk, void* stream) {{
  return phase_alone<float>(which, reps, state, perm, zu, pair, au, lines1, vel1, lines2,
                            vel2, chans, qst, prop, zz, scal, partial, acc, statics, W, D,
                            M1, M2, C, cb0, S, cblock, n_blk, stream);
}}
"""


def time_split(parent, case, gen, device):
    """The three-kernel K3 of DIR (SPLIT_SOURCE over DIR's
    csrc/gather_step.cu, built here) on the dense case's f32 tables at
    channel blocks of 128, beside this tree's K3 on the same inputs, in
    turns: the parent's prepare, evaluate and accept kernels each alone and
    the three in sequence (us per half-step launch), the parent's
    k3_fused_steps and this tree's gather_step_block (us per ensemble step,
    16 calls of K_STEPS steps a run). Returns {name: (median, q1, q3)}."""
    import ctypes

    import torch
    from cha1_mcmc_tpu_torch.sampler.fused import _pack_statics, block_randomness
    from cha1_mcmc_tpu_torch.sampler.stretch import draw_randomness
    from cha1_mcmc_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    src = os.path.abspath(os.path.join(parent, CU_SOURCE_K3))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = BUILD_DIR / "k3_parent_split.cu", BUILD_DIR / "k3_parent_split.so"
    cu.write_text(SPLIT_SOURCE.format(source=src))
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k3_phase_f32.argtypes = [I, I] + [P] * 17 + [I] * 9 + [P]
    lib.k3_fused_steps_f32.argtypes = [P] * 20 + [I] * 10 + [P]
    lib.k3_phase_f32.restype = lib.k3_fused_steps_f32.restype = I

    fns, (st, tb), _, plans = dense_tables(case)
    geom = plans[torch.float32]
    pos0 = dense_pos0(case, seed=1).to(torch.float32)
    lnp0 = fns[1](pos0, tb, st)
    M1, M2, C, S = tb[1].shape[0], tb[3].shape[0], tb[1].shape[1], tb[5].shape[1]
    D, h, nb = pos0.shape[1], W // 2, 16
    f32 = dict(dtype=torch.float32, device=DEVICE)
    packed = _pack_statics(st, torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    pb, zb, prb, ab = block_randomness(draw_randomness(nb * K_STEPS, W, gen, device=DEVICE),
                                       K_STEPS)
    scratch = [torch.empty((h, D), **f32), torch.empty(h, **f32),
               torch.empty((h, 8), **f32), torch.empty((h, geom.n_blk), **f32),
               torch.zeros(1, dtype=torch.int32, device=DEVICE)]
    state = torch.cat([pos0, lnp0[:, None]], dim=1).contiguous()
    ints = (W, D, M1, M2, C, geom.cb0, S, geom.cblock, geom.n_blk)
    ptrs = lambda ts: [t.data_ptr() for t in ts]   # noqa: E731

    def phase_call(which, reps=20):
        err = lib.k3_phase_f32(which, reps, state.data_ptr(), pb[0].data_ptr(),
                               zb[0].data_ptr(), prb[0].data_ptr(), ab[0].data_ptr(),
                               *ptrs(tb), *ptrs(scratch), ctypes.addressof(packed), *ints,
                               stream)
        assert err == 0, f"parent K3 phase {which}: CUDA error {err}"

    def old_steps(c, l, b):
        st_ = torch.cat([c, l[:, None]], dim=1).contiguous()
        out = (torch.empty((K_STEPS * W, D), **f32), torch.empty(K_STEPS * W, **f32),
               torch.empty(K_STEPS, **f32))
        err = lib.k3_fused_steps_f32(st_.data_ptr(), pb[b].data_ptr(), zb[b].data_ptr(),
                                     prb[b].data_ptr(), ab[b].data_ptr(), *ptrs(tb),
                                     *ptrs(scratch), *ptrs(out), ctypes.addressof(packed),
                                     *ints, K_STEPS, stream)
        assert err == 0, f"parent K3 steps: CUDA error {err}"
        return out

    def new_steps(c, l, b):
        return fns[2](c, l, pb[b], zb[b], prb[b], ab[b], tb, st)

    def per_step(fn):
        c, l = pos0, lnp0
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for b in range(nb):
            cb, lb, _ = fn(c, l, b)
            c, l = cb[(K_STEPS - 1) * W:], lb[(K_STEPS - 1) * W:]
        t1.record()
        torch.cuda.synchronize()
        return 1e3 * t0.elapsed_time(t1) / (nb * K_STEPS)

    def per_launch(which, reps=20):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        phase_call(which, reps)
        t1.record()
        torch.cuda.synchronize()
        return 1e3 * t0.elapsed_time(t1) / reps

    for which in (0, 1, 2, 3):      # warm-up; prepare before evaluate before accept
        phase_call(which, 1)
    for fn in (old_steps, new_steps):
        per_step(fn)
    calls = {"parent prepare": lambda: per_launch(0), "parent evaluate": lambda: per_launch(1),
             "parent accept": lambda: per_launch(2),
             "parent half-step (3 launches)": lambda: per_launch(3),
             "parent K3 step": lambda: per_step(old_steps),
             "this tree's K3 step": lambda: per_step(new_steps)}
    times = {k: [] for k in calls}
    for _ in range(TIMING_PAIRS):
        for k in list(calls) + list(calls)[::-1]:
            times[k].append(calls[k]())
    out = {k: quartiles(v) for k, v in times.items()}
    phase(4, "time", f"K3 before / after ({parent}), dense {case[0]}, {W} walkers, "
          f"f32, channel blocks of {geom.cblock}, median [q1, q3] of {2 * TIMING_PAIRS} runs, "
          f"in turns: " + "; ".join(f"{k} {m:.2f} [{a:.2f}, {b:.2f}] us" for k, (m, a, b) in
                                    out.items()) + f" (launches alone: 20 a run, us per "
          f"launch; steps: us per ensemble step); {device}")
    return out


def main(argv) -> int:
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print("usage (on a CUDA device): python3 cha1_mcmc_tpu_torch/utils/"
              "k3_parent_split.py DIR", file=sys.stderr)
        return 2
    from tests.port_problems import write_dense_problem

    device = card_line()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            prob = write_dense_problem(os.path.join(tmp, "dense"), scale="full")
        time_split(argv[0], dense_cases(prob)[0], gen, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
