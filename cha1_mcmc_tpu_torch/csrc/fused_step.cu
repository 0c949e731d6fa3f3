// K1 — fused whole-ensemble stretch-move step kernel, hand-written for
// Hopper (sm_90a). Built at first use by cha1_mcmc_tpu_torch/utils/
// cuda_build.py and bound through ctypes by cha1_mcmc_tpu_torch/sampler/
// fused.py, whose plain PyTorch version (fused_steps_plain /
// fused_lnprob_plain) computes the same function and is the kernel's test
// oracle.
//
// Replaces: the Pallas TPU kernel cha1_mcmc_tpu/sampler/fused.py:
// _step_kernel (with _run_step_loop, _make_dense_lnprob, _make_q_of,
// _unpack_single, _rt_chi2_block, _prior_box, _lnprob_tail and the statics
// of single_statics_tables). One launch runs k emcee-v3 stretch-move steps
// of one single-component ensemble: per step two sequential half-updates,
// each gathering the active walkers, their complement and random partners,
// proposing Y = c + z (s - c), evaluating lnprob = box + Gaussian priors
// (flat Ncol) + chi^2 of dil (J_T - J_Tbg)(1 - exp(-opac)) with
// opac_c = sum_l tau_l 1{|v_lc - v0| < 10 dV} exp2(aa d^2), and accepting
// when ln u < (D - 1) ln z + lnp_new - lnp_s.
//
// What bounds it on this card: latency, not bandwidth or FLOP/s. The two
// half-updates of a step, and the k steps, depend on each other, so one
// ensemble is one CTA on one SM. At the flagship size (W = 128 walkers,
// 9 lines x 561 channels) a half-update is 64 x 9 x 561 ~ 323k windowed
// Gaussians (exp2 on the SFU) plus ~36k exp/log for the radiative
// transfer, ~10 MFLOP-equivalent, against tables of ~26 KB that stay in
// L1. The work is one SM's SFU throughput and the barrier chain between
// phases.
//
// Design:
//  * the (W, D+1) state (coordinates || lnp) lives in shared memory for
//    the whole launch (2.5 KB at W=128, D=4, f32); __syncthreads()
//    separates the proposal, evaluation and write-back phases of each
//    half-update, so the second half reads the first half's writes;
//  * gathers and scatters are indexed loads and stores through perm and
//    pair — no one-hot products, so nothing depends on matmul precision,
//    and no -inf clamp is needed: a walker that never accepted keeps
//    lnp = -inf, and -inf - (-inf) = NaN makes `ln u < NaN` false, as in
//    the general sampler (so: no fast-math, no flush-to-zero);
//  * the write-back is a select per accepted walker;
//  * one warp evaluates one proposal: lanes stride the channels, each
//    lane sums the lines in line order (skipping out-of-window lines,
//    whose term is exactly 0) and the warp reduces chi^2 by shuffles;
//    per-line opacities live in a per-warp shared scratch;
//  * statics (box, priors, Q(T) coefficients, geometry) are a plain
//    struct passed by value (__grid_constant__), rounded to the kernel's
//    scalar type once on the host;
//  * the stretch factor, the proposal (one fused multiply-add, as
//    torch.addcmul rounds it) and the acceptance difference use explicitly
//    rounded intrinsics, so in float64 the kernel's trajectories equal the
//    plain version's bitwise.
//  * the step loop is written once (run_step_loop in step_loop.cuh),
//    templated on the device lnprob; K2 (multi_step.cu) shares it. The
//    statics struct, the theta unpack and the prior are shared with K3
//    (single_statics.cuh).
//
// K5a — the sharded half-step, in this source because it is K1's lnprob
// and K1's half-update. Replaces the Pallas TPU kernel
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_step_kernel (:137, with
// _half_update :91; call :631): one half-update of a rank's W_l local
// walkers against the complement all-gathered over the walker shards
// (the gather and the all_gather run before the launch, on the caller's
// stream). One CTA: the (W_l, D+1) state is loaded from device memory into
// shared memory, half_update runs with partners read from the gathered
// (h n_w, D) buffer, and the state is stored back; the accepted count goes
// to out_acc. Bound as K1 (latency of one SM), plus a launch per
// half-step: a step is two launches where K1 runs k steps in one.
//
// C entries (all return cudaGetLastError() after the launch):
//   k1_fused_steps_{f32,f64}: k whole steps of one ensemble;
//   k1_lnprob_{f32,f64}:      the same device lnprob over an (N, D) batch;
//   k5a_half_{f32,f64}:       one sharded half-step (K5a), state in place;
//   k1_statics_size_{f32,f64}: sizeof(Statics<T>), checked by the binding;
//   k1_error_string: the CUDA error message of a returned code.

#include "single_statics.cuh"

namespace {

template <typename T>
struct Tables {
  const T* lines;  // (5, L): freq MHz, elower, aij, gup, glow
  const T* vel;    // (L, C): channel velocity relative to each line
  const T* chans;  // (3, C): freq MHz, observed y, 1 / sigma^2
  const T* qst;    // (2, S): state-sum g, E
  int L, C, S;
};

// lnprob of one proposal, evaluated by one warp; `tau` is the warp's
// (L,) scratch. The value is returned on every lane.
template <typename T>
__device__ T dense_lnprob(const T* th, const Statics<T>& st,
                          const Tables<T>& tb, T* tau, int lane) {
  T ss_w, Ncol, Tex, vlsr, dV;
  unpack_single(th, st, ss_w, Ncol, Tex, vlsr, dV);
  // Box bounds + Gaussian priors, Ncol flat (_prior_box).
  T lp;
  if (!single_prior(th, st, lp)) return neg_inf<T>();  // the whole warp leaves together

  // Stick opacities (ops/lte.py:tau_sticks), one line per lane.
  const T Q = q_of(Tex, st, tb.qst, tb.S, lane);
  for (int l = lane; l < tb.L; l += 32) {
    tau[l] = tau_stick(tb.lines[l], tb.lines[tb.L + l], tb.lines[2 * tb.L + l],
                       tb.lines[3 * tb.L + l], tb.lines[4 * tb.L + l], Q, Ncol,
                       Tex, dV);
  }
  __syncwarp();

  // exp(-0.5 ((v - vlsr) / sigma)^2) as exp2(aa d^2), aa = -log2(e) / (2 sigma^2).
  const T sigma = dV / T(2.355);
  const T aa = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
  const T win = T(10) * dV;
  T part = T(0);
  for (int c = lane; c < tb.C; c += 32) {
    T opac = T(0);
    for (int l = 0; l < tb.L; ++l) {
      const T v = tb.vel[l * tb.C + c];
      if (ab(v - st.mask_center) < win) {
        const T d = v - vlsr;
        opac += tau[l] * ex2(aa * (d * d));
      }
    }
    const T gf = tb.chans[c], y = tb.chans[tb.C + c], isig = tb.chans[2 * tb.C + c];
    const T J_T = planck_J(gf, Tex);
    const T J_Tbg = planck_J(gf, st.Tbg);
    const T dil = beam_dilution(gf, ss_w, st.dish_size);
    const T m = dil * (J_T - J_Tbg) * (T(1) - ex(-opac));
    const T resid = y - m;
    part += resid * resid * isig - lg(isig);
  }
  const T chi = warp_sum(part);
  __syncwarp();  // tau is rewritten by this warp's next proposal
  const T val = lp + T(-0.5) * chi;
  return isfinite(val) ? val : neg_inf<T>();
}

template <typename T>
struct DenseLnProb {
  const Statics<T>& st;
  Tables<T> tb;
  T* tau;  // kWarps x L scratch
  __device__ T operator()(const T* th, int warp, int lane) const {
    return dense_lnprob(th, st, tb, tau + warp * tb.L, lane);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_steps_kernel(const T* __restrict__ coords, const T* __restrict__ lnp0,
                   const int32_t* __restrict__ perm, const T* __restrict__ zu,
                   const int32_t* __restrict__ pair, const T* __restrict__ au,
                   Tables<T> tb, T* __restrict__ out_chain,
                   T* __restrict__ out_lnps, float* __restrict__ out_acc,
                   int W, int D, int k, __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = W / 2;
  T* state = reinterpret_cast<T*>(smem);
  T* prop = state + (size_t)W * (D + 1);
  T* zz = prop + (size_t)h * (D + 1);
  T* tau = zz + h;
  int* flag = reinterpret_cast<int*>(tau + (size_t)kWarps * tb.L);
  int* acc_count = flag + h;
  DenseLnProb<T> lnprob{st, tb, tau};
  run_step_loop<T>(coords, lnp0, perm, zu, pair, au, out_chain, out_lnps,
                   out_acc, W, D, k, st.a, state, prop, zz, flag, acc_count,
                   lnprob);
}

// K5a: one sharded half-step of a rank's W local walkers against the
// complement gathered over the walker shards (run_sharded_half in
// step_loop.cuh around the same DenseLnProb); one CTA, K1's layout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_half_kernel(T* __restrict__ state_g, const int32_t* __restrict__ act,
                    const T* __restrict__ comp, const T* __restrict__ zu,
                    const int32_t* __restrict__ pair, const T* __restrict__ au,
                    Tables<T> tb, float* __restrict__ out_acc, int W, int D,
                    __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = W / 2;
  T* state = reinterpret_cast<T*>(smem);
  T* prop = state + (size_t)W * (D + 1);
  T* zz = prop + (size_t)h * (D + 1);
  T* tau = zz + h;
  int* flag = reinterpret_cast<int*>(tau + (size_t)kWarps * tb.L);
  int* acc_count = flag + h;
  DenseLnProb<T> lnprob{st, tb, tau};
  run_sharded_half<T>(state_g, act, comp, zu, pair, au, out_acc, W, D, st.a, state,
                      prop, zz, flag, acc_count, lnprob);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lnprob_kernel(const T* __restrict__ theta, T* __restrict__ out, Tables<T> tb,
              int N, int D, __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= N) return;  // whole warps only: no block barrier follows
  DenseLnProb<T> lnprob{st, tb, reinterpret_cast<T*>(smem)};
  const T v = lnprob(theta + (size_t)j * D, warp, lane);
  if (lane == 0) out[j] = v;
}

template <typename T>
int launch_steps(const void* coords, const void* lnp0, const void* perm,
                 const void* zu, const void* pair, const void* au,
                 const void* lines, const void* vel, const void* chans,
                 const void* qst, void* out_chain, void* out_lnps,
                 void* out_acc, const void* statics, int W, int D, int L,
                 int C, int S, int k, void* stream) {
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const Tables<T> tb{static_cast<const T*>(lines), static_cast<const T*>(vel),
                     static_cast<const T*>(chans), static_cast<const T*>(qst),
                     L, C, S};
  const size_t smem = step_smem_bytes<T>(W, D, (size_t)kWarps * L);
  cudaError_t err = cudaFuncSetAttribute(
      fused_steps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_steps_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coords), static_cast<const T*>(lnp0),
      static_cast<const int32_t*>(perm), static_cast<const T*>(zu),
      static_cast<const int32_t*>(pair), static_cast<const T*>(au), tb,
      static_cast<T*>(out_chain), static_cast<T*>(out_lnps),
      static_cast<float*>(out_acc), W, D, k, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_half(void* state, const void* act, const void* comp, const void* zu,
                const void* pair, const void* au, const void* lines, const void* vel,
                const void* chans, const void* qst, void* out_acc,
                const void* statics, int W, int D, int L, int C, int S, void* stream) {
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const Tables<T> tb{static_cast<const T*>(lines), static_cast<const T*>(vel),
                     static_cast<const T*>(chans), static_cast<const T*>(qst),
                     L, C, S};
  const size_t smem = step_smem_bytes<T>(W, D, (size_t)kWarps * L);
  cudaError_t err = cudaFuncSetAttribute(
      sharded_half_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sharded_half_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(state), static_cast<const int32_t*>(act),
      static_cast<const T*>(comp), static_cast<const T*>(zu),
      static_cast<const int32_t*>(pair), static_cast<const T*>(au), tb,
      static_cast<float*>(out_acc), W, D, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lnprob(const void* theta, void* out, const void* lines,
                  const void* vel, const void* chans, const void* qst,
                  const void* statics, int N, int D, int L, int C, int S,
                  void* stream) {
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const Tables<T> tb{static_cast<const T*>(lines), static_cast<const T*>(vel),
                     static_cast<const T*>(chans), static_cast<const T*>(qst),
                     L, C, S};
  const size_t smem = sizeof(T) * (size_t)kWarps * L;
  cudaError_t err = cudaFuncSetAttribute(
      lnprob_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kWarps - 1) / kWarps;
  lnprob_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<T*>(out), tb, N, D, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k1_statics_size_f32() { return (int)sizeof(Statics<float>); }
int k1_statics_size_f64() { return (int)sizeof(Statics<double>); }
const char* k1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int k1_fused_steps_f32(const void* coords, const void* lnp0, const void* perm,
                       const void* zu, const void* pair, const void* au,
                       const void* lines, const void* vel, const void* chans,
                       const void* qst, void* out_chain, void* out_lnps,
                       void* out_acc, const void* statics, int W, int D, int L,
                       int C, int S, int k, void* stream) {
  return launch_steps<float>(coords, lnp0, perm, zu, pair, au, lines, vel, chans,
                             qst, out_chain, out_lnps, out_acc, statics, W, D,
                             L, C, S, k, stream);
}

int k1_fused_steps_f64(const void* coords, const void* lnp0, const void* perm,
                       const void* zu, const void* pair, const void* au,
                       const void* lines, const void* vel, const void* chans,
                       const void* qst, void* out_chain, void* out_lnps,
                       void* out_acc, const void* statics, int W, int D, int L,
                       int C, int S, int k, void* stream) {
  return launch_steps<double>(coords, lnp0, perm, zu, pair, au, lines, vel,
                              chans, qst, out_chain, out_lnps, out_acc, statics,
                              W, D, L, C, S, k, stream);
}

int k1_lnprob_f32(const void* theta, void* out, const void* lines,
                  const void* vel, const void* chans, const void* qst,
                  const void* statics, int N, int D, int L, int C, int S,
                  void* stream) {
  return launch_lnprob<float>(theta, out, lines, vel, chans, qst, statics, N, D,
                              L, C, S, stream);
}

int k1_lnprob_f64(const void* theta, void* out, const void* lines,
                  const void* vel, const void* chans, const void* qst,
                  const void* statics, int N, int D, int L, int C, int S,
                  void* stream) {
  return launch_lnprob<double>(theta, out, lines, vel, chans, qst, statics, N,
                               D, L, C, S, stream);
}

#define K5A_HALF(SFX, T)                                                            \
  int k5a_half_##SFX(void* state, const void* act, const void* comp, const void* zu, \
                     const void* pair, const void* au, const void* lines,            \
                     const void* vel, const void* chans, const void* qst,            \
                     void* out_acc, const void* statics, int W, int D, int L, int C, \
                     int S, void* stream) {                                          \
    return launch_half<T>(state, act, comp, zu, pair, au, lines, vel, chans, qst,    \
                          out_acc, statics, W, D, L, C, S, stream);                  \
  }
K5A_HALF(f32, float)
K5A_HALF(f64, double)

}  // extern "C"
