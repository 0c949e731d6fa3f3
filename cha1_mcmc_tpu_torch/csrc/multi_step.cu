// K2 — fused whole-ensemble stretch-move step kernel for K-component
// (GOTHAM / TMC-1) fits, hand-written for Hopper (sm_90a). Built at first
// use by cha1_mcmc_tpu_torch/utils/cuda_build.py and bound through ctypes
// by cha1_mcmc_tpu_torch/sampler/fused_multi.py, whose plain PyTorch
// version (multi_steps_plain / multi_lnprob_plain) computes the same
// function and is the kernel's test oracle.
//
// Replaces: the Pallas TPU kernel cha1_mcmc_tpu/sampler/fused_multi.py:
// _multi_step_kernel (:370, pallas_call :576) with its lnprob
// _make_multi_lnprob (:227) and the statics of multi_statics_tables
// (:430). One launch runs k emcee-v3 stretch-move steps of one
// K-component ensemble, theta = [ss x K | Ncol x K | Tex | vlsr x K | dV]
// (D = 3K + 2): per step two sequential half-updates, each gathering the
// active walkers, their complement and random partners, proposing
// Y = c + z (s - c), evaluating
//   lnprob = ordered-velocity prior + chi^2 of
//            sum_k dil_k (J_T - J_Tbg)(1 - exp(-opac_k)),
//   opac_k,c = sum_l tau_k,l 1{|v_lc - v0| < 10 dV} exp2(aa (v_lc - vlsr_k)^2),
// and accepting when ln u < (D - 1) ln z + lnp_new - lnp_s.
//
// What bounds it on this card: latency, as for K1. The half-updates and
// steps depend on each other, so one ensemble is one CTA on one SM. At the
// GOTHAM size (128 walkers, K = 4, 66 lines x ~1,133 channels, 3 lines
// per channel) a half-update evaluates 64 proposals x 1,133 channels x 3
// lines x 4 components ~ 870k windowed exp2 plus ~360k exp/log of the
// radiative transfer, against ~40 KB of tables that stay in L1/L2.
//
// Design (the TPU layout does not carry over: its (C, K*h) opacity
// accumulator alone is 1.16 MB of VMEM at 128 walkers, five times a
// CTA's shared memory):
//  * K1's shape and K1's step loop (run_step_loop, step_loop.cuh): the
//    (W, D+1) state in shared memory, indexed gathers and a select
//    write-back, no one-hot products and no -inf clamp; a walker that
//    never accepted keeps lnp = -inf;
//  * one warp per proposal, lanes striding the channels; each lane keeps
//    its channel's K opacities in registers;
//  * the lines that can touch a channel come from the channel-major
//    tables (M, C) of the gather formulation (build_opacity_gather:
//    active-line index and velocity per entry, padding at velocity 1e30)
//    plus the entry's hfs group — consecutive active lines sharing one
//    +-10 dV_max window start, as the TPU kernel's _chunk_plan groups them;
//  * summation order: per channel the in-window lines of one group are
//    summed left to right in line order, and the group sums are added to
//    the channel's opacity in group order — the TPU kernel's
//    group-then-scatter order exactly, so in float64 the plain version
//    reproduces the Pallas kernel's opacities;
//  * only tau needs scratch: (K x La) values per warp in shared memory;
//  * statics (prior bounds and Gaussians, Q(T), geometry) are a plain
//    struct passed by value (__grid_constant__), rounded to the kernel's
//    scalar type once on the host; at most kMaxComp components.
//
// K5c — the sharded multi-component half-step, in this source because it
// is K2's lnprob and half-update. Replaces the Pallas TPU kernel
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_step_kernel_multi (:320,
// call :494): one half-update of a rank's W_l local walkers against the
// complement all-gathered over the walker shards. It keeps K2's (W, D+1)
// state layout, not the TPU kernel's transposed (D+1, W) one: one CTA
// loads the state from device memory into shared memory, runs half_update
// (step_loop.cuh) with partners from the gathered (h n_w, D) buffer and
// stores it back; the accepted count goes to out_acc. Bound as K2, plus a
// launch per half-step.
//
// C entries (all return cudaGetLastError() after the launch):
//   k2_fused_steps_{f32,f64}: k whole steps of one ensemble;
//   k2_lnprob_{f32,f64}:      the same device lnprob over an (N, D) batch;
//   k5c_half_{f32,f64}:       one sharded half-step (K5c), state in place;
//   k2_statics_size_{f32,f64}: sizeof(MultiStatics<T>), checked by the binding;
//   k2_error_string: the CUDA error message of a returned code.

#include "step_loop.cuh"

namespace {

constexpr int kMaxComp = 4;
constexpr int kMaxPoly = 8;
constexpr int kMaxCheb = 65;

template <typename T>
struct MultiStatics {
  T mean_ss[kMaxComp], sd_ss[kMaxComp], norm_ss[kMaxComp];
  T mean_vlsr[kMaxComp], sd_vlsr[kMaxComp], norm_vlsr[kMaxComp];
  T poly[kMaxPoly];            // analytic Q: ascending coefficients
  T cheb[kMaxCheb];            // Chebyshev Q: c_0 .. c_deg
  T mean_tex, sd_tex, norm_tex, mean_dv, sd_dv, norm_dv;
  T ss_lo, ss_hi, ncol_lo, ncol_hi, tex_min, dv_bound, vlsr_min_sep, vlsr_max_sep;
  T dish_size, Tbg, mask_center, a;
  T q_scale, q_pa, q_pb, cheb_lo, cheb_scale;
  int32_t ncomp, ndim, q_kind, n_poly, has_power, n_cheb;
};

template <typename T>
struct MultiTables {
  const T* lines;           // (5, La): freq MHz, elower, aij, gup, glow
  const T* vel;             // (M, C): entry velocity, 1e30 on padding
  const int32_t* line_idx;  // (M, C): active-line index of the entry
  const int32_t* group;     // (M, C): hfs group of the entry
  const T* chans;           // (3, C): freq MHz, observed y, 1 / sigma^2
  const T* qst;             // (2, S): state-sum g, E
  int La, M, C, S;
};

// lnprob of one proposal, evaluated by one warp; `tau` is the warp's
// (K, La) scratch. The value is returned on every lane.
template <typename T>
__device__ T multi_lnprob(const T* th, const MultiStatics<T>& st,
                          const MultiTables<T>& tb, T* tau, int lane) {
  const int K = st.ncomp;
  const T Tex = th[2 * K], dV = th[3 * K + 1];
  T ss[kMaxComp], vl[kMaxComp];
  // Ordered-velocity prior (_make_multi_lnprob:350-365): per component the
  // ss and vlsr Gaussians, then Tex, then dV; flat Ncol.
  bool ok = true;
  T lp = T(0);
#pragma unroll
  for (int k = 0; k < kMaxComp; ++k) {
    if (k < K) {
      ss[k] = th[k];
      vl[k] = th[2 * K + 1 + k];
      const T ncol = th[K + k];
      ok = ok && (ss[k] > st.ss_lo) && (ss[k] < st.ss_hi)
              && (ncol > st.ncol_lo) && (ncol < st.ncol_hi);
      T u = (ss[k] - st.mean_ss[k]) / st.sd_ss[k];
      lp = lp + (st.norm_ss[k] - T(0.5) * (u * u));
      u = (vl[k] - st.mean_vlsr[k]) / st.sd_vlsr[k];
      lp = lp + (st.norm_vlsr[k] - T(0.5) * (u * u));
    }
  }
#pragma unroll
  for (int k = 0; k + 1 < kMaxComp; ++k) {
    if (k + 1 < K)
      ok = ok && (vl[k] < vl[k + 1] - st.vlsr_min_sep)
              && (vl[k + 1] < vl[k] + st.vlsr_max_sep);
  }
  ok = ok && (dV < st.dv_bound) && (Tex > st.tex_min);
  T u = (Tex - st.mean_tex) / st.sd_tex;
  lp = lp + (st.norm_tex - T(0.5) * (u * u));
  u = (dV - st.mean_dv) / st.sd_dv;
  lp = lp + (st.norm_dv - T(0.5) * (u * u));
  if (!ok) return neg_inf<T>();  // the whole warp leaves together

  // Stick opacities per (component, active line), spread over the lanes.
  const T Q = q_of(Tex, st, tb.qst, tb.S, lane);
  for (int i = lane; i < K * tb.La; i += 32) {
    const int k = i / tb.La, l = i - k * tb.La;
    tau[i] = tau_stick(tb.lines[l], tb.lines[tb.La + l], tb.lines[2 * tb.La + l],
                       tb.lines[3 * tb.La + l], tb.lines[4 * tb.La + l], Q,
                       th[K + k], Tex, dV);
  }
  __syncwarp();

  // exp(-0.5 ((v - vlsr) / sigma)^2) as exp2(aa d^2), aa = -log2(e) / (2 sigma^2).
  const T sigma = dV / T(2.355);
  const T aa = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
  const T win = T(10) * dV;
  T part = T(0);
  for (int c = lane; c < tb.C; c += 32) {
    T opac[kMaxComp], gacc[kMaxComp];
#pragma unroll
    for (int k = 0; k < kMaxComp; ++k) opac[k] = gacc[k] = T(0);
    int cur = -1;
    for (int m = 0; m < tb.M; ++m) {
      const T v = tb.vel[m * tb.C + c];
      if (ab(v - st.mask_center) < win) {
        const int g = tb.group[m * tb.C + c];
        if (g != cur) {  // a new hfs group: add the finished group's sums
#pragma unroll
          for (int k = 0; k < kMaxComp; ++k) {
            opac[k] = opac[k] + gacc[k];
            gacc[k] = T(0);
          }
          cur = g;
        }
        const T* tl = tau + tb.line_idx[m * tb.C + c];
#pragma unroll
        for (int k = 0; k < kMaxComp; ++k) {
          if (k < K) {
            const T d = v - vl[k];
            gacc[k] = gacc[k] + tl[k * tb.La] * ex2(aa * (d * d));
          }
        }
      }
    }
    const T gf = tb.chans[c], y = tb.chans[tb.C + c], isig = tb.chans[2 * tb.C + c];
    const T J_T = planck_J(gf, Tex);
    const T J_Tbg = planck_J(gf, st.Tbg);
    T mdl = T(0);
#pragma unroll
    for (int k = 0; k < kMaxComp; ++k) {
      if (k < K) {
        const T o = opac[k] + gacc[k];
        mdl = mdl + beam_dilution(gf, ss[k], st.dish_size) * (J_T - J_Tbg)
                    * (T(1) - ex(-o));
      }
    }
    const T resid = y - mdl;
    part += resid * resid * isig - lg(isig);
  }
  const T chi = warp_sum(part);
  __syncwarp();  // tau is rewritten by this warp's next proposal
  const T val = lp + T(-0.5) * chi;
  return isfinite(val) ? val : neg_inf<T>();
}

template <typename T>
struct MultiLnProb {
  const MultiStatics<T>& st;
  MultiTables<T> tb;
  T* tau;  // kWarps x (K x La) scratch
  __device__ T operator()(const T* th, int warp, int lane) const {
    return multi_lnprob(th, st, tb, tau + (size_t)warp * st.ncomp * tb.La, lane);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
multi_steps_kernel(const T* __restrict__ coords, const T* __restrict__ lnp0,
                   const int32_t* __restrict__ perm, const T* __restrict__ zu,
                   const int32_t* __restrict__ pair, const T* __restrict__ au,
                   MultiTables<T> tb, T* __restrict__ out_chain,
                   T* __restrict__ out_lnps, float* __restrict__ out_acc,
                   int W, int D, int k, __grid_constant__ const MultiStatics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = W / 2;
  T* state = reinterpret_cast<T*>(smem);
  T* prop = state + (size_t)W * (D + 1);
  T* zz = prop + (size_t)h * (D + 1);
  T* tau = zz + h;
  int* flag = reinterpret_cast<int*>(tau + (size_t)kWarps * st.ncomp * tb.La);
  int* acc_count = flag + h;
  MultiLnProb<T> lnprob{st, tb, tau};
  run_step_loop<T>(coords, lnp0, perm, zu, pair, au, out_chain, out_lnps,
                   out_acc, W, D, k, st.a, state, prop, zz, flag, acc_count,
                   lnprob);
}

// K5c: one sharded half-step of a rank's W local walkers against the
// complement gathered over the walker shards (run_sharded_half in
// step_loop.cuh around the same MultiLnProb); one CTA, K2's layout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
multi_sharded_half_kernel(T* __restrict__ state_g, const int32_t* __restrict__ act,
                          const T* __restrict__ comp, const T* __restrict__ zu,
                          const int32_t* __restrict__ pair, const T* __restrict__ au,
                          MultiTables<T> tb, float* __restrict__ out_acc, int W, int D,
                          __grid_constant__ const MultiStatics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = W / 2;
  T* state = reinterpret_cast<T*>(smem);
  T* prop = state + (size_t)W * (D + 1);
  T* zz = prop + (size_t)h * (D + 1);
  T* tau = zz + h;
  int* flag = reinterpret_cast<int*>(tau + (size_t)kWarps * st.ncomp * tb.La);
  int* acc_count = flag + h;
  MultiLnProb<T> lnprob{st, tb, tau};
  run_sharded_half<T>(state_g, act, comp, zu, pair, au, out_acc, W, D, st.a, state,
                      prop, zz, flag, acc_count, lnprob);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
multi_lnprob_kernel(const T* __restrict__ theta, T* __restrict__ out,
                    MultiTables<T> tb, int N, int D,
                    __grid_constant__ const MultiStatics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= N) return;  // whole warps only: no block barrier follows
  MultiLnProb<T> lnprob{st, tb, reinterpret_cast<T*>(smem)};
  const T v = lnprob(theta + (size_t)j * D, warp, lane);
  if (lane == 0) out[j] = v;
}

template <typename T>
MultiTables<T> make_tables(const void* lines, const void* vel,
                           const void* line_idx, const void* group,
                           const void* chans, const void* qst, int La, int M,
                           int C, int S) {
  return MultiTables<T>{static_cast<const T*>(lines), static_cast<const T*>(vel),
                        static_cast<const int32_t*>(line_idx),
                        static_cast<const int32_t*>(group),
                        static_cast<const T*>(chans), static_cast<const T*>(qst),
                        La, M, C, S};
}

template <typename T>
int launch_steps(const void* coords, const void* lnp0, const void* perm,
                 const void* zu, const void* pair, const void* au,
                 const void* lines, const void* vel, const void* line_idx,
                 const void* group, const void* chans, const void* qst,
                 void* out_chain, void* out_lnps, void* out_acc,
                 const void* statics, int W, int D, int La, int M, int C,
                 int S, int k, void* stream) {
  const MultiStatics<T> st = *static_cast<const MultiStatics<T>*>(statics);
  const MultiTables<T> tb = make_tables<T>(lines, vel, line_idx, group, chans,
                                           qst, La, M, C, S);
  const size_t smem = step_smem_bytes<T>(W, D, (size_t)kWarps * st.ncomp * La);
  cudaError_t err = cudaFuncSetAttribute(
      multi_steps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  multi_steps_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
                const void* line_idx, const void* group, const void* chans,
                const void* qst, void* out_acc, const void* statics, int W, int D,
                int La, int M, int C, int S, void* stream) {
  const MultiStatics<T> st = *static_cast<const MultiStatics<T>*>(statics);
  const MultiTables<T> tb = make_tables<T>(lines, vel, line_idx, group, chans,
                                           qst, La, M, C, S);
  const size_t smem = step_smem_bytes<T>(W, D, (size_t)kWarps * st.ncomp * La);
  cudaError_t err = cudaFuncSetAttribute(
      multi_sharded_half_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  multi_sharded_half_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(state), static_cast<const int32_t*>(act),
      static_cast<const T*>(comp), static_cast<const T*>(zu),
      static_cast<const int32_t*>(pair), static_cast<const T*>(au), tb,
      static_cast<float*>(out_acc), W, D, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lnprob(const void* theta, void* out, const void* lines,
                  const void* vel, const void* line_idx, const void* group,
                  const void* chans, const void* qst, const void* statics,
                  int N, int D, int La, int M, int C, int S, void* stream) {
  const MultiStatics<T> st = *static_cast<const MultiStatics<T>*>(statics);
  const MultiTables<T> tb = make_tables<T>(lines, vel, line_idx, group, chans,
                                           qst, La, M, C, S);
  const size_t smem = sizeof(T) * (size_t)kWarps * st.ncomp * La;
  cudaError_t err = cudaFuncSetAttribute(
      multi_lnprob_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kWarps - 1) / kWarps;
  multi_lnprob_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<T*>(out), tb, N, D, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k2_statics_size_f32() { return (int)sizeof(MultiStatics<float>); }
int k2_statics_size_f64() { return (int)sizeof(MultiStatics<double>); }
const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int k2_fused_steps_f32(const void* coords, const void* lnp0, const void* perm,
                       const void* zu, const void* pair, const void* au,
                       const void* lines, const void* vel, const void* line_idx,
                       const void* group, const void* chans, const void* qst,
                       void* out_chain, void* out_lnps, void* out_acc,
                       const void* statics, int W, int D, int La, int M, int C,
                       int S, int k, void* stream) {
  return launch_steps<float>(coords, lnp0, perm, zu, pair, au, lines, vel,
                             line_idx, group, chans, qst, out_chain, out_lnps,
                             out_acc, statics, W, D, La, M, C, S, k, stream);
}

int k2_fused_steps_f64(const void* coords, const void* lnp0, const void* perm,
                       const void* zu, const void* pair, const void* au,
                       const void* lines, const void* vel, const void* line_idx,
                       const void* group, const void* chans, const void* qst,
                       void* out_chain, void* out_lnps, void* out_acc,
                       const void* statics, int W, int D, int La, int M, int C,
                       int S, int k, void* stream) {
  return launch_steps<double>(coords, lnp0, perm, zu, pair, au, lines, vel,
                              line_idx, group, chans, qst, out_chain, out_lnps,
                              out_acc, statics, W, D, La, M, C, S, k, stream);
}

int k2_lnprob_f32(const void* theta, void* out, const void* lines,
                  const void* vel, const void* line_idx, const void* group,
                  const void* chans, const void* qst, const void* statics,
                  int N, int D, int La, int M, int C, int S, void* stream) {
  return launch_lnprob<float>(theta, out, lines, vel, line_idx, group, chans,
                              qst, statics, N, D, La, M, C, S, stream);
}

int k2_lnprob_f64(const void* theta, void* out, const void* lines,
                  const void* vel, const void* line_idx, const void* group,
                  const void* chans, const void* qst, const void* statics,
                  int N, int D, int La, int M, int C, int S, void* stream) {
  return launch_lnprob<double>(theta, out, lines, vel, line_idx, group, chans,
                               qst, statics, N, D, La, M, C, S, stream);
}

#define K5C_HALF(SFX, T)                                                             \
  int k5c_half_##SFX(void* state, const void* act, const void* comp, const void* zu,  \
                     const void* pair, const void* au, const void* lines,             \
                     const void* vel, const void* line_idx, const void* group,        \
                     const void* chans, const void* qst, void* out_acc,               \
                     const void* statics, int W, int D, int La, int M, int C, int S,  \
                     void* stream) {                                                  \
    return launch_half<T>(state, act, comp, zu, pair, au, lines, vel, line_idx,       \
                          group, chans, qst, out_acc, statics, W, D, La, M, C, S,     \
                          stream);                                                    \
  }
K5C_HALF(f32, float)
K5C_HALF(f64, double)

}  // extern "C"
