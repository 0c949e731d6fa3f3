// Device code shared by the port's whole-ensemble-step kernels, K1
// (fused_step.cu) and K2 (multi_step.cu, through cluster_step.cuh), and
// their sharded half-steps K5a and K5c: the launch shape, the scalar
// overloads and explicitly rounded intrinsics that make one template body
// serve float and double, the warp reduction, Q(T), the Planck term, the
// stretch factor and where a partner comes from; and K1's one-CTA
// emcee-v3 half-update (half_update, templated on where the partners come
// from), the step loop over it (run_step_loop) and the sharded half-step
// (run_sharded_half), each templated on the warp-level device lnprob
// K1 / K5a supply. K2 / K5c spread their half-update over a cluster
// instead (cluster_step.cuh).
//
// Port of the parts of cha1_mcmc_tpu/sampler/fused.py that the TPU
// kernels share: _run_step_loop (:221) and _make_q_of (:57); and of
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_update (:91).
//
// Every name here is in an anonymous namespace: each .cu file including
// this header builds into its own shared library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // 16 warps a CTA
constexpr int kWarps = kThreads / 32;

enum QKind : int32_t { kQAnalytic = 0, kQCheb = 1, kQStates = 2 };

// Overloads so one template body serves float and double.
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float ex2(float x) { return exp2f(x); }
__device__ __forceinline__ double ex2(double x) { return exp2(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float ab(float x) { return fabsf(x); }
__device__ __forceinline__ double ab(double x) { return fabs(x); }
__device__ __forceinline__ float pw(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pw(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ __forceinline__ T neg_inf() { return -T(INFINITY); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x**n by binary exponentiation, multiplying in jax.lax.integer_pow's order.
template <typename T>
__device__ __forceinline__ T int_pow(T x, int n) {
  if (n == 0) return T(1);
  T acc = T(0);
  bool have = false;
  while (n > 0) {
    if (n & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return acc;
}

// Q(Tex), identical on every lane of the warp (_make_q_of). `st` is any
// statics struct with the Q fields (q_kind, poly/n_poly, has_power, q_pa,
// q_pb, q_scale, cheb/n_cheb, cheb_lo, cheb_scale); `qst` is the (2, S)
// state-sum table (g, E).
template <typename T, typename S>
__device__ T q_of(T Tex, const S& st, const T* qst, int n_states, int lane) {
  if (st.q_kind == kQCheb) {
    const T x = (Tex - st.cheb_lo) * st.cheb_scale - T(1);
    T bk1 = T(0), bk2 = T(0);
    for (int i = st.n_cheb - 1; i >= 1; --i) {
      const T nb = st.cheb[i] + T(2) * x * bk1 - bk2;
      bk2 = bk1;
      bk1 = nb;
    }
    return st.cheb[0] + x * bk1 - bk2;
  }
  if (st.q_kind == kQStates) {
    T part = T(0);
    for (int s = lane; s < n_states; s += 32)
      part += qst[s] * ex(-qst[n_states + s] / (T(0.69503476) * Tex));
    return warp_sum(part);
  }
  T q = T(0);
  for (int i = 0; i < st.n_poly; ++i) q = q + st.poly[i] * int_pow(Tex, i);
  if (st.has_power) q = q + st.q_pa * pw(Tex, st.q_pb);
  return st.q_scale * q;
}

// Planck radiation temperature with the hot loop's 1e-10 guard.
template <typename T>
__device__ __forceinline__ T planck_J(T freq_mhz, T temp) {
  const T x = T(6.626e-34) * freq_mhz * T(1e6) / T(1.381e-23);
  return x / (ex(x / temp) - T(1) + T(1e-10));
}

// Stick opacity of one line (ops/lte.py:tau_sticks) for one column.
template <typename T>
__device__ __forceinline__ T tau_stick(T lf, T le, T la, T lgu, T lgl, T Q,
                                       T Ncol, T Tex, T dV) {
  const T Nl = Ncol * lgl * ex(-le / (T(0.695) * Tex)) / Q;
  const T nu = lf * T(1e6);
  const T r = T(2.998e10) / nu;
  const T num = r * r * la * lgu * Nl
                * (T(1) - ex(-(T(6.626e-34) * nu) / (T(1.381e-23) * Tex)));
  const T den = T(8.0 * 3.141592653589793) * (dV * nu / T(2.998e5)) * lgl;
  return num / den;
}

// Beam dilution ss^2 / (beam^2 + ss^2) at one channel (ops/lte.py).
template <typename T>
__device__ __forceinline__ T beam_dilution(T freq_mhz, T ss, T dish_size) {
  const T wl = T(2.998e8) / (freq_mhz * T(1e6));
  const T beam = wl * T(206265.0) * T(1.22) / dish_size;
  return ss * ss / (beam * beam + ss * ss);
}

// z = ((a - 1) u + 1)^2 / a, each operation rounded as the plain version's.
template <typename T>
__device__ __forceinline__ T stretch_z(T u, T a) {
  const T t = add_rn(mul_rn(a - T(1), u), T(1));
  return div_rn(mul_rn(t, t), a);
}

// Where a half-update finds the partner c of proposal j: row pair[j] of
// the complement. For K1 and K2 the complement is the other half of the
// resident state (`cmp` indexes its rows); for the sharded half-steps (K5)
// it is the complement all-gathered over the walker shards, an (n, D)
// buffer in device memory.
template <typename T>
struct StateComplement {
  const T* state;
  const int32_t* cmp;
  int D1;
  __device__ const T* operator()(int32_t p) const { return state + cmp[p] * D1; }
};

template <typename T>
struct GatheredComplement {
  const T* comp;
  int D;
  __device__ const T* operator()(int32_t p) const { return comp + (size_t)p * D; }
};

// One half-update of the resident ensemble (the CTA): the h walkers `act`
// of `state` (W, D+1) against the partners comp(pair[j]), around any
// warp-level lnprob(theta, warp, lane). Shared scratch: `prop` (h, D+1),
// `zz` (h,), `flag` (h,); `acc_count` gains the accepted proposals. Ends
// on a barrier, so the next half reads this one's writes.
template <typename T, typename Comp, typename LnProb>
__device__ void half_update(T* state, int D, int h, const int32_t* act,
                            const Comp& comp, const T* zu, const int32_t* pair,
                            const T* au, T a, T* prop, T* zz, int* flag,
                            int* acc_count, const LnProb& lnprob) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = D + 1;
  // Phase 1: proposals Y = c + z (s - c) from indexed gathers.
  for (int j = tid; j < h; j += kThreads) {
    const T* s = state + act[j] * D1;
    const T* c = comp(pair[j]);
    const T z = stretch_z(zu[j], a);
    zz[j] = z;
    for (int d = 0; d < D; ++d)
      prop[j * D1 + d] = fma_rn(z, sub_rn(s[d], c[d]), c[d]);
  }
  __syncthreads();
  // Phase 2: one warp per proposal; lane 0 decides acceptance.
  for (int j = warp; j < h; j += kWarps) {
    const T lnp_new = lnprob(prop + j * D1, warp, lane);
    if (lane == 0) {
      const T lnp_s = state[act[j] * D1 + D];
      const T diff = sub_rn(add_rn(mul_rn(T(D - 1), lg(zz[j])), lnp_new), lnp_s);
      const bool accept = lg(au[j]) < diff;
      prop[j * D1 + D] = lnp_new;
      flag[j] = accept;
      if (accept) atomicAdd(acc_count, 1);
    }
  }
  __syncthreads();
  // Phase 3: write accepted proposals back (a select, not a delta).
  for (int j = tid; j < h; j += kThreads) {
    if (flag[j]) {
      T* dst = state + act[j] * D1;
      for (int d = 0; d < D1; ++d) dst[d] = prop[j * D1 + d];
    }
  }
  __syncthreads();
}

// k whole ensemble steps of one ensemble (the CTA), around any warp-level
// lnprob(theta, warp, lane). Shared state: `state` (W, D+1),
// `prop` (h, D+1), `zz` (h,), `flag` (h,), `acc_count`.
template <typename T, typename LnProb>
__device__ void run_step_loop(const T* coords, const T* lnp0,
                              const int32_t* perm, const T* zu,
                              const int32_t* pair, const T* au,
                              T* out_chain, T* out_lnps, float* out_acc,
                              int W, int D, int k, T a, T* state, T* prop,
                              T* zz, int* flag, int* acc_count,
                              const LnProb& lnprob) {
  const int tid = threadIdx.x;
  const int h = W / 2, D1 = D + 1;
  for (int i = tid; i < W * D; i += kThreads) state[(i / D) * D1 + i % D] = coords[i];
  for (int w = tid; w < W; w += kThreads) state[w * D1 + D] = lnp0[w];
  __syncthreads();

  for (int step = 0; step < k; ++step) {
    const int32_t* pm = perm + (size_t)step * W;
    if (tid == 0) *acc_count = 0;
    for (int half = 0; half < 2; ++half) {
      const int r = 2 * step + half;
      const StateComplement<T> comp{state, pm + (1 - half) * h, D1};
      half_update<T>(state, D, h, pm + half * h, comp, zu + r * h, pair + r * h,
                     au + r * h, a, prop, zz, flag, acc_count, lnprob);
    }
    T* oc = out_chain + (size_t)step * W * D;
    for (int i = tid; i < W * D; i += kThreads) oc[i] = state[(i / D) * D1 + i % D];
    for (int w = tid; w < W; w += kThreads) out_lnps[(size_t)step * W + w] = state[w * D1 + D];
    if (tid == 0) out_acc[step] = (float)(*acc_count);
    __syncthreads();
  }
}

// Size of the step kernels' shared memory: the state, the proposals, the
// stretch factors, `scratch` values of per-warp scratch and the flags.
template <typename T>
size_t step_smem_bytes(int W, int D, size_t scratch) {
  const int h = W / 2;
  return sizeof(T) * ((size_t)W * (D + 1) + (size_t)h * (D + 1) + h + scratch)
         + sizeof(int) * (h + 1);
}

// One sharded half-step (K5a, K5c) of a rank's W local walkers: load the
// (W, D+1) state from device memory into shared memory, half_update the h
// walkers `act` against the gathered complement `comp` (n, D), store the
// state back and write the accepted count to out_acc[0]. Shared memory as
// in the step kernels (step_smem_bytes).
template <typename T, typename LnProb>
__device__ void run_sharded_half(T* state_g, const int32_t* act, const T* comp,
                                 const T* zu, const int32_t* pair, const T* au,
                                 float* out_acc, int W, int D, T a, T* state,
                                 T* prop, T* zz, int* flag, int* acc_count,
                                 const LnProb& lnprob) {
  const int tid = threadIdx.x, n = W * (D + 1);
  for (int i = tid; i < n; i += kThreads) state[i] = state_g[i];
  if (tid == 0) *acc_count = 0;
  __syncthreads();
  const GatheredComplement<T> c{comp, D};
  half_update<T>(state, D, W / 2, act, c, zu, pair, au, a, prop, zz, flag,
                 acc_count, lnprob);
  for (int i = tid; i < n; i += kThreads) state_g[i] = state[i];
  if (tid == 0) out_acc[0] = (float)(*acc_count);
}

}  // namespace
