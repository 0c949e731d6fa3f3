// Device code shared by the port's CUDA kernels: the launch shape, the
// scalar overloads and explicitly rounded intrinsics that make one
// template body serve float and double, the warp reduction, Q(T), the
// Planck term, the stick opacity, the beam dilution, the stretch factor
// and where a half-update's partner comes from. The whole-ensemble step
// kernels (K1 and K5a in fused_step.cu, K2 and K5c in multi_step.cu) build
// their half-updates on these in cluster_step.cuh; K3 and K5b
// (gather_step.cu) and K4 (opacity.cu) use the scalar pieces.
//
// Port of the parts of cha1_mcmc_tpu/sampler/fused.py that the TPU
// kernels share: _make_q_of (:57) and the stretch move of _run_step_loop
// (:221).
//
// What bounds these pieces on this card is the latency they add to the
// calling kernel's serial chain (a lane's channel walk: dependent exp,
// exp2, log and IEEE divides), not memory or issue rate. So each is a
// __forceinline__ device function on values in registers, with no table
// of its own, and the half-update is spread over a cluster
// (cluster_step.cuh) to shorten that chain. No fast-math: the explicitly
// rounded intrinsics keep f64 chains bitwise equal to the plain versions,
// and -inf survives the acceptance test.
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

}  // namespace
