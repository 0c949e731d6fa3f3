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
//  * the step loop is written once (run_step_loop), templated on the
//    device lnprob, for the kernels that share it later.
//
// C entries (all return cudaGetLastError() after the launch):
//   k1_fused_steps_{f32,f64}: k whole steps of one ensemble;
//   k1_lnprob_{f32,f64}:      the same device lnprob over an (N, D) batch;
//   k1_statics_size_{f32,f64}: sizeof(Statics<T>), checked by the binding;
//   k1_error_string: the CUDA error message of a returned code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 5;
constexpr int kMaxPoly = 8;
constexpr int kMaxCheb = 65;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

enum QKind : int32_t { kQAnalytic = 0, kQCheb = 1, kQStates = 2 };

template <typename T>
struct Statics {
  T lo[kMaxDim], hi[kMaxDim];  // strict box bounds per theta dim
  T mean[kMaxDim], sd[kMaxDim];  // Gaussian priors (sd with overrides)
  T norm[kMaxDim];             // log(1/(sqrt(2 pi) sd)), computed in f64
  T poly[kMaxPoly];            // analytic Q: ascending coefficients
  T cheb[kMaxCheb];            // Chebyshev Q: c_0 .. c_deg
  T ss, dish_size, Tbg, mask_center, a;
  T q_scale, q_pa, q_pb, cheb_lo, cheb_scale;
  int32_t ndim, free_ss, ncol_idx, q_kind, n_poly, has_power, n_cheb, pad;
};

template <typename T>
struct Tables {
  const T* lines;  // (5, L): freq MHz, elower, aij, gup, glow
  const T* vel;    // (L, C): channel velocity relative to each line
  const T* chans;  // (3, C): freq MHz, observed y, 1 / sigma^2
  const T* qst;    // (2, S): state-sum g, E
  int L, C, S;
};

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

// Q(Tex), identical on every lane of the warp (_make_q_of).
template <typename T>
__device__ T q_of(T Tex, const Statics<T>& st, const Tables<T>& tb, int lane) {
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
    for (int s = lane; s < tb.S; s += 32)
      part += tb.qst[s] * ex(-tb.qst[tb.S + s] / (T(0.69503476) * Tex));
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

// lnprob of one proposal, evaluated by one warp; `tau` is the warp's
// (L,) scratch. The value is returned on every lane.
template <typename T>
__device__ T dense_lnprob(const T* th, const Statics<T>& st,
                          const Tables<T>& tb, T* tau, int lane) {
  T ss_w, Ncol, Tex, vlsr, dV;
  if (st.free_ss) {
    ss_w = th[0]; Ncol = th[1]; Tex = th[2]; vlsr = th[3]; dV = th[4];
  } else {
    ss_w = st.ss; Ncol = th[0]; Tex = th[1]; vlsr = th[2]; dV = th[3];
  }
  // Box bounds + Gaussian priors, Ncol flat (_prior_box).
  bool ok = true;
  T lp = T(0);
#pragma unroll
  for (int i = 0; i < kMaxDim; ++i) {
    if (i < st.ndim) {
      const T x = th[i];
      ok = ok && (x > st.lo[i]) && (x < st.hi[i]);
      if (i != st.ncol_idx) {
        const T u = (x - st.mean[i]) / st.sd[i];
        lp = lp + (st.norm[i] - T(0.5) * (u * u));
      }
    }
  }
  if (!ok) return neg_inf<T>();  // the whole warp leaves together

  // Stick opacities (ops/lte.py:tau_sticks), one line per lane.
  const T Q = q_of(Tex, st, tb, lane);
  for (int l = lane; l < tb.L; l += 32) {
    const T lf = tb.lines[l], le = tb.lines[tb.L + l];
    const T la = tb.lines[2 * tb.L + l], lgu = tb.lines[3 * tb.L + l];
    const T lgl = tb.lines[4 * tb.L + l];
    const T Nl = Ncol * lgl * ex(-le / (T(0.695) * Tex)) / Q;
    const T nu = lf * T(1e6);
    const T r = T(2.998e10) / nu;
    const T num = r * r * la * lgu * Nl
                  * (T(1) - ex(-(T(6.626e-34) * nu) / (T(1.381e-23) * Tex)));
    const T den = T(8.0 * 3.141592653589793) * (dV * nu / T(2.998e5)) * lgl;
    tau[l] = num / den;
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
    const T wl = T(2.998e8) / (gf * T(1e6));
    const T beam = wl * T(206265.0) * T(1.22) / st.dish_size;
    const T dil = ss_w * ss_w / (beam * beam + ss_w * ss_w);
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

// z = ((a - 1) u + 1)^2 / a, each operation rounded as the plain version's.
template <typename T>
__device__ __forceinline__ T stretch_z(T u, T a) {
  const T t = add_rn(mul_rn(a - T(1), u), T(1));
  return div_rn(mul_rn(t, t), a);
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = W / 2, D1 = D + 1;
  for (int i = tid; i < W * D; i += kThreads) state[(i / D) * D1 + i % D] = coords[i];
  for (int w = tid; w < W; w += kThreads) state[w * D1 + D] = lnp0[w];
  __syncthreads();

  for (int step = 0; step < k; ++step) {
    const int32_t* pm = perm + (size_t)step * W;
    if (tid == 0) *acc_count = 0;
    for (int half = 0; half < 2; ++half) {
      const int r = 2 * step + half;
      const int32_t* act = pm + half * h;
      const int32_t* cmp = pm + (1 - half) * h;
      // Phase 1: proposals Y = c + z (s - c) from indexed gathers.
      for (int j = tid; j < h; j += kThreads) {
        const T* s = state + act[j] * D1;
        const T* c = state + cmp[pair[r * h + j]] * D1;
        const T z = stretch_z(zu[r * h + j], a);
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
          const bool accept = lg(au[r * h + j]) < diff;
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
    T* oc = out_chain + (size_t)step * W * D;
    for (int i = tid; i < W * D; i += kThreads) oc[i] = state[(i / D) * D1 + i % D];
    for (int w = tid; w < W; w += kThreads) out_lnps[(size_t)step * W + w] = state[w * D1 + D];
    if (tid == 0) out_acc[step] = (float)(*acc_count);
    __syncthreads();
  }
}

template <typename T>
size_t step_smem_bytes(int W, int D, int L) {
  const int h = W / 2;
  return sizeof(T) * ((size_t)W * (D + 1) + (size_t)h * (D + 1) + h + (size_t)kWarps * L)
         + sizeof(int) * (h + 1);
}

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
  const size_t smem = step_smem_bytes<T>(W, D, L);
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

}  // extern "C"
