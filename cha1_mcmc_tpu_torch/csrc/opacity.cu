// K4a / K4b — the block-sparse and the compacted (CSR) Gaussian-opacity
// kernels, hand-written for Hopper (sm_90a). Built at first use by
// cha1_mcmc_tpu_torch/utils/cuda_build.py and bound through ctypes by
// cha1_mcmc_tpu_torch/models/opacity_kernels.py, whose plain PyTorch
// versions (opacity_block_plain / opacity_csr_plain) compute the same
// functions and are the kernels' test oracles.
//
// Both compute, for W walkers and C channels,
//   opac[w, c] = sum_l tau[w, l] * g(vel[l, c]; vlsr_w, dV_w)
// with the Gaussian in one of two forms:
//   exp  (kExp):  1{|v - v0| < 10 dV} exp(-0.5 ((v - vlsr) / sigma)^2)
//   exp2 (kExp2): exp2(aa (v - vlsr)^2), aa = -log2(e) / (2 sigma^2),
//                 with the same window select unless the caller proved it
//                 a no-op (unmasked; see below), sigma = dV / 2.355.
//
// Replaces the Pallas TPU kernels of cha1_mcmc_tpu/models/pallas_kernels.py:
//   K4a: _opacity_kernel (:90) and _opacity_kernel_fused (:176) — the exp
//        form — and _opacity_kernel_mxu (:136) — the exp2 form, masked or
//        not — over the shared block-sparse call (:240): (W, C) tiled as
//        walkers x 128-channel tiles x 512-line tiles, a tile skipped when
//        its (line tile, channel tile) bit of the activity mask is 0;
//   K4b: _opacity_kernel_csr (:344, call :423) — the exp2 form over the
//        lines compacted per 128-channel tile (line_table (nC, K),
//        vel_compact (nC * K, 128), tile_counts (nC,)).
//
// What bounds them on this card: the special-function unit. Every
// (walker, line, channel) term of an active tile costs one exp or exp2
// (and, in the exp form, one IEEE divide); the bytes are the velocity
// tiles (read once per walker tile) and the taus. At the dense fit's size
// (128 walkers, ~2,200 lines x ~10,900 channels) the block kernel
// evaluates ~10^9 Gaussians per call and the CSR kernel ~10^8.
//
// Design:
//  * one CTA owns a (8-walker tile, 128-channel tile); each thread owns
//    one channel and keeps the 8 walkers' sums in registers, accumulated
//    in line order (no atomics, deterministic);
//  * K4a walks the 512-line tiles in order and skips those whose mask bit
//    is 0 (the branch is uniform over the CTA); K4b walks its tile's
//    tile_counts[j] compacted lines and gathers their taus through
//    line_table itself (the TPU path materialised a (W, nC * K) gather);
//  * a tile's taus are staged in shared memory (8 x 512 values), the
//    velocities stream from device memory one coalesced row per line;
//  * the TPU's MXU contraction at Precision.HIGHEST becomes a plain
//    FP32/FP64 multiply-add: no tensor cores, so no TF32;
//  * masked: an out-of-window term is skipped, which is exact because it
//    would add tau * 0 = 0 for a finite tau. Unmasked (the exp2 form only)
//    evaluates every term. The TPU flushes subnormals; this card does not
//    (no fast-math, no flush-to-zero), so exp2(aa d^2) rounds to exactly
//    0 in float32 only once z = |d| / sigma > 14.4205 (2^-150, half the
//    smallest subnormal), and in float64 only beyond z = 38.6 (2^-1075).
//    window_is_exact's float32 edge, 14.37 x 1.1 = 15.81, clears the first;
//    models/opacity_kernels.py:unmasked_is_exact takes the unmasked form
//    only for float32 under that test.
//
// C entries (all return cudaGetLastError() after the launch):
//   k4_block_opacity_{f32,f64}: K4a, form 0 = exp, 1 = exp2;
//   k4_csr_opacity_{f32,f64}:   K4b (exp2);
//   k4_error_string: the CUDA error message of a returned code.

#include "step_loop.cuh"

namespace {

constexpr int kTC = 128;        // channels per CTA: the tables' channel tile
constexpr int kTW = 8;          // walkers per CTA, summed in registers
constexpr int kTL = 512;        // line tile of the block activity mask
constexpr int kCsrChunk = 512;  // compacted lines staged per pass (K4b)

enum Form : int { kExp = 0, kExp2 = 1 };

// Per-walker constants of the CTA's walker tile, in shared memory.
template <typename T>
struct WalkerTile {
  T vlsr[kTW], sigma[kTW], aa[kTW], win[kTW];
};

// Padded walkers (w >= W) take dV = 1, vlsr = 0 and zero taus: their sums
// are never written.
template <typename T>
__device__ void load_walkers(WalkerTile<T>& wt, const T* vlsr, const T* dv,
                             int w0, int W) {
  const int t = threadIdx.x;
  if (t < kTW) {
    const bool in = w0 + t < W;
    const T d = in ? dv[w0 + t] : T(1);
    const T sigma = d / T(2.355);
    wt.vlsr[t] = in ? vlsr[w0 + t] : T(0);
    wt.sigma[t] = sigma;
    wt.aa[t] = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
    wt.win[t] = T(10) * d;
  }
}

// acc[w] += tau_w * g(v) for the CTA's walkers, tau_w = tau[w * stride].
template <typename T, int F, bool Masked>
__device__ __forceinline__ void accumulate(T (&acc)[kTW], const WalkerTile<T>& wt,
                                           const T* tau, int stride, T v, T mc) {
#pragma unroll
  for (int w = 0; w < kTW; ++w) {
    if (Masked && !(ab(v - mc) < wt.win[w])) continue;   // adds exactly 0
    T g;
    if (F == kExp) {
      const T z = (v - wt.vlsr[w]) / wt.sigma[w];
      g = ex(T(-0.5) * z * z);
    } else {
      const T d = v - wt.vlsr[w];
      g = ex2(wt.aa[w] * (d * d));
    }
    acc[w] += tau[w * stride] * g;
  }
}

template <typename T>
__device__ __forceinline__ void store(const T (&acc)[kTW], T* out, int w0, int W,
                                      int c, int C) {
  if (c >= C) return;
#pragma unroll
  for (int w = 0; w < kTW; ++w)
    if (w0 + w < W) out[(size_t)(w0 + w) * C + c] = acc[w];
}

// K4a: grid (nC, ceil(W / 8)), 128 threads; vel (L, C), mask (nL, nC).
template <typename T, int F, bool Masked>
__global__ void __launch_bounds__(kTC)
block_opacity_kernel(const T* __restrict__ taus, const T* __restrict__ vlsr,
                     const T* __restrict__ dv, const T* __restrict__ vel,
                     const int32_t* __restrict__ mask, T* __restrict__ out,
                     int W, int L, int C, int nL, int nC, T mc) {
  __shared__ T s_tau[kTW * kTL];
  __shared__ WalkerTile<T> wt;
  const int ct = blockIdx.x, w0 = blockIdx.y * kTW, tid = threadIdx.x;
  const int c = ct * kTC + tid;
  load_walkers(wt, vlsr, dv, w0, W);
  T acc[kTW];
#pragma unroll
  for (int w = 0; w < kTW; ++w) acc[w] = T(0);
  for (int lt = 0; lt < nL; ++lt) {
    if (!mask[lt * nC + ct]) continue;   // uniform over the CTA
    const int l0 = lt * kTL, n = min(kTL, L - l0);
    __syncthreads();                     // the previous tile's readers are done
    for (int i = tid; i < kTW * kTL; i += kTC) {
      const int w = i / kTL, l = i % kTL;
      s_tau[i] = (w0 + w < W && l < n) ? taus[(size_t)(w0 + w) * L + l0 + l] : T(0);
    }
    __syncthreads();
    if (c < C) {
      for (int l = 0; l < n; ++l)
        accumulate<T, F, Masked>(acc, wt, s_tau + l, kTL, vel[(size_t)(l0 + l) * C + c], mc);
    }
  }
  store(acc, out, w0, W, c, C);
}

// K4b: grid (nC, ceil(W / 8)), 128 threads; line_table (nC, K),
// vel_compact (nC * K, 128), tile_counts (nC,).
template <typename T, bool Masked>
__global__ void __launch_bounds__(kTC)
csr_opacity_kernel(const T* __restrict__ taus, const T* __restrict__ vlsr,
                   const T* __restrict__ dv, const int32_t* __restrict__ line_table,
                   const T* __restrict__ vel_compact,
                   const int32_t* __restrict__ tile_counts, T* __restrict__ out,
                   int W, int L, int K, int n_channels, T mc) {
  __shared__ T s_tau[kTW * kCsrChunk];
  __shared__ WalkerTile<T> wt;
  const int j = blockIdx.x, w0 = blockIdx.y * kTW, tid = threadIdx.x;
  load_walkers(wt, vlsr, dv, w0, W);
  T acc[kTW];
#pragma unroll
  for (int w = 0; w < kTW; ++w) acc[w] = T(0);
  const int count = tile_counts[j];
  const int32_t* lines = line_table + (size_t)j * K;
  for (int k0 = 0; k0 < count; k0 += kCsrChunk) {
    const int n = min(kCsrChunk, count - k0);
    __syncthreads();
    for (int i = tid; i < kTW * kCsrChunk; i += kTC) {
      const int w = i / kCsrChunk, k = i % kCsrChunk;
      s_tau[i] = (w0 + w < W && k < n) ? taus[(size_t)(w0 + w) * L + lines[k0 + k]] : T(0);
    }
    __syncthreads();
    const T* vrow = vel_compact + ((size_t)j * K + k0) * kTC + tid;
    for (int k = 0; k < n; ++k)
      accumulate<T, kExp2, Masked>(acc, wt, s_tau + k, kCsrChunk, vrow[(size_t)k * kTC], mc);
  }
  store(acc, out, w0, W, j * kTC + tid, n_channels);
}

template <typename T>
int launch_block(const void* taus, const void* vlsr, const void* dv, const void* vel,
                 const void* mask, void* out, int W, int L, int C, int nL, int nC,
                 int form, int masked, double mc, void* stream) {
  const dim3 grid(nC, (W + kTW - 1) / kTW);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(taus);
  const T* b = static_cast<const T*>(vlsr);
  const T* d = static_cast<const T*>(dv);
  const T* v = static_cast<const T*>(vel);
  const int32_t* m = static_cast<const int32_t*>(mask);
  T* o = static_cast<T*>(out);
  if (form == kExp)   // the exp form is always masked (_opacity_kernel)
    block_opacity_kernel<T, kExp, true><<<grid, kTC, 0, s>>>(a, b, d, v, m, o, W, L, C, nL, nC, T(mc));
  else if (masked)
    block_opacity_kernel<T, kExp2, true><<<grid, kTC, 0, s>>>(a, b, d, v, m, o, W, L, C, nL, nC, T(mc));
  else
    block_opacity_kernel<T, kExp2, false><<<grid, kTC, 0, s>>>(a, b, d, v, m, o, W, L, C, nL, nC, T(mc));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_csr(const void* taus, const void* vlsr, const void* dv, const void* line_table,
               const void* vel_compact, const void* tile_counts, void* out, int W, int L,
               int K, int nC, int n_channels, int masked, double mc, void* stream) {
  const dim3 grid(nC, (W + kTW - 1) / kTW);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(taus);
  const T* b = static_cast<const T*>(vlsr);
  const T* d = static_cast<const T*>(dv);
  const int32_t* lt = static_cast<const int32_t*>(line_table);
  const T* v = static_cast<const T*>(vel_compact);
  const int32_t* tc = static_cast<const int32_t*>(tile_counts);
  T* o = static_cast<T*>(out);
  if (masked)
    csr_opacity_kernel<T, true><<<grid, kTC, 0, s>>>(a, b, d, lt, v, tc, o, W, L, K, n_channels, T(mc));
  else
    csr_opacity_kernel<T, false><<<grid, kTC, 0, s>>>(a, b, d, lt, v, tc, o, W, L, K, n_channels, T(mc));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* k4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int k4_block_opacity_f32(const void* taus, const void* vlsr, const void* dv, const void* vel,
                         const void* mask, void* out, int W, int L, int C, int nL, int nC,
                         int form, int masked, double mc, void* stream) {
  return launch_block<float>(taus, vlsr, dv, vel, mask, out, W, L, C, nL, nC, form, masked,
                             mc, stream);
}

int k4_block_opacity_f64(const void* taus, const void* vlsr, const void* dv, const void* vel,
                         const void* mask, void* out, int W, int L, int C, int nL, int nC,
                         int form, int masked, double mc, void* stream) {
  return launch_block<double>(taus, vlsr, dv, vel, mask, out, W, L, C, nL, nC, form, masked,
                              mc, stream);
}

int k4_csr_opacity_f32(const void* taus, const void* vlsr, const void* dv,
                       const void* line_table, const void* vel_compact,
                       const void* tile_counts, void* out, int W, int L, int K, int nC,
                       int n_channels, int masked, double mc, void* stream) {
  return launch_csr<float>(taus, vlsr, dv, line_table, vel_compact, tile_counts, out, W, L,
                           K, nC, n_channels, masked, mc, stream);
}

int k4_csr_opacity_f64(const void* taus, const void* vlsr, const void* dv,
                       const void* line_table, const void* vel_compact,
                       const void* tile_counts, void* out, int W, int L, int K, int nC,
                       int n_channels, int masked, double mc, void* stream) {
  return launch_csr<double>(taus, vlsr, dv, line_table, vel_compact, tile_counts, out, W, L,
                            K, nC, n_channels, masked, mc, stream);
}

}  // extern "C"
