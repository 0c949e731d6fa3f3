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
// What bounds them on this card: bytes. The least work of a call is the
// active tiles' velocities (K4a) or the compacted rows (K4b) read once,
// the taus and the output; one compare per element against the widest
// window; per walker, a compare per candidate and one exp2 per in-window
// term. At the dense fit's size (128 walkers, 2,232 lines x 10,924
// channels, 90 active 512 x 128 tiles) that is ~28 MB against ~5.4M
// element compares and ~10^7 walker terms: ~8 us of memory, ~1 us of
// arithmetic. The window keeps ~1% of an active tile's elements at the
// widest prior dV. No tensor cores: the contraction sum_l tau[w, l] *
// g[w, l, c] has a different Gaussian per walker and ~99% of its terms
// are 0, so it is no matrix product and wgmma has nothing to do.
//
// Design (one launch a call):
//  * A CTA owns 32 channels (a quarter of a channel tile) for up to 128
//    walkers, so the velocities cross L2 once a call for W <= 128. The
//    grid is (channel groups, walker groups): at the dense size 344 CTAs
//    of 8 warps over 132 SMs, 3 an SM. (A CTA of 64 channels and 16 warps
//    was slower on the card, for K4a and K4b, f32 and f64: PERF.md.)
//  * The walkers' constants (vlsr, the test radius, aa or sigma) sit in
//    shared memory, and each warp reduces the widest radius over the
//    CTA's walkers itself (no host synchronisation). Registers are kept
//    for the chunk loop: a value it spills to local memory is reloaded
//    through an L1 that shared memory has mostly taken, once a chunk.
//  * The CTA walks its channel tile's rows — the lines of its active
//    512-line tiles in order (K4a), or its tile_counts[j] compacted lines
//    (K4b) — in chunks of 32 rows, copied into a ring of 5 slots by
//    cp.async, 16 bytes at a time (4-byte copies would halve the rate):
//    the plan gives the table 16-byte aligned rows (K4a: a row pitch
//    rounded up to 16 bytes, NaN past the C channels; K4b's rows are 128
//    values). The next chunks load while the current one is filtered, one
//    barrier a chunk.
//  * Per chunk, the warp that owns a channel (4 a warp) tests its 32 rows
//    with one compare each of |v - mc| against the widest radius; a ballot
//    and a prefix count append the rows that pass (velocity, line) to the
//    channel's candidate list, in line order.
//  * Then (and whenever a list might not hold another chunk) the lists are
//    flushed: the candidates of a group of 32 channels lie on a few
//    neighbouring lines (11 on average, 26 at most at the dense size and
//    the widest window), so their taus come into shared memory once, as
//    a window of kSpan lines read coalesced for every walker. The owner
//    warp walks each of its channels' lists, lanes over walkers, 4 walkers
//    a lane: each lane pays its walkers' own tests and, where they pass,
//    the Gaussians and tau * g into the (walker, channel) sums of the
//    output tile. Each sum has one owner lane and takes its terms in line
//    order: no atomics, the same bits at every call.
//    A channel with no candidate keeps 0.
//  * The output tile (walkers x 32) leaves as whole rows of 32 channels.
//
// Rounding: sigma = dV * (1 / 2.355) and aa = (1 / sigma^2) * (-log2(e) /
// 2), as torch rounds the plain version's dV / 2.355 (a division by a
// scalar is a multiplication by its reciprocal on the card) and
// _AA / sigma^2 (a scalar over a tensor is the tensor's reciprocal times
// the scalar). So each term is the plain version's on the card, and only
// the order of the sums differs: a sum made of tail terms alone (z ~ 10-24,
// whose relative error is ~z^2 times that of sigma) still agrees in f32 to
// rtol 1e-5.
//
// Exactness of the prefilter:
//  * masked: the walker's test is |v - mc| < T(10) * dV_w, the plain
//    version's own select; the widest radius is max_w T(10) * dV_w, so
//    every term some walker's test keeps passes the prefilter, and a term
//    it drops is one the plain version multiplies by 0 (tau * 0 = 0 for a
//    finite tau, the old kernel's contract).
//  * unmasked (every term counts): a term may be dropped only where the
//    plain version's term is exactly 0. exp2 rounds to exactly 0 below
//    2^-150 in float32 (half the smallest subnormal; nothing flushes
//    subnormals here) and below 2^-1075 in float64, i.e. past z = |d| /
//    sigma = 14.42 (f32) or 38.6 (f64), since aa d^2 = -log2(e) z^2 / 2.
//    The walker's radius is reach_w = off_w + |sigma_w| kZ + slack (2 off_w
//    + |sigma_w| kZ), off_w = |vlsr_w - mc|, with kZ = 16 (f32: aa d^2 <=
//    -184.7, 34.7 past the edge, far beyond the few-ulp error of aa, d^2
//    and exp2f) or 40 (f64: <= -1154 against -1075). If |v - mc| >= reach_w
//    then |v - vlsr_w| >= |v - mc| - off_w >= |sigma_w| kZ: the slack
//    (2^-18 in f32, 2^-46 in f64, against a unit roundoff of 2^-24 /
//    2^-53) covers the rounding of the three differences. A walker whose
//    sigma is 0, non-finite or squares to infinity, or whose reach is not
//    finite, takes reach = inf: all its terms are evaluated as the plain
//    version evaluates them, so walkers outside any prior box keep the
//    plain version's answer. The widest reach is the prefilter as above.
//    An added 0 does not change a sum, so the result is bitwise that of
//    evaluating every term in the same order.
//
// C entries (all return a cudaError_t code):
//   k4_prepare: opens every kernel to the dynamic shared memory a CTA can
//     opt into on the current device; once per device, before any launch;
//   k4_opacity_{f32,f64}: one launch over a packed K4Tables (the plan's
//     static tables) and the call's taus / vlsr / dV, form 0 = exp, 1 =
//     exp2; the launch's own cudaGetLastError();
//   k4_error_string: the CUDA error message of a returned code.

#include <climits>

#include "step_loop.cuh"

namespace {

constexpr int kTC = 128;     // channel tile of the tables
constexpr int kTL = 512;     // line tile of the block activity mask
constexpr int kRows = 32;    // rows a chunk holds: the 32 a ballot tests
constexpr int kCap = 64;     // candidates a channel's list holds (flushed past kCap - kRows)
constexpr int kSpan = 32;    // lines a tau window holds
constexpr int kWalkers = 128;  // walkers a CTA sums: 4 a lane
constexpr int kWpl = kWalkers / 32;
constexpr int kCW = 32;        // channels a CTA owns
constexpr int kCtaThreads = 256;  // 8 warps, each the owner of 4 channels
constexpr int kStages = 5;     // the cp.async ring's chunks (all but one in flight)

enum Form : int { kExp = 0, kExp2 = 1 };

// CTAs an SM should hold at once: the dense size's 344 CTAs in one wave
// needs 3 (so at most 85 registers a thread); shared memory holds f64
// CTAs to 2.
template <typename T>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 ? 3 : 2;
}

// The unmasked radius's z past which exp2 is exactly 0, with margin, and
// the slack for the rounding of |v - mc|, |vlsr - mc| and v - vlsr.
template <typename T> struct Reach;
template <> struct Reach<float> {
  static constexpr float kZ = 16.0f, kSlack = 1.0f / 262144.0f;            // 2^-18
};
template <> struct Reach<double> {
  static constexpr double kZ = 40.0, kSlack = 1.0 / 70368744177664.0;      // 2^-46
};

// The plan's static tables (models/opacity_kernels.py:_K4Tables, same
// layout). K4a: vel = vel_grid's (L, C) values in rows `pitch` apart,
// mask (nL, nC); K4b: vel = vel_compact (nC * K, 128), pitch 128,
// line_table (nC, K), counts (nC,). vel and its rows start 16-byte
// aligned.
struct K4Tables {
  const void* vel;
  const int32_t* mask;
  const int32_t* line_table;
  const int32_t* counts;
  int32_t L, C, nL, nC, K, csr, pitch, pad;
  double mask_center;
};

template <typename T>
struct Call {
  const T* taus;                 // (W, L)
  const T* vlsr;                 // (W,)
  const T* dv;                   // (W,)
  T* out;                        // (W, C)
  const T* vel;
  const int32_t* mask;
  const int32_t* line_table;
  const int32_t* counts;
  int W, L, C, nL, nC, K;
  int pitch;                     // values between vel's rows
  int wgp;                       // walkers a CTA holds: min(128, W rounded up to 32)
  T mc;
};

__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }

// 4 bytes (a staged row's line)
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
// 16 bytes, both addresses 16-byte aligned; bypasses L1 (read once)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged chunk is row-major, kRows x (kCW + 16 bytes): each row starts
// 16-byte aligned for the 16-byte copies.
template <typename T>
__host__ __device__ constexpr int stage_pitch() { return kCW + 16 / (int)sizeof(T); }

// Dynamic shared memory of one CTA, T first: the chunk ring (kStages x
// kRows x stage_pitch), the output tile (wgp x (kCW + 1)), the tau window
// (kSpan x (wgp + 1)), the candidates' velocities (kCW x kCap), the
// walkers' vlsr / radius / aa-or-sigma (3 x 128); then int32: each staged
// row's line, the candidates' lines (kCW x kCap), the active line tiles
// (K4a).
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int wgp, int n_tiles) {
  return sizeof(T) * ((size_t)kStages * kRows * stage_pitch<T>() +
                      (size_t)wgp * (kCW + 1) + (size_t)kSpan * (wgp + 1) +
                      (size_t)kCW * kCap + 3 * kWalkers) +
         sizeof(int32_t) * ((size_t)kStages * kRows + (size_t)kCW * kCap + n_tiles);
}

// Grid (nC * 128 / kCW channel groups, walker groups of 128); see the
// note above.
template <typename T, int F, bool Masked, bool Csr>
__global__ void __launch_bounds__(kCtaThreads, (min_blocks<T>()))
opacity_kernel(const __grid_constant__ Call<T> a) {
  constexpr int CW = kCW, NT = kCtaThreads, NWARP = NT / 32, CPW = CW / NWARP;
  constexpr int SP = stage_pitch<T>(), NSTAGE = kStages;
  constexpr int kChunksPerTile = kTL / kRows;
  static_assert(CW % NWARP == 0 && CPW == 4, "geometry");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_n, s_lo;
  const int wgp = a.wgp;
  T* ring = reinterpret_cast<T*>(smem);
  T* out_s = ring + (size_t)NSTAGE * kRows * SP;
  T* s_tau = out_s + (size_t)wgp * (CW + 1);
  T* list_v = s_tau + (size_t)kSpan * (wgp + 1);
  T* w_vlsr = list_v + CW * kCap;   // kWalkers each
  T* w_rad = w_vlsr + kWalkers;
  T* w_k = w_rad + kWalkers;        // aa (exp2) or sigma (exp)
  int32_t* s_line = reinterpret_cast<int32_t*>(w_k + kWalkers);
  int32_t* list_l = s_line + NSTAGE * kRows;
  int32_t* act = list_l + CW * kCap;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = kTC / CW;
  const int ct = blockIdx.x / groups, cb = (blockIdx.x % groups) * CW, c0 = ct * kTC + cb;
  const int w0 = blockIdx.y * kWalkers, nw = min(kWalkers, a.W - w0);
  const T mc = a.mc;

  // The walkers' constants (vlsr, the test radius, aa or sigma) into
  // shared memory, from warp 0; every warp reduces the widest radius
  // among the CTA's walkers (lane + 32 u) itself.
  T rmax = T(0);
#pragma unroll
  for (int u = 0; u < kWpl; ++u) {
    const int w = lane + 32 * u;
    const T d = w < nw ? a.dv[w0 + w] : T(1), v = w < nw ? a.vlsr[w0 + w] : T(0);
    const T sigma = d * (T(1) / T(2.355));
    T r;
    if (Masked) {
      r = T(10) * d;
    } else {
      const T off = ab(v - mc), s = ab(sigma), reach = s * Reach<T>::kZ;
      r = (off + reach) + Reach<T>::kSlack * (T(2) * off + reach);
      if (!(s > T(0)) || !(s * s < T(INFINITY)) || !(r < T(INFINITY))) r = T(INFINITY);
    }
    r = w < nw ? r : T(0);   // no walker: no term
    if (warp == 0) {
      w_vlsr[w] = v;
      w_rad[w] = r;
      w_k[w] = (F == kExp) ? sigma : (T(1) / (sigma * sigma)) * T(-0.5 * 1.4426950408889634);
    }
    rmax = mx(rmax, r);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rmax = mx(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
  for (int i = tid; i < wgp * (CW + 1); i += NT) out_s[i] = T(0);

  // the rows this CTA walks, in chunks of kRows
  int count = 0;
  if (Csr) {
    count = min(max(a.counts[ct], 0), a.K);
  } else if (warp == 0) {   // the active line tiles, in order, 32 bits at a time
    int n = 0;
    for (int l0 = 0; l0 < a.nL; l0 += 32) {
      const bool on = l0 + lane < a.nL && a.mask[(size_t)(l0 + lane) * a.nC + ct] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) act[n + __popc(m & ((1u << lane) - 1u))] = l0 + lane;
      n += __popc(m);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  const int n_chunks = Csr ? (count + kRows - 1) / kRows : s_n * kChunksPerTile;

  // chunk q -> ring slot q % NSTAGE: kRows rows x CW channels, NaN where
  // no row or channel is (NaN never passes a compare); each row's line.
  // Rows are copied 16 bytes at a time (a copy that starts before channel
  // C may take the NaN of K4a's row padding, or K4b's row past its
  // channels: neither reaches the output). K4b: a row past the tile's
  // count is no row; its line (copied too) is checked by the scan.
  auto fetch = [&](int q) {
    if (q < n_chunks) {
      T* st = ring + (size_t)(q % NSTAGE) * kRows * SP;
      int32_t* ln = s_line + (q % NSTAGE) * kRows;
      const int base = Csr ? q * kRows
                           : act[q / kChunksPerTile] * kTL + (q % kChunksPerTile) * kRows;
      const int rows = Csr ? count - base : a.L - base;   // rows that exist
      const size_t pitch = (size_t)a.pitch;
      const T* src = Csr ? a.vel + ((size_t)ct * a.K + base) * pitch + cb
                         : a.vel + (size_t)base * pitch + c0;
      constexpr int V = 16 / (int)sizeof(T);   // values a 16-byte copy holds
      for (int e = tid; e < kRows * CW / V; e += NT) {
        const int r = e / (CW / V), c = (e % (CW / V)) * V;
        if (r < rows && c0 + c < a.C) {
          cp_async16(st + r * SP + c, src + r * pitch + c);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) st[r * SP + c + u] = T(NAN);
        }
      }
      if (tid < kRows) {
        if (Csr && tid < rows)
          cp_async4(ln + tid, a.line_table + (size_t)ct * a.K + base + tid);
        else
          ln[tid] = Csr ? -1 : base + tid;
      }
    }
    cp_commit();   // one group per chunk slot, empty past the last chunk
  };

  // Flush: each (walker, channel) sum takes its channel's listed
  // candidates in order. The warp that listed channel c (c = warp + k *
  // NWARP) sums it, lanes over walkers, 4 walkers a lane, so a candidate's
  // 4 terms a lane are independent. The taus come through a window of
  // kSpan lines from the lowest line any list still needs, loaded
  // coalesced into shared memory; a list is walked while its line lies in
  // the window. Lines in list order need not increase (K4b's table is the
  // caller's): a list stops at the first line outside the window and the
  // next window starts at the lowest such line.
  int nc[CPW];   // this warp's channels' list counts
#pragma unroll
  for (int k = 0; k < CPW; ++k) nc[k] = 0;
  auto flush = [&]() {
    int cur[CPW];
#pragma unroll
    for (int k = 0; k < CPW; ++k) cur[k] = 0;
    for (;;) {
      if (tid == 0) s_lo = INT_MAX;
      __syncthreads();   // the lists are complete; the last window's readers are done
      int m = INT_MAX;
#pragma unroll
      for (int k = 0; k < CPW; ++k)
        if (cur[k] < nc[k]) m = min(m, list_l[(warp + k * NWARP) * kCap + cur[k]]);
      if (lane == 0 && m < INT_MAX) atomicMin(&s_lo, m);
      __syncthreads();
      const int lo = s_lo;
      if (lo == INT_MAX) break;
      {   // the window's taus, every load in flight before the first store
        constexpr int U = kSpan * kWalkers / NT;
        T val[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = tid + u * NT, j = e % kSpan, w = e / kSpan;
          val[u] = w < nw && lo + j < a.L
                       ? __ldg(a.taus + (size_t)(w0 + w) * a.L + lo + j) : T(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = tid + u * NT;
          if (e / kSpan < nw) s_tau[(e % kSpan) * (wgp + 1) + e / kSpan] = val[u];
        }
      }
      __syncthreads();
      // this lane's walkers lane + 32 u
      T vl[kWpl], rd[kWpl], wk[kWpl];
#pragma unroll
      for (int u = 0; u < kWpl; ++u) {
        vl[u] = w_vlsr[lane + 32 * u];
        rd[u] = w_rad[lane + 32 * u];
        wk[u] = w_k[lane + 32 * u];
      }
#pragma unroll
      for (int k = 0; k < CPW; ++k) {
        const int c = warp + k * NWARP;
        int i = cur[k];
        if (i >= nc[k]) continue;
        T acc[kWpl];
#pragma unroll
        for (int u = 0; u < kWpl; ++u)
          acc[u] = lane + 32 * u < nw ? out_s[(lane + 32 * u) * (CW + 1) + c] : T(0);
        // the next candidate's line and velocity load while this one's
        // terms are computed
        int line = list_l[c * kCap + i];
        T v = list_v[c * kCap + i];
        for (; i < nc[k]; ++i) {
          const unsigned j = (unsigned)(line - lo);
          if (j >= (unsigned)kSpan) break;
          const T vi = v;
          if (i + 1 < nc[k]) {
            line = list_l[c * kCap + i + 1];
            v = list_v[c * kCap + i + 1];
          }
          const T dm = ab(vi - mc);
          const T* tau = s_tau + j * (wgp + 1) + lane;
#pragma unroll
          for (int u = 0; u < kWpl; ++u) {
            if (dm < rd[u]) {   // 0 past nw: no term
              T g;
              if (F == kExp) {
                const T z = (vi - vl[u]) / wk[u];
                g = ex(T(-0.5) * z * z);
              } else {
                const T d = vi - vl[u];
                g = ex2(wk[u] * (d * d));
              }
              acc[u] += tau[32 * u] * g;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kWpl; ++u)
          if (lane + 32 * u < nw) out_s[(lane + 32 * u) * (CW + 1) + c] = acc[u];
        cur[k] = i;
      }
    }
#pragma unroll
    for (int k = 0; k < CPW; ++k) nc[k] = 0;
  };

#pragma unroll
  for (int q = 0; q < NSTAGE - 1; ++q) fetch(q);

  // One pass a chunk; the pass after the last chunk only flushes.
  for (int q = 0;; ++q) {
    cp_wait<NSTAGE - 2>();
    bool full = q == n_chunks;
#pragma unroll
    for (int k = 0; k < CPW; ++k) full |= nc[k] > kCap - kRows;
    // chunk q is in, and the slot chunk q - 1 used is free; lists that
    // might not hold another chunk are flushed first
    if (__syncthreads_or(full)) flush();
    if (q == n_chunks) break;
    fetch(q + NSTAGE - 1);
    const T* st = ring + (size_t)(q % NSTAGE) * kRows * SP;
    const int line = s_line[(q % NSTAGE) * kRows + lane];
    const bool row_ok = line >= 0 && line < a.L;

    // prefilter: the chunk's rows inside the widest radius, appended to
    // the warp's channels' lists in line order
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int c = warp + k * NWARP;
      const T v = st[lane * SP + c];
      const bool p = row_ok && ab(v - mc) < rmax;
      const unsigned m = __ballot_sync(0xffffffffu, p);
      if (p) {
        const int at = c * kCap + nc[k] + __popc(m & ((1u << lane) - 1u));
        list_v[at] = v;
        list_l[at] = line;
      }
      nc[k] += __popc(m);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the output tile, as whole rows of CW channels
  for (int e = tid; e < nw * CW; e += NT) {
    const int w = e / CW, c = e % CW;
    if (c0 + c < a.C) a.out[(size_t)(w0 + w) * a.C + c0 + c] = out_s[w * (CW + 1) + c];
  }
}

template <typename T, int F, bool Masked, bool Csr>
cudaError_t open_smem(int optin) {
  const auto kernel = opacity_kernel<T, F, Masked, Csr>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  return err;
}

template <typename T>
cudaError_t open_kernels(int optin) {
  cudaError_t err = open_smem<T, kExp, true, false>(optin);
  if (err == cudaSuccess) err = open_smem<T, kExp2, true, false>(optin);
  if (err == cudaSuccess) err = open_smem<T, kExp2, false, false>(optin);
  if (err == cudaSuccess) err = open_smem<T, kExp2, true, true>(optin);
  if (err == cudaSuccess) err = open_smem<T, kExp2, false, true>(optin);
  return err;
}

template <typename T, int F, bool Masked, bool Csr>
int launch_t(Call<T> call, cudaStream_t stream) {
  call.wgp = min(kWalkers, (call.W + 31) / 32 * 32);
  const dim3 grid(call.nC * (kTC / kCW), (call.W + kWalkers - 1) / kWalkers);
  const size_t smem = smem_bytes<T>(call.wgp, Csr ? 0 : call.nL);
  opacity_kernel<T, F, Masked, Csr><<<grid, kCtaThreads, smem, stream>>>(call);
  return (int)cudaGetLastError();
}

// The launch's checks: the walker count, the tables' shape against the
// call's, 16-byte aligned rows (K4a: a pitch of at least C; K4b: 128) and
// the form (exp is masked; K4b is exp2).
template <typename T>
int launch(const K4Tables* tb, const void* taus, const void* vlsr, const void* dv, void* out,
           int W, int L, int form, int masked, void* stream) {
  const bool csr = tb->csr != 0;
  const bool ok = W > 0 && L >= 0 && tb->C > 0 && tb->nC > 0 &&
                  (long long)tb->nC * kTC >= tb->C && (form == kExp || form == kExp2) &&
                  (form == kExp2 || masked) && (!csr || form == kExp2) &&
                  reinterpret_cast<uintptr_t>(tb->vel) % 16 == 0 &&
                  (size_t)tb->pitch * sizeof(T) % 16 == 0 &&
                  (csr ? tb->K >= 0 && tb->pitch == kTC
                       : (L == tb->L && tb->pitch >= tb->C && tb->nL == (L + kTL - 1) / kTL &&
                          tb->nC == (tb->C + kTC - 1) / kTC));
  if (!ok) return (int)cudaErrorInvalidValue;
  const Call<T> call{static_cast<const T*>(taus), static_cast<const T*>(vlsr),
                     static_cast<const T*>(dv),   static_cast<T*>(out),
                     static_cast<const T*>(tb->vel), tb->mask, tb->line_table, tb->counts,
                     W, L, tb->C, csr ? 0 : tb->nL, tb->nC, tb->K, tb->pitch, 0,
                     T(tb->mask_center)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (csr)
    return masked ? launch_t<T, kExp2, true, true>(call, s)
                  : launch_t<T, kExp2, false, true>(call, s);
  if (form == kExp) return launch_t<T, kExp, true, false>(call, s);
  return masked ? launch_t<T, kExp2, true, false>(call, s)
                : launch_t<T, kExp2, false, false>(call, s);
}

}  // namespace

extern "C" {

const char* k4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int k4_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = open_kernels<float>(optin);
  if (err == cudaSuccess) err = open_kernels<double>(optin);
  return (int)err;
}

int k4_opacity_f32(const void* tables, const void* taus, const void* vlsr, const void* dv,
                   void* out, int W, int L, int form, int masked, void* stream) {
  return launch<float>(static_cast<const K4Tables*>(tables), taus, vlsr, dv, out, W, L, form,
                       masked, stream);
}

int k4_opacity_f64(const void* tables, const void* taus, const void* vlsr, const void* dv,
                   void* out, int W, int L, int form, int masked, void* stream) {
  return launch<double>(static_cast<const K4Tables*>(tables), taus, vlsr, dv, out, W, L, form,
                       masked, stream);
}

}  // extern "C"
