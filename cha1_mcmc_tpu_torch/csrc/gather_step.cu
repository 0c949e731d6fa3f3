// K3 — the whole-ensemble stretch-move step for dense catalogs over the
// channel-major gather tables, hand-written for Hopper (sm_90a) and spread
// over the whole card. Built at first use by cha1_mcmc_tpu_torch/utils/
// cuda_build.py and bound through ctypes by cha1_mcmc_tpu_torch/sampler/
// fused_gather.py, whose plain PyTorch version (gather_steps_plain /
// gather_lnprob_plain) computes the same function and is the kernel's
// test oracle.
//
// Replaces: the Pallas TPU kernel cha1_mcmc_tpu/sampler/fused_gather.py:
// _step_kernel_gather (:706, with _make_gather_lnprob :539 and the step
// loop of sampler/fused.py:_run_step_loop). For each proposal theta =
// (ss?, Ncol, Tex, vlsr, dV), with the channels in heavy-first order,
//   opac_c = sum_{m<M1} tau(lines1[:, m, c]) 1{|vel1[m,c] - v0| < 10 dV}
//              exp2(aa (vel1[m,c] - vlsr)^2)
//          + [c < cb0] sum_{m<M2} (the same over lines2 / vel2)
//   lnprob = prior_box(theta) - 1/2 sum_c [(y_c - dil_c (J_T,c - J_Tbg,c)
//              (1 - e^{-opac_c}))^2 isig_c - ln isig_c]
// with tau recomputed per table entry from its five line constants.
//
// What bounds it on this card: special-function and divide throughput.
// At the dense fit's size (~2,200 lines x ~10,900 channels, M1 = 9 main
// entries per channel, M2 = 11 overflow entries on ~1,450 heavy channels)
// a proposal touches ~115k table entries, a half-step of 64 proposals
// ~7.4 M; each in-window entry costs 2 exp (tau), 1 exp2 (the Gaussian)
// and ~6 IEEE divides. One SM (the shape of K1 and K2: one CTA per
// ensemble) would need milliseconds per half-step, so K3 spreads every
// half-step over the card.
//
// Design:
//  * a half-step is three kernels on the caller's stream: (1) prepare —
//    one warp per proposal draws Y = c + z (s - c) from the (W, D+1)
//    state in device memory and computes the per-proposal scalars once:
//    box + Gaussian prior, Q(Tex) (analytic, Chebyshev or the warp-summed
//    state sum); (2) evaluate — a 2-D grid of (channel block) x (group of
//    8 proposals); each thread owns one channel, keeps the 8 proposals'
//    opacities in registers, reads each table entry once for all 8, and
//    the CTA writes one chi^2 partial per (proposal, block) into an (h,
//    n_blk) buffer; (3) accept — one CTA sums each proposal's partials in
//    block order (no atomics: deterministic), adds the prior, applies the
//    stretch-move acceptance and writes accepted rows back. k steps are
//    6k launches from a host-side C loop (not one cooperative kernel: the
//    phases need different grids, and a launch costs a few us against
//    tens of us of work), each followed by cudaGetLastError();
//  * the TPU kernel's channel blocks become CTAs and keep its summation
//    shape: per channel the main entries in m order, then the overflow
//    sum added; chi^2 per block, times -1/2; blocks summed in order. The
//    plain version follows the same order, so float64 chains stay bitwise;
//  * tau is recomputed per entry from the expanded constants, as on the
//    TPU: no shared scratch grows with the catalog (K2's tau-per-line
//    scratch would not fit 227 KB at ~2k lines x 16 warps in float64).
//    An out-of-window entry (and every padding entry, velocity 1e30) is
//    skipped, which is exact: it would add tau * 0 = 0 for a finite tau;
//  * K1/K2's numerics: no fast-math (no flush-to-zero), the explicitly
//    rounded intrinsics of step_loop.cuh for the stretch factor, the
//    proposal (one fused multiply-add) and the acceptance difference,
//    indexed loads and stores (no one-hot products), no -inf clamp: a
//    walker that never accepts reports -inf.
//
// Limits: one component, 4- or 5-dim, analytic / Chebyshev / state-sum
// Q, float32 and float64, h = W / 2 <= 1024, a channel block of 32..512
// channels (a multiple of 32).
//
// K5b — the sharded half-step over the same tables, in this source
// because it is K3's three kernels. Replaces the Pallas TPU kernel
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_step_kernel_gather (:147,
// call :272): one half-update of a rank's W_l local walkers against the
// complement all-gathered over the walker shards. K3's prepare / evaluate
// / accept split at the local walker count, the prepare kernel taking
// each partner from the gathered (h n_w, D) buffer instead of the state;
// the accept kernel writes the half's accepted count. Bound as K3, at
// three launches per half-step.
//
// C entries (all return the first CUDA error of their launches, or 0):
//   k3_fused_steps_{f32,f64}: k whole steps of one ensemble;
//   k3_lnprob_{f32,f64}:      the same lnprob over an (N, D) batch;
//   k5b_half_{f32,f64}:       one sharded half-step (K5b), state in place;
//   k3_statics_size_{f32,f64}: sizeof(Statics<T>), checked by the binding;
//   k3_error_string: the CUDA error message of a returned code.

#include "single_statics.cuh"

namespace {

constexpr int kRows = 8;         // proposals per evaluation CTA
constexpr int kPrepWarps = 4;    // proposals per prepare CTA
constexpr int kMaxBlock = 512;   // channels per evaluation CTA, at most
constexpr int kScal = 8;         // per-row scalars (below)
enum Scal : int { kSs = 0, kNcol, kTex, kVlsr, kDv, kQ, kLp, kOk };

template <typename T>
struct GatherTables {
  const T* lines1;  // (5, M1, C): freq MHz, elower, aij, gup, glow per entry
  const T* vel1;    // (M1, C): the entry's line velocity at the channel
  const T* lines2;  // (5, M2, cb0): overflow entries of the heavy channels
  const T* vel2;    // (M2, cb0)
  const T* chans;   // (3, C): freq MHz, observed y, 1 / sigma^2
  const T* qst;     // (2, S): state-sum g, E
  int M1, M2, C, cb0, S;
};

// Phase 1: one warp per row. For a step, the row is proposal j of the
// half-step (written to prop, its stretch factor to zz), its partner row
// pair[j] of the other half of the state (`cmp`) or, for the sharded
// half-step K5b, of the gathered complement `comp` (n, D); for the lnprob
// entry it is theta[j]. Writes the row's scalars (Scal order).
template <typename T>
__global__ void __launch_bounds__(32 * kPrepWarps)
prepare_kernel(const T* __restrict__ theta, const T* __restrict__ state,
               const int32_t* __restrict__ act, const int32_t* __restrict__ cmp,
               const T* __restrict__ comp, const int32_t* __restrict__ pair,
               const T* __restrict__ zu, T* __restrict__ prop, T* __restrict__ zz,
               T* __restrict__ scal, GatherTables<T> tb, int n, int D,
               __grid_constant__ const Statics<T> st) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  if (j >= n) return;  // whole warps only
  const T* th;
  if (theta != nullptr) {
    th = theta + (size_t)j * D;
  } else {
    if (lane == 0) {
      const int D1 = D + 1;
      const T* s = state + (size_t)act[j] * D1;
      const T* c = comp != nullptr ? comp + (size_t)pair[j] * D
                                   : state + (size_t)cmp[pair[j]] * D1;
      const T z = stretch_z(zu[j], st.a);
      zz[j] = z;
      for (int d = 0; d < D; ++d) prop[j * D + d] = fma_rn(z, sub_rn(s[d], c[d]), c[d]);
    }
    __syncwarp();
    th = prop + (size_t)j * D;
  }
  T ss_w, Ncol, Tex, vlsr, dV, lp;
  unpack_single(th, st, ss_w, Ncol, Tex, vlsr, dV);
  const bool ok = single_prior(th, st, lp);
  const T Q = ok ? q_of(Tex, st, tb.qst, tb.S, lane) : T(1);   // ok is warp-uniform
  if (lane == 0) {
    T* out = scal + (size_t)j * kScal;
    out[kSs] = ss_w; out[kNcol] = Ncol; out[kTex] = Tex; out[kVlsr] = vlsr;
    out[kDv] = dV; out[kQ] = Q; out[kLp] = lp; out[kOk] = ok ? T(1) : T(0);
  }
}

// Phase 2: grid (n_blk, ceil(n / kRows)), one thread per channel of the
// block. partial[j * n_blk + b] = -1/2 * the block's chi^2 of row j.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
evaluate_kernel(const T* __restrict__ scal, T* __restrict__ partial,
                GatherTables<T> tb, int n, int n_blk,
                __grid_constant__ const Statics<T> st) {
  __shared__ T s_ss[kRows], s_ncol[kRows], s_tex[kRows], s_vlsr[kRows], s_dv[kRows];
  __shared__ T s_q[kRows], s_aa[kRows], s_win[kRows];
  __shared__ int s_ok[kRows];
  __shared__ T s_red[kRows][kMaxBlock / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x, j0 = blockIdx.y * kRows;
  const int c = b * blockDim.x + tid;
  if (tid < kRows) {
    const int j = j0 + tid;
    const T* r = scal + (size_t)j * kScal;
    const bool ok = j < n && r[kOk] != T(0);
    s_ok[tid] = ok;
    if (ok) {
      const T dV = r[kDv];
      const T sigma = dV / T(2.355);
      s_ss[tid] = r[kSs]; s_ncol[tid] = r[kNcol]; s_tex[tid] = r[kTex];
      s_vlsr[tid] = r[kVlsr]; s_dv[tid] = dV; s_q[tid] = r[kQ];
      s_aa[tid] = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
      s_win[tid] = T(10) * dV;
    } else {
      s_win[tid] = T(-1);   // no entry is in this row's window
    }
  }
  __syncthreads();

  T term[kRows];
#pragma unroll
  for (int p = 0; p < kRows; ++p) term[p] = T(0);
  if (c < tb.C) {
    const T mc = st.mask_center;
    T o1[kRows], o2[kRows];
#pragma unroll
    for (int p = 0; p < kRows; ++p) o1[p] = o2[p] = T(0);
    // Main entries in m order, then (heavy channels) the overflow entries.
    for (int part = 0; part < 2; ++part) {
      const int M = part ? (c < tb.cb0 ? tb.M2 : 0) : tb.M1;
      const int Cs = part ? tb.cb0 : tb.C;
      const T* lines = part ? tb.lines2 : tb.lines1;
      const T* vel = part ? tb.vel2 : tb.vel1;
      for (int m = 0; m < M; ++m) {
        const T v = vel[(size_t)m * Cs + c];
        const T dist = ab(v - mc);
        bool any = false;
#pragma unroll
        for (int p = 0; p < kRows; ++p) any = any || (dist < s_win[p]);
        if (!any) continue;
        const size_t plane = (size_t)M * Cs, e = (size_t)m * Cs + c;
        const T lf = lines[e], le = lines[plane + e], la = lines[2 * plane + e];
        const T lgu = lines[3 * plane + e], lgl = lines[4 * plane + e];
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          if (!(dist < s_win[p])) continue;   // adds exactly 0 (finite tau)
          const T tau = tau_stick(lf, le, la, lgu, lgl, s_q[p], s_ncol[p], s_tex[p], s_dv[p]);
          const T d = v - s_vlsr[p];
          const T g = tau * ex2(s_aa[p] * (d * d));
          if (part) o2[p] += g; else o1[p] += g;
        }
      }
    }
    const T gf = tb.chans[c], y = tb.chans[tb.C + c], isig = tb.chans[2 * tb.C + c];
    const T J_Tbg = planck_J(gf, st.Tbg);
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      if (!s_ok[p]) continue;
      const T opac = c < tb.cb0 ? o1[p] + o2[p] : o1[p];
      const T J_T = planck_J(gf, s_tex[p]);
      const T dil = beam_dilution(gf, s_ss[p], st.dish_size);
      const T m = dil * (J_T - J_Tbg) * (T(1) - ex(-opac));
      const T resid = y - m;
      term[p] = resid * resid * isig - lg(isig);
    }
  }
  // chi^2 of the block per row: warp shuffles, then the warps in order.
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const T v = warp_sum(term[p]);
    if (lane == 0) s_red[p][warp] = v;
  }
  __syncthreads();
  if (tid < kRows && j0 + tid < n) {
    T sum = T(0);
    for (int w = 0; w < nwarps; ++w) sum += s_red[tid][w];
    partial[(size_t)(j0 + tid) * n_blk + b] = T(-0.5) * sum;
  }
}

// lnprob of row j from its scalars and the block partials, in block order.
template <typename T>
__device__ __forceinline__ T combine(const T* scal, const T* partial, int j, int n_blk) {
  const T* r = scal + (size_t)j * kScal;
  if (r[kOk] == T(0)) return neg_inf<T>();
  T ll = T(0);
  for (int b = 0; b < n_blk; ++b) ll = ll + partial[(size_t)j * n_blk + b];
  const T val = r[kLp] + ll;
  return isfinite(val) ? val : neg_inf<T>();
}

// Phase 3 of the lnprob entry: out[j] for every row.
template <typename T>
__global__ void combine_kernel(const T* __restrict__ scal, const T* __restrict__ partial,
                               T* __restrict__ out, int n, int n_blk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) out[j] = combine(scal, partial, j, n_blk);
}

// Phase 3 of a half-step: one CTA, thread j for proposal j. Accepted
// proposals replace their walker's row of the state (a select, not a
// delta). After the second half the CTA records the step: the chain and
// lnps rows and the step's acceptance count.
template <typename T>
__global__ void __launch_bounds__(1024)
accept_kernel(T* __restrict__ state, const int32_t* __restrict__ act,
              const T* __restrict__ au, const T* __restrict__ prop,
              const T* __restrict__ zz, const T* __restrict__ scal,
              const T* __restrict__ partial, int* __restrict__ acc_first,
              T* __restrict__ out_chain, T* __restrict__ out_lnps,
              float* __restrict__ out_acc, int W, int D, int n_blk, int half) {
  const int j = threadIdx.x, h = W / 2, D1 = D + 1;
  bool accept = false;
  if (j < h) {
    const T lnp_new = combine(scal, partial, j, n_blk);
    T* dst = state + (size_t)act[j] * D1;
    const T diff = sub_rn(add_rn(mul_rn(T(D - 1), lg(zz[j])), lnp_new), dst[D]);
    accept = lg(au[j]) < diff;
    if (accept) {
      for (int d = 0; d < D; ++d) dst[d] = prop[j * D + d];
      dst[D] = lnp_new;
    }
  }
  const int n_acc = __syncthreads_count(accept);   // also a barrier
  if (half == 0) {
    if (j == 0) *acc_first = n_acc;
    return;
  }
  for (int i = j; i < W * D; i += blockDim.x) out_chain[i] = state[(i / D) * D1 + i % D];
  for (int w = j; w < W; w += blockDim.x) out_lnps[w] = state[w * D1 + D];
  if (j == 0) out_acc[0] = (float)(*acc_first + n_acc);
}

template <typename T>
GatherTables<T> tables(const void* lines1, const void* vel1, const void* lines2,
                       const void* vel2, const void* chans, const void* qst, int M1,
                       int M2, int C, int cb0, int S) {
  return GatherTables<T>{static_cast<const T*>(lines1), static_cast<const T*>(vel1),
                         static_cast<const T*>(lines2), static_cast<const T*>(vel2),
                         static_cast<const T*>(chans), static_cast<const T*>(qst),
                         M1, M2, C, cb0, S};
}

bool geometry_ok(int n, int cblock, int n_blk, int C) {
  return n > 0 && cblock >= 32 && cblock <= kMaxBlock && cblock % 32 == 0 &&
         (long long)n_blk * cblock >= C;
}

template <typename T>
int launch_steps(void* state, const void* perm, const void* zu, const void* pair,
                 const void* au, const void* lines1, const void* vel1,
                 const void* lines2, const void* vel2, const void* chans,
                 const void* qst, void* prop, void* zz, void* scal, void* partial,
                 void* acc_first, void* out_chain, void* out_lnps, void* out_acc,
                 const void* statics, int W, int D, int M1, int M2, int C, int cb0,
                 int S, int cblock, int n_blk, int k, void* stream) {
  const int h = W / 2;
  if (W % 2 || h > 1024 || !geometry_ok(h, cblock, n_blk, C)) return (int)cudaErrorInvalidValue;
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const GatherTables<T> tb = tables<T>(lines1, vel1, lines2, vel2, chans, qst, M1, M2, C, cb0, S);
  const auto s = static_cast<cudaStream_t>(stream);
  T* state_t = static_cast<T*>(state);
  T* prop_t = static_cast<T*>(prop);
  T* zz_t = static_cast<T*>(zz);
  T* scal_t = static_cast<T*>(scal);
  T* part_t = static_cast<T*>(partial);
  const int32_t* perm_t = static_cast<const int32_t*>(perm);
  const dim3 eval_grid(n_blk, (h + kRows - 1) / kRows);
  const int prep_blocks = (h + kPrepWarps - 1) / kPrepWarps;
  const int acc_threads = (h + 31) / 32 * 32;
  for (int step = 0; step < k; ++step) {
    for (int half = 0; half < 2; ++half) {
      const int r = 2 * step + half;
      const int32_t* act = perm_t + (size_t)step * W + half * h;
      const int32_t* cmp = perm_t + (size_t)step * W + (1 - half) * h;
      prepare_kernel<T><<<prep_blocks, 32 * kPrepWarps, 0, s>>>(
          nullptr, state_t, act, cmp, nullptr,
          static_cast<const int32_t*>(pair) + (size_t)r * h,
          static_cast<const T*>(zu) + (size_t)r * h, prop_t, zz_t, scal_t, tb, h, D, st);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      evaluate_kernel<T><<<eval_grid, cblock, 0, s>>>(scal_t, part_t, tb, h, n_blk, st);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      accept_kernel<T><<<1, acc_threads, 0, s>>>(
          state_t, act, static_cast<const T*>(au) + (size_t)r * h, prop_t, zz_t, scal_t,
          part_t, static_cast<int*>(acc_first),
          static_cast<T*>(out_chain) + (size_t)step * W * D,
          static_cast<T*>(out_lnps) + (size_t)step * W,
          static_cast<float*>(out_acc) + step, W, D, n_blk, half);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

// K5b: one sharded half-step of a rank's W local walkers, state (W, D+1)
// in device memory, updated in place: prepare (partners from the gathered
// complement), evaluate and accept, the accepted count to acc_out[0].
template <typename T>
int launch_half(void* state, const void* act, const void* comp, const void* zu,
                const void* pair, const void* au, const void* lines1, const void* vel1,
                const void* lines2, const void* vel2, const void* chans, const void* qst,
                void* prop, void* zz, void* scal, void* partial, void* acc_out,
                const void* statics, int W, int D, int M1, int M2, int C, int cb0, int S,
                int cblock, int n_blk, void* stream) {
  const int h = W / 2;
  if (W % 2 || h > 1024 || !geometry_ok(h, cblock, n_blk, C)) return (int)cudaErrorInvalidValue;
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const GatherTables<T> tb = tables<T>(lines1, vel1, lines2, vel2, chans, qst, M1, M2, C, cb0, S);
  const auto s = static_cast<cudaStream_t>(stream);
  T* state_t = static_cast<T*>(state);
  T* scal_t = static_cast<T*>(scal);
  T* part_t = static_cast<T*>(partial);
  const int32_t* act_t = static_cast<const int32_t*>(act);
  prepare_kernel<T><<<(h + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      nullptr, state_t, act_t, nullptr, static_cast<const T*>(comp),
      static_cast<const int32_t*>(pair), static_cast<const T*>(zu), static_cast<T*>(prop),
      static_cast<T*>(zz), scal_t, tb, h, D, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  evaluate_kernel<T><<<dim3(n_blk, (h + kRows - 1) / kRows), cblock, 0, s>>>(
      scal_t, part_t, tb, h, n_blk, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  accept_kernel<T><<<1, (h + 31) / 32 * 32, 0, s>>>(
      state_t, act_t, static_cast<const T*>(au), static_cast<const T*>(prop),
      static_cast<const T*>(zz), scal_t, part_t, static_cast<int*>(acc_out), nullptr,
      nullptr, nullptr, W, D, n_blk, 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lnprob(const void* theta, void* out, const void* lines1, const void* vel1,
                  const void* lines2, const void* vel2, const void* chans,
                  const void* qst, void* scal, void* partial, const void* statics,
                  int N, int D, int M1, int M2, int C, int cb0, int S, int cblock,
                  int n_blk, void* stream) {
  if (!geometry_ok(N, cblock, n_blk, C)) return (int)cudaErrorInvalidValue;
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const GatherTables<T> tb = tables<T>(lines1, vel1, lines2, vel2, chans, qst, M1, M2, C, cb0, S);
  const auto s = static_cast<cudaStream_t>(stream);
  T* scal_t = static_cast<T*>(scal);
  T* part_t = static_cast<T*>(partial);
  prepare_kernel<T><<<(N + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps, 0, s>>>(
      static_cast<const T*>(theta), nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, scal_t, tb, N, D, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  evaluate_kernel<T><<<dim3(n_blk, (N + kRows - 1) / kRows), cblock, 0, s>>>(
      scal_t, part_t, tb, N, n_blk, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<(N + 255) / 256, 256, 0, s>>>(scal_t, part_t, static_cast<T*>(out), N,
                                                    n_blk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k3_statics_size_f32() { return (int)sizeof(Statics<float>); }
int k3_statics_size_f64() { return (int)sizeof(Statics<double>); }
const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#define K3_STEPS(SFX, T)                                                              \
  int k3_fused_steps_##SFX(void* state, const void* perm, const void* zu,             \
                           const void* pair, const void* au, const void* lines1,      \
                           const void* vel1, const void* lines2, const void* vel2,    \
                           const void* chans, const void* qst, void* prop, void* zz,  \
                           void* scal, void* partial, void* acc_first,                \
                           void* out_chain, void* out_lnps, void* out_acc,            \
                           const void* statics, int W, int D, int M1, int M2, int C,  \
                           int cb0, int S, int cblock, int n_blk, int k,              \
                           void* stream) {                                            \
    return launch_steps<T>(state, perm, zu, pair, au, lines1, vel1, lines2, vel2,     \
                           chans, qst, prop, zz, scal, partial, acc_first, out_chain, \
                           out_lnps, out_acc, statics, W, D, M1, M2, C, cb0, S,       \
                           cblock, n_blk, k, stream);                                 \
  }
K3_STEPS(f32, float)
K3_STEPS(f64, double)

#define K3_LNPROB(SFX, T)                                                             \
  int k3_lnprob_##SFX(const void* theta, void* out, const void* lines1,               \
                      const void* vel1, const void* lines2, const void* vel2,         \
                      const void* chans, const void* qst, void* scal, void* partial,  \
                      const void* statics, int N, int D, int M1, int M2, int C,       \
                      int cb0, int S, int cblock, int n_blk, void* stream) {          \
    return launch_lnprob<T>(theta, out, lines1, vel1, lines2, vel2, chans, qst, scal, \
                            partial, statics, N, D, M1, M2, C, cb0, S, cblock, n_blk, \
                            stream);                                                  \
  }
K3_LNPROB(f32, float)
K3_LNPROB(f64, double)

#define K5B_HALF(SFX, T)                                                              \
  int k5b_half_##SFX(void* state, const void* act, const void* comp, const void* zu,   \
                     const void* pair, const void* au, const void* lines1,             \
                     const void* vel1, const void* lines2, const void* vel2,           \
                     const void* chans, const void* qst, void* prop, void* zz,         \
                     void* scal, void* partial, void* acc_out, const void* statics,    \
                     int W, int D, int M1, int M2, int C, int cb0, int S, int cblock,  \
                     int n_blk, void* stream) {                                        \
    return launch_half<T>(state, act, comp, zu, pair, au, lines1, vel1, lines2, vel2,  \
                          chans, qst, prop, zz, scal, partial, acc_out, statics, W, D, \
                          M1, M2, C, cb0, S, cblock, n_blk, stream);                   \
  }
K5B_HALF(f32, float)
K5B_HALF(f64, double)

}  // extern "C"
