// K3 — the whole-ensemble stretch-move step for dense catalogs over the
// channel-major gather tables, hand-written for Hopper (sm_90a) as one
// persistent cooperative kernel spread over the whole card. Built at first
// use by cha1_mcmc_tpu_torch/utils/cuda_build.py and bound through ctypes
// by cha1_mcmc_tpu_torch/sampler/fused_gather.py, whose plain PyTorch
// version (gather_steps_plain / gather_lnprob_plain) computes the same
// function and is the kernel's test oracle.
//
// Replaces: the Pallas TPU kernel cha1_mcmc_tpu/sampler/fused_gather.py:
// _step_kernel_gather (:706, with _make_gather_lnprob :539 and the step
// loop of sampler/fused.py:_run_step_loop). For each proposal theta =
// (ss?, Ncol, Tex, vlsr, dV), with the channels in heavy-first order,
//   opac_c = sum_{m<M1} tau(line1[m, c]) 1{|vel1[m,c] - v0| < 10 dV}
//              exp2(aa (vel1[m,c] - vlsr)^2)
//          + [c < cb0] sum_{m<M2} (the same over line2 / vel2)
//   lnprob = prior_box(theta) - 1/2 sum_c [(y_c - dil_c (J_T,c - J_Tbg,c)
//              (1 - e^{-opac_c}))^2 isig_c - ln isig_c]
//
// What bounds it on this card: the latency of three dependent phases a
// half-step (each must see the whole previous one) and special-function
// and divide throughput. At the dense fit's size (~2,200 lines x ~10,900
// channels, M1 = 9 main entries per channel, M2 = 11 overflow entries on
// ~1,450 heavy channels) a half-step of 64 proposals walks ~7.4 M
// (proposal, entry) pairs, ~2.3 M of them inside their windows, but its
// tables reference only ~2,900 (channel block, line) pairs: a line's tau
// is the same for every entry of it that a proposal meets.
//
// Design:
//  * one cooperative launch per call (cudaLaunchCooperativeKernel; the
//    grid is the plan's, at most every CTA the card keeps resident, sized
//    by cudaOccupancyMaxActiveBlocksPerMultiprocessor): k whole steps
//    (k3_fused_steps_*), one sharded half-step (k5b_half_*) or a batch of
//    lnprobs (k3_lnprob_*). A half-step is three phases separated by
//    grid.sync(): (1) prepare — one warp per proposal draws Y = c + z (s -
//    c) with the rounded intrinsics (partners from the other half of the
//    state, or for K5b from the gathered complement), then computes the
//    per-proposal scalars once: box + Gaussian prior, Q(Tex) (analytic,
//    Chebyshev or the warp-summed state sum); (2) evaluate — the resident
//    CTAs walk the (channel block, group of 8 proposals) tiles in a fixed
//    order; a CTA's threads own one channel each, keep the 8 opacities in
//    registers and read each table entry once for all 8, and the tile
//    writes one chi^2 partial per (proposal, block) into an (n, n_blk)
//    buffer (a tile none of whose proposals is inside the prior box reads
//    no table and writes 0s); (3) accept — one warp per proposal: the
//    lanes load its partials together and lane 0 adds them in block
//    order, applies the stretch-move test and writes the accepted row (and,
//    in a step, the walker's chain and lnps rows); accepted counts are
//    integer atomics, written out as floats after the last half's
//    grid.sync().
//    Every tile and every sum is the same whatever the grid, so chains do
//    not depend on the grid size;
//  * tau once per (block line, proposal): the binding lists per channel
//    block the distinct active lines its main and overflow entries
//    reference (blines, padded with -1 to U_max) and gives each entry its
//    slot in that list; at the start of a tile the CTA computes tau for its
//    <= U_max lines x 8 proposals into shared memory, and the entry walk
//    does one shared load and one exp2 per in-window (entry, proposal).
//    Where U_max x 8 taus would not fit a CTA's shared memory, the prepare
//    warp writes its proposal's tau of every active line into an (n, La)
//    scratch in device memory instead, and entries carry their active-line
//    index (kShared = false);
//  * the proposal-independent per-channel constants (h nu / k, J(Tbg),
//    ln(1/sigma^2), and in 4 dims the beam dilution, else the beam's
//    square) are computed once per call into a (4, C) scratch by K1 and
//    K2's chan_consts, so no bit moves;
//  * the summation shape of the TPU kernel and of the plain version: per
//    channel the main entries in m order, then the overflow sum added;
//    chi^2 per block by warp shuffles, then the warps in order, times
//    -1/2; blocks summed in order. Float64 chains stay bitwise;
//  * K1/K2's numerics: no fast-math (no flush-to-zero), the explicitly
//    rounded intrinsics of step_loop.cuh for the stretch factor, the
//    proposal (one fused multiply-add) and the acceptance difference,
//    indexed loads and stores (no one-hot products), no -inf clamp: a
//    walker that never accepts reports -inf. An out-of-window entry (and
//    every padding entry, velocity 1e30) is skipped, which is exact: it
//    would add tau * 0 = 0 for a finite tau. Data written during the
//    launch (state, scalars, partials, constants, taus) is read with
//    coherent loads after grid.sync(); only the tables use __ldg.
//
// Limits: one component, 4- or 5-dim, analytic / Chebyshev / state-sum
// Q, float32 and float64, an even ensemble, a channel block of 32..512
// channels (a multiple of 32: one CTA's threads), and at least one CTA
// resident per SM.
//
// K5b — the sharded half-step over the same tables, in this source because
// it is K3's half-step. Replaces the Pallas TPU kernel
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_step_kernel_gather (:147,
// call :272): one half-update of a rank's W_l local walkers against the
// complement all-gathered over the walker shards; the state stays in
// device memory and the half's accepted count goes to out_acc[0].
//
// C entries (all return the first CUDA error, or 0):
//   k3_fused_steps_{f32,f64}: k whole steps of one ensemble;
//   k3_lnprob_{f32,f64}:      the same lnprob over an (N, D) batch;
//   k5b_half_{f32,f64}:       one sharded half-step (K5b), state in place;
//   k3_max_grid_{f32,f64}:    the CTAs of a launch the card keeps resident;
//   k3_statics_size_{f32,f64}: sizeof(Statics<T>), checked by the binding;
//   k3_error_string: the CUDA error message of a returned code.

#include "single_statics.cuh"
#include "cluster_step.cuh"

namespace {

constexpr int kRows = 8;         // proposals per tile
constexpr int kBatch = 4;        // table entries (or taus) whose loads fly together
constexpr int kMaxBlock = 512;   // channels per tile (threads a CTA), at most
constexpr int kScal = 8;         // per-row scalars (below)
enum Scal : int { kSs = 0, kNcol, kTex, kVlsr, kDv, kQ, kLp, kOk };
enum Mode : int { kSteps = 0, kHalf = 1, kLnprob = 2 };

template <typename T>
struct GatherTables {
  const T* lines;          // (5, La): freq MHz, elower, aij, gup, glow per active line
  const T* vel1;           // (M1, C): the entry's line velocity at the channel
  const T* vel2;           // (M2, w2): overflow entries of the heavy channels
  const void* key1;        // (M1, C): the entry's slot in its block's line list,
                           // int16 (kShared), else its active-line index, int32
  const void* key2;        // (M2, w2), the same
  const int32_t* blines;   // (n_blk, U): each block's active lines, -1 past them
  const T* chans;          // (3, C): freq MHz, observed y, 1 / sigma^2
  const T* qst;            // (2, S): state-sum g, E
  int La, M1, M2, C, cb0, S, U;
};

// What one launch reads and writes besides the tables. Pointers to data the
// launch writes are read with plain (coherent) loads.
template <typename T>
struct GatherWork {
  T* state;              // (W, D+1) coordinates || lnp (steps, K5b)
  const int32_t* perm;   // steps: (k W) per-step permutations
  const int32_t* act;    // K5b: (h,) active walkers
  const T* comp;         // K5b: (n_comp, D) the gathered complement
  const T* theta;        // lnprob: (N, D)
  const T* zu;           // (2k, h) steps, (h,) K5b: stretch uniforms
  const int32_t* pair;   // partner rows, same layout
  const T* au;           // acceptance uniforms, same layout
  T* prop;               // (h, D) proposals
  T* zz;                 // (h,) stretch factors
  T* scal;               // (n, kScal) per-row scalars
  T* partial;            // (n, n_blk) chi^2 partials
  T* cc;                 // (kChanConsts, C) per-channel constants
  T* tau;                // (n, La) taus in device memory (!kShared)
  int* acc;              // steps: (k,) accepted counts; K5b: (1,)
  T* out_chain;          // steps: (k W, D)
  T* out_lnps;           // steps: (k W,)
  float* out_acc;        // the accepted counts: steps (k,), K5b (1,)
  T* out;                // lnprob: (N,)
  int mode, W, D, n, k, n_blk;
};

// K3's per-channel constants: chan_consts, with the dilution itself in
// place of the beam's square where the source size is fixed (4 dims), as
// K1's.
template <typename T>
__device__ __forceinline__ ChanConsts<T> k3_chan_consts(const Statics<T>& st, T gf, T isig) {
  ChanConsts<T> k = chan_consts(st, gf, isig);
  if (!st.free_ss) k.b2 = dilution(k.b2, mul_rn(st.ss, st.ss));
  return k;
}

template <typename T>
__device__ __forceinline__ T line_tau(const GatherTables<T>& tb, int l, T Q, T Ncol, T Tex,
                                      T dV) {
  const T* L = tb.lines;
  return tau_stick(L[l], L[tb.La + l], L[2 * tb.La + l], L[3 * tb.La + l], L[4 * tb.La + l],
                   Q, Ncol, Tex, dV);
}

// Phase 1 for row j (one warp): its scalars (Scal order) from theta `th`,
// and without shared taus its tau of every active line.
template <typename T, bool kShared>
__device__ void prepare_row(int j, const T* th, const GatherTables<T>& tb,
                            const Statics<T>& st, const GatherWork<T>& w, int lane) {
  T ss_w, Ncol, Tex, vlsr, dV, lp;
  unpack_single(th, st, ss_w, Ncol, Tex, vlsr, dV);
  const bool ok = single_prior(th, st, lp);
  const T Q = ok ? q_of(Tex, st, tb.qst, tb.S, lane) : T(1);   // ok is warp-uniform
  if (!kShared && ok)
    for (int l = lane; l < tb.La; l += 32)
      w.tau[(size_t)j * tb.La + l] = line_tau(tb, l, Q, Ncol, Tex, dV);
  if (lane == 0) {
    T* out = w.scal + (size_t)j * kScal;
    out[kSs] = ss_w; out[kNcol] = Ncol; out[kTex] = Tex; out[kVlsr] = vlsr;
    out[kDv] = dV; out[kQ] = Q; out[kLp] = lp; out[kOk] = ok ? T(1) : T(0);
  }
}

// Phase 2, one tile: channel block b (one thread per channel) x rows
// [j0, j0 + kRows). partial[j * n_blk + b] = -1/2 * the block's chi^2 of
// row j. s_tau: the tile's U x kRows taus (kShared).
template <typename T, bool kShared>
__device__ void evaluate_tile(int b, int j0, const GatherTables<T>& tb,
                              const Statics<T>& st, const GatherWork<T>& w, T* s_tau) {
  __shared__ T s_ss2[kRows], s_ncol[kRows], s_tex[kRows], s_vlsr[kRows], s_dv[kRows];
  __shared__ T s_q[kRows], s_aa[kRows], s_win[kRows];
  __shared__ int s_ok[kRows];
  __shared__ T s_red[kRows][kMaxBlock / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5, C = tb.C;
  const int c = b * blockDim.x + tid;
  if (tid < kRows) {
    const int j = j0 + tid;
    const T* r = w.scal + (size_t)j * kScal;
    const bool ok = j < w.n && r[kOk] != T(0);
    s_ok[tid] = ok;
    if (ok) {
      const T dV = r[kDv];
      const T sigma = dV / T(2.355);
      s_ss2[tid] = mul_rn(r[kSs], r[kSs]); s_ncol[tid] = r[kNcol]; s_tex[tid] = r[kTex];
      s_vlsr[tid] = r[kVlsr]; s_dv[tid] = dV; s_q[tid] = r[kQ];
      s_aa[tid] = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
      s_win[tid] = T(10) * dV;
    } else {
      s_win[tid] = T(-1);   // no entry is in this row's window
    }
  }
  __syncthreads();
  bool any_ok = false;
#pragma unroll
  for (int p = 0; p < kRows; ++p) any_ok = any_ok || s_ok[p];
  if (!any_ok) {   // every row outside the prior box: nothing to walk or reduce
    if (tid < kRows && j0 + tid < w.n) w.partial[(size_t)(j0 + tid) * w.n_blk + b] = T(0);
    __syncthreads();   // the next tile rewrites the row scalars
    return;
  }
  if constexpr (kShared) {
    // tau of the block's lines x the tile's rows, once each; kBatch of a
    // thread's items load their line constants together
    const int32_t* bl = tb.blines + (size_t)b * tb.U;
    const int n_items = tb.U * kRows, stride = blockDim.x;
    for (int i0 = tid; i0 < n_items; i0 += kBatch * stride) {
      int l[kBatch];
      T k[kBatch][5];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * stride;
        l[q] = i < n_items && s_ok[i % kRows] ? __ldg(bl + i / kRows) : -1;
#pragma unroll
        for (int f = 0; f < 5; ++f) k[q][f] = l[q] >= 0 ? tb.lines[f * tb.La + l[q]] : T(0);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * stride, p = i % kRows;
        if (l[q] >= 0)
          s_tau[i] = tau_stick(k[q][0], k[q][1], k[q][2], k[q][3], k[q][4], s_q[p],
                               s_ncol[p], s_tex[p], s_dv[p]);
      }
    }
    __syncthreads();
  }

  T term[kRows];
#pragma unroll
  for (int p = 0; p < kRows; ++p) term[p] = T(0);
  if (c < C) {
    const T mc = st.mask_center;
    T o1[kRows], o2[kRows];
#pragma unroll
    for (int p = 0; p < kRows; ++p) o1[p] = o2[p] = T(0);
    // Main entries in m order, then (heavy channels) the overflow entries;
    // the velocities and slots (line indices) of kBatch entries load
    // together, then the entries add in order.
    for (int part = 0; part < 2; ++part) {
      const int M = part ? (c < tb.cb0 ? tb.M2 : 0) : tb.M1;
      const int Cs = part ? tb.cb0 : C;
      const T* vel = part ? tb.vel2 : tb.vel1;
      for (int m0 = 0; m0 < M; m0 += kBatch) {
        T v[kBatch];
        int key[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const size_t e = (size_t)(m0 + q) * Cs + c;
          const bool in = m0 + q < M;
          v[q] = in ? __ldg(vel + e) : T(0);
          const void* keys = part ? tb.key2 : tb.key1;
          if constexpr (kShared)
            key[q] = in ? (int)__ldg(static_cast<const int16_t*>(keys) + e) : 0;
          else
            key[q] = in ? __ldg(static_cast<const int32_t*>(keys) + e) : 0;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (m0 + q >= M) break;
          const T dist = ab(v[q] - mc);
          bool any = false;
#pragma unroll
          for (int p = 0; p < kRows; ++p) any = any || (dist < s_win[p]);
          if (!any) continue;
#pragma unroll
          for (int p = 0; p < kRows; ++p) {
            if (!(dist < s_win[p])) continue;   // adds exactly 0 (finite tau)
            T tau;
            if constexpr (kShared)
              tau = s_tau[key[q] * kRows + p];
            else
              tau = w.tau[(size_t)(j0 + p) * tb.La + key[q]];
            const T d = v[q] - s_vlsr[p];
            const T g = tau * ex2(s_aa[p] * (d * d));
            if (part) o2[p] += g; else o1[p] += g;
          }
        }
      }
    }
    const ChanConsts<T> kc{w.cc[c], w.cc[C + c], w.cc[2 * C + c], w.cc[3 * C + c]};
    const T y = tb.chans[C + c], isig = tb.chans[2 * C + c];
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      if (!s_ok[p]) continue;
      const T opac = c < tb.cb0 ? o1[p] + o2[p] : o1[p];
      // planck_J(nu, Tex) from x, minus J(Tbg)
      const T dJ = kc.x / (ex(kc.x / s_tex[p]) - T(1) + T(1e-10)) - kc.jbg;
      const T dil = st.free_ss ? dilution(kc.b2, s_ss2[p]) : kc.b2;
      const T m = dil * dJ * (T(1) - ex(-opac));
      const T resid = y - m;
      term[p] = resid * resid * isig - kc.lnisig;
    }
  }
  // chi^2 of the block per row: warp shuffles, then the warps in order.
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const T v = warp_sum(term[p]);
    if (lane == 0) s_red[p][warp] = v;
  }
  __syncthreads();
  if (tid < kRows && j0 + tid < w.n) {
    T sum = T(0);
    for (int k = 0; k < nwarps; ++k) sum += s_red[tid][k];
    w.partial[(size_t)(j0 + tid) * w.n_blk + b] = T(-0.5) * sum;
  }
  __syncthreads();   // the next tile rewrites the row scalars, taus and sums
}

// lnprob of row j from its scalars and its partials (one warp): the lanes
// load the partials together, every lane adds them in block order.
template <typename T>
__device__ T combine_row(const GatherWork<T>& w, int j, int lane) {
  const T* parts = w.partial + (size_t)j * w.n_blk;
  T ll = T(0);
  for (int b0 = 0; b0 < w.n_blk; b0 += 32) {
    const T mine = b0 + lane < w.n_blk ? parts[b0 + lane] : T(0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const T v = __shfl_sync(0xffffffffu, mine, i);
      if (b0 + i < w.n_blk) ll = ll + v;
    }
  }
  const T* r = w.scal + (size_t)j * kScal;
  if (r[kOk] == T(0)) return neg_inf<T>();
  const T val = r[kLp] + ll;
  return isfinite(val) ? val : neg_inf<T>();
}

// One launch: w.mode selects k steps, one K5b half-step or the lnprob batch.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxBlock)
gather_kernel(GatherWork<T> w, GatherTables<T> tb, __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tau = reinterpret_cast<T*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int gwarp = blockIdx.x * warps + (threadIdx.x >> 5), nwarp = gridDim.x * warps;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x, nthread = gridDim.x * blockDim.x;
  const int n = w.n, D = w.D, D1 = D + 1, W = w.W, h = W / 2;
  const int n_tiles = w.n_blk * ((n + kRows - 1) / kRows);
  const int C = tb.C;
  // Once per call, before the first evaluation: the per-channel constants
  // and the accepted counts.
  for (int c = gtid; c < C; c += nthread) {
    const ChanConsts<T> k = k3_chan_consts(st, tb.chans[c], tb.chans[2 * C + c]);
    w.cc[c] = k.x; w.cc[C + c] = k.jbg; w.cc[2 * C + c] = k.lnisig; w.cc[3 * C + c] = k.b2;
  }
  const int n_acc = w.mode == kSteps ? w.k : (w.mode == kHalf ? 1 : 0);
  for (int i = gtid; i < n_acc; i += nthread) w.acc[i] = 0;
  const int steps = w.mode == kSteps ? w.k : 1, halves = w.mode == kSteps ? 2 : 1;
  for (int step = 0; step < steps; ++step) {
    for (int half = 0; half < halves; ++half) {
      const int r = 2 * step + half;
      const int32_t* act = w.mode == kSteps ? w.perm + (size_t)step * W + half * h : w.act;
      const int32_t* cmp = w.mode == kSteps ? w.perm + (size_t)step * W + (1 - half) * h
                                            : nullptr;
      const size_t off = w.mode == kSteps ? (size_t)r * h : 0;
      // Phase 1: one warp per row.
      for (int j = gwarp; j < n; j += nwarp) {
        const T* th;
        if (w.mode == kLnprob) {
          th = w.theta + (size_t)j * D;
        } else {
          if (lane == 0) {
            const T* s = w.state + (size_t)act[j] * D1;
            const int32_t p = w.pair[off + j];
            const T* c = w.mode == kHalf ? w.comp + (size_t)p * D
                                         : w.state + (size_t)cmp[p] * D1;
            const T z = stretch_z(w.zu[off + j], st.a);
            w.zz[j] = z;
            for (int d = 0; d < D; ++d)
              w.prop[(size_t)j * D + d] = fma_rn(z, sub_rn(s[d], c[d]), c[d]);
          }
          __syncwarp();
          th = w.prop + (size_t)j * D;
        }
        prepare_row<T, kShared>(j, th, tb, st, w, lane);
      }
      grid.sync();
      // Phase 2: the tiles, block-fastest.
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        evaluate_tile<T, kShared>(t % w.n_blk, (t / w.n_blk) * kRows, tb, st, w, s_tau);
      grid.sync();
      // Phase 3: one warp per row.
      for (int j = gwarp; j < n; j += nwarp) {
        const T lnp_new = combine_row(w, j, lane);
        if (lane != 0) continue;
        if (w.mode == kLnprob) {
          w.out[j] = lnp_new;
          continue;
        }
        const int32_t wk = act[j];
        T* dst = w.state + (size_t)wk * D1;
        const T diff = sub_rn(add_rn(mul_rn(T(D - 1), lg(w.zz[j])), lnp_new), dst[D]);
        if (lg(w.au[off + j]) < diff) {
          for (int d = 0; d < D; ++d) dst[d] = w.prop[(size_t)j * D + d];
          dst[D] = lnp_new;
          atomicAdd(w.acc + (w.mode == kSteps ? step : 0), 1);
        }
        if (w.mode == kSteps) {   // the walker's row of this step (active once a step)
          T* row = w.out_chain + ((size_t)step * W + wk) * D;
          for (int d = 0; d < D; ++d) row[d] = dst[d];
          w.out_lnps[(size_t)step * W + wk] = dst[D];
        }
      }
      // the next half reads the accepted rows; the counts are complete
      if (w.mode != kLnprob) grid.sync();
    }
  }
  for (int i = gtid; i < n_acc; i += nthread) w.out_acc[i] = (float)w.acc[i];
}

// The CTAs of one launch the card keeps resident at `smem` bytes of
// dynamic shared memory. Also opens the kernel to all the dynamic shared
// memory a CTA may opt into on this device, once for every launch after.
template <typename T, bool kShared>
int max_grid_t(int cblock, int smem, int* out) {
  const auto kernel = gather_kernel<T, kShared>;
  cudaFuncAttributes fa;
  int dev = 0, sms = 0, per_sm = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, cblock, smem);
  if (err != cudaSuccess) return (int)err;
  *out = coop ? per_sm * sms : 0;
  return (int)cudaSuccess;
}

// One cooperative launch; max_grid_t has run for this kernel and device.
template <typename T, bool kShared>
int launch_t(GatherWork<T> w, GatherTables<T> tb, const Statics<T>& st, int cblock,
             int grid, int smem, void* stream) {
  Statics<T> s = st;
  void* args[] = {&w, &tb, &s};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)gather_kernel<T, kShared>, dim3(grid), dim3(cblock), args, (size_t)smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch's checks and the kShared dispatch. smem: the tau tile's bytes
// (U x kRows x sizeof(T)) where shared, else 0.
template <typename T>
int launch(const GatherWork<T>& w, const GatherTables<T>& tb, const void* statics,
           int cblock, int grid, int shared, void* stream) {
  const bool ok = w.n > 0 && w.n_blk > 0 && cblock >= 32 && cblock <= kMaxBlock &&
                  cblock % 32 == 0 && (long long)w.n_blk * cblock >= tb.C && grid > 0 &&
                  (w.mode == kLnprob || (w.W % 2 == 0 && w.n == w.W / 2)) &&
                  (!shared || (tb.U > 0 && tb.U <= 32767));
  if (!ok) return (int)cudaErrorInvalidValue;
  const Statics<T>& st = *static_cast<const Statics<T>*>(statics);
  if (shared)
    return launch_t<T, true>(w, tb, st, cblock, grid, tb.U * kRows * (int)sizeof(T), stream);
  return launch_t<T, false>(w, tb, st, cblock, grid, 0, stream);
}

template <typename T>
GatherTables<T> tables(const void* lines, const void* vel1, const void* vel2,
                       const void* key1, const void* key2, const void* blines,
                       const void* chans, const void* qst, int La, int M1, int M2, int C,
                       int cb0, int S, int U) {
  return GatherTables<T>{static_cast<const T*>(lines),  static_cast<const T*>(vel1),
                         static_cast<const T*>(vel2),   key1, key2,
                         static_cast<const int32_t*>(blines), static_cast<const T*>(chans),
                         static_cast<const T*>(qst),    La, M1, M2, C, cb0, S, U};
}

}  // namespace

extern "C" {

int k3_statics_size_f32() { return (int)sizeof(Statics<float>); }
int k3_statics_size_f64() { return (int)sizeof(Statics<double>); }
const char* k3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#define K3_TABLE_ARGS                                                                     \
  const void *lines, const void *vel1, const void *vel2, const void *key1,                \
      const void *key2, const void *blines, const void *chans, const void *qst
#define K3_TABLE_INTS int La, int M1, int M2, int C, int cb0, int S, int U
#define K3_TABLES(T)                                                                 \
  tables<T>(lines, vel1, vel2, key1, key2, blines, chans, qst, La, M1, M2, C, cb0, S, U)

#define K3_ENTRIES(SFX, T)                                                                \
  int k3_max_grid_##SFX(int cblock, int smem, int shared, int* out) {                    \
    return shared ? max_grid_t<T, true>(cblock, smem, out)                                \
                  : max_grid_t<T, false>(cblock, smem, out);                              \
  }                                                                                       \
  int k3_fused_steps_##SFX(void* state, const void* perm, const void* zu,                 \
                           const void* pair, const void* au, K3_TABLE_ARGS, void* prop,   \
                           void* zz, void* scal, void* partial, void* cc, void* tau,      \
                           void* acc, void* out_chain, void* out_lnps, void* out_acc,     \
                           const void* statics, int W, int D, K3_TABLE_INTS, int cblock,  \
                           int n_blk, int grid, int shared, int k, void* stream) {        \
    GatherWork<T> w{};                                                                    \
    w.state = static_cast<T*>(state);                                                     \
    w.perm = static_cast<const int32_t*>(perm);                                           \
    w.zu = static_cast<const T*>(zu);                                                     \
    w.pair = static_cast<const int32_t*>(pair);                                           \
    w.au = static_cast<const T*>(au);                                                     \
    w.prop = static_cast<T*>(prop); w.zz = static_cast<T*>(zz);                           \
    w.scal = static_cast<T*>(scal); w.partial = static_cast<T*>(partial);                 \
    w.cc = static_cast<T*>(cc); w.tau = static_cast<T*>(tau);                             \
    w.acc = static_cast<int*>(acc);                                                       \
    w.out_chain = static_cast<T*>(out_chain); w.out_lnps = static_cast<T*>(out_lnps);     \
    w.out_acc = static_cast<float*>(out_acc);                                             \
    w.mode = kSteps; w.W = W; w.D = D; w.n = W / 2; w.k = k; w.n_blk = n_blk;             \
    if (k < 1) return (int)cudaErrorInvalidValue;                                         \
    return launch<T>(w, K3_TABLES(T), statics, cblock, grid, shared, stream);             \
  }                                                                                       \
  int k5b_half_##SFX(void* state, const void* act, const void* comp, const void* zu,     \
                     const void* pair, const void* au, K3_TABLE_ARGS, void* prop,         \
                     void* zz, void* scal, void* partial, void* cc, void* tau, void* acc, \
                     void* out_acc, const void* statics, int W, int D, K3_TABLE_INTS,     \
                     int cblock, int n_blk, int grid, int shared, void* stream) {         \
    GatherWork<T> w{};                                                                    \
    w.state = static_cast<T*>(state);                                                     \
    w.act = static_cast<const int32_t*>(act);                                             \
    w.comp = static_cast<const T*>(comp);                                                 \
    w.zu = static_cast<const T*>(zu);                                                     \
    w.pair = static_cast<const int32_t*>(pair);                                           \
    w.au = static_cast<const T*>(au);                                                     \
    w.prop = static_cast<T*>(prop); w.zz = static_cast<T*>(zz);                           \
    w.scal = static_cast<T*>(scal); w.partial = static_cast<T*>(partial);                 \
    w.cc = static_cast<T*>(cc); w.tau = static_cast<T*>(tau);                             \
    w.acc = static_cast<int*>(acc);                                                       \
    w.out_acc = static_cast<float*>(out_acc);                                             \
    w.mode = kHalf; w.W = W; w.D = D; w.n = W / 2; w.k = 1; w.n_blk = n_blk;              \
    return launch<T>(w, K3_TABLES(T), statics, cblock, grid, shared, stream);             \
  }                                                                                       \
  int k3_lnprob_##SFX(const void* theta, void* out, K3_TABLE_ARGS, void* scal,           \
                      void* partial, void* cc, void* tau, const void* statics, int N,     \
                      int D, K3_TABLE_INTS, int cblock, int n_blk, int grid, int shared,  \
                      void* stream) {                                                     \
    GatherWork<T> w{};                                                                    \
    w.theta = static_cast<const T*>(theta);                                               \
    w.out = static_cast<T*>(out);                                                         \
    w.scal = static_cast<T*>(scal); w.partial = static_cast<T*>(partial);                 \
    w.cc = static_cast<T*>(cc); w.tau = static_cast<T*>(tau);                             \
    w.mode = kLnprob; w.W = 0; w.D = D; w.n = N; w.k = 1; w.n_blk = n_blk;                \
    return launch<T>(w, K3_TABLES(T), statics, cblock, grid, shared, stream);             \
  }
K3_ENTRIES(f32, float)
K3_ENTRIES(f64, double)

}  // extern "C"
