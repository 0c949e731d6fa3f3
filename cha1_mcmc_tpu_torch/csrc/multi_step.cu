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
// What bounds it on this card: latency. At the GOTHAM size (128 walkers,
// K = 4, 66 lines x ~1,133 channels, ~3 lines per channel) a half-update
// evaluates 64 proposals x 1,133 channels x 3 lines x 4 components ~ 870k
// windowed exp2 plus ~300k exp and divides of the radiative transfer; on
// one SM that alone is ~56 us of special-function issue, over the card
// under 1 us. The half-updates depend on each other, so the time of one
// is the time of its longest chain: each lane walks its ~9 channels in
// series, a dependent chain of table loads, exp2, exp and divides per
// channel. So one ensemble is spread over a thread-block cluster
// (cluster_step.cuh) and the chain is kept short:
//  * one cluster of n = 16 CTAs (8 where the card cannot place 16), each
//    with a full copy of the (W, D+1) state in shared memory; CTA r owns
//    proposals [r h / n, (r + 1) h / n) of every half;
//  * K independent ensembles (MultiChainSampler, the JAX package's vmap
//    over chains) run in one launch, one cluster each (grid (n, K);
//    cluster_step.cuh: chain_offsets): each cluster offsets its walkers,
//    randomness and outputs by its chain and reads the shared tables, so
//    K chains pay one launch per k steps, and a chain's trajectory is the
//    one it takes launched alone, bitwise; clusters past those the card
//    holds at once run in later waves;
//  * four warps per proposal, 128 lanes striding the channels; their chi^2
//    partials are reduced per warp and added in warp order (no float
//    atomics: a theta's lnprob is one function of theta, the same in the
//    lnprob entry, in K2 and in K5c, whatever the cluster size);
//  * where they fit (a "staged" launch: up to ~3,200 GOTHAM-shaped
//    channels in f32, ~1,900 in f64, at 128 walkers and K = 4), every
//    table the loop reads (lines, the (M, C) entry tables, chans) is
//    copied into each CTA's shared memory once per launch — a half-step
//    is a chain of dependent loads per channel, and shared memory answers
//    in tens of cycles where L2 takes hundreds — and the per-channel
//    constants h nu / k, J(Tbg), ln(1 / sigma^2) and the beam's square
//    are computed there once per launch, so the (proposal, channel) loop
//    pays only for J(Tex), per component the dilution's divide and
//    exp(-opac), and the in-window exp2 terms. Larger problems take the
//    same kernel reading the tables from device memory and computing the
//    constants in the loop (chan_consts, cluster_step.cuh: the same
//    function, so the same bits); their shared memory does not grow with
//    the channel count;
//  * the owner of a proposal accepts it and writes the row into every
//    CTA's copy through distributed shared memory, then cluster.sync();
//    accepted counts are integer atomics into rank 0's shared memory;
//    each walker's chain row is written by the owner of its proposal;
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
//  * no one-hot products and no -inf clamp: a walker that never accepted
//    keeps lnp = -inf;
//  * statics (prior bounds and Gaussians, Q(T), geometry) are a plain
//    struct passed by value (__grid_constant__), rounded to the kernel's
//    scalar type once on the host; at most kMaxComp components.
//
// K5c — the sharded multi-component half-step, in this source because it
// is K2's lnprob and half-update. Replaces the Pallas TPU kernel
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_step_kernel_multi (:320,
// call :494): one half-update of a rank's W_l local walkers against the
// complement all-gathered over the walker shards, as one cluster launch.
// It keeps K2's (W, D+1) layout, not the TPU kernel's transposed (D+1, W)
// one, but no copy of it in shared memory: each CTA reads the rows of its
// own proposals from device memory and writes its accepted rows back
// there; the accepted count goes to out_acc.
//
// C entries (all return a CUDA error code, cudaGetLastError() after the
// launch):
//   k2_fused_steps_{f32,f64}: k whole steps of K ensembles, one cluster
//                             each (grid (n, K));
//   k2_lnprob_{f32,f64}:      the same device lnprob over an (N, D) batch,
//                             kGroups thetas per CTA, no cluster;
//   k5c_half_{f32,f64}:       one sharded half-step (K5c), state in place;
//   k2_cluster_occupancy_{f32,f64}: cudaOccupancyMaxActiveClusters of the
//                             steps (entry 0) or half-step (1) kernel;
//   k2_statics_size_{f32,f64}: sizeof(MultiStatics<T>), checked by the binding;
//   k2_geometry:              the constants the binding's layout assumes,
//                             checked when the library loads;
//   k2_error_string: the CUDA error message of a returned code.
// The cluster size and the shared-memory layout (SmemLayout: each
// region's offset, the total, staged or not) come from the binding
// (fused_multi.py:plan_multi_cluster over sampler/cluster.py:smem_layout),
// the one place that sizes them; the kernels only apply the offsets.

#include "step_loop.cuh"
#include "cluster_step.cuh"

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

// The (kChanConsts, C) constants of every channel into `cc`, by the CTA.
template <typename T>
__device__ void channel_constants(const MultiStatics<T>& st, const MultiTables<T>& tb,
                                  T* cc) {
  const int C = tb.C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const ChanConsts<T> k = chan_consts(st, tb.chans[c], tb.chans[2 * C + c]);
    cc[c] = k.x;
    cc[C + c] = k.jbg;
    cc[2 * C + c] = k.lnisig;
    cc[3 * C + c] = k.b2;
  }
}

// K2's lnprob as a CTA-cooperative functor: every thread of the CTA calls
// it once per round with its warp group's theta (nullptr: none this round);
// thread 0 of each group with a theta writes the value to `out`. Ends on a
// CTA barrier. kStaged: `tb` and `cc` are in shared memory; else `tb` is
// in device memory and the constants are computed per channel.
template <typename T, bool kStaged>
struct MultiGroupLnProb {
  const MultiStatics<T>& st;
  MultiTables<T> tb;
  const T* cc;   // (kChanConsts, C) per-channel constants (kStaged)
  T* tau;        // kGroups x (K x La) stick opacities
  T* part;       // kGroups x kGroupWarps chi^2 partials

  __device__ void operator()(const T* th, T* out) const {
    const int tid = threadIdx.x, grp = tid / kGroupThreads, gt = tid - grp * kGroupThreads;
    const int lane = tid & 31, K = st.ncomp, C = tb.C;
    T* tg = tau + (size_t)grp * K * tb.La;
    T* pg = part + grp * kGroupWarps;
    T ss2[kMaxComp], vl[kMaxComp];
    T lp = T(0), Tex = T(0), dV = T(0);
    bool ok = th != nullptr;
    if (ok) {
      // Ordered-velocity prior (_make_multi_lnprob:350-365): per component
      // the ss and vlsr Gaussians, then Tex, then dV; flat Ncol.
      Tex = th[2 * K];
      dV = th[3 * K + 1];
#pragma unroll
      for (int k = 0; k < kMaxComp; ++k) {
        if (k < K) {
          const T ss = th[k], ncol = th[K + k];
          vl[k] = th[2 * K + 1 + k];
          ss2[k] = mul_rn(ss, ss);
          ok = ok && (ss > st.ss_lo) && (ss < st.ss_hi)
                  && (ncol > st.ncol_lo) && (ncol < st.ncol_hi);
          T u = (ss - st.mean_ss[k]) / st.sd_ss[k];
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
    }
    // Stick opacities per (component, active line), over the group.
    if (ok) {
      const T Q = q_of(Tex, st, tb.qst, tb.S, lane);
      for (int i = gt; i < K * tb.La; i += kGroupThreads) {
        const int k = i / tb.La, l = i - k * tb.La;
        tg[i] = tau_stick(tb.lines[l], tb.lines[tb.La + l], tb.lines[2 * tb.La + l],
                          tb.lines[3 * tb.La + l], tb.lines[4 * tb.La + l], Q,
                          th[K + k], Tex, dV);
      }
    }
    __syncthreads();
    if (ok) {
      // exp(-0.5 ((v - vlsr) / sigma)^2) as exp2(aa d^2), aa = -log2(e) / (2 sigma^2).
      const T sigma = dV / T(2.355);
      const T aa = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
      const T win = T(10) * dV;
      T p = T(0);
      for (int c = gt; c < C; c += kGroupThreads) {
        T opac[kMaxComp], gacc[kMaxComp];
#pragma unroll
        for (int k = 0; k < kMaxComp; ++k) opac[k] = gacc[k] = T(0);
        int cur = -1;
        for (int m = 0; m < tb.M; ++m) {
          const T v = tb.vel[m * C + c];
          if (ab(v - st.mask_center) < win) {
            const int g = tb.group[m * C + c];
            if (g != cur) {  // a new hfs group: add the finished group's sums
#pragma unroll
              for (int k = 0; k < kMaxComp; ++k) {
                opac[k] = opac[k] + gacc[k];
                gacc[k] = T(0);
              }
              cur = g;
            }
            const T* tl = tg + tb.line_idx[m * C + c];
#pragma unroll
            for (int k = 0; k < kMaxComp; ++k) {
              if (k < K) {
                const T d = v - vl[k];
                gacc[k] = gacc[k] + tl[k * tb.La] * ex2(aa * (d * d));
              }
            }
          }
        }
        ChanConsts<T> kc;
        if constexpr (kStaged)
          kc = {cc[c], cc[C + c], cc[2 * C + c], cc[3 * C + c]};
        else
          kc = chan_consts(st, tb.chans[c], tb.chans[2 * C + c]);
        // planck_J(nu, Tex) from x, minus J(Tbg)
        const T dJ = kc.x / (ex(kc.x / Tex) - T(1) + T(1e-10)) - kc.jbg;
        T mdl = T(0);
#pragma unroll
        for (int k = 0; k < kMaxComp; ++k) {
          if (k < K) {
            const T o = opac[k] + gacc[k];
            mdl = mdl + ss2[k] / add_rn(kc.b2, ss2[k]) * dJ * (T(1) - ex(-o));
          }
        }
        const T resid = tb.chans[C + c] - mdl;
        p += resid * resid * tb.chans[2 * C + c] - kc.lnisig;
      }
      const T w = warp_sum(p);
      if (lane == 0) pg[gt >> 5] = w;
    }
    __syncthreads();
    if (th != nullptr && gt == 0) {
      T val = neg_inf<T>();
      if (ok) {
        T chi = pg[0];
#pragma unroll
        for (int w = 1; w < kGroupWarps; ++w) chi = chi + pg[w];
        const T v = lp + T(-0.5) * chi;
        if (isfinite(v)) val = v;
      }
      *out = val;
    }
    __syncthreads();  // tau and the partials are rewritten next round
  }
};

// kStaged: copy the tables into the CTA's shared memory and compute the
// per-channel constants there, and return the tables as the lnprob reads
// them (the state sum's qst stays in device memory); the caller's next
// barrier publishes them. Else the tables stay where they are.
template <typename T, bool kStaged>
__device__ MultiTables<T> stage_tables(const MultiStatics<T>& st, const MultiTables<T>& g,
                                       const Carve<T>& s) {
  if constexpr (!kStaged) return g;
  const int C = g.C, MC = g.M * g.C;
  for (int i = threadIdx.x; i < kChanRows * C; i += kThreads) s.chans[i] = g.chans[i];
  for (int i = threadIdx.x; i < MC; i += kThreads) {
    s.vel[i] = g.vel[i];
    s.line_idx[i] = g.line_idx[i];
    s.group[i] = g.group[i];
  }
  for (int i = threadIdx.x; i < kLineRows * g.La; i += kThreads) s.lines[i] = g.lines[i];
  channel_constants(st, g, s.cc);
  return MultiTables<T>{s.lines, s.vel, s.line_idx, s.group, s.chans, g.qst,
                        g.La, g.M, g.C, g.S};
}

// K2: k whole steps of K independent ensembles, one cluster each: this
// cluster runs chain blockIdx.y.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
multi_cluster_steps_kernel(const T* __restrict__ coords, const T* __restrict__ lnp0,
                           const int32_t* __restrict__ perm, const T* __restrict__ zu,
                           const int32_t* __restrict__ pair, const T* __restrict__ au,
                           MultiTables<T> tb, T* __restrict__ out_chain,
                           T* __restrict__ out_lnps, float* __restrict__ out_acc,
                           int W, int D, int k, SmemLayout L,
                           __grid_constant__ const MultiStatics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, h = W / 2, D1 = D + 1;
  const int rank = (int)cluster.block_rank();
  const ChainOffsets at = chain_offsets(W, D, k);
  coords += at.walkers;
  lnp0 += at.lnp;
  perm += at.steps;
  zu += at.steps;
  pair += at.steps;
  au += at.steps;
  out_chain += at.chain;
  out_lnps += at.steps;
  out_acc += at.acc;
  const Carve<T> s = carve<T>(smem, L);
  for (int i = tid; i < W * D; i += kThreads) s.state[(i / D) * D1 + i % D] = coords[i];
  for (int w = tid; w < W; w += kThreads) s.state[w * D1 + D] = lnp0[w];
  const MultiTables<T> tables = stage_tables<T, kStaged>(st, tb, s);
  if (tid < 2) s.acc[tid] = 0;
  cluster.sync();  // every CTA resident and initialised before remote access
  int* acc0 = cluster.map_shared_rank(s.acc, 0);
  const MultiGroupLnProb<T, kStaged> lnprob{st, tables, s.cc, s.tau, s.part};
  for (int step = 0; step < k; ++step) {
    const int32_t* pm = perm + (size_t)step * W;
    const ResidentCommit<T> commit{s.state, out_chain + (size_t)step * W * D,
                                   out_lnps + (size_t)step * W, D};
    for (int half = 0; half < 2; ++half) {
      const int r = 2 * step + half;
      const StateComplement<T> comp{s.state, pm + (1 - half) * h, D1};
      cluster_half_update<T>(s.state, D, h, pm + half * h, comp, zu + r * h,
                             pair + r * h, au + r * h, st.a, s.prop, s.zz, s.flag,
                             acc0 + (step & 1), lnprob, commit);
    }
    // Every add of this step precedes the cluster.sync() just passed; the
    // slot is next added to two steps on, after rank 0 has reset it.
    if (rank == 0 && tid == 0) {
      out_acc[step] = (float)s.acc[step & 1];
      s.acc[step & 1] = 0;
    }
  }
}

// K5c: one sharded half-step of a rank's W local walkers against the
// complement gathered over the walker shards, on one cluster.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
multi_cluster_half_kernel(T* __restrict__ state_g, const int32_t* __restrict__ act,
                          const T* __restrict__ comp, const T* __restrict__ zu,
                          const int32_t* __restrict__ pair, const T* __restrict__ au,
                          MultiTables<T> tb, float* __restrict__ out_acc, int W, int D,
                          SmemLayout L, __grid_constant__ const MultiStatics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, h = W / 2;
  const Carve<T> s = carve<T>(smem, L);
  const MultiTables<T> tables = stage_tables<T, kStaged>(st, tb, s);
  if (tid == 0) s.acc[0] = 0;
  cluster.sync();
  const MultiGroupLnProb<T, kStaged> lnprob{st, tables, s.cc, s.tau, s.part};
  cluster_half_update<T>(state_g, D, h, act, GatheredComplement<T>{comp, D}, zu, pair, au,
                         st.a, s.prop, s.zz, s.flag, cluster.map_shared_rank(s.acc, 0),
                         lnprob, GlobalCommit<T>{state_g, D});
  if (cluster.block_rank() == 0 && tid == 0) out_acc[0] = (float)s.acc[0];
}

// The lnprob entry: kGroups thetas per CTA, as many CTAs as the batch fills.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
multi_lnprob_kernel(const T* __restrict__ theta, T* __restrict__ out,
                    MultiTables<T> tb, int N, int D, SmemLayout L,
                    __grid_constant__ const MultiStatics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Carve<T> s = carve<T>(smem, L);
  const MultiTables<T> tables = stage_tables<T, kStaged>(st, tb, s);
  __syncthreads();
  const int j = blockIdx.x * kGroups + threadIdx.x / kGroupThreads;
  const MultiGroupLnProb<T, kStaged> lnprob{st, tables, s.cc, s.tau, s.part};
  lnprob(j < N ? theta + (size_t)j * D : nullptr, out + j);
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

// Each kernel's instance for a layout: staged or not.
template <typename T>
auto steps_kernel(const SmemLayout& L) {
  return L.staged ? multi_cluster_steps_kernel<T, true> : multi_cluster_steps_kernel<T, false>;
}
template <typename T>
auto half_kernel(const SmemLayout& L) {
  return L.staged ? multi_cluster_half_kernel<T, true> : multi_cluster_half_kernel<T, false>;
}
template <typename T>
auto lnprob_kernel(const SmemLayout& L) {
  return L.staged ? multi_lnprob_kernel<T, true> : multi_lnprob_kernel<T, false>;
}

template <typename T>
int launch_steps(const void* coords, const void* lnp0, const void* perm,
                 const void* zu, const void* pair, const void* au,
                 const void* lines, const void* vel, const void* line_idx,
                 const void* group, const void* chans, const void* qst,
                 void* out_chain, void* out_lnps, void* out_acc,
                 const void* statics, const void* layout, int W, int D, int La, int M,
                 int C, int S, int k, int chains, int n, void* stream) {
  const MultiStatics<T> st = *static_cast<const MultiStatics<T>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  return cluster_launch(steps_kernel<T>(L), n, chains, (size_t)L.bytes, stream,
                        static_cast<const T*>(coords), static_cast<const T*>(lnp0),
                        static_cast<const int32_t*>(perm), static_cast<const T*>(zu),
                        static_cast<const int32_t*>(pair), static_cast<const T*>(au),
                        make_tables<T>(lines, vel, line_idx, group, chans, qst, La, M, C, S),
                        static_cast<T*>(out_chain), static_cast<T*>(out_lnps),
                        static_cast<float*>(out_acc), W, D, k, L, st);
}

template <typename T>
int launch_half(void* state, const void* act, const void* comp, const void* zu,
                const void* pair, const void* au, const void* lines, const void* vel,
                const void* line_idx, const void* group, const void* chans,
                const void* qst, void* out_acc, const void* statics, const void* layout,
                int W, int D, int La, int M, int C, int S, int n, void* stream) {
  const MultiStatics<T> st = *static_cast<const MultiStatics<T>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  return cluster_launch(half_kernel<T>(L), n, 1, (size_t)L.bytes, stream,
                        static_cast<T*>(state), static_cast<const int32_t*>(act),
                        static_cast<const T*>(comp), static_cast<const T*>(zu),
                        static_cast<const int32_t*>(pair), static_cast<const T*>(au),
                        make_tables<T>(lines, vel, line_idx, group, chans, qst, La, M, C, S),
                        static_cast<float*>(out_acc), W, D, L, st);
}

template <typename T>
int launch_lnprob(const void* theta, void* out, const void* lines,
                  const void* vel, const void* line_idx, const void* group,
                  const void* chans, const void* qst, const void* statics,
                  const void* layout, int N, int D, int La, int M, int C, int S,
                  void* stream) {
  const MultiStatics<T> st = *static_cast<const MultiStatics<T>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  if (N == 0) return (int)cudaSuccess;
  const auto kernel = lnprob_kernel<T>(L);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kGroups - 1) / kGroups;
  kernel<<<blocks, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<T*>(out),
      make_tables<T>(lines, vel, line_idx, group, chans, qst, La, M, C, S), N, D, L, st);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int entry, int n, const void* layout, void* out) {
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  int* clusters = static_cast<int*>(out);
  return entry == 0 ? cluster_occupancy(steps_kernel<T>(L), n, (size_t)L.bytes, clusters)
                    : cluster_occupancy(half_kernel<T>(L), n, (size_t)L.bytes, clusters);
}

}  // namespace

extern "C" {

int k2_statics_size_f32() { return (int)sizeof(MultiStatics<float>); }
int k2_statics_size_f64() { return (int)sizeof(MultiStatics<double>); }
const char* k2_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// What sampler/cluster.py:smem_layout sizes the regions by (layout_geometry).
void k2_geometry(int* out) { layout_geometry(out); }

#define K2_ENTRIES(SFX, T)                                                            \
  int k2_fused_steps_##SFX(const void* coords, const void* lnp0, const void* perm,    \
                           const void* zu, const void* pair, const void* au,          \
                           const void* lines, const void* vel, const void* line_idx,  \
                           const void* group, const void* chans, const void* qst,     \
                           void* out_chain, void* out_lnps, void* out_acc,            \
                           const void* statics, const void* layout, int W, int D,     \
                           int La, int M, int C, int S, int k, int chains,            \
                           int cluster, void* stream) {                               \
    return launch_steps<T>(coords, lnp0, perm, zu, pair, au, lines, vel, line_idx,    \
                           group, chans, qst, out_chain, out_lnps, out_acc, statics,  \
                           layout, W, D, La, M, C, S, k, chains, cluster, stream);    \
  }                                                                                   \
  int k2_lnprob_##SFX(const void* theta, void* out, const void* lines,                \
                      const void* vel, const void* line_idx, const void* group,       \
                      const void* chans, const void* qst, const void* statics,        \
                      const void* layout, int N, int D, int La, int M, int C, int S,  \
                      void* stream) {                                                 \
    return launch_lnprob<T>(theta, out, lines, vel, line_idx, group, chans, qst,      \
                            statics, layout, N, D, La, M, C, S, stream);              \
  }                                                                                   \
  int k5c_half_##SFX(void* state, const void* act, const void* comp, const void* zu,  \
                     const void* pair, const void* au, const void* lines,             \
                     const void* vel, const void* line_idx, const void* group,        \
                     const void* chans, const void* qst, void* out_acc,               \
                     const void* statics, const void* layout, int W, int D, int La,   \
                     int M, int C, int S, int cluster, void* stream) {                \
    return launch_half<T>(state, act, comp, zu, pair, au, lines, vel, line_idx,       \
                          group, chans, qst, out_acc, statics, layout, W, D, La, M,   \
                          C, S, cluster, stream);                                     \
  }                                                                                   \
  int k2_cluster_occupancy_##SFX(int entry, int cluster, const void* layout,          \
                                 void* out) {                                         \
    return occupancy<T>(entry, cluster, layout, out);                                 \
  }
K2_ENTRIES(f32, float)
K2_ENTRIES(f64, double)

}  // extern "C"
