// K1 — fused whole-ensemble stretch-move step kernel, hand-written for
// Hopper (sm_90a). Built at first use by cha1_mcmc_tpu_torch/utils/
// cuda_build.py and bound through ctypes by cha1_mcmc_tpu_torch/sampler/
// fused.py, whose plain PyTorch version (fused_steps_plain /
// fused_lnprob_plain) computes the same function and is the kernel's test
// oracle.
//
// Replaces: the Pallas TPU kernel cha1_mcmc_tpu/sampler/fused.py:
// _step_kernel (:204, pallas_call :415; with _run_step_loop :221,
// _make_dense_lnprob :168, _make_q_of, _unpack_single, _prior_box and the
// statics of single_statics_tables). One launch runs k emcee-v3
// stretch-move steps of one single-component ensemble: per step two
// sequential half-updates, each gathering the active walkers, their
// complement and random partners, proposing Y = c + z (s - c), evaluating
// lnprob = box + Gaussian priors (flat Ncol) + chi^2 of
// dil (J_T - J_Tbg)(1 - exp(-opac)) with
// opac_c = sum_l tau_l 1{|v_lc - v0| < 10 dV} exp2(aa (v_lc - vlsr)^2),
// and accepting when ln u < (D - 1) ln z + lnp_new - lnp_s.
//
// What bounds it on this card: latency. At the flagship size (128 walkers,
// 9 lines x 561 channels) a half-update is 64 proposals x 561 channels of
// a few windowed exp2 and the radiative transfer (~0.1 us of the card's
// special-function rate), but the half-updates depend on each other, so
// the time of one is the time of its longest chain: a lane's serial walk
// over its channels, each a chain of dependent loads, exp2, exp and
// divides, plus the barriers between phases. The one-CTA design this
// replaces ran a half-update as 4 rounds of 16 warps on one SM, each lane
// walking ~18 channels and, for each, all 9 lines with a device-memory
// load and a window compare, and computing J(Tbg), ln(1 / sigma^2) and
// the beam per (proposal, channel). So the chain is cut three ways:
//  * one cluster of n = 16 CTAs (8 where the card cannot place 16)
//    (cluster_step.cuh), each with a full copy of the (W, D+1) state in
//    shared memory; CTA r owns proposals [r h / n, (r + 1) h / n) of every
//    half — at 128 walkers 4 proposals, one round of its 4 warp groups;
//  * K independent ensembles (MultiChainSampler, the JAX package's vmap
//    over chains) run in one launch, one cluster each (grid (n, K);
//    cluster_step.cuh: chain_offsets): each cluster offsets its walkers,
//    randomness and outputs by its chain and reads the shared tables, so
//    K chains pay one launch per k steps, and a chain's trajectory is the
//    one it takes launched alone, bitwise; clusters past those the card
//    holds at once run in later waves;
//  * four warps per proposal, 128 lanes striding the channels (~4-5 a lane
//    at the flagship); their chi^2 partials are reduced per warp and added
//    in warp order (no float atomics: a theta's lnprob is one function of
//    theta, the same in the lnprob entry, in K1 and in K5a, whatever the
//    cluster size or staging);
//  * per channel only the lines whose window at the prior's dV bound can
//    reach it: the channel-major entry tables (M, C) of the gather
//    formulation (build_opacity_gather: active-line index and velocity per
//    entry, in ascending line order, padding at velocity 1e30); M = 3 of 9
//    lines at the flagship. The exact per-proposal window test is kept on
//    each entry; the out-of-window terms it skips are exact zeros in the
//    plain version, so the in-window lines are summed in the same order;
//  * where they fit (always at the flagship), the tables (lines, entries,
//    chans) are copied into each CTA's shared memory once per launch and
//    the per-channel constants h nu / k, J(Tbg), ln(1 / sigma^2) and the
//    beam's square — in 4 dims (fixed source size) the dilution itself —
//    are computed there once per launch (chan_consts). Larger problems take
//    the same kernel reading the tables from device memory and computing
//    the constants in the loop with the same function, so the same bits;
//    their shared memory does not grow with the channel count;
//  * the owner of a proposal accepts it and writes the row into every
//    CTA's copy through distributed shared memory, then cluster.sync();
//    accepted counts are integer atomics into rank 0's shared memory,
//    double-buffered by step parity; each walker's chain row is written by
//    the owner of its proposal;
//  * no one-hot products and no -inf clamp: a walker that never accepted
//    keeps lnp = -inf, and -inf - (-inf) = NaN makes `ln u < NaN` false, as
//    in the general sampler (so: no fast-math, no flush-to-zero); the
//    stretch factor, the proposal (one fused multiply-add, as torch.addcmul
//    rounds it) and the acceptance difference use explicitly rounded
//    intrinsics, so in float64 the trajectories equal the plain version's
//    bitwise;
//  * statics (box, priors, Q(T) coefficients, geometry) are a plain struct
//    passed by value (__grid_constant__), rounded to the kernel's scalar
//    type once on the host (single_statics.cuh, shared with K3).
//
// K5a — the sharded half-step, in this source because it is K1's lnprob
// and half-update. Replaces the Pallas TPU kernel
// cha1_mcmc_tpu/parallel/sharded_fused.py:_half_step_kernel (:137, with
// _half_update :91; call :631): one half-update of a rank's W_l local
// walkers against the complement all-gathered over the walker shards (the
// gather and the all_gather run before the launch, on the caller's
// stream), as one cluster launch. The state stays in device memory: each
// CTA reads the rows of its own proposals and writes its accepted rows
// back there; the accepted count goes to out_acc. A call is one launch and
// a step two, where K1 runs k steps in one, so a timed call is bound by
// the host's launch path.
//
// C entries (all return a CUDA error code, cudaGetLastError() after the
// launch):
//   k1_fused_steps_{f32,f64}: k whole steps of K ensembles, one cluster
//                             each (grid (n, K));
//   k1_lnprob_{f32,f64}:      the same device lnprob over an (N, D) batch,
//                             kGroups thetas per CTA, no cluster;
//   k5a_half_{f32,f64}:       one sharded half-step (K5a), state in place;
//   k1_cluster_occupancy_{f32,f64}: cudaOccupancyMaxActiveClusters of the
//                             steps (entry 0) or half-step (1) kernel;
//   k1_statics_size_{f32,f64}: sizeof(Statics<T>), checked by the binding;
//   k1_geometry:              the constants the binding's layout assumes,
//                             checked when the library loads;
//   k1_error_string: the CUDA error message of a returned code.
// The cluster size and the shared-memory layout (SmemLayout) come from the
// binding (fused.py:plan_fused_cluster over sampler/cluster.py:
// smem_layout), the one place that sizes them; the kernels only apply the
// offsets.

#include "single_statics.cuh"
#include "cluster_step.cuh"

namespace {

template <typename T>
struct K1Tables {
  const T* lines;           // (5, La): the active lines' freq MHz, elower, aij, gup, glow
  const T* vel;             // (M, C): entry velocity, 1e30 on padding
  const int32_t* line_idx;  // (M, C): active-line index of the entry
  const T* chans;           // (3, C): freq MHz, observed y, 1 / sigma^2
  const T* qst;             // (2, S): state-sum g, E
  int La, M, C, S;
};

// K1's per-channel constants: chan_consts, with the dilution itself in
// place of the beam's square where the source size is fixed (4 dims).
template <typename T>
__device__ __forceinline__ ChanConsts<T> k1_chan_consts(const Statics<T>& st, T gf, T isig) {
  ChanConsts<T> k = chan_consts(st, gf, isig);
  if (!st.free_ss) k.b2 = dilution(k.b2, mul_rn(st.ss, st.ss));
  return k;
}

// K1's lnprob as a CTA-cooperative functor: every thread of the CTA calls
// it once per round with its warp group's theta (nullptr: none this round);
// thread 0 of each group with a theta writes the value to `out`. Ends on a
// CTA barrier. kStaged: `tb` and `cc` are in shared memory; else `tb` is
// in device memory and the constants are computed per channel.
template <typename T, bool kStaged>
struct K1GroupLnProb {
  const Statics<T>& st;
  K1Tables<T> tb;
  const T* cc;   // (kChanConsts, C) per-channel constants (kStaged)
  T* tau;        // kGroups x La stick opacities
  T* part;       // kGroups x kGroupWarps chi^2 partials

  __device__ void operator()(const T* th, T* out) const {
    const int tid = threadIdx.x, grp = tid / kGroupThreads, gt = tid - grp * kGroupThreads;
    const int lane = tid & 31, C = tb.C;
    T* tg = tau + (size_t)grp * tb.La;
    T* pg = part + grp * kGroupWarps;
    T ss_w = T(0), Ncol = T(0), Tex = T(0), vlsr = T(0), dV = T(0), lp = T(0);
    bool ok = th != nullptr;
    if (ok) {
      // Box bounds + Gaussian priors, Ncol flat (_prior_box).
      unpack_single(th, st, ss_w, Ncol, Tex, vlsr, dV);
      ok = single_prior(th, st, lp);
    }
    // Stick opacities of the active lines (ops/lte.py:tau_sticks), over the group.
    if (ok) {
      const T Q = q_of(Tex, st, tb.qst, tb.S, lane);
      for (int l = gt; l < tb.La; l += kGroupThreads)
        tg[l] = tau_stick(tb.lines[l], tb.lines[tb.La + l], tb.lines[2 * tb.La + l],
                          tb.lines[3 * tb.La + l], tb.lines[4 * tb.La + l], Q, Ncol, Tex,
                          dV);
    }
    __syncthreads();
    if (ok) {
      // exp(-0.5 ((v - vlsr) / sigma)^2) as exp2(aa d^2), aa = -log2(e) / (2 sigma^2).
      const T sigma = dV / T(2.355);
      const T aa = T(-0.5 * 1.4426950408889634) / (sigma * sigma);
      const T win = T(10) * dV;
      const T ss2 = mul_rn(ss_w, ss_w);
      T p = T(0);
      for (int c = gt; c < C; c += kGroupThreads) {
        T opac = T(0);
        for (int m = 0; m < tb.M; ++m) {
          const T v = tb.vel[m * C + c];
          if (ab(v - st.mask_center) < win) {
            const T d = v - vlsr;
            opac += tg[tb.line_idx[m * C + c]] * ex2(aa * (d * d));
          }
        }
        ChanConsts<T> kc;
        if constexpr (kStaged)
          kc = {cc[c], cc[C + c], cc[2 * C + c], cc[3 * C + c]};
        else
          kc = k1_chan_consts(st, tb.chans[c], tb.chans[2 * C + c]);
        // planck_J(nu, Tex) from x, minus J(Tbg)
        const T dJ = kc.x / (ex(kc.x / Tex) - T(1) + T(1e-10)) - kc.jbg;
        const T dil = st.free_ss ? dilution(kc.b2, ss2) : kc.b2;
        const T mdl = dil * dJ * (T(1) - ex(-opac));
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
__device__ K1Tables<T> stage_tables(const Statics<T>& st, const K1Tables<T>& g,
                                    const Carve<T>& s) {
  if constexpr (!kStaged) return g;
  const int C = g.C, MC = g.M * g.C;
  for (int i = threadIdx.x; i < kChanRows * C; i += kThreads) s.chans[i] = g.chans[i];
  for (int i = threadIdx.x; i < MC; i += kThreads) {
    s.vel[i] = g.vel[i];
    s.line_idx[i] = g.line_idx[i];
  }
  for (int i = threadIdx.x; i < kLineRows * g.La; i += kThreads) s.lines[i] = g.lines[i];
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const ChanConsts<T> k = k1_chan_consts(st, g.chans[c], g.chans[2 * C + c]);
    s.cc[c] = k.x;
    s.cc[C + c] = k.jbg;
    s.cc[2 * C + c] = k.lnisig;
    s.cc[3 * C + c] = k.b2;
  }
  return K1Tables<T>{s.lines, s.vel, s.line_idx, s.chans, g.qst, g.La, g.M, g.C, g.S};
}

// K1: k whole steps of K independent ensembles, one cluster each: this
// cluster runs chain blockIdx.y.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
k1_cluster_steps_kernel(const T* __restrict__ coords, const T* __restrict__ lnp0,
                        const int32_t* __restrict__ perm, const T* __restrict__ zu,
                        const int32_t* __restrict__ pair, const T* __restrict__ au,
                        K1Tables<T> tb, T* __restrict__ out_chain, T* __restrict__ out_lnps,
                        float* __restrict__ out_acc, int W, int D, int k, SmemLayout L,
                        __grid_constant__ const Statics<T> st) {
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
  const K1Tables<T> tables = stage_tables<T, kStaged>(st, tb, s);
  if (tid < 2) s.acc[tid] = 0;
  cluster.sync();  // every CTA resident and initialised before remote access
  int* acc0 = cluster.map_shared_rank(s.acc, 0);
  const K1GroupLnProb<T, kStaged> lnprob{st, tables, s.cc, s.tau, s.part};
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

// K5a: one sharded half-step of a rank's W local walkers against the
// complement gathered over the walker shards, on one cluster.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
k5a_cluster_half_kernel(T* __restrict__ state_g, const int32_t* __restrict__ act,
                        const T* __restrict__ comp, const T* __restrict__ zu,
                        const int32_t* __restrict__ pair, const T* __restrict__ au,
                        K1Tables<T> tb, float* __restrict__ out_acc, int W, int D,
                        SmemLayout L, __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, h = W / 2;
  const Carve<T> s = carve<T>(smem, L);
  const K1Tables<T> tables = stage_tables<T, kStaged>(st, tb, s);
  if (tid == 0) s.acc[0] = 0;
  cluster.sync();
  const K1GroupLnProb<T, kStaged> lnprob{st, tables, s.cc, s.tau, s.part};
  cluster_half_update<T>(state_g, D, h, act, GatheredComplement<T>{comp, D}, zu, pair, au,
                         st.a, s.prop, s.zz, s.flag, cluster.map_shared_rank(s.acc, 0),
                         lnprob, GlobalCommit<T>{state_g, D});
  if (cluster.block_rank() == 0 && tid == 0) out_acc[0] = (float)s.acc[0];
}

// The lnprob entry: kGroups thetas per CTA, as many CTAs as the batch fills.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
k1_lnprob_kernel(const T* __restrict__ theta, T* __restrict__ out, K1Tables<T> tb, int N,
                 int D, SmemLayout L, __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Carve<T> s = carve<T>(smem, L);
  const K1Tables<T> tables = stage_tables<T, kStaged>(st, tb, s);
  __syncthreads();
  const int j = blockIdx.x * kGroups + threadIdx.x / kGroupThreads;
  const K1GroupLnProb<T, kStaged> lnprob{st, tables, s.cc, s.tau, s.part};
  lnprob(j < N ? theta + (size_t)j * D : nullptr, out + j);
}

template <typename T>
K1Tables<T> make_tables(const void* lines, const void* vel, const void* line_idx,
                        const void* chans, const void* qst, int La, int M, int C, int S) {
  return K1Tables<T>{static_cast<const T*>(lines), static_cast<const T*>(vel),
                     static_cast<const int32_t*>(line_idx), static_cast<const T*>(chans),
                     static_cast<const T*>(qst), La, M, C, S};
}

// Each kernel's instance for a layout: staged or not.
template <typename T>
auto steps_kernel(const SmemLayout& L) {
  return L.staged ? k1_cluster_steps_kernel<T, true> : k1_cluster_steps_kernel<T, false>;
}
template <typename T>
auto half_kernel(const SmemLayout& L) {
  return L.staged ? k5a_cluster_half_kernel<T, true> : k5a_cluster_half_kernel<T, false>;
}
template <typename T>
auto lnprob_kernel(const SmemLayout& L) {
  return L.staged ? k1_lnprob_kernel<T, true> : k1_lnprob_kernel<T, false>;
}

template <typename T>
int launch_steps(const void* coords, const void* lnp0, const void* perm, const void* zu,
                 const void* pair, const void* au, const void* lines, const void* vel,
                 const void* line_idx, const void* chans, const void* qst, void* out_chain,
                 void* out_lnps, void* out_acc, const void* statics, const void* layout,
                 int W, int D, int La, int M, int C, int S, int k, int chains, int n,
                 void* stream) {
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  return cluster_launch(steps_kernel<T>(L), n, chains, (size_t)L.bytes, stream,
                        static_cast<const T*>(coords), static_cast<const T*>(lnp0),
                        static_cast<const int32_t*>(perm), static_cast<const T*>(zu),
                        static_cast<const int32_t*>(pair), static_cast<const T*>(au),
                        make_tables<T>(lines, vel, line_idx, chans, qst, La, M, C, S),
                        static_cast<T*>(out_chain), static_cast<T*>(out_lnps),
                        static_cast<float*>(out_acc), W, D, k, L, st);
}

template <typename T>
int launch_half(void* state, const void* act, const void* comp, const void* zu,
                const void* pair, const void* au, const void* lines, const void* vel,
                const void* line_idx, const void* chans, const void* qst, void* out_acc,
                const void* statics, const void* layout, int W, int D, int La, int M, int C,
                int S, int n, void* stream) {
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  return cluster_launch(half_kernel<T>(L), n, 1, (size_t)L.bytes, stream,
                        static_cast<T*>(state), static_cast<const int32_t*>(act),
                        static_cast<const T*>(comp), static_cast<const T*>(zu),
                        static_cast<const int32_t*>(pair), static_cast<const T*>(au),
                        make_tables<T>(lines, vel, line_idx, chans, qst, La, M, C, S),
                        static_cast<float*>(out_acc), W, D, L, st);
}

template <typename T>
int launch_lnprob(const void* theta, void* out, const void* lines, const void* vel,
                  const void* line_idx, const void* chans, const void* qst,
                  const void* statics, const void* layout, int N, int D, int La, int M,
                  int C, int S, void* stream) {
  const Statics<T> st = *static_cast<const Statics<T>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  if (N == 0) return (int)cudaSuccess;
  const auto kernel = lnprob_kernel<T>(L);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kGroups - 1) / kGroups;
  kernel<<<blocks, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<T*>(out),
      make_tables<T>(lines, vel, line_idx, chans, qst, La, M, C, S), N, D, L, st);
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

int k1_statics_size_f32() { return (int)sizeof(Statics<float>); }
int k1_statics_size_f64() { return (int)sizeof(Statics<double>); }
const char* k1_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// What sampler/cluster.py:smem_layout sizes the regions by (layout_geometry).
void k1_geometry(int* out) { layout_geometry(out); }

#define K1_ENTRIES(SFX, T)                                                              \
  int k1_fused_steps_##SFX(const void* coords, const void* lnp0, const void* perm,      \
                           const void* zu, const void* pair, const void* au,            \
                           const void* lines, const void* vel, const void* line_idx,    \
                           const void* chans, const void* qst, void* out_chain,         \
                           void* out_lnps, void* out_acc, const void* statics,          \
                           const void* layout, int W, int D, int La, int M, int C,      \
                           int S, int k, int chains, int cluster, void* stream) {       \
    return launch_steps<T>(coords, lnp0, perm, zu, pair, au, lines, vel, line_idx,      \
                           chans, qst, out_chain, out_lnps, out_acc, statics, layout,   \
                           W, D, La, M, C, S, k, chains, cluster, stream);              \
  }                                                                                     \
  int k1_lnprob_##SFX(const void* theta, void* out, const void* lines, const void* vel, \
                      const void* line_idx, const void* chans, const void* qst,         \
                      const void* statics, const void* layout, int N, int D, int La,    \
                      int M, int C, int S, void* stream) {                              \
    return launch_lnprob<T>(theta, out, lines, vel, line_idx, chans, qst, statics,      \
                            layout, N, D, La, M, C, S, stream);                         \
  }                                                                                     \
  int k5a_half_##SFX(void* state, const void* act, const void* comp, const void* zu,    \
                     const void* pair, const void* au, const void* lines,               \
                     const void* vel, const void* line_idx, const void* chans,          \
                     const void* qst, void* out_acc, const void* statics,               \
                     const void* layout, int W, int D, int La, int M, int C, int S,     \
                     int cluster, void* stream) {                                       \
    return launch_half<T>(state, act, comp, zu, pair, au, lines, vel, line_idx, chans,  \
                          qst, out_acc, statics, layout, W, D, La, M, C, S, cluster,    \
                          stream);                                                      \
  }                                                                                     \
  int k1_cluster_occupancy_##SFX(int entry, int cluster, const void* layout,            \
                                 void* out) {                                           \
    return occupancy<T>(entry, cluster, layout, out);                                   \
  }
K1_ENTRIES(f32, float)
K1_ENTRIES(f64, double)

}  // extern "C"
