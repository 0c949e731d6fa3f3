// Device code of the port's cluster step kernels — K1 and its sharded
// half-step K5a (fused_step.cu), K2 and its sharded half-step K5c
// (multi_step.cu): one ensemble spread over a thread-block cluster of up
// to 16 CTAs. A K1 or K2 launch runs K independent ensembles, one
// cluster each: its grid is (n, K) with clusters of (n, 1), and each
// cluster reads its chain from blockIdx.y (chain_offsets). No barrier
// crosses clusters, so K may exceed the clusters the card holds at once;
// the rest run in later waves. K5a and K5c launch one cluster (K = 1).
// K2's wide path (multi_step.cu: wide_steps, h CTAs a chain in one
// cooperative launch) takes its layout and chain_offsets from here, not
// its clusters.
//
//  * CTA `rank` of n owns proposals [rank h / n, (rank + 1) h / n) of a
//    half-update (owned_slice): a balanced, possibly ragged split in which
//    every proposal has exactly one owner;
//  * each proposal is evaluated by a group of kGroupWarps warps, kGroups
//    groups per CTA, in rounds over the owned proposals; the lnprob is a
//    CTA-cooperative functor lnprob(theta or nullptr, out) that every
//    thread calls once per round and that ends on a CTA barrier;
//  * the owning CTA decides acceptance and hands the accepted row to a
//    commit policy: ResidentCommit (K1, K2) writes it into every CTA's
//    copy of the (W, D+1) state through distributed shared memory,
//    GlobalCommit (K5a, K5c) into the rank's state in device memory;
//  * accepted proposals are counted with integer atomics into a counter
//    in rank 0's shared memory, so the count is exact whatever the order;
//  * every half-update ends on cluster.sync() (release / acquire over the
//    cluster), which orders the remote writes before the next half reads
//    them and keeps every CTA resident while a peer still writes into it.
//
// The arithmetic of a proposal and of the acceptance test is the plain
// version's (sampler/stretch.py:half_step), operation for operation, so
// chains do not depend on the cluster size or on which CTA owns a
// proposal.
//
// Also here, because both kernel sources lay out and fill their shared
// memory the same way: the layout the binding sizes (SmemLayout, applied
// by carve) and the proposal-independent per-channel constants
// (chan_consts).

#pragma once

#include <cooperative_groups.h>

#include "step_loop.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGroupWarps = 4;                      // warps per proposal
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kGroups = kThreads / kGroupThreads;   // proposals per round
constexpr int kMaxCluster = 16;                     // non-portable on Hopper

constexpr int kChanConsts = 4;   // per channel: x, J(Tbg), ln(1/sigma^2), beam term
constexpr int kChanRows = 3;     // chans: freq, y, 1/sigma^2
constexpr int kLineRows = 5;     // lines: freq, elower, aij, gup, glow

// Byte offsets of the regions of a launch's dynamic shared memory and
// their total, from the binding (sampler/cluster.py:smem_layout): the T
// regions first, then the int32 ones; a region a launch does not use has
// size 0. `staged`: the tables and per-channel constants are in shared
// memory (chans, cc, vel, lines, line_idx, group), else they are not.
struct SmemLayout {
  int32_t state, chans, cc, vel, lines, tau, part, prop, zz;
  int32_t line_idx, group, flag, acc;
  int32_t bytes, staged;
};

// The regions of a launch's dynamic shared memory, at the layout's
// offsets: [the (W, D+1) state], [the staged tables: chans, per-channel
// constants, entry velocities, lines], each warp group's tau and chi^2
// partials, the cluster kernels' owned proposals and stretch factors;
// [the entry line indices and (K2) groups], flags and counters.
template <typename T>
struct Carve {
  T *state, *chans, *cc, *vel, *lines, *tau, *part, *prop, *zz;
  int *line_idx, *group, *flag, *acc;
};

template <typename T>
__device__ Carve<T> carve(unsigned char* smem, const SmemLayout& L) {
  const auto t = [smem](int32_t off) { return reinterpret_cast<T*>(smem + off); };
  const auto i = [smem](int32_t off) { return reinterpret_cast<int*>(smem + off); };
  return {t(L.state), t(L.chans), t(L.cc),       t(L.vel),   t(L.lines), t(L.tau), t(L.part),
          t(L.prop),  t(L.zz),    i(L.line_idx), i(L.group), i(L.flag),  i(L.acc)};
}

// threads a CTA, warp groups a CTA, chi^2 partials a group (one a warp
// unless the library's lnprob sums more lanes than a group has threads),
// per-channel constants, sizeof(SmemLayout): what sampler/cluster.py sizes
// the regions by, checked by the binding when a library loads.
inline void layout_geometry(int* out, int partials = kGroupWarps) {
  out[0] = kThreads;
  out[1] = kGroups;
  out[2] = partials;
  out[3] = kChanConsts;
  out[4] = (int)sizeof(SmemLayout);
}

// The proposal-independent constants of one channel (frequency gf in MHz,
// isig = 1 / sigma^2): x = h nu / k, J(Tbg) (planck_J), ln(1 / sigma^2)
// and the beam's square (beam_dilution's wl and beam, squared with one
// rounding as the plain version squares it). `st` is any statics struct
// with dish_size and Tbg. A staged launch computes them once into shared
// memory, an unstaged one in the channel loop: one function, so the same
// bits either way.
template <typename T>
struct ChanConsts {
  T x, jbg, lnisig, b2;
};

template <typename T, typename S>
__device__ __forceinline__ ChanConsts<T> chan_consts(const S& st, T gf, T isig) {
  const T wl = T(2.998e8) / (gf * T(1e6));
  const T beam = wl * T(206265.0) * T(1.22) / st.dish_size;
  return {T(6.626e-34) * gf * T(1e6) / T(1.381e-23), planck_J(gf, st.Tbg), lg(isig),
          mul_rn(beam, beam)};
}

// The beam dilution ss^2 / (beam^2 + ss^2) from the beam's square and
// ss2 = mul_rn(ss, ss), the denominator rounded once.
template <typename T>
__device__ __forceinline__ T dilution(T b2, T ss2) {
  return ss2 / add_rn(b2, ss2);
}

struct Slice {
  int first, count;
};

// Proposals [first, first + count) of h owned by CTA `rank` of n.
__device__ __forceinline__ Slice owned_slice(int rank, int n, int h) {
  const int first = (int)((long long)rank * h / n);
  return {first, (int)((long long)(rank + 1) * h / n) - first};
}

// K1, K2: the state lives in every CTA's shared memory. The accepted rows go
// into every copy; each walker's row of the step goes to the chain output
// from the half-update in which it was active (each walker is active in
// exactly one half of a step).
template <typename T>
struct ResidentCommit {
  T* state;       // this CTA's copy, (W, D+1)
  T* out_chain;   // this step's (W, D)
  T* out_lnps;    // this step's (W,)
  int D;
  __device__ void row(int32_t w, bool accept, const T* prop_row, const T* state_row) const {
    const T* src = accept ? prop_row : state_row;
    for (int d = 0; d < D; ++d) out_chain[(size_t)w * D + d] = src[d];
    out_lnps[w] = src[D];
  }
  __device__ void broadcast(const int* flag, const T* prop, const int32_t* act, int p) const {
    cg::cluster_group cluster = cg::this_cluster();
    const int n = (int)cluster.num_blocks(), D1 = D + 1, per = n * D1;
    for (int i = threadIdx.x; i < p * per; i += kThreads) {
      const int jl = i / per;
      if (!flag[jl]) continue;
      const int rem = i - jl * per, r = rem / D1, d = rem - r * D1;
      cluster.map_shared_rank(state, r)[act[jl] * D1 + d] = prop[jl * D1 + d];
    }
  }
};

// K5a, K5c: the rank's state stays in device memory; only the owner of a row
// reads or writes it during the half-update.
template <typename T>
struct GlobalCommit {
  T* state;       // (W, D+1) in device memory
  int D;
  __device__ void row(int32_t w, bool accept, const T* prop_row, const T*) const {
    if (accept)
      for (int d = 0; d <= D; ++d) state[(size_t)w * (D + 1) + d] = prop_row[d];
  }
  __device__ void broadcast(const int*, const T*, const int32_t*, int) const {}
};

// One half-update of an ensemble spread over the cluster: the h walkers
// `act` of `state` (W, D+1) against the partners comp(pair[j]) (see
// StateComplement / GatheredComplement), around a CTA-cooperative
// lnprob. Shared scratch of the CTA's owned slice: `prop` (P, D+1), `zz`
// (P,), `flag` (P,), P = ceil(h / n); `acc_count` (in rank 0's shared
// memory) gains the accepted proposals. Ends on cluster.sync().
template <typename T, typename Comp, typename LnProb, typename Commit>
__device__ void cluster_half_update(const T* state, int D, int h, const int32_t* act,
                                    const Comp& comp, const T* zu, const int32_t* pair,
                                    const T* au, T a, T* prop, T* zz, int* flag,
                                    int* acc_count, const LnProb& lnprob,
                                    const Commit& commit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, D1 = D + 1;
  const Slice own = owned_slice((int)cluster.block_rank(), (int)cluster.num_blocks(), h);
  act += own.first;
  zu += own.first;
  pair += own.first;
  au += own.first;
  // Phase 1: the owned proposals Y = c + z (s - c), from this CTA's copy.
  for (int jl = tid; jl < own.count; jl += kThreads) {
    const T* s = state + act[jl] * D1;
    const T* c = comp(pair[jl]);
    const T z = stretch_z(zu[jl], a);
    zz[jl] = z;
    for (int d = 0; d < D; ++d)
      prop[jl * D1 + d] = fma_rn(z, sub_rn(s[d], c[d]), c[d]);
  }
  __syncthreads();
  // Phase 2: kGroups proposals a round, a warp group each.
  const int grp = tid / kGroupThreads;
  for (int base = 0; base < own.count; base += kGroups) {
    const int jl = base + grp;
    T* th = jl < own.count ? prop + jl * D1 : nullptr;
    lnprob(th, th != nullptr ? th + D : nullptr);
  }
  // Phase 3: the owner accepts and commits.
  for (int jl = tid; jl < own.count; jl += kThreads) {
    const int32_t w = act[jl];
    const T lnp_new = prop[jl * D1 + D], lnp_s = state[w * D1 + D];
    const T diff = sub_rn(add_rn(mul_rn(T(D - 1), lg(zz[jl])), lnp_new), lnp_s);
    const bool accept = lg(au[jl]) < diff;
    flag[jl] = accept;
    if (accept) atomicAdd(acc_count, 1);
    commit.row(w, accept, prop + jl * D1, state + w * D1);
  }
  __syncthreads();
  commit.broadcast(flag, prop, act, own.count);
  cluster.sync();
}

// The offsets of chain blockIdx.y in a step launch's (K, ...) arrays:
// walkers (K, W, D) and lnp (K, W); permutations (K, k W) and uniforms /
// partners (K, 2k, W / 2), k W each; outputs chain (K, k W, D), lnps
// (K, k W) and acceptances (K, k). The tables and statics are every
// chain's.
struct ChainOffsets {
  size_t walkers, lnp, steps, chain, acc;
};

__device__ __forceinline__ ChainOffsets chain_offsets(int W, int D, int k) {
  const size_t c = blockIdx.y, kW = (size_t)k * W;
  return {c * W * D, c * W, c * kW, c * kW * D, c * k};
}

// The launch configuration of `chains` clusters of n CTAs of kThreads
// threads (grid (n, chains), clusters (n, 1)) with `smem` bytes of
// dynamic shared memory each; sets the kernel's attributes for it (sizes
// above 8 are non-portable). `attr` backs cfg.attrs. Returns a CUDA error
// code.
template <typename Kernel>
int cluster_config(Kernel kernel, int n, int chains, size_t smem, void* stream,
                   cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  if (n < 1 || n > kMaxCluster || chains < 1 || chains > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && n > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n, chains, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return (int)cudaSuccess;
}

// How many clusters of n CTAs of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: the card cannot run that size).
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int n, size_t smem, int* out_clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int err = cluster_config(kernel, n, 1, smem, nullptr, &attr, &cfg);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaOccupancyMaxActiveClusters(out_clusters, kernel, &cfg);
}

// Launch `kernel` as `chains` clusters of n CTAs. Returns a CUDA error
// code, cudaGetLastError() after the launch.
template <typename Kernel, typename... Args>
int cluster_launch(Kernel kernel, int n, int chains, size_t smem, void* stream,
                   Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int err = cluster_config(kernel, n, chains, smem, stream, &attr, &cfg);
  if (err != (int)cudaSuccess) return err;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace
