// Device code of the port's cluster step kernels — K1 and its sharded
// half-step K5a (fused_step.cu), K2 and its sharded half-step K5c
// (multi_step.cu). A K1 or K2 step launch runs K independent ensembles on
// one of two paths, which the binding chooses (sampler/cluster.py:
// steps_plan) and the kernels only follow:
//
//  * the cluster path (cluster_steps): one thread-block cluster of up to
//    16 CTAs a chain, grid (n, K) with clusters of (n, 1), each cluster
//    reading its chain from blockIdx.y (chain_offsets). No barrier crosses
//    clusters, so K may exceed the clusters the card holds at once; the
//    rest run in later waves. K5a and K5c launch one cluster (K = 1);
//  * the wide path (wide_steps): h = W / 2 CTAs a chain in one cooperative
//    launch of grid (h, K), CTA j owning proposal j of every half-update
//    with all its warps, the state in device memory, one grid.sync() a
//    half-update. Only where the K h CTAs fit the card at once.
//
// On the cluster path:
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
// Both families' lnprobs are one function over kLanes = 512 lanes: lane v
// sums the channels v, v + 512, ... in order, each warp of lanes is
// reduced by warp_sum and the kLaneWarps warp sums added in order. A wide
// CTA runs it a lane a thread, a 4-warp group four lanes a thread (four
// independent sums): the same bits, so a theta's lnprob is the same on
// either path, in the lnprob entry and in the sharded half-step.
//
// The arithmetic of a proposal and of the acceptance test is the plain
// version's (sampler/stretch.py:half_step), operation for operation, so
// chains do not depend on the path, the cluster size or on which CTA owns
// a proposal.
//
// Also here, because both kernel sources lay out and fill their shared
// memory the same way: the layout the binding sizes (SmemLayout, applied
// by carve) and the proposal-independent per-channel constants
// (chan_consts); and the host side of both paths' launches
// (cluster_launch, wide_launch and their occupancy queries).

#pragma once

#include <cooperative_groups.h>

#include "step_loop.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kGroupWarps = 4;                      // warps per proposal
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kGroups = kThreads / kGroupThreads;   // proposals per round
constexpr int kMaxCluster = 16;                     // non-portable on Hopper

// The lanes of a family's lnprob: a theta's channels c = v, v + kLanes, ...
// are summed by lane v in channel order, each 32 lanes' sums are reduced
// by warp_sum's tree, and the kLaneWarps warp sums are added in order. A
// group of n threads runs kLanes / n lanes a thread (thread t: lanes t,
// t + n, ...), each with its own sum, so any n computes the same bits.
constexpr int kLanes = kThreads;
constexpr int kLaneWarps = kLanes / 32;

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

// threads a CTA, warp groups a CTA, chi^2 partials a group (one a warp of
// lanes), per-channel constants, sizeof(SmemLayout): what
// sampler/cluster.py sizes the regions by, checked by the binding when a
// library loads.
inline void layout_geometry(int* out) {
  out[0] = kThreads;
  out[1] = kGroups;
  out[2] = kLaneWarps;
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

// The cluster path's k steps of chain blockIdx.y (pointers already at the
// chain: chain_offsets) on this cluster: every CTA copies the chain's
// (W, D) walkers and their lnp into its (W, D+1) state (`s.state`), then
// each step's two half-updates (cluster_half_update, ResidentCommit); the
// accepted counts go through rank 0's two counters, one per step parity,
// into out_acc. `lnprob` is the family's functor in groups of kGroupWarps
// warps, its tables already staged (the barrier here publishes them).
template <typename T, typename LnProb>
__device__ void cluster_steps(const T* coords, const T* lnp0, const int32_t* perm, const T* zu,
                              const int32_t* pair, const T* au, T a, T* out_chain,
                              T* out_lnps, float* out_acc, int W, int D, int k,
                              const Carve<T>& s, const LnProb& lnprob) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, h = W / 2, D1 = D + 1;
  const int rank = (int)cluster.block_rank();
  for (int i = tid; i < W * D; i += kThreads) s.state[(i / D) * D1 + i % D] = coords[i];
  for (int w = tid; w < W; w += kThreads) s.state[w * D1 + D] = lnp0[w];
  if (tid < 2) s.acc[tid] = 0;
  cluster.sync();  // every CTA resident and initialised before remote access
  int* acc0 = cluster.map_shared_rank(s.acc, 0);
  for (int step = 0; step < k; ++step) {
    const int32_t* pm = perm + (size_t)step * W;
    const ResidentCommit<T> commit{s.state, out_chain + (size_t)step * W * D,
                                   out_lnps + (size_t)step * W, D};
    for (int half = 0; half < 2; ++half) {
      const int r = 2 * step + half;
      const StateComplement<T> comp{s.state, pm + (1 - half) * h, D1};
      cluster_half_update<T>(s.state, D, h, pm + half * h, comp, zu + r * h, pair + r * h,
                             au + r * h, a, s.prop, s.zz, s.flag, acc0 + (step & 1), lnprob,
                             commit);
    }
    // Every add of this step precedes the cluster.sync() just passed; the
    // slot is next added to two steps on, after rank 0 has reset it.
    if (rank == 0 && tid == 0) {
      out_acc[step] = (float)s.acc[step & 1];
      s.acc[step & 1] = 0;
    }
  }
}

// Half-updates whose proposal indices and draws a wide CTA holds at once.
constexpr int kWideHalves = 32;

// The wide path's k steps of chain blockIdx.y (pointers already at the
// chain) on gridDim.x = h CTAs, CTA j owning proposal j of every
// half-update, all its warps on it (`lnprob`: the family's functor in one
// group of kThreads threads, its tables already staged). The state is
// never copied whole: before step s walker w's row is row w of step
// s - 1's chain output (of coords at s = 0), and after the half in which w
// is active, row w of step s's. So a CTA reads only its walker's row, its
// lnp and its partner's row (L2 loads: rows other CTAs wrote in this
// launch), writes its walker's row of the step, and one grid barrier a
// half-update orders those writes before the next half reads them; the
// walker, partner and draws of its next kWideHalves halves are read into
// shared memory ahead, so that after a barrier only the rows are waited
// for. `prop` (D+1) holds Y and, at [D], its lnprob. The accepted counts
// are float adds of whole numbers (exact in any order) into out_acc, which
// CTA 0 zeroes before the first barrier; each CTA adds its step's count
// after that barrier.
template <typename T, typename LnProb>
__device__ void wide_steps(const T* coords, const T* lnp0, const int32_t* perm, const T* zu,
                           const int32_t* pair, const T* au, T a, T* out_chain, T* out_lnps,
                           float* out_acc, int W, int D, int k, T* prop,
                           const LnProb& lnprob) {
  __shared__ int32_t s_walker[kWideHalves], s_partner[kWideHalves];
  __shared__ T s_z[kWideHalves], s_dz[kWideHalves], s_lu[kWideHalves];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, j = blockIdx.x, h = W / 2;
  if (j == 0)
    for (int i = tid; i < k; i += kThreads) out_acc[i] = 0.f;
  int accepted = 0;   // this CTA's accepted proposals of the step (thread D)
  for (int r = 0; r < 2 * k; ++r) {
    const int step = r >> 1, half = r & 1, slot = r % kWideHalves;
    if (slot == 0) {
      // this CTA's walker, partner, z, (D - 1) ln z and ln u of the next halves
      if (r > 0) __syncthreads();
      const int t = r + tid;
      if (tid < kWideHalves && t < 2 * k) {
        const int32_t* pm = perm + (size_t)(t >> 1) * W;
        const int hf = t & 1;
        const T z = stretch_z(zu[(size_t)t * h + j], a);
        s_walker[tid] = pm[hf * h + j];
        s_partner[tid] = pm[(1 - hf) * h + pair[(size_t)t * h + j]];
        s_z[tid] = z;
        s_dz[tid] = mul_rn(T(D - 1), lg(z));
        s_lu[tid] = lg(au[(size_t)t * h + j]);
      }
      __syncthreads();
    }
    const T* prev = step == 0 ? coords : out_chain + (size_t)(step - 1) * W * D;
    const T* prev_lnp = step == 0 ? lnp0 : out_lnps + (size_t)(step - 1) * W;
    T* cur = out_chain + (size_t)step * W * D;
    const int32_t w = s_walker[slot];
    // the partner: of the other half, as it stands after the last half
    const T* crow = (half == 0 ? prev : cur) + (size_t)s_partner[slot] * D;
    T sd = T(0), lnp_s = T(0);
    if (tid <= D) {
      lnp_s = __ldcg(prev_lnp + w);
      if (tid < D) {
        sd = __ldcg(prev + (size_t)w * D + tid);
        const T cd = __ldcg(crow + tid);
        prop[tid] = fma_rn(s_z[slot], sub_rn(sd, cd), cd);
      }
    }
    __syncthreads();
    lnprob(prop, prop + D);
    // every thread of the row decides alike: the plain version's test
    if (tid <= D) {
      const T lnp_new = prop[D];
      const bool accept = s_lu[slot] < sub_rn(add_rn(s_dz[slot], lnp_new), lnp_s);
      if (tid < D) {
        cur[(size_t)w * D + tid] = accept ? prop[tid] : sd;
      } else {
        out_lnps[(size_t)step * W + w] = accept ? lnp_new : lnp_s;
        accepted += accept;
        if (half == 1) {   // past the first barrier, so after the zeroing
          if (accepted) atomicAdd(out_acc + step, (float)accepted);
          accepted = 0;
        }
      }
    }
    if (r + 1 < 2 * k) grid.sync();
  }
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

// The wide path's launch: one cooperative launch of `kernel` over grid
// (W / 2, chains) of kThreads threads with `smem` bytes of dynamic shared
// memory each; every CTA resident at once, or the card refuses the launch
// (cudaErrorCooperativeLaunchTooLarge) and nothing runs. The parameter
// types are deduced from the kernel alone (Same keeps the arguments out of
// the deduction), so each argument is converted to its parameter's exact
// type, which is what the launch reads through `ptrs`. Returns a CUDA error
// code, cudaGetLastError() after the launch.
template <typename X>
struct Same {
  using type = X;
};

template <typename... Params>
int wide_launch(void (*kernel)(Params...), int W, int k, int chains, size_t smem,
                void* stream, typename Same<Params>::type... args) {
  if (W < 2 || W % 2 || k < 1 || chains < 1 || chains > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* ptrs[] = {static_cast<void*>(&args)...};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(W / 2, chains, 1),
                                    dim3(kThreads, 1, 1), ptrs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();   // a refused launch leaves no error for the next one
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// The CTAs of the wide kernel `kernel` with `smem` bytes of dynamic shared
// memory that the card keeps resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs; 0 where the card
// has no cooperative launch): the wide path runs K chains of h CTAs where
// K h is at most this.
template <typename Kernel>
int wide_occupancy(Kernel kernel, size_t smem, int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  *out = coop ? per_sm * sms : 0;
  return (int)cudaSuccess;
}

}  // namespace
