// Variants of K1's step that time its parts on the card, built and driven
// by scripts/k1_step_split.py (not part of the package; no fit or cell
// runs them). Each reuses the package's own device code (fused_step.cu and
// cluster_step.cuh, included whole), with one part kept and the rest left
// out:
//   * null steps: the step loop of either path (cluster_steps /
//     wide_steps) around an lnprob that costs nothing (NullLnProb: 0 after
//     one CTA barrier): the proposal, the acceptance test, the row
//     broadcast (cluster) or row write (wide) and the half-update's
//     barriers;
//   * lnprob rounds: K1's lnprob alone, `rounds` times on fixed thetas,
//     a proposal to each group (four 4-warp groups a CTA, or one group of
//     16 warps), no barrier between CTAs;
//   * bare barriers: `rounds` cluster.sync() of a cluster of n CTAs, or
//     grid.sync() of a cooperative grid of n CTAs.
// C entries (float32 only; each returns a CUDA error code):
//   split_null_steps_f32, split_lnprob_f32, split_barriers.

#include "fused_step.cu"

namespace {

template <typename T, int kGroupN = kGroupThreads>
struct NullLnProb {
  __device__ void operator()(const T* th, T* out) const {
    if (th != nullptr && threadIdx.x % kGroupN == 0) *out = T(0);
    __syncthreads();
  }
};

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
null_steps_kernel(const T* __restrict__ coords, const T* __restrict__ lnp0,
                  const int32_t* __restrict__ perm, const T* __restrict__ zu,
                  const int32_t* __restrict__ pair, const T* __restrict__ au,
                  T* __restrict__ out_chain, T* __restrict__ out_lnps,
                  float* __restrict__ out_acc, int W, int D, int k, SmemLayout L, T a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Carve<T> s = carve<T>(smem, L);
  if constexpr (kWide)
    wide_steps<T>(coords, lnp0, perm, zu, pair, au, a, out_chain, out_lnps, out_acc, W, D, k,
                  s.prop, NullLnProb<T, kThreads>{});
  else
    cluster_steps<T>(coords, lnp0, perm, zu, pair, au, a, out_chain, out_lnps, out_acc, W, D,
                     k, s, NullLnProb<T>{});
}

template <typename T, int kGroupN>
__global__ void __launch_bounds__(kThreads)
lnprob_rounds_kernel(const T* __restrict__ theta, T* __restrict__ out, K1Tables<T> tb, int D,
                     int rounds, SmemLayout L, __grid_constant__ const Statics<T> st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Carve<T> s = carve<T>(smem, L);
  const K1Tables<T> tables = stage_tables<T, true>(st, tb, s);
  __syncthreads();
  const K1GroupLnProb<T, true, kGroupN> lnprob{st, tables, s.cc, s.tau, s.part};
  const int j = blockIdx.x * (kThreads / kGroupN) + threadIdx.x / kGroupN;
  for (int r = 0; r < rounds; ++r) lnprob(theta + (size_t)j * D, out + j);
}

__global__ void __launch_bounds__(kThreads) cluster_barriers_kernel(int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int r = 0; r < rounds; ++r) cluster.sync();
}

__global__ void __launch_bounds__(kThreads) grid_barriers_kernel(int rounds) {
  cg::grid_group grid = cg::this_grid();
  for (int r = 0; r < rounds; ++r) grid.sync();
}

}  // namespace

extern "C" {

// k null steps of one chain: on the wide path (wide != 0, h CTAs) or on a
// cluster of n CTAs; `layout` is the plan's SmemLayout.
int split_null_steps_f32(const void* coords, const void* lnp0, const void* perm, const void* zu,
                         const void* pair, const void* au, void* out_chain, void* out_lnps,
                         void* out_acc, const void* layout, int W, int D, int k, int n,
                         int wide, float a, void* stream) {
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  const auto* c = static_cast<const float*>(coords);
  const auto* l = static_cast<const float*>(lnp0);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* z = static_cast<const float*>(zu);
  const auto* q = static_cast<const int32_t*>(pair);
  const auto* u = static_cast<const float*>(au);
  auto* oc = static_cast<float*>(out_chain);
  auto* ol = static_cast<float*>(out_lnps);
  auto* oa = static_cast<float*>(out_acc);
  if (wide)
    return wide_launch(null_steps_kernel<float, true>, W, k, 1, (size_t)L.bytes, stream, c, l,
                       p, z, q, u, oc, ol, oa, W, D, k, L, a);
  return cluster_launch(null_steps_kernel<float, false>, n, 1, (size_t)L.bytes, stream, c, l, p,
                        z, q, u, oc, ol, oa, W, D, k, L, a);
}

// `rounds` lnprob evaluations of `ctas` CTAs, each on its groups' thetas
// (wide != 0: one group of 16 warps a CTA; else four of four warps).
int split_lnprob_f32(const void* theta, void* out, const void* lines, const void* vel,
                     const void* line_idx, const void* chans, const void* qst,
                     const void* statics, const void* layout, int ctas, int wide, int D,
                     int La, int M, int C, int S, int rounds, void* stream) {
  const Statics<float> st = *static_cast<const Statics<float>*>(statics);
  const SmemLayout L = *static_cast<const SmemLayout*>(layout);
  const auto kernel = wide ? lnprob_rounds_kernel<float, kThreads>
                           : lnprob_rounds_kernel<float, kGroupThreads>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<float*>(out),
      make_tables<float>(lines, vel, line_idx, chans, qst, La, M, C, S), D, rounds, L, st);
  return (int)cudaGetLastError();
}

// `rounds` bare barriers of n CTAs: cluster.sync() of one cluster
// (grid != 0: grid.sync() of one cooperative grid).
int split_barriers(int n, int grid, int rounds, void* stream) {
  if (grid)
    return wide_launch(grid_barriers_kernel, 2 * n, 1, 1, 0, stream, rounds);
  return cluster_launch(cluster_barriers_kernel, n, 1, 0, stream, rounds);
}

}  // extern "C"
