// Statics of the single-component kernels, K1 (fused_step.cu) and K3
// (gather_step.cu): the struct the binding packs (sampler/fused.py:
// _statics_type), the theta unpack and the box + Gaussian prior. Port of
// cha1_mcmc_tpu/sampler/fused.py: _unpack_single (:96) and _prior_box
// (:133).

#pragma once

#include "step_loop.cuh"

namespace {

constexpr int kMaxDim = 5;
constexpr int kMaxPoly = 8;
constexpr int kMaxCheb = 65;

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

// theta -> (ss, Ncol, Tex, vlsr, dV): 5-dim free source size, or 4-dim
// with the fixed st.ss.
template <typename T>
__device__ __forceinline__ void unpack_single(const T* th, const Statics<T>& st,
                                              T& ss_w, T& Ncol, T& Tex, T& vlsr,
                                              T& dV) {
  if (st.free_ss) {
    ss_w = th[0]; Ncol = th[1]; Tex = th[2]; vlsr = th[3]; dV = th[4];
  } else {
    ss_w = st.ss; Ncol = th[0]; Tex = th[1]; vlsr = th[2]; dV = th[3];
  }
}

// Box bounds (returned) + Gaussian priors with Ncol flat (into lp).
template <typename T>
__device__ __forceinline__ bool single_prior(const T* th, const Statics<T>& st, T& lp) {
  bool ok = true;
  lp = T(0);
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
  return ok;
}

}  // namespace
