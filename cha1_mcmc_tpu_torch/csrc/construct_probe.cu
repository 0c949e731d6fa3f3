// T3 — a probe of the device constructs the port's kernels rely on,
// hand-written for Hopper (sm_90a). Built at first use by
// cha1_mcmc_tpu_torch/utils/cuda_build.py and bound through ctypes by
// cha1_mcmc_tpu_torch/utils/construct_probe.py, whose plain PyTorch
// version (probes_plain) computes the same values in the same order and
// is the probe's oracle.
//
// Replaces: the Pallas TPU probe tools/mosaic_construct_probe.py (main
// :52), which compiles the dense gather kernel's suspect constructs one
// at a time as tiny programs. Here each probe is one CTA of one launch
// (blockIdx.x picks the probe), one thread per column of the (rows, 128)
// float32 inputs, at the TPU probe's shapes:
//   A  a runtime loop accumulating 8-row bands of x (48, 128);
//   B  the same with the band offset asserted a multiple of 8;
//   D  the same loop fully unrolled (the control);
//   C  a runtime loop over bands at stride 56 of x (336, 128), each band's
//      first 50 rows read as 5 planes of 10 rows and summed plane by
//      plane (the gather kernel's 5*M line-constant planes);
//   E  the same unrolled (the control);
//   F  a shared-memory scratch written in 8-row chunks (2 x) and read
//      back after a barrier (the scratch store / reload of the gather
//      tables' chunked lnprob);
//   G  the band loop fed through exp2 / where, the windowed-Gaussian
//      chain of every lnprob.
// Sums run in band order (then plane order), as the plain version's.
//
// What bounds it: nothing measurable; it moves ~0.3 MB and does ~10^4
// operations. Its time is one launch.
//
// C entries: t3_probes (returns cudaGetLastError() after the launch) and
// t3_error_string.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 128;
constexpr int kBands = 6, kRows = 8;        // A, B, D, G: x (48, 128)
constexpr int kPlane = 10, kStride = 56;    // C, E: x (336, 128)
constexpr int kScratch = 32;                // F: x (32, 128)

struct Outputs {
  float *a, *b, *c, *d, *e, *f, *g;         // (8|10|32, 128) each
};

__device__ void band_sum(const float* x, float* out, int c, bool aligned_hint) {
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < kBands; ++i) {
    const int r0 = i * kRows;
    if (aligned_hint) __builtin_assume(r0 % 8 == 0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = acc[r] + x[(r0 + r) * kCols + c];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * kCols + c] = acc[r];
}

// One band's 5 planes of 10 rows, each row summed plane by plane from 0,
// added to acc.
__device__ __forceinline__ void add_planes(const float* band, float* acc, int c) {
#pragma unroll
  for (int r = 0; r < kPlane; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) s = s + band[(j * kPlane + r) * kCols + c];
    acc[r] = acc[r] + s;
  }
}

__device__ void plane_sum(const float* x, float* out, int c, bool unroll) {
  float acc[kPlane];
#pragma unroll
  for (int r = 0; r < kPlane; ++r) acc[r] = 0.0f;
  if (unroll) {
#pragma unroll
    for (int i = 0; i < kBands; ++i) add_planes(x + i * kStride * kCols, acc, c);
  } else {
#pragma unroll 1
    for (int i = 0; i < kBands; ++i) add_planes(x + i * kStride * kCols, acc, c);
  }
#pragma unroll
  for (int r = 0; r < kPlane; ++r) out[r * kCols + c] = acc[r];
}

__global__ void __launch_bounds__(kCols)
probe_kernel(const float* __restrict__ xa, const float* __restrict__ xc,
             const float* __restrict__ xf, Outputs o) {
  __shared__ float scratch[kScratch * kCols];
  const int c = threadIdx.x;
  switch (blockIdx.x) {
    case 0: band_sum(xa, o.a, c, false); break;
    case 1: band_sum(xa, o.b, c, true); break;
    case 2: plane_sum(xc, o.c, c, false); break;
    case 3: {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < kBands; ++i)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = acc[r] + xa[(i * kRows + r) * kCols + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) o.d[r * kCols + c] = acc[r];
      break;
    }
    case 4: plane_sum(xc, o.e, c, true); break;
    case 5: {
      for (int w0 = 0; w0 < kScratch; w0 += 8)
        for (int r = w0; r < w0 + 8; ++r) scratch[r * kCols + c] = xf[r * kCols + c] * 2.0f;
      __syncthreads();   // the whole CTA takes this case: blockIdx.x is uniform
      for (int r = 0; r < kScratch; ++r) o.f[r * kCols + c] = scratch[r * kCols + c];
      break;
    }
    case 6: {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 1
      for (int i = 0; i < kBands; ++i) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float v = xa[(i * kRows + r) * kCols + c];
          acc[r] = acc[r] + (v > 0.0f ? exp2f(-v * v) : 0.0f);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) o.g[r * kCols + c] = acc[r];
      break;
    }
  }
}

}  // namespace

extern "C" {

const char* t3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int t3_probes(const void* xa, const void* xc, const void* xf, void* a, void* b, void* c,
              void* d, void* e, void* f, void* g, void* stream) {
  const Outputs o{static_cast<float*>(a), static_cast<float*>(b), static_cast<float*>(c),
                  static_cast<float*>(d), static_cast<float*>(e), static_cast<float*>(f),
                  static_cast<float*>(g)};
  probe_kernel<<<7, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xa), static_cast<const float*>(xc),
      static_cast<const float*>(xf), o);
  return (int)cudaGetLastError();
}

}  // extern "C"
