// Device functions shared by the stretch kernels: the fused half-step
// (fused_stretch.cu) and the split propose/accept pair (stretch_split.cu).
//
// Both replace parts of mcmcpp_tpu/ops/pallas_stretch.py::_kernel: the
// partner of active walker i is other[(i + shift) % n] (the roll of
// mcmcpp_tpu/ops/partner.py), z ~ g(z) comes from a uniform u by the
// inverse CDF of mcmcpp_tpu/ops/gw.py, and the accept rule is
// log(ue) < (P−1)·log z + lp_new − lp_old.
//
// Built without --use_fast_math: IEEE logf/sqrtf keep the −inf and NaN
// semantics the accept rule relies on (lp_old = −inf with a finite lp_new
// accepts; a NaN log ratio rejects, as `log_u < nan` is false).

#pragma once

#include <cuda_runtime.h>

namespace mcmcpp {

// Row of `other` that active walker i pairs with, for a shift in any range.
__device__ __forceinline__ long long partner_row(long long i, int shift,
                                                 long long n) {
  long long j = (i + (long long)shift) % n;
  return j < 0 ? j + n : j;
}

// z and the split path's proposal round after every operation, as the plain
// PyTorch versions' separate elementwise ops do: the _rn intrinsics are never
// contracted into an FMA, so the split kernels' z and Y equal the plain
// versions' bit for bit on the card, and the torch logp evaluated on Y sees
// the same input (a logp whose terms cancel, like Neal's funnel's, would
// otherwise turn one ULP of Y into a large relative error in lp_new).

// z = ((sqrt(a) − 1/sqrt(a))·u + 1/sqrt(a))², z in [1/a, a].
__device__ __forceinline__ float stretch_z(float u, float a) {
  const float sqrt_a = sqrtf(a);
  const float inv_sqrt_a = 1.0f / sqrt_a;
  const float w = __fadd_rn(__fmul_rn(sqrt_a - inv_sqrt_a, u), inv_sqrt_a);
  return __fmul_rn(w, w);
}

// One coordinate of the split path's proposal Y = partner + z·(X − partner).
__device__ __forceinline__ float stretch_point(float partner, float x,
                                               float z) {
  return __fadd_rn(partner, __fmul_rn(z, __fsub_rn(x, partner)));
}

// The Metropolis test of the stretch move; log_factor is (P−1)·log z.
__device__ __forceinline__ bool stretch_accepts(float ue, float log_factor,
                                                float lp_new, float lp_old) {
  return logf(ue) < log_factor + lp_new - lp_old;
}

}  // namespace mcmcpp
