// Stretch half-step for any torch logp: the propose and accept kernels of the
// split path.
//
// Replaces mcmcpp_tpu/ops/pallas_stretch.py::fused_stretch_half (its body
// `_kernel`) for a logp that is not a GaussianTarget. The Pallas kernel traced
// the user's logp into its own body; a torch logp cannot run inside a CUDA C++
// kernel, so the half-step is cut around it:
//
//   stretch_propose: Y = partner + z·(X − partner) and (P−1)·log z,
//   the user's logp on Y, as torch ops on the same stream,
//   stretch_accept:  log(ue) < (P−1)·log z + lp_new − lp_old, then select.
//
// The partner index, z and the accept rule are the device functions of
// stretch_common.cuh, the same code the fused kernel runs.
//
// What bounds them: both are elementwise over the (n, P) rows and memory-bound.
// At P = 10 the propose kernel moves about 128 B per walker (X, the partner row
// and Y at 40 B, u and the log factor at 4 B) and the accept kernel about
// 144 B (X, Y and the output row, and five 4-B planes), against a handful of
// FLOPs. So one thread owns one element, not one row: neighbouring threads
// read neighbouring addresses of X, Y and the output, and the partner rows of
// one shift are a contiguous run of `other`, so every load and store is
// coalesced. The per-row values (z, the accept decision) are recomputed by
// each of the row's P threads from the same inputs, which costs a few FLOPs
// and no traffic (the row's threads share the cache lines of u, ue and the
// logps), and are written once, by the row's first thread.
//
// What this design leaves for later: the proposal and the log factor go
// through device memory between the two kernels (the price of running the
// logp as torch ops), and u and ue are drawn by the caller.

#include "stretch_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stretch_propose_kernel(
    const float* __restrict__ act, const float* __restrict__ other,
    const int* __restrict__ shift, const float* __restrict__ u,
    float* __restrict__ out_y, float* __restrict__ out_factor, long long n,
    int P, float a) {
  const long long total = n * P;
  const int s = *shift;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / P;
    const int k = (int)(e - i * P);
    const long long j = mcmcpp::partner_row(i, s, n);
    const float z = mcmcpp::stretch_z(u[i], a);
    out_y[e] = mcmcpp::stretch_point(other[j * P + k], act[e], z);
    if (k == 0) out_factor[i] = (float)(P - 1) * logf(z);
  }
}

__global__ void __launch_bounds__(kThreads) stretch_accept_kernel(
    const float* __restrict__ act, const float* __restrict__ y,
    const float* __restrict__ lp_old, const float* __restrict__ lp_new,
    const float* __restrict__ factor, const float* __restrict__ ue,
    float* __restrict__ out_act, float* __restrict__ out_lp,
    int* __restrict__ out_acc, long long n, int P) {
  const long long total = n * P;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / P;
    const int k = (int)(e - i * P);
    const float lo = lp_old[i];
    const float ln = lp_new[i];
    const bool accept = mcmcpp::stretch_accepts(ue[i], factor[i], ln, lo);
    out_act[e] = accept ? y[e] : act[e];
    if (k == 0) {
      out_lp[i] = accept ? ln : lo;
      out_acc[i] = accept ? 1 : 0;
    }
  }
}

// enough blocks to cover every element once, capped well inside gridDim.x;
// the grid-stride loops cover the rest
unsigned int blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return (unsigned int)(b < (1LL << 30) ? b : (1LL << 30));
}

}  // namespace

// Proposal Y (n, P) and log factor (P−1)·log z (n,) of a stretch half-step
// with partner other[(i + *shift) % n]. Device pointers; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mcmcpp_stretch_propose_f32(const float* act, const float* other,
                                          const int* shift, const float* u,
                                          float* out_y, float* out_factor,
                                          long long n, int P, float a,
                                          void* stream) {
  if (n <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  stretch_propose_kernel<<<blocks_for(n * P), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      act, other, shift, u, out_y, out_factor, n, P, a);
  return (int)cudaGetLastError();
}

// Accept and select of a stretch half-step: the row, its logp and an int32
// flag, from X, Y, lp_old, lp_new, the log factor and ue. Device pointers;
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int mcmcpp_stretch_accept_f32(const float* act, const float* y,
                                         const float* lp_old,
                                         const float* lp_new,
                                         const float* factor, const float* ue,
                                         float* out_act, float* out_lp,
                                         int* out_acc, long long n, int P,
                                         void* stream) {
  if (n <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  stretch_accept_kernel<<<blocks_for(n * P), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      act, y, lp_old, lp_new, factor, ue, out_act, out_lp, out_acc, n, P);
  return (int)cudaGetLastError();
}
