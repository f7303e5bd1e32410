// Fused Goodman–Weare stretch half-step for a dense Gaussian target.
//
// Replaces the TPU kernel mcmcpp_tpu/ops/pallas_stretch.py::fused_stretch_half
// (its body `_kernel`): for every active walker i it reads the partner
// other[(i + shift) % n], forms z = ((sqrt(a) - 1/sqrt(a))·u + 1/sqrt(a))^2 and
// the proposal Y = partner + z·(X − partner), evaluates
// lp_new = −0.5·‖Y @ L‖² with the precision Cholesky L (P×P, row-major), and
// accepts iff log(ue) < (P−1)·log z + lp_new − lp_old. It writes the selected
// row, its logp and an int32 accept flag.
//
// What bounds it: at P = 10 one walker half-update moves about 140 B of device
// memory (X, partner and the output row at 40 B each, plus lp_old, u, ue,
// out_lp and out_acc at 4 B each) against about 200 FLOPs for the 10×10
// product, so the kernel is memory-bound on an H100. The design keeps every
// intermediate (partner row, proposal, y = Y @ L) in registers and L in shared
// memory, so each walker's bytes cross device memory once.
//
// What this simple design leaves for later: one thread owns one row, so
// neighbouring threads read rows 4·P bytes apart (40 B at P = 10) and the loads
// are not coalesced; a transposed (P, n) layout or a cooperative row load would
// fix that. The uniforms u and ue are drawn by the caller (a Philox generator
// inside the kernel would save their 8 B per walker), and P is capped at 64 so
// that L fits in 16 KB of static shared memory.
//
// The partner index, z and the accept rule are the device functions of
// stretch_common.cuh, shared with the split kernels (stretch_split.cu); the
// header also says why the build keeps IEEE logf/sqrtf (no fast math).

#include "stretch_common.cuh"

namespace {

constexpr int kThreads = 256;

// PMAX is a compile-time bound on P: the per-row arrays are unrolled over PMAX
// with `k < P` guards, so they stay in registers for any P <= PMAX.
template <int PMAX>
__global__ void __launch_bounds__(kThreads) fused_stretch_half_kernel(
    const float* __restrict__ act, const float* __restrict__ lp_old,
    const float* __restrict__ other, const int* __restrict__ shift,
    const float* __restrict__ u, const float* __restrict__ ue,
    const float* __restrict__ prec_chol, float* __restrict__ out_act,
    float* __restrict__ out_lp, int* __restrict__ out_acc, int n, int P,
    float a) {
  __shared__ float sL[PMAX * PMAX];
  for (int t = threadIdx.x; t < P * P; t += blockDim.x) {
    sL[(t / P) * PMAX + (t % P)] = prec_chol[t];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const long long j = mcmcpp::partner_row(i, *shift, n);
  const float* x = act + (size_t)i * P;
  const float* xp = other + (size_t)j * P;
  const float z = mcmcpp::stretch_z(u[i], a);

  float y[PMAX];
#pragma unroll
  for (int k = 0; k < PMAX; ++k) {
    if (k < P) {
      // contracted to an FMA, unlike the split kernels' stretch_point: this
      // kernel's logp is its own, so no torch op has to see the same Y bit
      // for bit, and the FMA keeps the kernel as fast as it was
      const float p = xp[k];
      y[k] = p + z * (x[k] - p);
    }
  }
  float q = 0.0f;
#pragma unroll
  for (int c = 0; c < PMAX; ++c) {
    if (c < P) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < PMAX; ++k) {
        if (k < P) s += y[k] * sL[k * PMAX + c];
      }
      q += s * s;
    }
  }
  const float lp_new = -0.5f * q;
  const float lo = lp_old[i];
  const bool accept =
      mcmcpp::stretch_accepts(ue[i], (float)(P - 1) * logf(z), lp_new, lo);

  float* xo = out_act + (size_t)i * P;
#pragma unroll
  for (int k = 0; k < PMAX; ++k) {
    if (k < P) xo[k] = accept ? y[k] : x[k];
  }
  out_lp[i] = accept ? lp_new : lo;
  out_acc[i] = accept ? 1 : 0;
}

template <int PMAX>
void launch(const float* act, const float* lp_old, const float* other,
            const int* shift, const float* u, const float* ue,
            const float* prec_chol, float* out_act, float* out_lp,
            int* out_acc, int n, int P, float a, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_stretch_half_kernel<PMAX><<<blocks, kThreads, 0, stream>>>(
      act, lp_old, other, shift, u, ue, prec_chol, out_act, out_lp, out_acc,
      n, P, a);
}

}  // namespace

// One fused stretch half-step over n active walkers of dimension P (n == m).
// All pointers are device pointers; `shift` points at one int32 in [0, n).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mcmcpp_fused_stretch_half_f32(
    const float* act, const float* lp_old, const float* other,
    const int* shift, const float* u, const float* ue, const float* prec_chol,
    float* out_act, float* out_lp, int* out_acc, int n, int P, float a,
    void* stream) {
  if (n <= 0 || P <= 0 || P > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 8) {
    launch<8>(act, lp_old, other, shift, u, ue, prec_chol, out_act, out_lp,
              out_acc, n, P, a, s);
  } else if (P <= 16) {
    launch<16>(act, lp_old, other, shift, u, ue, prec_chol, out_act, out_lp,
               out_acc, n, P, a, s);
  } else if (P <= 32) {
    launch<32>(act, lp_old, other, shift, u, ue, prec_chol, out_act, out_lp,
               out_acc, n, P, a, s);
  } else {
    launch<64>(act, lp_old, other, shift, u, ue, prec_chol, out_act, out_lp,
               out_acc, n, P, a, s);
  }
  return (int)cudaGetLastError();
}
