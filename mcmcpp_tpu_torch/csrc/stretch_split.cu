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
// The partner index, z, the uniforms (Philox words of the half-step's key and
// the walker's global index: u is word 0, ue word 1), the row offset (a
// launch covers rows row0…row0+n−1 of a half of m walkers) and the accept
// rule are the device functions of stretch_common.cuh, the same code the
// fused kernel runs.
//
// What bounds them: both are elementwise over the (n, P) rows and
// memory-bound. At P = 10 the propose kernel moves 124 B per walker (X, the
// partner row and Y at 40 B, the log factor at 4 B: 130.0 MB, 0.0388 ms at
// n = 2^20 on an H100's 3.35 TB/s) and the accept kernel 140 B (X, Y and the
// output row, and five 4-B planes: 146.8 MB, 0.0438 ms), against a handful
// of FLOPs.
//
// stretch_propose, what the design does about it. Its first form gave one
// thread one element: coalesced, but every element paid a 64-bit division
// and a modulo by P, a sqrt, a division and the whole of z again, and it was
// bound by instructions at 44% of the memory rate. Now a block owns a tile
// of consecutive rows (about 2560 elements, at most 256 rows). One thread a
// row computes the row's z once (Philox, sqrt, the division) into shared
// memory and writes the log factor, coalesced; then the block streams the
// tile's elements with tile-local 32-bit indices kept by additions
// (TileWalk), so an element costs a compare, three roundings and its loads.
// X, Y and, with the roll, the partner rows are contiguous runs (the partner
// run wraps at n with a compare and a subtract; the one modulo is per tile).
// For even P every row starts 8-B aligned, so a thread moves a float2;
// odd P, or a base pointer off 8 B, takes the 4-B path (decided per launch;
// a build forced to 4 B measured 0.0495 ms against 0.0482 ms, and the first
// design 0.0895 ms, at n = 2^20, P = 10 on an H100 at 700 W). The arithmetic is unchanged and stays bit for bit the plain
// version's.
//
// stretch_accept keeps its first design, one thread an element, the row's
// decision recomputed by each of the row's P threads from the same cached
// planes and written once by the row's first thread; only ue now comes from
// the key, by the device function, where it was loaded. Philox's ten rounds
// per element cost it nothing measurable (0.0798 ms against 0.0800 ms with
// the loaded plane, n = 2^20, P = 10, H100 at 700 W): the 64-bit division
// by P per element is what holds it at 55% of its bound. The propose
// kernel's tile walk with the decision taken once per row measured
// 0.0445 ms in the same run; that redesign is left for its own change.
//
// What this design leaves for later: the proposal and the log factor go
// through device memory between the two kernels (the price of running the
// logp as torch ops).

#include "stretch_common.cuh"

namespace {

constexpr int kThreads = 256;

// rows of a propose tile: about 2560 elements a block, at most one row a
// thread, so that the grid stays wide for any P
int propose_rows(int P) {
  const int rows = (2560 + P - 1) / P;
  return rows < kThreads ? rows : kThreads;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) stretch_propose_kernel(
    const float* __restrict__ act, const float* __restrict__ other,
    const int* __restrict__ shift, unsigned long long key,
    float* __restrict__ out_y, float* __restrict__ out_factor, long long n,
    long long row0, long long m, int P, float a, int tile_rows) {
  __shared__ float sZ[kThreads];
  const long long i0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, n - i0);
  if ((int)threadIdx.x < rows) {
    const long long i = i0 + threadIdx.x;
    const float u =
        mcmcpp::unit_uniforms(key, (unsigned long long)(row0 + i)).x;
    const float z = mcmcpp::stretch_z(u, a);
    sZ[threadIdx.x] = z;
    out_factor[i] = (float)(P - 1) * logf(z);
  }
  __syncthreads();

  const long long j0 = mcmcpp::partner_row(row0 + i0, *shift, m);
  const float* x = act + i0 * P;
  float* y = out_y + i0 * P;
  const int count = rows * P;
  for (mcmcpp::TileWalk<VEC> w(P); w.e < count; w.next(P)) {
    long long g = j0 + w.row;
    if (g >= m) g -= m;
    const float* xp = other + g * P + w.k;
    const float z = sZ[w.row];
    if (VEC == 2) {
      const float2 pv = *reinterpret_cast<const float2*>(xp);
      const float2 xv = *reinterpret_cast<const float2*>(x + w.e);
      *reinterpret_cast<float2*>(y + w.e) =
          make_float2(mcmcpp::stretch_point(pv.x, xv.x, z),
                      mcmcpp::stretch_point(pv.y, xv.y, z));
    } else {
      y[w.e] = mcmcpp::stretch_point(*xp, x[w.e], z);
    }
  }
}

__global__ void __launch_bounds__(kThreads) stretch_accept_kernel(
    const float* __restrict__ act, const float* __restrict__ y,
    const float* __restrict__ lp_old, const float* __restrict__ lp_new,
    const float* __restrict__ factor, unsigned long long key,
    float* __restrict__ out_act, float* __restrict__ out_lp,
    int* __restrict__ out_acc, long long n, long long row0, int P) {
  const long long total = n * P;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / P;
    const int k = (int)(e - i * P);
    const float lo = lp_old[i];
    const float ln = lp_new[i];
    const float ue =
        mcmcpp::unit_uniforms(key, (unsigned long long)(row0 + i)).y;
    const bool accept = mcmcpp::stretch_accepts(ue, factor[i], ln, lo);
    out_act[e] = accept ? y[e] : act[e];
    if (k == 0) {
      out_lp[i] = accept ? ln : lo;
      out_acc[i] = accept ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads) unit_uniforms_kernel(
    unsigned long long key, float* __restrict__ out_u,
    float* __restrict__ out_ue, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float2 uu = mcmcpp::unit_uniforms(key, (unsigned long long)i);
    out_u[i] = uu.x;
    out_ue[i] = uu.y;
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
// over rows row0…row0+n−1 of a half of m walkers (unsharded: row0 = 0,
// m = n): local walker i pairs with other[(row0 + i + *shift) % m] (`other`
// has m rows) and draws u from (key, row0 + i). Device pointers; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mcmcpp_stretch_propose_f32(const float* act, const float* other,
                                          const int* shift,
                                          unsigned long long key, float* out_y,
                                          float* out_factor, long long n,
                                          long long row0, long long m, int P,
                                          float a, void* stream) {
  if (!mcmcpp::valid_rows(n, row0, m) || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = propose_rows(P);
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mcmcpp::rows_aligned8(P, act, other, out_y)) {
    stretch_propose_kernel<2><<<(unsigned int)blocks, kThreads, 0, s>>>(
        act, other, shift, key, out_y, out_factor, n, row0, m, P, a, rows);
  } else {
    stretch_propose_kernel<1><<<(unsigned int)blocks, kThreads, 0, s>>>(
        act, other, shift, key, out_y, out_factor, n, row0, m, P, a, rows);
  }
  return (int)cudaGetLastError();
}

// Accept and select of a stretch half-step: the row, its logp and an int32
// flag, from X, Y, lp_old, lp_new, the log factor and ue of local walker i
// drawn from (key, row0 + i), for rows row0… of a half (unsharded:
// row0 = 0). Device pointers; returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int mcmcpp_stretch_accept_f32(const float* act, const float* y,
                                         const float* lp_old,
                                         const float* lp_new,
                                         const float* factor,
                                         unsigned long long key,
                                         float* out_act, float* out_lp,
                                         int* out_acc, long long n,
                                         long long row0, int P,
                                         void* stream) {
  if (n <= 0 || row0 < 0 || P <= 0) return (int)cudaErrorInvalidValue;
  stretch_accept_kernel<<<blocks_for(n * P), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      act, y, lp_old, lp_new, factor, key, out_act, out_lp, out_acc, n, row0,
      P);
  return (int)cudaGetLastError();
}

// The planes u and ue (n,) that the three kernels draw from `key`, written
// out: a debug entry point, for holding the device function against its
// plain twin. No kernel of the port reads a plane.
extern "C" int mcmcpp_unit_uniforms_f32(unsigned long long key, float* out_u,
                                        float* out_ue, long long n,
                                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  unit_uniforms_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(key, out_u,
                                                              out_ue, n);
  return (int)cudaGetLastError();
}
