// Fused Goodman–Weare stretch half-step for a dense Gaussian target.
//
// Replaces the TPU kernel mcmcpp_tpu/ops/pallas_stretch.py::fused_stretch_half
// (its body `_kernel`): for every active walker i (global row row0 + i of
// a half of m walkers, stretch_common.cuh) it reads the partner
// other[(row0 + i + shift) % m], draws u and ue from the half-step's key and
// row0 + i, forms
// z = ((sqrt(a) - 1/sqrt(a))·u + 1/sqrt(a))^2 and the proposal
// Y = partner + z·(X − partner), evaluates lp_new = −0.5·‖Y @ L‖² with the
// precision Cholesky L (P×P, row-major), and accepts iff
// log(ue) < (P−1)·log z + lp_new − lp_old. It writes the selected row, its
// logp and an int32 accept flag.
//
// What bounds it: at P = 10 one walker half-update moves 132 B of device
// memory (X, partner and the output row at 40 B each, plus lp_old, out_lp and
// out_acc at 4 B each; 138.4 MB and 0.0413 ms at n = 2^20 on an H100's
// 3.35 TB/s) against about 200 FLOPs for the 10×10 product and some 80
// integer operations for the two uniforms, so the kernel is memory-bound.
//
// What the design does about it:
// - u and ue never touch device memory: they are Philox words of (key, i),
//   computed in registers (stretch_common.cuh), as the Pallas kernel drew
//   them from the TPU's generator.
// - Every global load and store is coalesced. A block owns a tile of R
//   consecutive walkers. Their X rows are one contiguous run of R·P floats,
//   and with the roll so are their partner rows (two runs where the tile
//   crosses the wrap at n). The block copies those runs into shared memory
//   cooperatively, neighbouring threads on neighbouring addresses, so each
//   load instruction of a warp covers whole 128-B lines (one thread per 40-B
//   row, as this kernel first had it, used 4 B of every 40 per instruction
//   and reached a third of the memory rate). Then each thread takes its own
//   row from shared memory, computes in registers as before, writes an
//   accepted proposal over its X row in shared memory, and the block stores
//   the tile back in one contiguous run.
// - Rows in shared memory have an odd stride (P | 1) so that the per-row
//   reads of a warp fall into 32 different banks.
// - The loads are plain loads, and what decides their speed is how many
//   bytes are in flight: a thread starts all the loads of a tile before its
//   first store to shared memory (kLoadBatch), and the kernel is
//   compiled for six blocks an SM (kMinBlocks), so that other
//   blocks load while one computes. Measured at n = 2^20, P = 10 on an H100
//   at 700 W, in turns in one run: the first design 0.1405 ms; this one
//   0.0676 ms; with four loads a batch 0.0731 ms; at the compiler's own 53
//   registers (four blocks an SM) and four loads a batch 0.1095 ms; seven
//   blocks an SM spill and take 0.0920 ms.
// - For even P every row starts 8-B aligned in X, the partner run and the
//   output, whatever the shift, so the copies move a float2 per thread; odd
//   P, or a base pointer that is not 8-B aligned, takes the 4-B copies
//   (decided per launch, between two instantiations: as a run-time
//   argument of one instantiation the choice measured 0.0682 ms against
//   0.0672 ms). A build forced to 4 B took 0.1345 ms against 0.1095 ms,
//   both at four blocks an SM.
//   cp.async of 4 B straight into shared memory, which holds no value in a
//   register, measured 0.0759 ms at six blocks an SM and lost to the plain
//   float2 loads; it was taken out again. A TMA bulk copy needs 16-B aligned
//   runs, which a roll by an odd number of 40-B rows does not give; it was
//   not tried.
// - The one modulo is per tile: the tile's first partner row; the rows after
//   it wrap with a compare and a subtract.
//
// P is capped at 16: L (PMAX×PMAX) and the two tiles live in dynamic shared
// memory, 22.5 KB + 1 KB a block at P = 10 and 34 KB + 1 KB at P = 16, below
// the 48 KB a block has without an opt-in. Wider Gaussians go to
// fused_stretch_wide.cu, which measured faster from P = 17 on (PERF.md §6:
// a thread a walker reads all of L from shared memory for its row).
//
// The partner index, z, the uniforms and the accept rule are the device
// functions of stretch_common.cuh, shared with the split kernels
// (stretch_split.cu); the header also says why the build keeps IEEE
// logf/sqrtf (no fast math).

#include "stretch_common.cuh"

namespace {

// The tile's rows and the block's threads, and the blocks per SM the kernel
// is compiled for: 6 caps it at 42 registers (40 used at P <= 16, no spill).
constexpr int kRows = 256;
constexpr int kMinBlocks = 6;
// The widest P the kernel takes.
constexpr int kMaxP = 16;

// PMAX is a compile-time bound on P: the per-row arrays are unrolled over PMAX
// with `k < P` guards, so they stay in registers for any P <= PMAX.
template <int PMAX, int VEC>
__global__ void __launch_bounds__(kRows, kMinBlocks)
fused_stretch_half_kernel(
    const float* __restrict__ act, const float* __restrict__ lp_old,
    const float* __restrict__ other, const int* __restrict__ shift,
    unsigned long long key, const float* __restrict__ prec_chol,
    float* __restrict__ out_act, float* __restrict__ out_lp,
    int* __restrict__ out_acc, int n, long long row0, long long m, int P,
    float a) {
  extern __shared__ float smem[];
  const int stride = P | 1;
  float* sL = smem;
  float* sX = sL + PMAX * PMAX;
  float* sP = sX + kRows * stride;

  const long long i0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)n - i0);
  const long long j0 = mcmcpp::partner_row(row0 + i0, *shift, m);

  for (int t = threadIdx.x; t < P * P; t += kRows) {
    sL[(t / P) * PMAX + (t % P)] = prec_chol[t];
  }
  mcmcpp::load_tile<VEC>(act, i0, rows, n, P, stride, sX);
  mcmcpp::load_tile<VEC>(other, j0, rows, m, P, stride, sP);
  __syncthreads();

  // ragged last tile: the threads past its rows skip the row's work and
  // still reach both barriers
  if ((int)threadIdx.x < rows) {
    const long long i = i0 + threadIdx.x;
    const float* x = sX + threadIdx.x * stride;
    const float* xp = sP + threadIdx.x * stride;
    const float2 uu =
        mcmcpp::unit_uniforms(key, (unsigned long long)(row0 + i));
    const float z = mcmcpp::stretch_z(uu.x, a);

    float y[PMAX];
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
      if (k < P) {
        // contracted to an FMA, unlike the split kernels' stretch_point: this
        // kernel's logp is its own, so no torch op has to see the same Y bit
        // for bit
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
    const bool accept = mcmcpp::stretch_accepts(
        uu.y, (float)(P - 1) * logf(z), lp_new, lo);
    if (accept) {
      float* xo = sX + threadIdx.x * stride;
#pragma unroll
      for (int k = 0; k < PMAX; ++k) {
        if (k < P) xo[k] = y[k];
      }
    }
    out_lp[i] = accept ? lp_new : lo;
    out_acc[i] = accept ? 1 : 0;
  }
  __syncthreads();
  mcmcpp::store_tile<VEC>(sX, i0, rows, P, stride, out_act);
}

template <int PMAX>
size_t smem_bytes(int P) {
  return sizeof(float) *
         ((size_t)PMAX * PMAX + 2 * (size_t)kRows * (P | 1));
}

template <int PMAX, int VEC>
cudaError_t launch_vec(const float* act, const float* lp_old,
                       const float* other, const int* shift,
                       unsigned long long key, const float* prec_chol,
                       float* out_act, float* out_lp, int* out_acc, int n,
                       long long row0, long long m, int P, float a,
                       cudaStream_t stream) {
  auto kernel = fused_stretch_half_kernel<PMAX, VEC>;
  const size_t bytes = smem_bytes<PMAX>(P);
  const int blocks = (n + kRows - 1) / kRows;
  kernel<<<blocks, kRows, bytes, stream>>>(act, lp_old, other, shift, key,
                                           prec_chol, out_act, out_lp,
                                           out_acc, n, row0, m, P, a);
  return cudaGetLastError();
}

template <int PMAX>
cudaError_t launch(const float* act, const float* lp_old, const float* other,
                   const int* shift, unsigned long long key,
                   const float* prec_chol, float* out_act, float* out_lp,
                   int* out_acc, int n, long long row0, long long m, int P,
                   float a, cudaStream_t stream) {
  if (mcmcpp::rows_aligned8(P, act, other, out_act)) {
    return launch_vec<PMAX, 2>(act, lp_old, other, shift, key, prec_chol,
                                  out_act, out_lp, out_acc, n, row0, m, P, a,
                                  stream);
  }
  return launch_vec<PMAX, 1>(act, lp_old, other, shift, key, prec_chol,
                                out_act, out_lp, out_acc, n, row0, m, P, a,
                                stream);
}

}  // namespace

// Dynamic shared memory of one block of the fused kernel at dimension P
// (L and the two tiles), for the records; 0 for a P the kernel refuses.
extern "C" long long mcmcpp_fused_stretch_half_smem_bytes(int P) {
  if (P <= 0 || P > kMaxP) return 0;
  if (P <= 8) return (long long)smem_bytes<8>(P);
  return (long long)smem_bytes<16>(P);
}

// One fused stretch half-step over n active walkers of dimension P <= 16: rows
// row0…row0+n−1 of a half of m walkers, against `other`, the whole opposite
// half of m rows (unsharded: row0 = 0, m = n). All pointers are device
// pointers; `act`, `lp_old` and the outputs have n rows; `shift` points at
// one int32 (any value: the partner index is taken modulo m); `key` is the
// half-step's Philox key, local walker i drawing its u and ue from
// (key, row0 + i). Returns the launch's cudaError_t (0 on success).
extern "C" int mcmcpp_fused_stretch_half_f32(
    const float* act, const float* lp_old, const float* other,
    const int* shift, unsigned long long key, const float* prec_chol,
    float* out_act, float* out_lp, int* out_acc, int n, long long row0,
    long long m, int P, float a, void* stream) {
  if (!mcmcpp::valid_rows(n, row0, m) || P <= 0 || P > kMaxP) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 8) {
    return (int)launch<8>(act, lp_old, other, shift, key, prec_chol, out_act,
                          out_lp, out_acc, n, row0, m, P, a, s);
  }
  return (int)launch<16>(act, lp_old, other, shift, key, prec_chol, out_act,
                         out_lp, out_acc, n, row0, m, P, a, s);
}
