// Fused Goodman–Weare stretch half-step for a dense Gaussian target of any
// width P (the dispatch sends P > 16 here; fused_stretch.cu keeps P <= 16).
//
// Replaces the TPU kernel mcmcpp_tpu/ops/pallas_stretch.py::fused_stretch_half
// (its body `_kernel`, which traces the logp into the kernel at any P): for
// every active walker i (global row row0 + i of a half of m walkers,
// stretch_common.cuh) it reads the partner other[(row0 + i + shift) % m],
// draws u and ue from the half-step's key and row0 + i, forms z and the
// proposal Y = partner + z·(X − partner), evaluates lp_new = −0.5·‖Y·L‖² with
// the whole P×P matrix L (row-major; the upper triangle is not assumed
// zero), and accepts iff log(ue) < (P−1)·log z + lp_new − lp_old. It writes
// the selected row, its logp and an int32 accept flag: the semantics of
// fused_stretch.cu, whose one-thread-a-walker design keeps Y in registers
// and all of L in shared memory, and so stops at small P.
//
// What bounds it: a walker moves 4·(3P + 3) B (X, the partner and the output
// row, lp_old, out_lp, out_acc) against the P×P product's 2P² FLOP. Done as
// 3xTF32 on the tensor cores (below) the product is 3·2P² FLOP at 495
// TFLOP/s, so the kernel is memory-bound up to P ≈ 290 (at n = 2^20 and
// P = 100: 0.379 ms of bytes against 0.127 ms of tensor work). mma.sync,
// which this kernel issues, has about two thirds of that TF32 rate.
//
// Design:
// - A block of four warps owns R = 64·MT consecutive walkers, one warp
//   16·MT rows: MT m16 tiles of an mma.sync m16n8k8 (MT = 2 where three
//   such blocks fit an SM, which halves the reads of L and the splits of its
//   fragments per walker). The block reads the X run and the partner run
//   with coalesced loads (the tile walk of stretch_common.cuh, a batch of
//   loads in flight before the first store), forms the Y tile once, in
//   shared memory, with the rows padded with zeros to whole k-steps of 8 and
//   a row stride ≡ 4 (mod 8) floats, so that an A fragment's 32 loads fall
//   into 32 banks.
// - L streams through shared memory in 32 × 64 panels (rows k, columns n of
//   S = Y·L), a ring of two stages filled by 4-byte cp.async with the zero
//   fill past P (any P, any alignment, no padded copy of L), one panel in
//   flight while the warps multiply the one before (a third stage was
//   slower: the ring's shared memory costs blocks an SM). The panel's row
//   stride ≡ 8 (mod 16) floats: a B fragment's loads fall into 32 banks.
// - Product: S column panel by column panel, over all of K, in fp32
//   accumulators (32·MT a thread: 16·MT rows × 64 columns a warp); when a
//   panel is complete its accumulators are squared into each row's running
//   sum. The four threads of an mma quad hold a row between them and add
//   their sums with two shuffles; a warp owns its rows, so no sum crosses
//   warps. Every row's sum is taken in the same order whatever block or
//   launch holds it, so launches over row shards equal one launch bit for
//   bit.
// - 3xTF32: a = a_big + a_small with a_big = a rounded to TF32 and a_small
//   = a − a_big (truncated to TF32 by the tensor cores); each product is
//   a_small·b_big + a_big·b_small + a_big·b_big, three m16n8k8 TF32 mma into
//   a zeroed partial, which an fp32 add (round to nearest) puts into the
//   accumulator. That keeps about float32's accuracy (what is dropped is
//   below 2^-21 relative) at a third of the TF32 rate; plain TF32 keeps about
//   three digits, which at |lp| ≈ 10² moves accept decisions. The tensor
//   cores truncate the sum they write, so the three mma of every k-step
//   accumulated into S itself lost up to an ulp of the running sum each: a
//   bias toward zero that grows with K, 1.3e-5 relative against the float32
//   plain version at P = 1000 on an H100 (within 1e-5 up to P = 257).
// - fp32 FMA on the CUDA cores, register-tiled in the same fragment layout,
//   was measured against this product and lost at every P (PERF.md §6: it
//   issues a shared-memory load for every 3.2 FMA), so only 3xTF32 is built.
// - Epilogue: X goes to the output rows as it is read, as if every row were
//   rejected; after the accept decisions of the R rows the accepted rows get
//   Y from the tile (an accepted row is written twice, a rejected one is not
//   read twice: reading X again at the end, one load at a time, measured
//   0.96 ms at P = 65, n = 2^20, on an H100).
// - What holds it back (PERF.md §6): the blocks of an SM overlap their
//   product poorly with their loads, so the time is near the sum of the two
//   phases. A block that kept the next tile's loads in flight during its
//   product needs the shared memory of a second tile; a grid of resident
//   blocks walking tiles, with L2 prefetches of the next one, was slower
//   (more registers, spills). wgmma, which reads B from shared memory
//   without register fragments, is the next step.
// - Past the shared memory of the Y tile (19456 + 256·(K + 4) B a block at
//   R = 64, K = P rounded up to 8: P >= 825 on an H100, whose blocks may opt
//   into 227 KB), the streamed variant (STREAM_A) writes Y
//   straight into the output rows, streams it back in 64 × 32 panels beside
//   L's, and writes X over the rejected rows (read again, a batch of loads
//   in flight): no cap on P.
//
// The partner index, z, the uniforms and the accept rule are the device
// functions of stretch_common.cuh, shared with the other stretch kernels.

#include "stretch_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// walkers of a block for each m16 tile a warp holds (16 rows, the M of an
// m16n8k8 mma): a block of MT tiles a warp owns R = 64·MT walkers
constexpr int kRowsPerMT = 16 * kWarps;
// columns of S a panel (8 n8 tiles a warp) and rows of L a stage
constexpr int kPanelN = 64;
constexpr int kChunkK = 32;
constexpr int kStages = 2;
// row strides in floats: ≡ 8 (mod 16) for L's panels (B fragments), ≡ 4
// (mod 8) for the streamed Y panels and the Y tile (A fragments)
constexpr int kStrideL = kPanelN + 8;
constexpr int kStrideA = kChunkK + 4;
// Devices of one host that the shared-memory opt-in keeps a value for.
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

// K padded to whole k-steps of the mma, and the Y tile's row stride
__host__ __device__ inline int padded_k(int P) { return round_up(P, 8); }
__host__ __device__ inline int tile_stride(int P) { return padded_k(P) + 4; }

__host__ __device__ inline int stage_floats(bool stream_a) {
  return kChunkK * kStrideL + (stream_a ? kRowsPerMT * kStrideA : 0);
}

// Dynamic shared memory of one block of MT m16 tiles a warp: the ring, the
// Y tile (unless streamed), z, ue, the row sums and the accept flags.
size_t wide_smem_bytes(int P, bool stream_a, int mt) {
  const size_t rows = (size_t)kRowsPerMT * mt;
  const size_t floats = (size_t)kStages * stage_floats(stream_a) +
                        (stream_a ? 0 : rows * tile_stride(P)) + 3 * rows;
  return 4 * (floats + rows);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // src-size 0 reads nothing and fills the 4 bytes with zeros
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small for the 3xTF32 product: big is x rounded to TF32 (to
// nearest, ties away from zero: half a TF32 ULP added to the magnitude's
// bits, the low 13 bits cleared), small the exact remainder x − big, whose
// low 13 bits the tensor cores ignore. A NaN or infinite x leaves a NaN
// small, so the row's logp stays NaN (a rejection), as the plain version's
// NaN or −inf logp does.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of 8 of a warp's 16·MT × 8·NT block of S: A (16·MT rows, row
// stride lda) and B (8 rows of L's panel) from shared memory. Thread (g, t)
// = (lane / 4, lane % 4) holds rows 16·mt + g and 16·mt + g + 8, columns
// 8·nt + 2t and 8·nt + 2t + 1 of every tile (mt, nt) (the mma's C
// fragment). NT is a compile-time count, so that the loops unroll with no
// branch between the tiles (a runtime count measured 10.56 ms at P = 257,
// n = 2^20, on an H100, against 6.18 ms). The n8 tiles go in pairs: a pair's
// 2·MT partials are zeroed, take the three products of their tile (the 2·MT
// tiles' mma interleaved, so that no mma waits on the one before it) and are
// added to S; each A fragment is split once for the k-step, each B fragment
// once for the MT tiles below it.
template <int NT, int MT>
__device__ __forceinline__ void k_step(float (&acc)[MT][8][4],
                                       const float* __restrict__ sa, int lda,
                                       const float* __restrict__ sb, int g,
                                       int t) {
  static_assert(NT % 2 == 0, "n8 tiles go in pairs");
  unsigned ab[MT][4], as[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* a = sa + mt * 16 * lda;
    split_tf32(a[g * lda + t], ab[mt][0], as[mt][0]);
    split_tf32(a[(g + 8) * lda + t], ab[mt][1], as[mt][1]);
    split_tf32(a[g * lda + t + 4], ab[mt][2], as[mt][2]);
    split_tf32(a[(g + 8) * lda + t + 4], ab[mt][3], as[mt][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += 2) {
    unsigned bb[2][2], bs[2][2];
    float part[MT][2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nt = n0 + j;
      split_tf32(sb[t * kStrideL + nt * 8 + g], bb[j][0], bs[j][0]);
      split_tf32(sb[(t + 4) * kStrideL + nt * 8 + g], bb[j][1], bs[j][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        part[mt][j][0] = part[mt][j][1] = part[mt][j][2] = part[mt][j][3] =
            0.0f;
      }
    }
    // the small terms first, the big product last
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][j], as[mt], bb[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][j], ab[mt], bs[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][j], ab[mt], bb[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][n0 + j][i] += part[mt][j][i];
      }
    }
  }
}

// The k-steps of one stage: four, unrolled, but in K's last chunk.
template <int NT, int MT>
__device__ __forceinline__ void stage_product(float (&acc)[MT][8][4],
                                              const float* sa, int lda,
                                              const float* sb, int ksteps,
                                              int g, int t) {
  if (ksteps == kChunkK / 8) {
#pragma unroll
    for (int ks = 0; ks < kChunkK / 8; ++ks) {
      k_step<NT, MT>(acc, sa + ks * 8, lda, sb + ks * 8 * kStrideL, g, t);
    }
  } else {
    for (int ks = 0; ks < ksteps; ++ks) {
      k_step<NT, MT>(acc, sa + ks * 8, lda, sb + ks * 8 * kStrideL, g, t);
    }
  }
}

// The proposal rows of a tile: Y = p + z·(x − p) for `rows` walkers from
// row i0 of `act` and their partners from row j0 of `other` (wrapping at
// m), written to dst[row·ld + k] (the Y tile, or the output rows with ld =
// P); with x_out, X is also written to those output rows, as if every row
// were rejected (the epilogue writes the accepted rows over them).
// Coalesced as load_tile: kLoadBatch elements of X and of the partners in
// flight before the first store.
template <int VEC>
__device__ __forceinline__ void proposal_tile(
    const float* __restrict__ act, const float* __restrict__ other,
    long long i0, long long j0, int rows, long long m, int P,
    const float* sZ, float* dst, int ld, float* __restrict__ x_out) {
  constexpr int B = mcmcpp::kLoadBatch;
  const int count = rows * P;
  mcmcpp::TileWalk<VEC> w(P);
  const float* x_run = act + i0 * P;
  while (w.e < count) {
    float2 xv[B], pv[B];
    int row[B], col[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      row[b] = -1;
      if (w.e < count) {
        long long gp = j0 + w.row;
        if (gp >= m) gp -= m;
        const float* xs = x_run + w.e;
        const float* ps = other + gp * P + w.k;
        if (VEC == 2) {
          xv[b] = *reinterpret_cast<const float2*>(xs);
          pv[b] = *reinterpret_cast<const float2*>(ps);
        } else {
          xv[b].x = *xs;
          pv[b].x = *ps;
        }
        row[b] = w.row;
        col[b] = w.k;
      }
      w.next(P);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (row[b] >= 0) {
        const float z = sZ[row[b]];
        float* d = dst + (long long)row[b] * ld + col[b];
        d[0] = fmaf(z, xv[b].x - pv[b].x, pv[b].x);
        if (VEC == 2) d[1] = fmaf(z, xv[b].y - pv[b].y, pv[b].y);
        if (x_out != nullptr) {
          float* o = x_out + (long long)row[b] * P + col[b];
          if (VEC == 2) {
            *reinterpret_cast<float2*>(o) = xv[b];
          } else {
            o[0] = xv[b].x;
          }
        }
      }
    }
  }
}

// X over the rejected rows of a tile whose output rows hold Y (the
// streamed variant), kLoadBatch loads in flight before the first store.
template <int VEC>
__device__ __forceinline__ void copy_rejected(const float* __restrict__ x_run,
                                             float* __restrict__ out_run,
                                             int rows, int P,
                                             const int* sAcc) {
  constexpr int B = mcmcpp::kLoadBatch;
  const int count = rows * P;
  mcmcpp::TileWalk<VEC> w(P);
  while (w.e < count) {
    float2 v[B];
    int at[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      at[b] = -1;
      if (w.e < count && !sAcc[w.row]) {
        if (VEC == 2) {
          v[b] = *reinterpret_cast<const float2*>(x_run + w.e);
        } else {
          v[b].x = x_run[w.e];
        }
        at[b] = w.e;
      }
      w.next(P);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (at[b] >= 0) {
        if (VEC == 2) {
          *reinterpret_cast<float2*>(out_run + at[b]) = v[b];
        } else {
          out_run[at[b]] = v[b].x;
        }
      }
    }
  }
}

// MT = 2 (128 walkers a block) reads L once for twice the rows; the
// streamed variant has MT = 1.
template <int MT, bool STREAM_A, int VEC>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 4 : 3)
fused_stretch_wide_kernel(
    const float* __restrict__ act, const float* __restrict__ lp_old,
    const float* __restrict__ other, const int* __restrict__ shift,
    unsigned long long key, const float* __restrict__ prec_chol,
    float* __restrict__ out_act, float* __restrict__ out_lp,
    int* __restrict__ out_acc, int n, long long row0, long long m, int P,
    float a) {
  constexpr int R = kRowsPerMT * MT;
  extern __shared__ __align__(16) float smem[];
  const int Kp = padded_k(P);
  const int stride = tile_stride(P);
  const int sf = stage_floats(STREAM_A);
  float* ring = smem;
  float* sY = ring + kStages * sf;
  float* sZ = sY + (STREAM_A ? 0 : R * stride);
  float* sUe = sZ + R;
  float* sQ = sUe + R;
  int* sAcc = reinterpret_cast<int*>(sQ + R);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long i0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, (long long)n - i0);
  const long long j0 = mcmcpp::partner_row(row0 + i0, *shift, m);
  float* out_run = out_act + i0 * P;

  const int n_chunks = (Kp + kChunkK - 1) / kChunkK;
  const int n_panels = (P + kPanelN - 1) / kPanelN;
  const int total = n_chunks * n_panels;

  // stage s of the ring: rows k0… of L's column panel n0…, and (streamed)
  // columns k0… of the block's Y rows
  auto load_stage = [&](int s) {
    const int k0 = (s % n_chunks) * kChunkK, n0 = (s / n_chunks) * kPanelN;
    float* sl = ring + (s % kStages) * sf;
#pragma unroll
    for (int i = 0; i < kChunkK * kPanelN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / kPanelN, nn = e % kPanelN;
      const int k = k0 + kk, c = n0 + nn;
      const bool ok = k < P && c < P;
      cp_async4(sl + kk * kStrideL + nn,
                ok ? prec_chol + (long long)k * P + c : prec_chol, ok);
    }
    if (STREAM_A) {
      // the block's own output rows, written before the loop: loaded from
      // L2 (ld.global.cg), not through this SM's L1
      constexpr int kPer = R * kChunkK / kThreads;
      float v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kChunkK, k = k0 + e % kChunkK;
        v[i] = (r < rows && k < P) ? __ldcg(out_run + (long long)r * P + k)
                                   : 0.0f;
      }
      float* sa = sl + kChunkK * kStrideL;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads;
        sa[(e / kChunkK) * kStrideA + e % kChunkK] = v[i];
      }
    }
  };

  if (!STREAM_A) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < total) load_stage(s);
      cp_async_commit();
    }
  }

  if (tid < rows) {
    const float2 uu = mcmcpp::unit_uniforms(
        key, (unsigned long long)(row0 + i0 + tid));
    sZ[tid] = mcmcpp::stretch_z(uu.x, a);
    sUe[tid] = uu.y;
  }
  __syncthreads();

  if (STREAM_A) {
    proposal_tile<VEC>(act, other, i0, j0, rows, m, P, sZ, out_run, P,
                       nullptr);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < total) load_stage(s);
      cp_async_commit();
    }
  } else {
    proposal_tile<VEC>(act, other, i0, j0, rows, m, P, sZ, sY, stride,
                       out_run);
    // zeros in the padding columns of every row and in the rows past a
    // ragged last tile
    const int pad = Kp - P;
    for (int e = tid; e < R * pad; e += kThreads) {
      const int r = e / pad;
      sY[r * stride + P + (e - r * pad)] = 0.0f;
    }
    for (int e = tid; e < (R - rows) * Kp; e += kThreads) {
      sY[(rows + e / Kp) * stride + e % Kp] = 0.0f;
    }
  }

  float acc[MT][8][4];
  float q[MT][2];  // rows 16·mt + g and 16·mt + g + 8 of the warp
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    q[mt][0] = q[mt][1] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
    }
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < total) load_stage(s + kStages - 1);
    cp_async_commit();
    const int chunk = s % n_chunks, panel = s / n_chunks;
    const int k0 = chunk * kChunkK;
    const int ksteps = min(kChunkK, Kp - k0) / 8;
    const int ntiles = min(8, (P - panel * kPanelN + 7) / 8);
    const float* sl = ring + (s % kStages) * sf;
    const float* sa = STREAM_A ? sl + kChunkK * kStrideL + warp * 16 * kStrideA
                               : sY + warp * 16 * MT * stride + k0;
    const int lda = STREAM_A ? kStrideA : stride;
    // the panel's n8 tiles rounded up to an even count (L's columns past P
    // are zeros)
    switch ((ntiles + 1) / 2) {
      case 4:
        stage_product<8, MT>(acc, sa, lda, sl, ksteps, g, t);
        break;
      case 3:
        stage_product<6, MT>(acc, sa, lda, sl, ksteps, g, t);
        break;
      case 2:
        stage_product<4, MT>(acc, sa, lda, sl, ksteps, g, t);
        break;
      default:
        stage_product<2, MT>(acc, sa, lda, sl, ksteps, g, t);
    }
    if (chunk == n_chunks - 1) {
      // the panel's columns are complete: square them into the row sums
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float* c = acc[mt][nt];
          q[mt][0] = fmaf(c[0], c[0], q[mt][0]);
          q[mt][0] = fmaf(c[1], c[1], q[mt][0]);
          q[mt][1] = fmaf(c[2], c[2], q[mt][1]);
          q[mt][1] = fmaf(c[3], c[3], q[mt][1]);
          c[0] = c[1] = c[2] = c[3] = 0.0f;
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[mt][h] += __shfl_xor_sync(0xffffffffu, q[mt][h], 1);
      q[mt][h] += __shfl_xor_sync(0xffffffffu, q[mt][h], 2);
      if (t == 0) sQ[(warp * MT + mt) * 16 + h * 8 + g] = q[mt][h];
    }
  }
  __syncthreads();

  if (tid < rows) {
    const long long i = i0 + tid;
    const float lp_new = -0.5f * sQ[tid];
    const float lo = lp_old[i];
    const bool accept = mcmcpp::stretch_accepts(
        sUe[tid], (float)(P - 1) * logf(sZ[tid]), lp_new, lo);
    out_lp[i] = accept ? lp_new : lo;
    out_acc[i] = accept ? 1 : 0;
    sAcc[tid] = accept ? 1 : 0;
  }
  __syncthreads();

  // the rows: the output holds X (resident) or Y (streamed); the accepted
  // rows get Y from the tile, or the rejected ones X again
  if (STREAM_A) {
    copy_rejected<VEC>(act + i0 * P, out_run, rows, P, sAcc);
    return;
  }
  const int count = rows * P;
  for (mcmcpp::TileWalk<VEC> w(P); w.e < count; w.next(P)) {
    if (sAcc[w.row]) {
      const float* s = sY + w.row * stride + w.k;
      if (VEC == 2) {
        *reinterpret_cast<float2*>(out_run + w.e) = make_float2(s[0], s[1]);
      } else {
        out_run[w.e] = s[0];
      }
    }
  }
}

// The largest dynamic shared memory a block of this device may opt into.
cudaError_t smem_optin(int* bytes) {
  static int known[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!known[device]) {
    err = cudaDeviceGetAttribute(
        &known[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
  }
  *bytes = known[device];
  return cudaSuccess;
}

template <int MT, bool STREAM_A, int VEC>
cudaError_t launch_vec(const float* act, const float* lp_old,
                       const float* other, const int* shift,
                       unsigned long long key, const float* prec_chol,
                       float* out_act, float* out_lp, int* out_acc, int n,
                       long long row0, long long m, int P, float a,
                       cudaStream_t stream) {
  auto kernel = fused_stretch_wide_kernel<MT, STREAM_A, VEC>;
  const size_t bytes = wide_smem_bytes(P, STREAM_A, MT);
  // above 48 KB a block's dynamic shared memory has to be asked for: once
  // for this instantiation on each device, at the most the device gives
  static bool asked[kMaxDevices] = {};
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024 && !asked[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    asked[device] = true;
  }
  const long long blocks = ((long long)n + kRowsPerMT * MT - 1) /
                           (kRowsPerMT * MT);
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
      act, lp_old, other, shift, key, prec_chol, out_act, out_lp, out_acc, n,
      row0, m, P, a);
  return cudaGetLastError();
}

template <int MT, bool STREAM_A>
cudaError_t launch_mode(const float* act, const float* lp_old,
                        const float* other, const int* shift,
                        unsigned long long key, const float* prec_chol,
                        float* out_act, float* out_lp, int* out_acc, int n,
                        long long row0, long long m, int P, float a,
                        cudaStream_t stream) {
  if (mcmcpp::rows_aligned8(P, act, other, out_act)) {
    return launch_vec<MT, STREAM_A, 2>(
        act, lp_old, other, shift, key, prec_chol, out_act, out_lp, out_acc,
        n, row0, m, P, a, stream);
  }
  return launch_vec<MT, STREAM_A, 1>(
      act, lp_old, other, shift, key, prec_chol, out_act, out_lp, out_acc, n,
      row0, m, P, a, stream);
}

// The block shape: the Y tile in shared memory where it fits, else streamed;
// MT = 2 where three such blocks still fit an SM, else MT = 1 (timed in turns
// on an H100 at P = 65, 100, 128 and 257: MT = 2 was faster at P = 65 and
// 100, MT = 1 at 128, where only two MT = 2 blocks fit; PERF.md §6).
cudaError_t launch_shape(const float* act, const float* lp_old,
                         const float* other, const int* shift,
                         unsigned long long key, const float* prec_chol,
                         float* out_act, float* out_lp, int* out_acc, int n,
                         long long row0, long long m, int P, float a,
                         cudaStream_t stream) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  if (wide_smem_bytes(P, false, 1) > (size_t)optin) {
    return launch_mode<1, true>(act, lp_old, other, shift, key, prec_chol,
                                out_act, out_lp, out_acc, n, row0, m, P, a,
                                stream);
  }
  if (3 * wide_smem_bytes(P, false, 2) <= (size_t)optin) {
    return launch_mode<2, false>(act, lp_old, other, shift, key, prec_chol,
                                 out_act, out_lp, out_acc, n, row0, m, P, a,
                                 stream);
  }
  return launch_mode<1, false>(act, lp_old, other, shift, key, prec_chol,
                               out_act, out_lp, out_acc, n, row0, m, P, a,
                               stream);
}

}  // namespace

// Dynamic shared memory of one block of the wide kernel at dimension P,
// with the Y tile of 64·mt walkers in shared memory (stream_a = 0) or
// streamed (1, mt = 1).
extern "C" long long mcmcpp_fused_stretch_wide_smem_bytes(int P, int stream_a,
                                                          int mt) {
  if (P <= 0 || mt < 1 || mt > 2 || (stream_a && mt != 1)) return 0;
  return (long long)wide_smem_bytes(P, stream_a != 0, mt);
}

// The wide variant of mcmcpp_fused_stretch_half_f32, with the same arguments
// and outputs, for any P >= 1: rows row0…row0+n−1 of a half of m walkers
// against `other`, the whole opposite half (unsharded: row0 = 0, m = n).
// All pointers are device pointers; `prec_chol` is L, (P, P) row-major;
// `shift` points at one int32 (any value); `key` is the half-step's Philox
// key, local walker i drawing its u and ue from (key, row0 + i). Returns the
// launch's cudaError_t (0 on success).
extern "C" int mcmcpp_fused_stretch_wide_f32(
    const float* act, const float* lp_old, const float* other,
    const int* shift, unsigned long long key, const float* prec_chol,
    float* out_act, float* out_lp, int* out_acc, int n, long long row0,
    long long m, int P, float a, void* stream) {
  if (!mcmcpp::valid_rows(n, row0, m) || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_shape(act, lp_old, other, shift, key, prec_chol, out_act,
                           out_lp, out_acc, n, row0, m, P, a,
                           static_cast<cudaStream_t>(stream));
}
