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
// P = 100: 0.379 ms of bytes against 0.127 ms of tensor work).
//
// Seven routes (the numbers mcmcpp_fused_stretch_wide_layout gives), chosen
// by P and the device's shared memory, tried in the order 0, 3, 4, 5, 6,
// 1–2; on an H100 (227 KB a block):
// - route 0, P <= 117: L's halves resident in one block with two Y tiles;
//   bound by the bytes (the product is under the loads);
// - route 3, 117 < P <= 296: L's columns split over a thread-block cluster;
//   bound by the bytes, held back by one tile a cluster at a time;
// - route 4, 296 < P <= 784: the Y tile resident, L split once a launch and
//   streamed; bound by the product (past P ≈ 296 above the bytes), held
//   back by the rate at which an SM takes in L's stages and by the next
//   tile's formation, which waits for this tile's product;
// - route 5, 784 < P <= the widest P whose Y slice fits a cluster of 8
//   (plan_ksplit): the product's K split over a thread-block cluster of 4
//   or 8 blocks, each with a k-slice of a 128-row Y tile, the partial
//   products reduced in distributed shared memory; bound by the product,
//   held back by the tile's formation, which waits for the last tile's
//   product, and by L's stream;
// - route 6, past that (no cap on P): Y and L both streamed, Y formed once
//   into a buffer in the scratch, each operand's stages multicast over a
//   4 × 2 cluster (Y to the blocks of a tile's two column groups, L to
//   those of a column group's four tiles); bound by the product, held back
//   by its loads, which overlap the wgmma loop only in part;
// - routes 1 and 2: the mma.sync kernel with the Y tile or with Y streamed
//   through the output rows (no cap on P); kept for a device whose blocks
//   no wgmma route's plan fits (on an H100 the dispatch takes them at no
//   width; mcmcpp_fused_stretch_wide_forced_mma_f32 launches them for
//   checking and timing).
// PERF.md §6 has each route's times against its bound.
//
// 1. Route 0. Where L's split halves fit beside two Y tiles and two rings
//    of at least three stages (P <= 117 on an H100, whose blocks may opt
//    into 227 KB): a persistent, warp-specialised block on each SM.
// - The grid is one block an SM. A block walks walker tiles of 64 rows (one
//   wgmma M), tile blockIdx.x, blockIdx.x + gridDim.x, …; its two consumer
//   warpgroups take every other tile, each with its own Y tile and ring.
// - A producer warp keeps the X run and the partner run of the next tiles in
//   flight: stages of 8–32 rows, filled by cp.async.bulk (the 16-B aligned
//   middle of each run) and 4-B cp.async (its unaligned head and tail, up to
//   3 floats each: a row-shard view at any row0, any P), completing on the
//   stage's mbarrier; the partner run wraps at m within a stage as two
//   pieces. A consumer frees a stage on a second mbarrier as soon as it has
//   formed the stage's proposal rows, so the loads of its next tile run
//   under the product and epilogue of this one, and one consumer's product
//   under the other's passes over its tile.
// - A consumer forms its tile's Y = p + z·(X − p) from the stages into its
//   Y tile (row stride ≡ 8 mod 16 floats: an A fragment's float2 loads fall
//   into distinct banks) and writes X to the output rows as it goes, as if
//   every row were rejected; after the decisions the accepted rows get Y
//   from the tile (an accepted row is written twice, and nothing is read
//   twice from device memory). lp_old is loaded when the tile starts.
// - Product: wgmma.mma_async m64nNk8 .f32.tf32.tf32 with N = P rounded up
//   to 16 (at least 32): every column of S at once, so Y is read and split
//   once a tile. A (the Y tile's k-step, split in registers) comes from
//   registers, B (L's big and small halves, split once a block) from shared
//   memory in the K-major core-matrix layout without swizzle. Within each
//   k-step the columns are taken in the order 2t, 2t + 1 of thread t (a
//   float2 of the tile), and L's rows are laid out in that order.
// - 3xTF32: a = a_big + a_small with a_big = a rounded to TF32 and a_small
//   = a − a_big (truncated to TF32 by the tensor cores); each product is
//   a_small·b_big + a_big·b_small + a_big·b_big, three wgmma into a partial
//   that the first of them zeroes (scale-d = 0) and an fp32 add (round to
//   nearest) puts into S: a partial for every four k-steps at N <= 80, two
//   to N = 112 (as many as the A fragments of the group fit beside the
//   accumulators in 168 registers a thread). That keeps about float32's
//   accuracy (what is dropped is below 2^-21 relative); the tensor cores
//   truncate the sum they write, so products accumulated into S itself
//   would lose up to an ulp of the running sum each, a bias toward zero
//   that grows with K (1.3e-5 relative at P = 1000; partials of four
//   k-steps hold 8.1e-7 there in tests/test_torch_fused_stretch.py's
//   emulation). A NaN or infinite Y gives a NaN small part, so the row's
//   logp is NaN and the row rejects, as the plain version's NaN or −inf
//   logp does.
// - Bits: every row's S, squares and sums are taken in one order whatever
//   block, consumer or persistent iteration takes its tile, so launches
//   over row shards equal one launch bit for bit.
// - Registers are not the limit at one block an SM (shared memory is), so
//   the consumers keep the compiler's allocation (no setmaxnreg).
// - Wider P: L's halves (2·4·Kp·N bytes, 131 KB at P = 128) leave too
//   little room for two consumers' tiles and rings. Two single-block
//   designs for wider P measured slower than the mma.sync kernel on an H100
//   (PERF.md §6, PR 15): both consumers on one tile, one half of S's
//   columns each, with L resident (P = 128: fewer bytes in flight and every
//   phase of a tile synchronised across both), and the same with L streamed
//   from L2 in chunks of one k-step, split by two more producer warps
//   (P = 257: every tile re-reads L, and the few chunks the shared memory
//   holds do not hide their L2 latency).
//
// 2. Route 3. Past those widths, where a cluster's plan fits (plan_cluster:
//    on an H100 117 < P <= 296), the same product spread over a thread-block
//    cluster of 2, 4 or 8 blocks: each holds a column slice of L's halves
//    and forms its share of every tile's proposal rows, which it sends to
//    the others' shared memory, and the row sums are reduced through
//    distributed shared memory; its notes are above its code below.
//
// 3. Route 4. Past those, while a 64-row Y tile fits beside two slots of a
//    ring (plan_stream: on an H100 P <= 784), one block an SM keeps the Y
//    tile and streams L: a prologue of the same launch splits L once into
//    scratch in the order of the product's stages, which a producer warp
//    bulk-copies into the ring that also takes the walker stages, under
//    two consumer warpgroups' wgmma; its notes are above its code below.
//
// 4. Route 5. Past those, while a cluster's k-slices of a 128-row Y tile
//    fit beside the exchange area of the partial products and two slots of
//    a ring (plan_ksplit), each block of a cluster of 4 or 8 keeps its
//    k-slice of the tile's Y and streams its rows of L (split once a launch
//    by the same prologue) under two consumer warpgroups' wgmma; the
//    partials of each column panel go to the blocks that own their rows,
//    which add them in rank order; its notes are above its code below.
//
// 5. Route 6. Past those, two stages of a ring of Y stages beside L stages
//    fit at any P (plan_yl): a 2-D cluster of 4 × 2 blocks forms each
//    tile's Y once into scratch and streams it back beside L's stages,
//    each multicast to the blocks that share it, under two consumer
//    warpgroups' wgmma; its notes are above its code below.
//
// 6. Routes 1 and 2. Elsewhere, the mma.sync kernel: a block of four warps
//    owns 64 or 128 walkers (the Y tile in shared memory, or past P ≈ 825
//    on an H100 Y streamed through the output rows), streams L in 32 × 64
//    panels by 4-byte cp.async, and takes Y·L as 3xTF32 on mma.sync
//    m16n8k8 with a zeroed partial a k-step; its notes are above its code
//    below.
//
// The partner index, z, the uniforms and the accept rule are the device
// functions of stretch_common.cuh, shared with the other stretch kernels.

#include <algorithm>
#include <climits>

#include "sm90.cuh"
#include "stretch_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace mcmcpp;

// Devices of one host that the shared-memory opt-in keeps a value for.
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

// x = big + small for the 3xTF32 product: big is x rounded to TF32 (to
// nearest, ties away from zero: half a TF32 ULP added to the magnitude's
// bits, the low 13 bits cleared), small the exact remainder x − big, whose
// low 13 bits the tensor cores ignore. A NaN or infinite x leaves a NaN
// small.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
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

// Above 48 KB a block's dynamic shared memory has to be asked for: once for
// each kernel on each device, at the most the device gives.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* asked) {
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
  return cudaSuccess;
}

// ===========================================================================
// The persistent, warp-specialised kernel (L resident)
// ===========================================================================

constexpr int kTileRows = 64;
constexpr int kWgThreads = 128;
// consumer warpgroups, each with its own tiles, Y tile and stages
constexpr int kConsumers = 2;
constexpr int kThreadsWs = kConsumers * kWgThreads + 32;
constexpr int kMaxSlots = 8;  // a consumer's stages at most

// The block's plan, computed on the host from P and the shared memory a
// block may have (plan_for); byte offsets into the dynamic shared memory.
struct Plan {
  int P, Kp, ystride;  // K padded to k-steps of 8; Y tile row stride
  int nsub;            // wgmma N: every column of S (the cluster route: a
                       // block's slice of them)
  int sr, slots, area; // rows a stage; a consumer's stages; floats of an X
                       // or partner area of a stage (the K-split route:
                       // of a walker row in a slot)
  int off_l, off_ring, off_y, off_rows, off_bar, smem;
  // the cluster route (and, for cluster and off_xch, the K-split route):
  // blocks a cluster, k-steps in the first half of the Y tile and the
  // second half's row stride, offsets
  int cluster, ks0, ystride1, off_stg, off_xch;
  // the L-streamed and K-split routes: bytes of a slot of the ring (an L
  // stage), column panels (of 2·nsub columns; of nsub on the K-split
  // route), k-steps of 8 an L stage
  int lstage, panels, lkc;
};

// The head and tail (up to 3 floats each) of a run, or all of a run under
// 32 B, by 4-B cp.async from lanes lane0…lane0+7; returns the bytes of the
// 16-B aligned middle, which piece_bulk copies. dst ≡ src (mod 16 B).
__device__ __forceinline__ unsigned piece_scalars(float* dst, const float* src,
                                                  int count, int lane,
                                                  int lane0) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = a + 4ull * (unsigned)count;
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, b16 = b & ~(uintptr_t)15;
  const bool bulk = b16 > a16;
  const int head = bulk ? (int)((a16 - a) >> 2) : count;
  const int tail = bulk ? (int)((b - b16) >> 2) : 0;
  const int l = lane - lane0;
  if (l >= 0 && l < head) {
    cp_async4_to(dst + l, src + l);
  } else if (l >= head && l < head + tail) {
    const int e = count - tail + (l - head);
    cp_async4_to(dst + e, src + e);
  }
  return bulk ? (unsigned)(b16 - a16) : 0u;
}

__device__ __forceinline__ void piece_bulk(float* dst, const float* src,
                                           int count, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = a + 4ull * (unsigned)count;
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, b16 = b & ~(uintptr_t)15;
  if (b16 > a16) {
    bulk_load(dst + ((a16 - a) >> 2), reinterpret_cast<const void*>(a16),
              (unsigned)(b16 - a16), bar);
  }
}

// Floats from a 16-B boundary to p.
__device__ __forceinline__ int align_off(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Where the runs of a stage (rows r0…r0+rs−1 of the launch) lie: the X run
// at xo of the X area; the partner rows from j (wrapping at m after r1
// rows) at pao of the partner area, the wrapped rest at pbo. Each run starts
// at its source's offset from a 16-B boundary.
struct Stage {
  const float* x;
  const float* pa;
  int xo, r1, pao, pbo;
};

__device__ __forceinline__ Stage stage_at(const float* act, const float* other,
                                          long long r0, int rs, long long row0,
                                          int shift, long long m, int P) {
  Stage s;
  s.x = act + r0 * P;
  s.xo = align_off(s.x);
  const long long j = partner_row(row0 + r0, shift, m);
  s.r1 = (int)min((long long)rs, m - j);
  s.pa = other + j * P;
  s.pao = align_off(s.pa);
  s.pbo = round_up(s.pao + s.r1 * P, 4) + align_off(other);
  return s;
}

// Producer warp: fill one stage from up to three runs (count 0:
// none). Every lane issues its scalars and arms the barrier for them; then
// lane 0 adds the bulk bytes to the phase and issues the bulk copies.
__device__ __forceinline__ void fill(uint64_t* bar, int lane, float* d0,
                                     const float* s0, int c0, float* d1,
                                     const float* s1, int c1, float* d2,
                                     const float* s2, int c2) {
  unsigned bytes = piece_scalars(d0, s0, c0, lane, 0);
  if (c1 > 0) bytes += piece_scalars(d1, s1, c1, lane, 8);
  if (c2 > 0) bytes += piece_scalars(d2, s2, c2, lane, 16);
  cp_async_arrive(bar);
  __syncwarp();
  if (lane == 0) {
    mbar_arrive_expect_tx(bar, bytes);
    piece_bulk(d0, s0, c0, bar);
    if (c1 > 0) piece_bulk(d1, s1, c1, bar);
    if (c2 > 0) piece_bulk(d2, s2, c2, bar);
  }
}

// Split L's columns col0…col0+ntot−1 into the big and small halves of the
// wgmma layout, Kp rows and ntot columns: element (k, n) at (n / 8)·8·Kp +
// (k / 4)·32 + (n % 8)·4 + k % 4, k in the k-step's order (its 2t-th row at
// position t, its (2t + 1)-th at t + 4), zeros past P in either direction.
// Thread `first` of `step` takes every step-th position of an n-block of 8
// columns and that position in every n-block.
__device__ __forceinline__ void split_l(const float* __restrict__ L, int P,
                                        int Kp, int ntot, float* big,
                                        float* small, int first, int step,
                                        int col0 = 0) {
  const int block = Kp * 8;
  for (int rem = first; rem < block; rem += step) {
    const int kl = (rem >> 5) * 4 + (rem & 3), r = (rem >> 2) & 7;
    const int j = kl & 7;
    const int kp = (kl & ~7) + (j < 4 ? 2 * j : 2 * (j - 4) + 1);
    const float* src = L + kp * P + col0 + r;
    // columns col0 + r + 8·nb < P
    const int n_valid = kp < P ? P - col0 - r : 0;
    for (int nb = 0; nb < ntot / 8; ++nb) {
      const float v = 8 * nb < n_valid ? src[8 * nb] : 0.0f;
      unsigned b, sm;
      split_tf32(v, b, sm);
      big[rem + nb * block] = __uint_as_float(b);
      small[rem + nb * block] = __uint_as_float(sm);
    }
  }
}

// The columns of S a consumer's product takes at once: every column, P
// rounded up to 16 (at least 32).
__host__ __device__ constexpr int nsub_for(int P) {
  return P <= 32 ? 32 : round_up(P, 16);
}

// A consumer's S = Y·L for its tile's 64 rows in registers, as 3xTF32 on
// wgmma: KG k-steps a group, each group's products into a partial that its
// first wgmma zeroes and an fp32 add puts into S (KG as the A fragments of
// KG k-steps fit beside the accumulators in 168 registers a thread).
// k-steps a group of Product<nsub> takes: as many as their A fragments fit
// beside the accumulators in 168 registers a thread.
__host__ __device__ constexpr int product_group(int nsub) {
  return nsub <= 80 ? 4 : (nsub <= 112 ? 2 : 1);
}

template <int NSUB>
struct Product {
  static constexpr int R = NSUB / 2;
  static constexpr int KG = product_group(NSUB);
  float acc[R];
  float part[R];

  __device__ __forceinline__ Product() {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = part[i] = 0.0f;
  }

  // CNT k-steps from column kcol0: A from the Y tile (rows yr and yr + 8 at
  // `yrow`, this thread's float2 of each k-step at column
  // (kcol0 + 8·i) ^ sw: sw swizzles whole k-steps, 0 on every route but
  // route 6), B at byte `off` + 256·i of the halves `lb`, `ls` with `sbo`
  // bytes between n-blocks. CNT is a compile-time count: no wgmma sits in a
  // branch.
  template <int CNT>
  __device__ __forceinline__ void group(const float* yrow, int ystride,
                                        int kcol0, unsigned lb, unsigned ls,
                                        unsigned off, unsigned sbo,
                                        int sw = 0) {
    unsigned ab[CNT][4], as[CNT][4];
#pragma unroll
    for (int i = 0; i < CNT; ++i) {
      const int col = (kcol0 + 8 * i) ^ sw;
      const float2 y0 = *reinterpret_cast<const float2*>(yrow + col);
      const float2 y1 =
          *reinterpret_cast<const float2*>(yrow + 8 * ystride + col);
      split_tf32(y0.x, ab[i][0], as[i][0]);
      split_tf32(y1.x, ab[i][1], as[i][1]);
      split_tf32(y0.y, ab[i][2], as[i][2]);
      split_tf32(y1.y, ab[i][3], as[i][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < CNT; ++i) {
      const uint64_t db = smem_desc(lb + off + 256 * i, 128, sbo);
      const uint64_t ds = smem_desc(ls + off + 256 * i, 128, sbo);
      // the small terms first, the big product last, into a partial the
      // group's first wgmma zeroes
      wgmma_tf32<NSUB>(part, as[i], db, i > 0);
      wgmma_tf32<NSUB>(part, ab[i], ds, 1);
      wgmma_tf32<NSUB>(part, ab[i], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < CNT; ++i) {
      // the A registers stay live until the wgmma that read them are done
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        asm volatile("" : "+r"(ab[i][q]), "+r"(as[i][q])::"memory");
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      reg_fence(part[i]);
      acc[i] += part[i];
    }
  }

  // k-steps ks0 … ks0 + count − 1, in groups of KG from ks0.
  __device__ __forceinline__ void steps(const float* yrow, int ystride,
                                        int kcol0, int count, unsigned lb,
                                        unsigned ls, unsigned off,
                                        unsigned sbo) {
    int i = 0;
    for (; i + KG <= count; i += KG) {
      group<KG>(yrow, ystride, kcol0 + 8 * i, lb, ls, off + 256 * i, sbo);
    }
    const int rest = count - i;
    if (KG > 3 && rest == 3) {
      group<(KG > 3 ? 3 : 1)>(yrow, ystride, kcol0 + 8 * i, lb, ls,
                              off + 256 * i, sbo);
    } else if (KG > 2 && rest == 2) {
      group<(KG > 2 ? 2 : 1)>(yrow, ystride, kcol0 + 8 * i, lb, ls,
                              off + 256 * i, sbo);
    } else if (rest == 1) {
      group<1>(yrow, ystride, kcol0 + 8 * i, lb, ls, off + 256 * i, sbo);
    }
  }

  // Row sums of squares of rows g (q0) and g + 8 (q1) over this thread's
  // columns, in column order.
  __device__ __forceinline__ void squares(float& q0, float& q1) const {
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      q0 = fmaf(acc[4 * j], acc[4 * j], q0);
      q0 = fmaf(acc[4 * j + 1], acc[4 * j + 1], q0);
      q1 = fmaf(acc[4 * j + 2], acc[4 * j + 2], q1);
      q1 = fmaf(acc[4 * j + 3], acc[4 * j + 3], q1);
    }
  }
};

// Warps 0–7: two consumer warpgroups, each with every other tile of the
// block; warp 8: the producer of their stages.
template <int NSUB>
__global__ void __launch_bounds__(kThreadsWs, 1)
wide_ws_kernel(const float* __restrict__ act, const float* __restrict__ lp_old,
               const float* __restrict__ other, const int* __restrict__ shift,
               unsigned long long key, const float* __restrict__ prec_chol,
               float* __restrict__ out_act, float* __restrict__ out_lp,
               int* __restrict__ out_acc, int n, long long row0, long long m,
               float a, const Plan plan, int loads_only) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = plan.P, Kp = plan.Kp, ys = plan.ystride;
  const int SR = plan.sr, S = plan.slots;
  float* lsplit = reinterpret_cast<float*>(smem + plan.off_l);
  float* ring = reinterpret_cast<float*>(smem + plan.off_ring);
  float* ytiles = reinterpret_cast<float*>(smem + plan.off_y);
  float* rows_smem = reinterpret_cast<float*>(smem + plan.off_rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* empty = full + kConsumers * kMaxSlots;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int stages_per_tile = kTileRows / SR;
  const int sh = *shift;

  if (tid == 0) {
    for (int s = 0; s < kConsumers * kMaxSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consumer's warps
    }
    mbar_init_fence();
  }
  // L split once a block, and the Y tiles zeroed once: their padding
  // columns stay zero
  split_l(prec_chol, P, Kp, NSUB, lsplit, lsplit + Kp * NSUB, tid,
          blockDim.x);
  for (int e = tid; e < kConsumers * kTileRows * ys; e += blockDim.x) {
    ytiles[e] = 0.0f;
  }
  fence_proxy_async();
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // ---------------- producer ----------------
    // the X and partner runs of every stage, into the ring of the tile's
    // consumer (tile k of the block goes to consumer k % 2)
    int k = 0;
    for (long long tile = blockIdx.x; tile < n_tiles;
         tile += gridDim.x, ++k) {
      const int c = k % kConsumers;
      const long long i0 = tile * kTileRows;
      const int rows = (int)min((long long)kTileRows, (long long)n - i0);
      for (int st = 0; st * SR < rows; ++st) {
        const int stage = (k / kConsumers) * stages_per_tile + st;
        const int slot = c * S + stage % S, round = stage / S;
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        const int rs = min(SR, rows - st * SR);
        const Stage g = stage_at(act, other, i0 + st * SR, rs, row0, sh, m, P);
        float* ax = ring + (size_t)slot * 2 * plan.area;
        float* ap = ax + plan.area;
        fill(&full[slot], lane, ax + g.xo, g.x, rs * P, ap + g.pao, g.pa,
             g.r1 * P, ap + g.pbo, other, (rs - g.r1) * P);
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---------------- consumer warpgroup c ----------------
  const int c = warp >> 2, wtid = tid & (kWgThreads - 1), wq = wtid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* yt = ytiles + (size_t)c * kTileRows * ys;
  float* sZ = rows_smem + c * 4 * kTileRows;
  float* sUe = sZ + kTileRows;
  float* sQ = sUe + kTileRows;
  int* sAcc = reinterpret_cast<int*>(sQ + kTileRows);
  const float* yrow = yt + (16 * wq + g) * ys + 2 * t;
  const unsigned lb = smem_addr(lsplit), ls = lb + 4 * Kp * NSUB;
  const unsigned sbo = Kp * 32;
  int k = c;
  for (long long tile = blockIdx.x + (long long)c * gridDim.x; tile < n_tiles;
       tile += (long long)kConsumers * gridDim.x, k += kConsumers) {
    const long long i0 = tile * kTileRows;
    const int rows = (int)min((long long)kTileRows, (long long)n - i0);
    // lp_old is loaded here and first read after the product
    const float lo = wtid < rows ? lp_old[i0 + wtid] : 0.0f;
    if (wtid < rows) {
      const float2 uu =
          unit_uniforms(key, (unsigned long long)(row0 + i0 + wtid));
      sZ[wtid] = stretch_z(uu.x, a);
      sUe[wtid] = uu.y;
    }
    named_bar(1 + c, kWgThreads);

    // the proposal rows into the Y tile, X into the output rows
    for (int st = 0; st * SR < rows; ++st) {
      const int stage = (k / kConsumers) * stages_per_tile + st;
      const int slot = c * S + stage % S;
      mbar_wait(&full[slot], (stage / S) & 1);
      const int rs = min(SR, rows - st * SR);
      const Stage sg = stage_at(act, other, i0 + st * SR, rs, row0, sh, m, P);
      const float* ax = ring + (size_t)slot * 2 * plan.area;
      const float* xs = ax + sg.xo;
      const float* pa = ax + plan.area + sg.pao;
      const float* pb = ax + plan.area + sg.pbo;
      const int split = sg.r1 * P;
      float* out = out_act + (i0 + st * SR) * P;
      float* ydst = yt + st * SR * ys;
      const float* zr = sZ + st * SR;
      for (TileWalk<1> w(P, wtid, kWgThreads); w.e < rs * P; w.next(P)) {
        const float x = xs[w.e];
        const float p = w.e < split ? pa[w.e] : pb[w.e - split];
        ydst[w.row * ys + w.k] = fmaf(zr[w.row], x - p, p);
        out[w.e] = x;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    named_bar(1 + c, kWgThreads);

    // S = Y·L (3xTF32 on wgmma) and the rows' sums of squares
    float q0 = 0.0f, q1 = 0.0f;
    if (!loads_only) {
      Product<NSUB> prod;
      prod.steps(yrow, ys, 0, Kp / 8, lb, ls, 0, sbo);
      prod.squares(q0, q1);
    }
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    if (t == 0) {
      sQ[16 * wq + g] = q0;
      sQ[16 * wq + g + 8] = q1;
    }
    named_bar(1 + c, kWgThreads);

    if (wtid < rows) {
      const long long i = i0 + wtid;
      // loads only: lp_new = lp_old, the decision by the factor alone
      const float lp_new = loads_only ? lo : -0.5f * sQ[wtid];
      const bool accept = stretch_accepts(
          sUe[wtid], (float)(P - 1) * logf(sZ[wtid]), lp_new, lo);
      out_lp[i] = accept ? lp_new : lo;
      out_acc[i] = accept ? 1 : 0;
      sAcc[wtid] = accept ? 1 : 0;
    }
    named_bar(1 + c, kWgThreads);
    // the accepted rows get Y
    float* out = out_act + i0 * P;
    for (TileWalk<1> w(P, wtid, kWgThreads); w.e < rows * P; w.next(P)) {
      if (sAcc[w.row]) out[w.e] = yt[w.row * ys + w.k];
    }
  }
}

// The plan of a block at P on a device whose blocks may have `optin` bytes
// of shared memory: L's halves, two Y tiles and each consumer's ring of at
// least three stages of 32, 16 or 8 rows (the largest that fits three, and
// at most kMaxSlots); false where they do not fit (on an H100 past P = 117).
bool plan_for(int P, int optin, Plan* out) {
  if (P < 1 || P > 128) return false;
  Plan p = {};
  p.P = P;
  p.Kp = round_up(P, 8);
  // ≡ 8 (mod 16): the float2 loads of an A fragment's eight rows in
  // distinct banks
  p.ystride = p.Kp % 16 ? p.Kp : p.Kp + 8;
  p.nsub = nsub_for(P);
  int off = 0;
  p.off_l = off;
  off += round_up(4 * 2 * p.Kp * p.nsub, 128);
  p.off_y = off;
  off += kConsumers * 4 * kTileRows * p.ystride;
  p.off_rows = off;
  off += kConsumers * 4 * 4 * kTileRows;
  p.off_bar = off;
  off += 8 * 2 * kConsumers * kMaxSlots;
  p.off_ring = round_up(off, 128);
  for (int sr = 32; sr >= 8; sr /= 2) {
    const int area = round_up(sr * P + 10, 4);
    const int slot_bytes = 2 * 4 * area;
    const int slots = std::min(
        kMaxSlots, (optin - p.off_ring) / (kConsumers * slot_bytes));
    if (slots >= 3) {
      p.sr = sr;
      p.area = area;
      p.slots = slots;
      p.smem = p.off_ring + kConsumers * slots * slot_bytes;
      *out = p;
      return true;
    }
  }
  return false;
}

template <int NSUB>
cudaError_t launch_ws(const float* act, const float* lp_old, const float* other,
                      const int* shift, unsigned long long key,
                      const float* prec_chol, float* out_act, float* out_lp,
                      int* out_acc, int n, long long row0, long long m,
                      float a, const Plan& plan, int loads_only,
                      cudaStream_t stream) {
  auto kernel = wide_ws_kernel<NSUB>;
  static bool asked[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, plan.smem, asked);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int blocks =
      std::max(1, std::min(sms, (n_tiles + kConsumers - 1) / kConsumers));
  kernel<<<blocks, kThreadsWs, plan.smem, stream>>>(
      act, lp_old, other, shift, key, prec_chol, out_act, out_lp, out_acc, n,
      row0, m, a, plan, loads_only);
  return cudaGetLastError();
}

cudaError_t launch_planned(const float* act, const float* lp_old,
                           const float* other, const int* shift,
                           unsigned long long key, const float* prec_chol,
                           float* out_act, float* out_lp, int* out_acc, int n,
                           long long row0, long long m, float a,
                           const Plan& plan, int loads_only,
                           cudaStream_t stream) {
#define MCMCPP_WS(NS)                                                        \
  if (plan.nsub == NS) {                                                     \
    return launch_ws<NS>(act, lp_old, other, shift, key, prec_chol, out_act, \
                         out_lp, out_acc, n, row0, m, a, plan, loads_only,   \
                         stream);                                            \
  }
  MCMCPP_WS(32)
  MCMCPP_WS(48)
  MCMCPP_WS(64)
  MCMCPP_WS(80)
  MCMCPP_WS(96)
  MCMCPP_WS(112)
  MCMCPP_WS(128)
#undef MCMCPP_WS
  return cudaErrorInvalidValue;
}

// ===========================================================================
// The cluster route: L's columns split over the blocks of a cluster
// ===========================================================================
//
// Past the widths plan_for takes, L's split halves no longer fit one block
// beside its tiles and rings. A thread-block cluster of c blocks (one an SM)
// shares them out:
// - Block r of the cluster holds the big and small halves of L's column
//   slice r: columns r·N … r·N + N − 1 with N = ⌈P / c⌉ rounded up to 8 (the
//   wgmma N granule), zeros past P; split once a launch, resident. Its
//   consumer warpgroup takes S[:, slice r] = Y·L[:, slice r] for the whole
//   64-row Y tile as 3xTF32 wgmma (Product above) and squares and sums its
//   columns into 64 partial row sums. A slice wholly past P (P = 257,
//   c = 8: the last) adds zeros, so that block skips its product.
// - The clusters are persistent: cluster q walks tiles q, q + Q, …, all its
//   blocks the same tiles in the same order.
// - Block r owns rows r·64/c … of each tile. Its producer warp loads only
//   those rows' X and partner runs into a ring (cp.async.bulk and 4-B
//   cp.async into mbarrier stages, as the warp-specialised kernel's
//   producer loads a tile); its former warpgroup forms only those rows of
//   the proposal, Y = p + z·(x − p), into a staging buffer (two, one a tile
//   in turn), writes their X to the output rows (as if rejected), and sends
//   the staged rows to the same rows of every block's Y tile, its own
//   included, by cp.async.bulk shared::cta → shared::cluster, completing on
//   that block's mbarrier. So each proposal row is read, formed and
//   written once for the whole cluster, and the former forms tile t + 1
//   while the consumer multiplies tile t. (A first build multicast every
//   stage of X and partner rows to all c blocks, each forming the whole
//   tile: every SM took in and formed c times the tile's bytes, and it was
//   slower than the mma.sync kernel at P = 128 and 257 on an H100; PERF.md
//   §6.)
// - The Y tile (and each staging row) is kept as two halves of k-steps,
//   each a whole number of the product's groups, so S's sums are those of
//   one pass. A block's consumer frees each half in every block of the
//   cluster (a remote mbarrier arrival) as soon as its product has read
//   it; the formers send tile t + 1's first half while the consumers still
//   multiply tile t's second.
// - The row sums are reduced through distributed shared memory: every
//   block stores its partials of block r's rows into block r's exchange
//   buffer by st.async, each completing as 4 transaction bytes on block r's
//   mbarrier, which block r's consumer arms for 4·64 bytes a tile; block r
//   adds the c partials in rank order, so every row's sum is one order
//   whatever cluster takes its tile, and row shards at any row0 equal one
//   launch bit for bit. The buffers alternate between tiles (the partials
//   of tile t + 2 follow the Y tile of t + 2, sent after this block's
//   consumer read tile t + 1, after its exchange of tile t).
// - Block r's consumer decides its own rows and writes their outputs: Y
//   (from the staging buffer) over the accepted rows, their logp and flag.
//   The former forms tile t + 2 into a staging buffer only after that
//   epilogue of tile t has read it.
// - No arrival is released at cluster scope: such a release first waits
//   for the thread's stores to device memory. A cluster_sync before any
//   block exits: no peer still writes to its shared memory.
// - The grid is as many clusters as cudaOccupancyMaxActiveClusters says fit
//   at one block an SM (a cluster of 8 needs 8 free SMs of one GPC).
// - What holds it back (PERF.md §6): a cluster multiplies one tile at a
//   time (a second Y tile does not fit beside L's slice), so the Y tile's
//   transfer between the blocks and the exchange of the partials sit
//   between one tile's product and the next; at c = 8 only 15 tiles are
//   in flight on an H100.

// The cluster sizes plan_cluster tries, smallest first: each divides a
// tile's 64 rows, and 8 is the largest portable size.
constexpr int kClusterSizes[] = {2, 4, 8};
// Warps 0–3: the consumer warpgroup; 4–7: the former warpgroup; 8: the
// producer.
constexpr int kThreadsCluster = 2 * kWgThreads + 32;

// The wgmma N (a block's columns of S) the cluster kernel is built for: the
// widths plan_cluster picks on an H100 (117 < P <= 296).
#define MCMCPP_CLUSTER_WIDTHS(X) \
  X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88)

bool cluster_width_built(int nsub) {
#define MCMCPP_CL(NS) \
  if (nsub == NS) return true;
  MCMCPP_CLUSTER_WIDTHS(MCMCPP_CL)
#undef MCMCPP_CL
  return false;
}

// Columns of a row a lane forms or copies at once (loads in flight before
// the first store).
constexpr int kFormUnroll = 4;

// The two halves of a row of the Y tile (and of the staging rows): columns
// 0 … k0 − 1 at row stride ys0, the rest from `h1` at row stride ys1.
struct HalfRows {
  float* h0;
  float* h1;
  int k0, ys0, ys1;
  __device__ __forceinline__ float* at(int r, int k) const {
    return k < k0 ? h0 + r * ys0 + k : h1 + r * ys1 + (k - k0);
  }
};

// Warp wq of the former warpgroup forms rows wq, wq + 4, … of a stage of rs
// rows (X at xs, the partner rows at pa, from row r1 on at pb): Y = p +
// z·(x − p) into the staging rows from row `row` on and X into the output
// rows. The lanes of a row take its columns lane, lane + 32, …, kFormUnroll
// loads of X and of the partner in flight a lane.
__device__ __forceinline__ void form_rows(const float* xs, const float* pa,
                                          const float* pb, int r1, int rs,
                                          int P, const float* zr,
                                          const HalfRows& y, int row,
                                          float* out, int wq, int lane) {
  for (int r = wq; r < rs; r += 4) {
    const float* xr = xs + r * P;
    const float* pr = r < r1 ? pa + r * P : pb + (r - r1) * P;
    float* orow = out + (long long)r * P;
    const float z = zr[r];
    for (int k0 = lane; k0 < P; k0 += 32 * kFormUnroll) {
      float xv[kFormUnroll], pv[kFormUnroll];
#pragma unroll
      for (int u = 0; u < kFormUnroll; ++u) {
        const int kk = k0 + 32 * u;
        xv[u] = kk < P ? xr[kk] : 0.0f;
        pv[u] = kk < P ? pr[kk] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kFormUnroll; ++u) {
        const int kk = k0 + 32 * u;
        if (kk < P) {
          *y.at(row + r, kk) = fmaf(z, xv[u] - pv[u], pv[u]);
          orow[kk] = xv[u];
        }
      }
    }
  }
}

template <int NSUB>
__global__ void __launch_bounds__(kThreadsCluster, 1)
wide_cluster_kernel(const float* __restrict__ act,
                    const float* __restrict__ lp_old,
                    const float* __restrict__ other,
                    const int* __restrict__ shift, unsigned long long key,
                    const float* __restrict__ prec_chol,
                    float* __restrict__ out_act, float* __restrict__ out_lp,
                    int* __restrict__ out_acc, int n, long long row0,
                    long long m, float a, const Plan plan, int loads_only) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = plan.P, Kp = plan.Kp;
  const int SR = plan.sr, S = plan.slots, C = plan.cluster;
  const int ks0 = plan.ks0, ys0 = plan.ystride, ys1 = plan.ystride1;
  const int yrow_floats = ys0 + ys1;  // a row of the Y tile, both halves
  const int own = kTileRows / C;      // rows of a tile that a block owns
  const unsigned rank = cluster_rank();
  const long long cid = cluster_index(), ncl = cluster_count();
  float* lsplit = reinterpret_cast<float*>(smem + plan.off_l);
  float* ring = reinterpret_cast<float*>(smem + plan.off_ring);
  float* yt = reinterpret_cast<float*>(smem + plan.off_y);
  // staging rows: [2 buffers][half][own][ys of the half]
  float* stg = reinterpret_cast<float*>(smem + plan.off_stg);
  float* sZ = reinterpret_cast<float*>(smem + plan.off_rows);  // [2][64]
  float* sUe = sZ + 2 * kTileRows;                             // [2][64]
  int* sAcc = reinterpret_cast<int*>(sUe + 2 * kTileRows);     // [64]
  float* xb = reinterpret_cast<float*>(smem + plan.off_xch);   // [2][c][own]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* empty = full + kMaxSlots;
  uint64_t* xf = empty + kMaxSlots;  // [2] partials landed
  uint64_t* yf = xf + 2;             // [half] the Y tile's half landed
  uint64_t* yfree = yf + 2;          // [half] every block done reading it
  uint64_t* formed = yfree + 2;      // [2] staging rows, z and ue written
  uint64_t* stg_free = formed + 2;   // [2] staging rows read

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int stages_per_tile = own / SR;
  const int first = (int)rank * own;  // this block's rows of a tile
  // the Y tile's halves: 64 rows of ys0, then 64 rows of ys1
  const HalfRows ytile = {yt, yt + kTileRows * ys0, 8 * ks0, ys0, ys1};
  const unsigned half_bytes[2] = {4u * own * ys0, 4u * own * ys1};
  const int col0 = (int)rank * NSUB;

  if (tid == 0) {
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the former's warps
    }
    for (int s = 0; s < 10; ++s) {
      // yfree: one arrival from every block's consumer
      mbar_init(&xf[s], s == 4 || s == 5 ? C : 1);
    }
    mbar_init_fence();
  }
  // this block's slice of L, split once; the Y tile and staging rows zeroed
  // once (the padding columns stay zero)
  split_l(prec_chol, P, Kp, NSUB, lsplit, lsplit + Kp * NSUB, tid, blockDim.x,
          col0);
  for (int e = tid; e < kTileRows * yrow_floats; e += blockDim.x) {
    yt[e] = 0.0f;
  }
  for (int e = tid; e < 2 * own * yrow_floats; e += blockDim.x) stg[e] = 0.0f;
  fence_proxy_async();
  __syncthreads();
  // every block's barriers exist before a peer's copy reaches them
  cluster_sync();

  if (warp == 8) {
    // ---------------- producer: this block's rows of every tile ----------
    const int sh = *shift;
    int j = 0;
    for (long long tile = cid; tile < n_tiles; tile += ncl, ++j) {
      const long long i0 = tile * kTileRows + first;
      const int mine = (int)min((long long)own, (long long)n - i0);
      for (int st = 0; st * SR < mine; ++st) {
        const int stage = j * stages_per_tile + st;
        const int slot = stage % S, round = stage / S;
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        const int rs = min(SR, mine - st * SR);
        const Stage g = stage_at(act, other, i0 + st * SR, rs, row0, sh, m, P);
        float* ax = ring + (size_t)slot * 2 * plan.area;
        float* ap = ax + plan.area;
        fill(&full[slot], lane, ax + g.xo, g.x, rs * P, ap + g.pao, g.pa,
             g.r1 * P, ap + g.pbo, other, (rs - g.r1) * P);
      }
    }
    cp_async_wait_all();
  } else if (warp >= 4) {
    // ---------------- former: this block's rows of the proposal ----------
    const int sh = *shift;
    const int ft = tid - kWgThreads, fq = warp - 4;
    int j = 0;
    for (long long tile = cid; tile < n_tiles; tile += ncl, ++j) {
      const int b = j & 1;
      const long long i0 = tile * kTileRows + first;
      const int mine = (int)max(0ll, min((long long)own, (long long)n - i0));
      float* sg = stg + b * own * yrow_floats;
      const HalfRows srows = {sg, sg + own * ys0, 8 * ks0, ys0, ys1};
      // the consumer's epilogue of tile j − 2 has read this buffer
      if (j >= 2) mbar_wait(&stg_free[b], ((j - 2) >> 1) & 1);
      if (ft < mine) {
        const float2 uu =
            unit_uniforms(key, (unsigned long long)(row0 + i0 + ft));
        sZ[b * kTileRows + ft] = stretch_z(uu.x, a);
        sUe[b * kTileRows + ft] = uu.y;
      }
      named_bar(2, kWgThreads);
      for (int st = 0; st * SR < mine; ++st) {
        const int stage = j * stages_per_tile + st;
        const int slot = stage % S;
        mbar_wait(&full[slot], (stage / S) & 1);
        const int rs = min(SR, mine - st * SR);
        const Stage g = stage_at(act, other, i0 + st * SR, rs, row0, sh, m, P);
        const float* ax = ring + (size_t)slot * 2 * plan.area;
        form_rows(ax + g.xo, ax + plan.area + g.pao, ax + plan.area + g.pbo,
                  g.r1, rs, P, sZ + b * kTileRows + st * SR, srows, st * SR,
                  out_act + (i0 + st * SR) * P, fq, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      // the staged rows to the bulk copies' proxy
      fence_proxy_async();
      named_bar(2, kWgThreads);
      if (ft == 0) mbar_arrive(&formed[b]);
      if (ft < C) {
        // each half of the rows once every block has read that half of its
        // Y tile for tile j − 1
        for (int h = 0; h < 2; ++h) {
          if (j >= 1) mbar_wait(&yfree[h], (j - 1) & 1);
          float* dst = h ? ytile.h1 + first * ys1 : ytile.h0 + first * ys0;
          bulk_copy_to_peer(map_rank(smem_addr(dst), ft),
                            h ? srows.h1 : srows.h0, half_bytes[h],
                            map_rank(smem_addr(&yf[h]), ft));
        }
      }
      __syncwarp();
    }
  } else {
    // ---------------- consumer ----------------
    const int wtid = tid, wq = warp;
    const int g = lane >> 2, t = lane & 3;
    const float* yrow0 = ytile.h0 + (16 * wq + g) * ys0 + 2 * t;
    const float* yrow1 = ytile.h1 + (16 * wq + g) * ys1 + 2 * t;
    const unsigned lb = smem_addr(lsplit), ls = lb + 4 * Kp * NSUB;
    const unsigned sbo = Kp * 32;
    const bool product = !loads_only && col0 < P;
    int j = 0;
    for (long long tile = cid; tile < n_tiles; tile += ncl, ++j) {
      const int b = j & 1;
      const long long i0 = tile * kTileRows + first;  // this block's rows
      const int mine = (int)max(0ll, min((long long)own, (long long)n - i0));
      // this tile's phases (the last ones completed: this consumer waited
      // on them) expect every block's rows of the Y tile and partials of
      // the own rows, which may land before they are armed
      if (wtid == 0) {
        mbar_arrive_expect_tx(&yf[0], C * half_bytes[0]);
        mbar_arrive_expect_tx(&yf[1], C * half_bytes[1]);
        mbar_arrive_expect_tx(&xf[b], 4 * kTileRows);
      }
      // lp_old of an own row, first read after the exchange
      const float lo = wtid < mine ? lp_old[i0 + wtid] : 0.0f;

      // S[:, slice] = Y·L[:, slice] (3xTF32 on wgmma), half the k-steps at
      // a time, each half of the Y tile freed in every block as soon as it
      // is read; then this slice's squares of each row, the sum in all four
      // threads of its quad
      Product<NSUB> prod;
      for (int h = 0; h < 2; ++h) {
        mbar_wait(&yf[h], j & 1);
        if (product) {
          if (h == 0) {
            prod.steps(yrow0, ys0, 0, ks0, lb, ls, 0, sbo);
          } else {
            prod.steps(yrow1, ys1, 0, Kp / 8 - ks0, lb, ls, 256 * ks0, sbo);
          }
        }
        named_bar(1, kWgThreads);
        if (wtid < C) mbar_arrive_cluster(map_rank(smem_addr(&yfree[h]), wtid));
      }
      float q0 = 0.0f, q1 = 0.0f;
      if (product) prod.squares(q0, q1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      // the partials to the blocks that own their rows
      if (t < 2) {
        const int row = 16 * wq + g + 8 * t, owner = row / own;
        const float* at = xb + b * kTileRows + (int)rank * own + row % own;
        st_async_cluster(map_rank(smem_addr(at), owner), t ? q1 : q0,
                         map_rank(smem_addr(&xf[b]), owner));
      }
      float sum = 0.0f;
      if (wtid < own) {
        mbar_wait(&xf[b], (j >> 1) & 1);
        // the c partials of the row, in rank order
        const float* part = xb + b * kTileRows + wtid;
        sum = part[0];
        for (int r = 1; r < C; ++r) sum += part[r * own];
      }
      mbar_wait(&formed[b], (j >> 1) & 1);
      if (wtid < mine) {
        // loads only: lp_new = lp_old, the decision by the factor alone
        const float lp_new = loads_only ? lo : -0.5f * sum;
        const bool accept = stretch_accepts(
            sUe[b * kTileRows + wtid],
            (float)(P - 1) * logf(sZ[b * kTileRows + wtid]), lp_new, lo);
        out_lp[i0 + wtid] = accept ? lp_new : lo;
        out_acc[i0 + wtid] = accept ? 1 : 0;
        sAcc[wtid] = accept ? 1 : 0;
      }
      named_bar(1, kWgThreads);
      // this block's accepted rows get Y
      float* sg = stg + b * own * yrow_floats;
      const HalfRows srows = {sg, sg + own * ys0, 8 * ks0, ys0, ys1};
      for (int r = wq; r < mine; r += 4) {
        if (!sAcc[r]) continue;
        float* dst = out_act + (i0 + r) * P;
        for (int k0 = lane; k0 < P; k0 += 32 * kFormUnroll) {
          float v[kFormUnroll];
#pragma unroll
          for (int u = 0; u < kFormUnroll; ++u) {
            const int kk = k0 + 32 * u;
            v[u] = kk < P ? *srows.at(r, kk) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kFormUnroll; ++u) {
            if (k0 + 32 * u < P) dst[k0 + 32 * u] = v[u];
          }
        }
      }
      named_bar(1, kWgThreads);
      if (wtid == 0) mbar_arrive(&stg_free[b]);
    }
  }
  // no block exits while a peer may still write to its shared memory
  cluster_sync();
}

// The plan of a cluster at P on a device whose blocks may have `optin`
// bytes of shared memory: the smallest cluster size c (kClusterSizes) whose
// block fits its slice of L's halves, the Y tile, two staging buffers of
// its own rows and a ring of at least two stages of 16 or 8 of its own
// rows; false where none fits (on an H100 past P = 296). The Y tile and
// the staging rows are kept as two halves of k-steps, each a whole number
// of the product's groups, the row stride of each ≡ 8 (mod 16) floats.
bool plan_cluster(int P, int optin, Plan* out) {
  if (P < 1) return false;
  for (int c : kClusterSizes) {
    const int nsub = round_up((P + c - 1) / c, 8);
    if (!cluster_width_built(nsub)) continue;
    const int own = kTileRows / c;
    const int kg = product_group(nsub);
    Plan p = {};
    p.P = P;
    p.Kp = round_up(P, 8);
    const int ks = p.Kp / 8;
    p.ks0 = std::max(1, (ks + kg) / (2 * kg)) * kg;
    if (p.ks0 >= ks) p.ks0 = ks;  // one half only: the second is empty
    const int k1 = 8 * (ks - p.ks0);
    p.ystride = 8 * p.ks0 % 16 ? 8 * p.ks0 : 8 * p.ks0 + 8;
    p.ystride1 = k1 % 16 ? k1 : k1 + 8;
    const int row_floats = p.ystride + p.ystride1;
    p.nsub = nsub;
    p.cluster = c;
    int off = 0;
    p.off_l = off;
    off += round_up(4 * 2 * p.Kp * nsub, 128);
    p.off_y = off;
    off += round_up(4 * kTileRows * row_floats, 128);
    p.off_stg = off;
    off += round_up(4 * 2 * own * row_floats, 128);
    p.off_rows = off;
    off += 5 * 4 * kTileRows;
    p.off_xch = off;
    off += 2 * 4 * kTileRows;
    p.off_bar = off;
    off += 8 * (2 * kMaxSlots + 10);
    p.off_ring = round_up(off, 128);
    for (int sr = 16; sr >= 8; sr /= 2) {
      if (sr > own) continue;
      const int area = round_up(sr * P + 10, 4);
      const int slot_bytes = 2 * 4 * area;
      const int slots =
          std::min(kMaxSlots, (optin - p.off_ring) / slot_bytes);
      if (slots >= 2) {
        p.sr = sr;
        p.area = area;
        p.slots = slots;
        p.smem = p.off_ring + slots * slot_bytes;
        *out = p;
        return true;
      }
    }
  }
  return false;
}

// A launch of `blocks` blocks of `threads` threads in clusters of `cluster`
// blocks, on `stream` (used in place: cfg points at attr).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int threads, int smem, int cluster,
                cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The clusters of plan.cluster blocks of `kernel` (`threads` threads, one
// block an SM) that the device holds at once, cached by device in `known`
// as (cluster · 2^20 + smem, count); `asked` is the kernel's opt-in record.
template <typename Kernel>
cudaError_t max_active_clusters(Kernel kernel, int threads, const Plan& plan,
                                bool* asked, int (*known)[2],
                                int* clusters) {
  cudaError_t err = allow_smem(kernel, plan.smem, asked);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int tag = (plan.cluster << 20) + plan.smem;
  if (known[device][0] != tag) {
    ClusterLaunch l(plan.cluster, threads, plan.smem, plan.cluster, nullptr);
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, (void*)kernel, &l.cfg);
    if (err != cudaSuccess) return err;
    known[device][0] = tag;
    known[device][1] = count;
  }
  *clusters = known[device][1];
  return cudaSuccess;
}

// The clusters of `plan` that the device holds at once, cached by device.
template <int NSUB>
cudaError_t active_clusters(const Plan& plan, int* clusters) {
  static bool asked[kMaxDevices] = {};
  static int known[kMaxDevices][2] = {};
  return max_active_clusters(wide_cluster_kernel<NSUB>, kThreadsCluster, plan,
                             asked, known, clusters);
}

template <int NSUB>
cudaError_t launch_cluster(const float* act, const float* lp_old,
                           const float* other, const int* shift,
                           unsigned long long key, const float* prec_chol,
                           float* out_act, float* out_lp, int* out_acc, int n,
                           long long row0, long long m, float a,
                           const Plan& plan, int loads_only,
                           cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = active_clusters<NSUB>(plan, &clusters);
  if (err != cudaSuccess) return err;
  // no cluster of this shape fits the device: refused, no other route
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int grid = std::min(clusters, n_tiles);
  ClusterLaunch l(grid * plan.cluster, kThreadsCluster, plan.smem,
                  plan.cluster, stream);
  err = cudaLaunchKernelEx(&l.cfg, wide_cluster_kernel<NSUB>, act, lp_old,
                           other, shift, key, prec_chol, out_act, out_lp,
                           out_acc, n, row0, m, a, plan, loads_only);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_cluster_planned(const float* act, const float* lp_old,
                                   const float* other, const int* shift,
                                   unsigned long long key,
                                   const float* prec_chol, float* out_act,
                                   float* out_lp, int* out_acc, int n,
                                   long long row0, long long m, float a,
                                   const Plan& plan, int loads_only,
                                   cudaStream_t stream) {
#define MCMCPP_CL(NS)                                                       \
  if (plan.nsub == NS) {                                                    \
    return launch_cluster<NS>(act, lp_old, other, shift, key, prec_chol,    \
                              out_act, out_lp, out_acc, n, row0, m, a, plan, \
                              loads_only, stream);                          \
  }
  MCMCPP_CLUSTER_WIDTHS(MCMCPP_CL)
#undef MCMCPP_CL
  return cudaErrorInvalidValue;
}

cudaError_t cluster_occupancy(const Plan& plan, int* clusters) {
#define MCMCPP_CL(NS) \
  if (plan.nsub == NS) return active_clusters<NS>(plan, clusters);
  MCMCPP_CLUSTER_WIDTHS(MCMCPP_CL)
#undef MCMCPP_CL
  return cudaErrorInvalidValue;
}
#undef MCMCPP_CLUSTER_WIDTHS

// ===========================================================================
// The L-streamed route: L split once a launch, streamed through a multicast
// ring
// ===========================================================================
//
// Past the widths the cluster route takes (P > 296 on an H100) L's halves do
// not fit in shared memory even split over a cluster of 8, but a 64-row Y
// tile still does. So L streams, and the Y tile stays:
// - A prologue kernel of the same launch (split_l_stages) splits L once into
//   its TF32 big and small halves, into scratch the caller allocates, laid
//   out in the order the product reads them: for each column panel of 2·N
//   columns and each chunk of 32 k-rows (four k-steps; 16 and two where the
//   Y tile leaves room for two slots of those only: on an H100 from P = 577
//   at the widest N, from 673 at every N), one stage, the big half then the
//   small half, each in wgmma's K-major core-matrix layout of split_l (k in
//   the k-step's order), zeros past P. Each stage is one contiguous, 16-B
//   aligned run of 512·N (256·N) bytes, so one cp.async.bulk fills it
//   whatever P and L's alignment, and nothing is split again.
// - One block an SM, persistent over 64-row walker tiles. Warp 8, the
//   producer, fills one ring in the order the consumers read it: for each
//   tile the X and partner runs of its rows (the warp-specialised kernel's
//   stages: cp.async.bulk of each run's aligned middle, 4-B cp.async of its
//   head and tail), then L's stages, panels × chunks. The formation and the
//   product are each bound by the latency of their loads, so each gets all
//   of the ring: a slot holds an L stage or as many walker rows as fit it,
//   and the next tile's walker stages land under this tile's last L
//   stages. (Two rings, one for each, measured slower: PERF.md §6.) A
//   row's scalars (z, ue, the consumers' sums, the accept flag) sit in the
//   Y tile's padding columns, which no product reads.
// - The blocks of a cluster of kStreamCluster need the same L stages, so
//   block r issues the r-th part of every stage with cp.async.bulk
//   .multicast::cluster into every block's slot: L is read from L2 once a
//   cluster. A slot is refilled only once the consumers of every block have
//   read it: its empty barrier counts a remote arrival of every consumer
//   warp of the cluster. The full barrier of a slot is armed by its own
//   producer for the whole stage; a peer's part may land first (the
//   transaction count goes below zero until the arming arrival). Every
//   block of a cluster fills the same slots in the same order: every
//   iteration of the cluster has the walker stages of a whole tile (empty
//   ones where a block's rows end or it has no tile) and all L stages.
// - Warps 0–7, two consumer warpgroups, form the tile's Y = p + z·(X − p)
//   into the Y tile (row stride ≡ 8 mod 16 floats, as the warp-specialised
//   kernel's) and write X to the output rows, then walk S's column panels:
//   consumer c takes columns c·N … c·N + N − 1 of each panel of 2·N, a
//   stage's k-steps at a time, 3xTF32 wgmma m64nNk8 with A from the Y tile
//   (split in registers) and B from the staged halves, into a partial that
//   the stage's first wgmma zeroes and an fp32 add puts into S (Product).
//   When a panel's chunks are done its columns are squared into the rows'
//   sums; a row's sum is consumer 0's plus consumer 1's, each over its
//   columns in panel order: one order whatever block, cluster or iteration
//   takes the tile, so row shards equal one launch bit for bit.
// - N (48–80) is the built width whose panels cover P with the fewest
//   padding columns (P = 297: 80; 384, 512: 64; 704: 72; 784: 56).
// - What bounds it: the 3xTF32 product (past P ≈ 296 above the bytes), and
//   each SM's intake of L, 8·P² bytes a tile for 384·P² FLOP: ~78 GB/s into
//   every SM at the tensor cores' rate. With one Y tile the next tile's
//   formation waits for this one's last panel; only the walker ring's loads
//   run under the product.

// k-steps of 8 in a stage of L: four where the plan fits such stages,
// else two (plan_stream)
constexpr int kStreamKcs[] = {4, 2};
// consumer warpgroups on the one Y tile, each with half of every panel
constexpr int kStreamConsumers = 2;
// warps 0–7 the consumers, 8 the producer
constexpr int kThreadsStream = kStreamConsumers * kWgThreads + 32;
// blocks of a cluster that share every L stage
constexpr int kStreamCluster = 2;

// A consumer's wgmma N on the L-streamed route.
#define MCMCPP_STREAM_WIDTHS(X) X(80) X(72) X(64) X(56) X(48)

// The built N whose panels of 2·N columns cover P with the fewest columns,
// the wider of a tie.
int stream_width(int P) {
  int best = 0, best_cols = 0;
#define MCMCPP_SW(NS)                                        \
  {                                                          \
    const int cols = 2 * NS * ((P + 2 * NS - 1) / (2 * NS)); \
    if (best == 0 || cols < best_cols) {                     \
      best = NS;                                             \
      best_cols = cols;                                      \
    }                                                        \
  }
  MCMCPP_STREAM_WIDTHS(MCMCPP_SW)
#undef MCMCPP_SW
  return best;
}

// The prologue: L's halves into `out` in the stage order of the L-streamed
// and the K-split routes (stage s = panel·chunks + chunk: the big half, then
// the small half, each krows k-rows × `cols` columns in split_l's layout),
// `total` elements of a half in all. A panel is 2·N columns on the
// L-streamed route (two consumers' halves), N on the K-split route.
__global__ void split_l_stages(const float* __restrict__ L, int P, int cols,
                               int krows, int chunks, int total,
                               float* __restrict__ out) {
  const int half = krows * cols;  // floats of a stage's half
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int s = e / half, rem = e - s * half;
    const int pn = s / chunks, ch = s - pn * chunks;
    const int nb = rem / (8 * krows), w = rem - nb * (8 * krows);
    const int kl = (w >> 5) * 4 + (w & 3), r = (w >> 2) & 7;
    const int j = kl & 7;
    const int k = ch * krows + (kl & ~7) + (j < 4 ? 2 * j : 2 * (j - 4) + 1);
    const int col = pn * cols + nb * 8 + r;
    const float v = k < P && col < P ? L[(long long)k * P + col] : 0.0f;
    unsigned b, sm;
    split_tf32(v, b, sm);
    float* st = out + (size_t)s * 2 * half;
    st[rem] = __uint_as_float(b);
    st[half + rem] = __uint_as_float(sm);
  }
}

template <int NSUB, int KC>
__global__ void __launch_bounds__(kThreadsStream, 1)
wide_stream_kernel(const float* __restrict__ act,
                   const float* __restrict__ lp_old,
                   const float* __restrict__ other,
                   const int* __restrict__ shift, unsigned long long key,
                   const float* __restrict__ lsplit,
                   float* __restrict__ out_act, float* __restrict__ out_lp,
                   int* __restrict__ out_acc, int n, long long row0,
                   long long m, float a, const Plan plan, int loads_only) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kKRows = 8 * KC;  // k-rows of a stage of L
  const int P = plan.P, Kp = plan.Kp, ys = plan.ystride;
  const int SR = plan.sr, S = plan.slots, C = plan.cluster;
  const int chunks = Kp / kKRows;
  const int n_stages = plan.panels * chunks;           // L stages a tile
  const int w_stages = (kTileRows + SR - 1) / SR;      // walker stages a tile
  const unsigned slot_bytes = plan.lstage;
  float* yt = reinterpret_cast<float*>(smem + plan.off_y);
  unsigned char* ring = smem + plan.off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* empty = full + kMaxSlots;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned rank = cluster_rank();
  const long long cid = cluster_index(), ncl = cluster_count();
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const int sh = *shift;
  constexpr int kConsumerWarps = 4 * kStreamConsumers;
  constexpr int kThreadsC = kStreamConsumers * kWgThreads;
  // a tile row's scalars, in its padding columns Kp … Kp + 7, which no
  // product reads: z, ue, consumer 0's and 1's sum of squares, the accept
  // flag
  auto row_at = [&](int r) { return yt + r * ys + Kp; };

  if (tid == 0) {
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&full[s], 1);
      // every consumer warp of every block of the cluster
      mbar_init(&empty[s], kConsumerWarps * C);
    }
    mbar_init_fence();
  }
  // the Y tile zeroed once: its columns past P stay zero
  for (int e = tid; e < kTileRows * ys; e += blockDim.x) yt[e] = 0.0f;
  __syncthreads();
  // every block's barriers exist before a peer's copy or arrival reaches them
  cluster_sync();

  if (warp == kConsumerWarps) {
    // ---------------- producer: every stage, in the consumers' order -----
    // Each cluster iteration: the tile's walker stages (empty ones where its
    // rows end, so every block of the cluster fills the same slots in the
    // same order), then L's stages, this block's part multicast to all.
    const unsigned part = slot_bytes / C;
    const unsigned short mask = (unsigned short)((1u << C) - 1);
    const unsigned char* lsrc =
        reinterpret_cast<const unsigned char*>(lsplit) + rank * part;
    int g = 0;
    for (long long j = 0; (j * ncl + cid) * C < n_tiles; ++j) {
      const long long tile = (j * ncl + cid) * C + rank;
      const long long i0 = tile * kTileRows;
      const int rows =
          tile < n_tiles ? (int)min((long long)kTileRows, (long long)n - i0)
                         : 0;
      for (int st = 0; st < w_stages; ++st, ++g) {
        const int slot = g % S, round = g / S;
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        const int rs = min(SR, rows - st * SR);
        if (rs <= 0) {
          if (lane == 0) mbar_arrive(&full[slot]);
          continue;
        }
        const Stage w = stage_at(act, other, i0 + st * SR, rs, row0, sh, m, P);
        float* ax = reinterpret_cast<float*>(ring + (size_t)slot * slot_bytes);
        float* ap = ax + plan.area;
        fill(&full[slot], lane, ax + w.xo, w.x, rs * P, ap + w.pao, w.pa,
             w.r1 * P, ap + w.pbo, other, (rs - w.r1) * P);
      }
      for (int s = 0; s < n_stages; ++s, ++g) {
        const int slot = g % S, round = g / S;
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[slot], slot_bytes);
          bulk_load_multicast(ring + (size_t)slot * slot_bytes + rank * part,
                              lsrc + (size_t)s * slot_bytes, part, &full[slot],
                              mask);
        }
        __syncwarp();
      }
    }
    cp_async_wait_all();
  } else if (warp < kConsumerWarps) {
    // ---------------- consumers ----------------
    const int ci = warp >> 2, wq = warp & 3, ct = tid;  // ct: 0 … 255
    const int g = lane >> 2, t = lane & 3;
    const float* yrow = yt + (16 * wq + g) * ys + 2 * t;
    // this consumer's n-blocks of 8 columns in a stage's half (each kKRows
    // k-rows × 8 columns), the small half after the big
    constexpr unsigned kNBlock = kKRows * 8 * 4;
    const unsigned lbase = smem_addr(ring) + ci * (NSUB / 8) * kNBlock;
    const unsigned half = slot_bytes / 2;
    // a stage read: freed in every block of the cluster
    auto release = [&](int slot) {
      __syncwarp();
      if (lane < C) {
        mbar_arrive_cluster(map_rank(smem_addr(&empty[slot]), lane));
      }
    };
    int g_at = 0;
    for (long long j = 0; (j * ncl + cid) * C < n_tiles; ++j) {
      const long long tile = (j * ncl + cid) * C + rank;
      const bool has = tile < n_tiles;
      const long long i0 = has ? tile * kTileRows : 0;
      const int rows =
          has ? (int)min((long long)kTileRows, (long long)n - i0) : 0;
      // lp_old is loaded here and first read after the product
      const float lo = ct < rows ? lp_old[i0 + ct] : 0.0f;
      if (ct < rows) {
        const float2 uu =
            unit_uniforms(key, (unsigned long long)(row0 + i0 + ct));
        row_at(ct)[0] = stretch_z(uu.x, a);
        row_at(ct)[1] = uu.y;
      }
      named_bar(1, kThreadsC);

      // the proposal rows into the Y tile, X into the output rows
      for (int st = 0; st < w_stages; ++st, ++g_at) {
        const int slot = g_at % S;
        mbar_wait(&full[slot], (g_at / S) & 1);
        const int rs = min(SR, rows - st * SR);
        if (rs > 0) {
          const Stage sg =
              stage_at(act, other, i0 + st * SR, rs, row0, sh, m, P);
          const float* ax =
              reinterpret_cast<const float*>(ring + (size_t)slot * slot_bytes);
          const float* xs = ax + sg.xo;
          const float* pa = ax + plan.area + sg.pao;
          const float* pb = ax + plan.area + sg.pbo;
          const int split = sg.r1 * P;
          float* out = out_act + (i0 + st * SR) * P;
          float* ydst = yt + st * SR * ys;
          for (TileWalk<1> w(P, ct, kThreadsC); w.e < rs * P; w.next(P)) {
            const float x = xs[w.e];
            const float p = w.e < split ? pa[w.e] : pb[w.e - split];
            float* yr = ydst + w.row * ys;
            yr[w.k] = fmaf(yr[Kp], x - p, p);
            out[w.e] = x;
          }
        }
        release(slot);
      }
      named_bar(1, kThreadsC);

      // S = Y·L panel by panel (3xTF32 on wgmma), each panel's columns
      // squared into the rows' sums when its chunks are done
      const bool product = has && !loads_only;
      float q0 = 0.0f, q1 = 0.0f;
      for (int pn = 0; pn < plan.panels; ++pn) {
        Product<NSUB> prod;
        for (int ch = 0; ch < chunks; ++ch, ++g_at) {
          const int slot = g_at % S;
          mbar_wait(&full[slot], (g_at / S) & 1);
          if (product) {
            const unsigned lb = lbase + slot * slot_bytes;
            prod.template group<KC>(yrow, ys, kKRows * ch, lb, lb + half, 0,
                                    kNBlock);
          }
          release(slot);
        }
        if (product) prod.squares(q0, q1);
      }
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      if (t == 0) {
        row_at(16 * wq + g)[2 + ci] = q0;
        row_at(16 * wq + g + 8)[2 + ci] = q1;
      }
      named_bar(1, kThreadsC);

      if (ct < rows) {
        float* rv = row_at(ct);
        // loads only: lp_new = lp_old, the decision by the factor alone
        const float lp_new = loads_only ? lo : -0.5f * (rv[2] + rv[3]);
        const bool accept =
            stretch_accepts(rv[1], (float)(P - 1) * logf(rv[0]), lp_new, lo);
        out_lp[i0 + ct] = accept ? lp_new : lo;
        out_acc[i0 + ct] = accept ? 1 : 0;
        rv[4] = accept ? 1.0f : 0.0f;
      }
      named_bar(1, kThreadsC);
      // the accepted rows get Y
      float* out = out_act + i0 * P;
      for (TileWalk<1> w(P, ct, kThreadsC); w.e < rows * P; w.next(P)) {
        const float* yr = yt + w.row * ys;
        if (yr[Kp + 4] != 0.0f) out[w.e] = yr[w.k];
      }
    }
  }
  // no block exits while a peer may still copy into its shared memory or
  // arrive on its barriers
  cluster_sync();
}

// The plan of the L-streamed route at P on a device whose blocks may have
// `optin` bytes of shared memory: the Y tile of 64 rows (each row's scalars
// in its padding columns) and one ring of at least two slots, each an L
// stage of four k-steps where such a ring fits, else of two (at most
// kMaxSlots slots); a walker stage takes as many rows (at most 64) as its
// X and partner runs fit a slot. False where none fits.
bool plan_stream(int P, int optin, Plan* out) {
  if (P < 1) return false;
  Plan p = {};
  p.P = P;
  p.nsub = stream_width(P);
  p.cluster = kStreamCluster;
  p.panels = (P + 2 * p.nsub - 1) / (2 * p.nsub);
  for (int kc : kStreamKcs) {
    p.lkc = kc;
    p.Kp = round_up(P, 8 * kc);
    p.ystride = p.Kp + 8;  // Kp ≡ 0 (mod 16): ≡ 8, and room for 8 scalars
    p.lstage = 2 * 4 * 8 * kc * 2 * p.nsub;
    p.off_y = 0;
    p.off_bar = 4 * kTileRows * p.ystride;
    p.off_ring = round_up(p.off_bar + 8 * 2 * kMaxSlots, 128);
    const int slots =
        std::min(kMaxSlots, (optin - p.off_ring) / p.lstage);
    // X and partner areas of round_up(sr·P + 10, 4) floats each in a slot
    const int sr = std::min(kTileRows, (p.lstage / 8 - 13) / P);
    if (slots >= 2 && sr >= 1) {
      p.slots = slots;
      p.sr = sr;
      p.area = round_up(sr * P + 10, 4);
      p.smem = p.off_ring + slots * p.lstage;
      *out = p;
      return true;
    }
  }
  return false;
}

// Bytes of the scratch that holds L's split stages (the L-streamed and the
// K-split routes).
size_t stream_scratch_bytes(const Plan& plan) {
  return (size_t)plan.panels * (plan.Kp / (8 * plan.lkc)) * plan.lstage;
}

// The prologue alone: L's split stages into `scratch` (a stage's columns:
// its bytes over the two halves' 4-B elements of 8·lkc k-rows).
cudaError_t split_for_stream(const float* prec_chol, const Plan& plan,
                             float* scratch, cudaStream_t stream) {
  const int total = (int)(stream_scratch_bytes(plan) / 8);
  const int blocks = std::min((total + 255) / 256, 1024);
  split_l_stages<<<blocks, 256, 0, stream>>>(
      prec_chol, plan.P, plan.lstage / (64 * plan.lkc), 8 * plan.lkc,
      plan.Kp / (8 * plan.lkc), total, scratch);
  return cudaGetLastError();
}

template <int NSUB, int KC>
cudaError_t stream_clusters(const Plan& plan, int* clusters) {
  static bool asked[kMaxDevices] = {};
  static int known[kMaxDevices][2] = {};
  return max_active_clusters(wide_stream_kernel<NSUB, KC>, kThreadsStream,
                             plan, asked, known, clusters);
}

template <int NSUB, int KC>
cudaError_t launch_stream(const float* act, const float* lp_old,
                          const float* other, const int* shift,
                          unsigned long long key, const float* prec_chol,
                          float* out_act, float* out_lp, int* out_acc, int n,
                          long long row0, long long m, float a,
                          const Plan& plan, float* scratch, int loads_only,
                          cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = stream_clusters<NSUB, KC>(plan, &clusters);
  if (err != cudaSuccess) return err;
  // no cluster of this shape fits the device: refused, no other route
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = split_for_stream(prec_chol, plan, scratch, stream);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int grid =
      std::min(clusters, (n_tiles + plan.cluster - 1) / plan.cluster);
  ClusterLaunch l(grid * plan.cluster, kThreadsStream, plan.smem,
                  plan.cluster, stream);
  err = cudaLaunchKernelEx(&l.cfg, wide_stream_kernel<NSUB, KC>, act, lp_old,
                           other, shift, key, (const float*)scratch, out_act,
                           out_lp, out_acc, n, row0, m, a, plan, loads_only);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_stream_planned(const float* act, const float* lp_old,
                                  const float* other, const int* shift,
                                  unsigned long long key,
                                  const float* prec_chol, float* out_act,
                                  float* out_lp, int* out_acc, int n,
                                  long long row0, long long m, float a,
                                  const Plan& plan, float* scratch,
                                  int loads_only, cudaStream_t stream) {
#define MCMCPP_ST(NS)                                                        \
  if (plan.nsub == NS) {                                                     \
    return plan.lkc == 4                                                     \
               ? launch_stream<NS, 4>(act, lp_old, other, shift, key,        \
                                      prec_chol, out_act, out_lp, out_acc,   \
                                      n, row0, m, a, plan, scratch,          \
                                      loads_only, stream)                    \
               : launch_stream<NS, 2>(act, lp_old, other, shift, key,        \
                                      prec_chol, out_act, out_lp, out_acc,   \
                                      n, row0, m, a, plan, scratch,          \
                                      loads_only, stream);                   \
  }
  MCMCPP_STREAM_WIDTHS(MCMCPP_ST)
#undef MCMCPP_ST
  return cudaErrorInvalidValue;
}

cudaError_t stream_occupancy(const Plan& plan, int* clusters) {
#define MCMCPP_ST(NS)                                                 \
  if (plan.nsub == NS) {                                              \
    return plan.lkc == 4 ? stream_clusters<NS, 4>(plan, clusters)     \
                         : stream_clusters<NS, 2>(plan, clusters);    \
  }
  MCMCPP_STREAM_WIDTHS(MCMCPP_ST)
#undef MCMCPP_ST
  return cudaErrorInvalidValue;
}
#undef MCMCPP_STREAM_WIDTHS

// ===========================================================================
// The K-split route: the product's K split over a thread-block cluster
// ===========================================================================
//
// Past the widths the L-streamed route takes (P > 784 on an H100) its 64-row
// Y tile no longer fits beside two slots of its ring. Here a cluster of c
// blocks (4, or 8 where a block of 4 does not fit three ring slots beside
// panels of N >= 64: on an H100 from P = 1025) shares a tile of 128
// walker rows by splitting the product's K, so that each block keeps only a
// k-slice of the tile's Y:
// - The clusters are persistent: cluster q walks tiles q, q + Q, …, every
//   block of it the same tile at the same time. Block r holds columns
//   k0(r) … k1(r) − 1 of the tile's 128 proposal rows: whole chunks of
//   8·KC k-rows (KC = 4 k-steps, 2 where only those fit), chunks/c each,
//   the first chunks % c blocks one more, at route 0's bank-safe row stride
//   (≡ 8 mod 16 floats). The slice's padding columns hold each row's
//   scalars, which no product reads.
// - A prologue of the same launch (split_l_stages, as on the L-streamed
//   route) splits L once into its TF32 halves, in scratch the caller
//   allocates, one stage for each column panel of N columns and each chunk
//   of k-rows: one contiguous, 16-B aligned run, one cp.async.bulk a stage.
//   The blocks read different rows of L, so nothing is multicast; the split
//   L (8 MB at P = 1000) stays in the 50 MB L2.
// - Warp 8, the producer, fills one ring in the consumers' order: the
//   tile's walker stages (this block's slice of each X row and of its
//   partner row: one run a row and array, a producer lane each, its 16-B
//   aligned middle by cp.async.bulk and its head and tail by 4-B cp.async,
//   at the source's offset from 16 B in the slot), then for each panel the
//   block's L stages.
// - Warps 0–7, two consumer warpgroups, form the slice of Y = p + z·(X − p)
//   (z drawn by every block for all 128 rows, z and ue by the reducer for
//   its own: Philox needs no exchange) and write the X slice to the output
//   rows (as if rejected);
//   then each takes 64 rows of every panel: S_r = Y[:, slice r]·L[slice r,
//   panel] as 3xTF32 wgmma m64nNk8, A from the Y slice split in registers,
//   B from the staged halves, a partial a stage added into S_r (Product).
//   Both read every L stage, so each byte of L that enters an SM serves 128
//   walkers.
// - The partial products are reduced in distributed shared memory: block r
//   owns rows 128·r/c … 128·(r + 1)/c − 1 of the tile. After each panel
//   every consumer warp stores its fragment of S_r (16 rows × N) into the
//   owner's exchange area by st.async (16 B a store, in the fragment's
//   layout), completing as transaction bytes on the owner's mbarrier; a
//   warp sends the next panel only once every owner has read this one (a
//   barrier of c remote arrivals). Warp 9, the owner's reducer, adds the c
//   partials of each element in rank order, S = ((S_0 + S_1) + S_2) + …,
//   whatever its own rank, and squares the panel's columns into its rows'
//   sums in the consumers' order (Product::squares): one order whatever
//   cluster takes the tile, so row shards equal one launch bit for bit. It
//   issues an element's c loads before adding them.
// - After the last panel the reducer decides its rows, writes their logp
//   and flag, and stores the accept flags into every block of the cluster
//   (st.async on each block's barrier); each block then writes its slice of
//   the accepted rows' Y.
// - What bounds it: the 3xTF32 product (n·6P² FLOP); an SM takes in
//   8·P²/c bytes of L per tile for 768·P²/c FLOP, half the L-streamed
//   route's intake per FLOP. What holds it back (PERF.md §6): the
//   ring's handshake a stage, both consumer warpgroups with the producer
//   (the wgmma loop alone reaches 62–75% of the bound, with the handshakes
//   but no data 48–51%), the exchange's round trip a panel, and a tile's
//   formation, which waits for the last tile's product (one Y slice).

// cluster sizes the plan tries, smallest first, and the ring slots each
// needs: clusters of 4 only with three slots or more (PERF.md §6)
constexpr int kKsplitClusters[] = {4, 8};
constexpr int kKsplitMinSlots[] = {3, 2};
// walker rows of a cluster's tile: two consumer warpgroups' wgmma M
constexpr int kKsplitRows = 2 * kTileRows;
// consumer warps (two warpgroups), then the producer and the reducer warps
constexpr int kKsplitConsumerWarps = 8;
constexpr int kThreadsKsplit = 32 * kKsplitConsumerWarps + 64;
// walker rows a stage at most: a producer lane for each row's X run and
// one for its partner run
constexpr int kKsplitMaxStageRows = 16;

// The wgmma N (a panel's columns) of the K-split route; the plan tries
// those of at least kKsplitWideN with either cluster size before a
// narrower one (N = 48 measured slower than a cluster of 8 with N = 80 on
// an H100 at P = 1100–1280, where a cluster of 4 fits only N <= 56 in
// three slots; PERF.md §6).
#define MCMCPP_KSPLIT_WIDTHS(X) X(80) X(72) X(64) X(56) X(48)
constexpr int kKsplitWidths[] = {80, 72, 64, 56, 48};
constexpr int kKsplitWideN = 64;

// The head and tail of a run of `count` floats (or all of it where it has
// no 16-B aligned middle) by 4-B cp.async from this lane; returns the bytes
// of the middle, which piece_bulk copies. dst ≡ src (mod 16 B).
__device__ __forceinline__ unsigned run_scalars(float* dst, const float* src,
                                                int count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = a + 4ull * (unsigned)count;
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, b16 = b & ~(uintptr_t)15;
  const bool bulk = b16 > a16;
  const int head = bulk ? (int)((a16 - a) >> 2) : count;
  const int tail = bulk ? (int)((b - b16) >> 2) : 0;
  for (int e = 0; e < head; ++e) cp_async4_to(dst + e, src + e);
  for (int e = count - tail; e < count; ++e) cp_async4_to(dst + e, src + e);
  return bulk ? (unsigned)(b16 - a16) : 0u;
}

// The reducer's sum of one panel's partials of its FRAGS fragments (16 rows
// × NJ·8 columns each, in the consumers' fragment layout: `area` at this
// lane's 4 floats), C blocks' in rank order, ((S_0 + S_1) + S_2) + …, each
// square folded into the rows' sums in the consumers' order
// (Product::squares). The C loads of an element are issued before its sum.
template <int C, int FRAGS, int NJ>
__device__ __forceinline__ void reduce_partials(const float* area,
                                                float (&qs)[2][2]) {
#pragma unroll
  for (int f = 0; f < FRAGS; ++f) {
#pragma unroll 3
    for (int j = 0; j < NJ; ++j) {
      float4 v[C];
#pragma unroll
      for (int r = 0; r < C; ++r) {
        v[r] = *reinterpret_cast<const float4*>(
            area + ((r * FRAGS + f) * NJ + j) * 128);
      }
      float4 s = v[0];
#pragma unroll
      for (int r = 1; r < C; ++r) {
        s.x += v[r].x;
        s.y += v[r].y;
        s.z += v[r].z;
        s.w += v[r].w;
      }
      qs[f][0] = fmaf(s.x, s.x, qs[f][0]);
      qs[f][0] = fmaf(s.y, s.y, qs[f][0]);
      qs[f][1] = fmaf(s.z, s.z, qs[f][1]);
      qs[f][1] = fmaf(s.w, s.w, qs[f][1]);
    }
  }
}

template <int NSUB, int KC>
__global__ void __launch_bounds__(kThreadsKsplit, 1)
wide_ksplit_kernel(const float* __restrict__ act,
                   const float* __restrict__ lp_old,
                   const float* __restrict__ other,
                   const int* __restrict__ shift, unsigned long long key,
                   const float* __restrict__ lsplit,
                   float* __restrict__ out_act, float* __restrict__ out_lp,
                   int* __restrict__ out_acc, int n, long long row0,
                   long long m, float a, const Plan plan, int loads_only) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kKRows = 8 * KC;         // k-rows of a chunk (an L stage)
  constexpr int kJ = NSUB / 8;           // 8-column blocks of a panel
  constexpr int kThreadsC = 32 * kKsplitConsumerWarps;
  const int P = plan.P, ys = plan.ystride, C = plan.cluster;
  const int S = plan.slots, SR = plan.sr, area = plan.area;
  const int pad = ys - 8;  // a row's scalars: z, its runs' offsets, its flag
  const int chunks = plan.Kp / kKRows;
  const unsigned rank = cluster_rank();
  const long long cid = cluster_index(), ncl = cluster_count();
  // this block's chunks of K: chunks / C, the first chunks % C blocks one
  // more
  const int q = chunks / C, rem = chunks % C;
  const int c0 = (int)rank * q + min((int)rank, rem);
  const int my_chunks = q + ((int)rank < rem ? 1 : 0);
  const int k0 = c0 * kKRows;                       // the slice's first column
  const int wr = min(P - k0, my_chunks * kKRows);   // its columns below P
  const int own = kKsplitRows / C;                  // rows a block owns
  const int frags = own / 16;                       // their 16-row fragments
  const long long n_tiles = (n + kKsplitRows - 1) / kKsplitRows;
  const unsigned slot_bytes = plan.lstage;
  // partials of one panel an owner receives: c blocks × its rows × N
  const unsigned xbytes = 4u * kKsplitRows * NSUB;
  float* yt = reinterpret_cast<float*>(smem + plan.off_y);
  // [rank][fragment][kJ][32 lanes][4]
  float* xch = reinterpret_cast<float*>(smem + plan.off_xch);
  unsigned char* ring = smem + plan.off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* empty = full + kMaxSlots;
  uint64_t* xfull = empty + kMaxSlots;  // a panel's partials of the own rows
  uint64_t* xfree = xfull + 1;          // every owner has read a panel's
  uint64_t* flagged = xfree + 1;        // the tile's accept flags landed
  auto row_at = [&](int r) { return yt + r * ys + pad; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kKsplitConsumerWarps);
    }
    mbar_init(xfull, 1);
    mbar_init(xfree, C);  // the reducer of every block
    mbar_init(flagged, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(xfull, xbytes);  // the first panel's partials
  }
  // the Y slice zeroed once: its columns past P stay zero
  for (int e = tid; e < kKsplitRows * ys; e += blockDim.x) yt[e] = 0.0f;
  __syncthreads();
  // every block's barriers exist before a peer's store or arrival reaches
  // them
  cluster_sync();

  if (warp == kKsplitConsumerWarps) {
    // ---------------- producer: every stage, in the consumers' order -----
    const int sh = *shift;
    const unsigned char* lsrc = reinterpret_cast<const unsigned char*>(lsplit);
    int g = 0;
    for (long long tile = cid; tile < n_tiles; tile += ncl) {
      const long long i0 = tile * kKsplitRows;
      const int rows = (int)min((long long)kKsplitRows, (long long)n - i0);
      for (int st = 0; st * SR < rows; ++st, ++g) {
        const int slot = g % S, round = g / S;
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        const int rs = min(SR, rows - st * SR);
        float* ax = reinterpret_cast<float*>(ring + (size_t)slot * slot_bytes);
        // lane l < rs: the X run of the stage's row l; rs <= l < 2·rs: the
        // partner run of row l − rs
        const bool mine = lane < 2 * rs;
        const bool part = lane >= rs;
        const int r = part ? lane - rs : lane;
        const float* src = nullptr;
        float* dst = nullptr;
        unsigned bytes = 0;
        if (mine) {
          const long long gr = i0 + st * SR + r;
          src = part ? other + partner_row(row0 + gr, sh, m) * P + k0
                     : act + gr * P + k0;
          dst = ax + (part ? SR + r : r) * area + align_off(src);
          bytes = run_scalars(dst, src, wr);
        }
        cp_async_arrive(&full[slot]);
        const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
        if (lane == 0) mbar_arrive_expect_tx(&full[slot], total);
        __syncwarp();
        if (mine) piece_bulk(dst, src, wr, &full[slot]);
      }
      for (int pn = 0; pn < plan.panels; ++pn) {
        const unsigned char* stages =
            lsrc + ((size_t)pn * chunks + c0) * slot_bytes;
        for (int ch = 0; ch < my_chunks; ++ch, ++g) {
          const int slot = g % S, round = g / S;
          if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[slot], slot_bytes);
            bulk_load(ring + (size_t)slot * slot_bytes,
                      stages + (size_t)ch * slot_bytes, slot_bytes,
                      &full[slot]);
          }
          __syncwarp();
        }
      }
    }
    cp_async_wait_all();
  } else if (warp == kKsplitConsumerWarps + 1) {
    // ---------------- reducer: the partials of this block's rows ---------
    const int g = lane >> 2, t = lane & 3;
    const int first = (int)rank * own;  // this block's rows of a tile
    int panel = 0;
    for (long long tile = cid; tile < n_tiles; tile += ncl) {
      const long long i0 = tile * kKsplitRows;
      const int rows = (int)min((long long)kKsplitRows, (long long)n - i0);
      // rows first + 16f + g (h = 0) and + 8 (h = 1) of fragment f
      float qs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int pn = 0; pn < plan.panels; ++pn, ++panel) {
        mbar_wait(xfull, panel & 1);
        if (C == 4) {
          reduce_partials<4, 2, kJ>(xch + lane * 4, qs);
        } else {
          reduce_partials<8, 1, kJ>(xch + lane * 4, qs);
        }
        __syncwarp();
        // the next panel's partials may land from now on
        if (lane == 0) mbar_arrive_expect_tx(xfull, xbytes);
        if (lane < C) mbar_arrive_cluster(map_rank(smem_addr(xfree), lane));
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          qs[f][h] += __shfl_xor_sync(0xffffffffu, qs[f][h], 1);
          qs[f][h] += __shfl_xor_sync(0xffffffffu, qs[f][h], 2);
        }
      }
      if (t == 0) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (f >= frags) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = first + 16 * f + g + 8 * h;
            float flag = 0.0f;
            if (r < rows) {
              const long long i = i0 + r;
              const float lo = lp_old[i];
              // z and ue drawn here too: the same Philox words as the
              // consumers'
              const float2 uu =
                  unit_uniforms(key, (unsigned long long)(row0 + i));
              // loads only: lp_new = lp_old, the decision by the factor
              // alone
              const float lp_new = loads_only ? lo : -0.5f * qs[f][h];
              const bool accept = stretch_accepts(
                  uu.y, (float)(P - 1) * logf(stretch_z(uu.x, a)), lp_new, lo);
              out_lp[i] = accept ? lp_new : lo;
              out_acc[i] = accept ? 1 : 0;
              flag = accept ? 1.0f : 0.0f;
            }
            const unsigned at = smem_addr(row_at(r) + 2);
            for (int b = 0; b < C; ++b) {
              st_async_cluster(map_rank(at, b), flag,
                               map_rank(smem_addr(flagged), b));
            }
          }
        }
      }
      __syncwarp();
    }
  } else {
    // ---------------- consumers ----------------
    const int ci = warp >> 2, wq = warp & 3, ct = tid;  // ct: 0 … 255
    const int g = lane >> 2, t = lane & 3;
    const float* yrow = yt + (kTileRows * ci + 16 * wq + g) * ys + 2 * t;
    // a stage's n-blocks of 8 columns (kKRows k-rows each), the small half
    // after the big
    constexpr unsigned kNBlock = kKRows * 8 * 4;
    const unsigned half = slot_bytes / 2;
    // this warp's rows go to the block that owns them: the slot of this
    // block's rank, the fragment of those rows
    const int owner = 16 * warp / own, f = 16 * warp % own / 16;
    const unsigned xdst = map_rank(
        smem_addr(xch + (((size_t)rank * frags + f) * kJ) * 128 + lane * 4),
        owner);
    const unsigned xbar = map_rank(smem_addr(xfull), owner);
    const int sh = *shift;
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    };
    int g_at = 0, panel = 0, j = 0;
    for (long long tile = cid; tile < n_tiles; tile += ncl, ++j) {
      const long long i0 = tile * kKsplitRows;
      const int rows = (int)min((long long)kKsplitRows, (long long)n - i0);
      // the flags of this tile, which the owners store
      if (ct == 0) mbar_arrive_expect_tx(flagged, 4 * kKsplitRows);
      if (ct < rows) {
        const long long gr = i0 + ct;
        const float2 uu = unit_uniforms(key, (unsigned long long)(row0 + gr));
        float* rv = row_at(ct);
        rv[0] = stretch_z(uu.x, a);
        // the row's X and partner runs' offsets from 16 B in the slot
        const float* p = other + partner_row(row0 + gr, sh, m) * P + k0;
        rv[1] = __int_as_float(align_off(act + gr * P + k0) +
                               4 * align_off(p));
      }
      named_bar(1, kThreadsC);

      // this block's slice of the proposal rows into the Y slice, of X
      // into the output rows
      for (int st = 0; st * SR < rows; ++st, ++g_at) {
        const int slot = g_at % S;
        mbar_wait(&full[slot], (g_at / S) & 1);
        const int rs = min(SR, rows - st * SR);
        const float* ax =
            reinterpret_cast<const float*>(ring + (size_t)slot * slot_bytes);
        float* out = out_act + (i0 + st * SR) * P + k0;
        for (TileWalk<1> w(wr, ct, kThreadsC); w.e < rs * wr; w.next(wr)) {
          float* yr = yt + (st * SR + w.row) * ys;
          const int offs = __float_as_int(yr[pad + 1]);
          const float x = ax[w.row * area + (offs & 3) + w.k];
          const float p = ax[(SR + w.row) * area + (offs >> 2) + w.k];
          yr[w.k] = fmaf(yr[pad], x - p, p);
          out[(long long)w.row * P + w.k] = x;
        }
        release(slot);
      }
      named_bar(1, kThreadsC);

      // S_r = Y[:, slice]·L[slice, panel] panel by panel (3xTF32 on wgmma),
      // each panel's partial sent to the rows' owners
      for (int pn = 0; pn < plan.panels; ++pn, ++panel) {
        Product<NSUB> prod;
        for (int ch = 0; ch < my_chunks; ++ch, ++g_at) {
          const int slot = g_at % S;
          mbar_wait(&full[slot], (g_at / S) & 1);
          if (!loads_only) {
            const unsigned lb = smem_addr(ring) + slot * slot_bytes;
            prod.template group<KC>(yrow, ys, kKRows * ch, lb, lb + half, 0,
                                    kNBlock);
          }
          release(slot);
        }
        // every owner has read the last panel's partials
        if (panel > 0) mbar_wait(xfree, (panel - 1) & 1);
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          st_async_cluster_v4(xdst + 512 * jj, prod.acc[4 * jj],
                              prod.acc[4 * jj + 1], prod.acc[4 * jj + 2],
                              prod.acc[4 * jj + 3], xbar);
        }
      }

      // the accepted rows get this block's slice of Y
      mbar_wait(flagged, j & 1);
      float* out = out_act + i0 * P + k0;
      for (TileWalk<1> w(wr, ct, kThreadsC); w.e < rows * wr; w.next(wr)) {
        const float* yr = yt + w.row * ys;
        if (yr[pad + 2] != 0.0f) out[(long long)w.row * P + w.k] = yr[w.k];
      }
      named_bar(1, kThreadsC);
    }
  }
  // no block exits while a peer may still store into its shared memory or
  // arrive on its barriers
  cluster_sync();
}

// The K-split route's plan at P with L stages of kc k-steps, clusters of
// kKsplitClusters[ci] blocks and panels of nsub columns, on a device whose
// blocks may have `optin` bytes of shared memory: each block holds its Y
// slice of 128 rows (the widest slice, ⌈chunks / c⌉ chunks; a row's
// scalars in its padding), the exchange area of one panel's partials of its
// own rows (c · 128/c rows × N floats) and one ring of at least
// kKsplitMinSlots[ci] slots, each an L stage (at most kMaxSlots); a walker
// stage takes as many rows (at most kKsplitMaxStageRows) as their X and
// partner runs fit a slot. False where they do not fit.
bool plan_ksplit_at(int P, int optin, int kc, int ci, int nsub, Plan* out) {
  const int krows = 8 * kc, c = kKsplitClusters[ci];
  const int chunks = (P + krows - 1) / krows;
  if (chunks < c) return false;
  const int wpad = (chunks + c - 1) / c * krows;  // the widest slice
  Plan p = {};
  p.P = P;
  p.nsub = nsub;
  p.panels = (P + nsub - 1) / nsub;
  p.cluster = c;
  p.lkc = kc;
  p.Kp = chunks * krows;
  p.ystride = wpad + 8;  // wpad ≡ 0 (mod 16): ≡ 8, room for 8 scalars
  p.lstage = 2 * 4 * krows * nsub;
  p.off_y = 0;
  p.off_xch = 4 * kKsplitRows * p.ystride;
  p.off_bar = p.off_xch + 4 * kKsplitRows * nsub;
  p.off_ring = round_up(p.off_bar + 8 * (2 * kMaxSlots + 3), 128);
  const int slots = std::min(kMaxSlots, (optin - p.off_ring) / p.lstage);
  // a walker row in a slot: its run at the source's offset from 16 B
  p.area = round_up(std::min(wpad, P), 4) + 4;
  const int sr = std::min(kKsplitMaxStageRows, p.lstage / (8 * p.area));
  if (slots < kKsplitMinSlots[ci] || sr < 1) return false;
  p.slots = slots;
  p.sr = sr;
  p.smem = p.off_ring + slots * p.lstage;
  *out = p;
  return true;
}

// The plan of the K-split route at P: the first that fits of L stages of
// four k-steps, then of two; N of at least kKsplitWideN, then narrower;
// clusters of 4, then of 8 blocks; and those N in the order of the columns
// their panels pad P to (the fewest first, the wider of a tie). False where
// none fits.
bool plan_ksplit(int P, int optin, Plan* out) {
  if (P < 1) return false;
  constexpr int kWidths = sizeof(kKsplitWidths) / sizeof(int);
  int widths[kWidths];
  for (int i = 0; i < kWidths; ++i) widths[i] = kKsplitWidths[i];
  std::stable_sort(widths, widths + kWidths, [P](int x, int y) {
    return x * ((P + x - 1) / x) < y * ((P + y - 1) / y);
  });
  for (int kc : kStreamKcs) {
    for (int narrow = 0; narrow < 2; ++narrow) {
      for (int ci = 0; ci < 2; ++ci) {
        for (int nsub : widths) {
          if ((nsub < kKsplitWideN) == (narrow == 1) &&
              plan_ksplit_at(P, optin, kc, ci, nsub, out)) {
            return true;
          }
        }
      }
    }
  }
  return false;
}

template <int NSUB, int KC>
cudaError_t ksplit_clusters(const Plan& plan, int* clusters) {
  static bool asked[kMaxDevices] = {};
  static int known[kMaxDevices][2] = {};
  return max_active_clusters(wide_ksplit_kernel<NSUB, KC>, kThreadsKsplit,
                             plan, asked, known, clusters);
}

template <int NSUB, int KC>
cudaError_t launch_ksplit(const float* act, const float* lp_old,
                          const float* other, const int* shift,
                          unsigned long long key, const float* prec_chol,
                          float* out_act, float* out_lp, int* out_acc, int n,
                          long long row0, long long m, float a,
                          const Plan& plan, float* scratch, int loads_only,
                          cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = ksplit_clusters<NSUB, KC>(plan, &clusters);
  if (err != cudaSuccess) return err;
  // no cluster of this shape fits the device: refused, no other route
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = split_for_stream(prec_chol, plan, scratch, stream);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n + kKsplitRows - 1) / kKsplitRows;
  const int grid = (int)std::min((long long)clusters, n_tiles);
  ClusterLaunch l(grid * plan.cluster, kThreadsKsplit, plan.smem,
                  plan.cluster, stream);
  err = cudaLaunchKernelEx(&l.cfg, wide_ksplit_kernel<NSUB, KC>, act, lp_old,
                           other, shift, key, (const float*)scratch, out_act,
                           out_lp, out_acc, n, row0, m, a, plan, loads_only);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_ksplit_planned(const float* act, const float* lp_old,
                                  const float* other, const int* shift,
                                  unsigned long long key,
                                  const float* prec_chol, float* out_act,
                                  float* out_lp, int* out_acc, int n,
                                  long long row0, long long m, float a,
                                  const Plan& plan, float* scratch,
                                  int loads_only, cudaStream_t stream) {
#define MCMCPP_KS(NS)                                                        \
  if (plan.nsub == NS) {                                                     \
    return plan.lkc == 4                                                     \
               ? launch_ksplit<NS, 4>(act, lp_old, other, shift, key,        \
                                      prec_chol, out_act, out_lp, out_acc,   \
                                      n, row0, m, a, plan, scratch,          \
                                      loads_only, stream)                    \
               : launch_ksplit<NS, 2>(act, lp_old, other, shift, key,        \
                                      prec_chol, out_act, out_lp, out_acc,   \
                                      n, row0, m, a, plan, scratch,          \
                                      loads_only, stream);                   \
  }
  MCMCPP_KSPLIT_WIDTHS(MCMCPP_KS)
#undef MCMCPP_KS
  return cudaErrorInvalidValue;
}

cudaError_t ksplit_occupancy(const Plan& plan, int* clusters) {
#define MCMCPP_KS(NS)                                                 \
  if (plan.nsub == NS) {                                              \
    return plan.lkc == 4 ? ksplit_clusters<NS, 4>(plan, clusters)     \
                         : ksplit_clusters<NS, 2>(plan, clusters);    \
  }
  MCMCPP_KSPLIT_WIDTHS(MCMCPP_KS)
#undef MCMCPP_KS
  return cudaErrorInvalidValue;
}
#undef MCMCPP_KSPLIT_WIDTHS

// ===========================================================================
// Route 6: Y and L streamed, each multicast over a 2-D thread-block cluster
// ===========================================================================
//
// Past the widths the K-split route takes (P > 2944 on an H100) neither
// operand fits on chip: a 128-row tile's k-slices of Y no longer fit a
// cluster of 8, and L's split stages (8·P² bytes, 72 MB at P = 3000) no
// longer fit the 50 MB L2. Both stream, and each byte that enters an SM
// feeds two of them:
// - Clusters of kYlRowGroups × kYlColGroups = 4 × 2 blocks, block rank
//   rg·kYlColGroups + cg, one an SM, persistent: in its j-th iteration
//   cluster q takes the tiles of 128 walkers (j·Q + q)·4 + rg, the two
//   blocks of row group rg the same tile. (Clusters of 2 × 2, 2 × 4 and
//   2 × 1 measured 1–4% slower on an H100 at P = 3000: PERF.md §6.)
// - The tile's proposal rows are formed once, Y = p + z·(X − p), by the
//   blocks of its row group, 64 rows each (the rows a block owns: cg·64 …),
//   with coalesced loads (kYlFormBatch of them in flight a thread), into a Y
//   buffer in the scratch (one for each row group of each cluster the
//   device holds), laid out stage by stage: a stage is 32 k-rows of the 128
//   rows, a row's 32 floats contiguous with its k-steps of 8 swizzled by
//   8·(row % 4) (the consumers' float2 A loads then fall into distinct
//   banks with no padding), zeros from P to K padded (yl_at). X goes to the
//   output rows as it is read, as if every row were rejected; z, ue and
//   lp_old of the owned rows stay in shared memory. The writers fence their
//   stores for the async proxy, and the cluster synchronises before any of
//   the tile's stages is loaded.
// - L's split stages come from the prologue of routes 4 and 5
//   (split_l_stages, panels of N = 128 columns, chunks of 32 k-rows), the
//   panels padded with zero columns to a multiple of kYlColGroups.
// - One ring a block, each slot a Y stage (16 KB) beside an L stage (32
//   KB), filled by warp 8 in the consumers' order: in round pr block
//   (rg, cg) takes panel pr·2 + cg, and for each chunk of K its slot gets
//   the tile's Y stage and the panel's L stage. The block issues part cg of
//   the Y stage, multicast to its row group, and part rg of the L stage,
//   multicast to its column group (cp.async.bulk .multicast::cluster): each
//   byte of L read from L2 feeds 512 walker rows, each byte of Y 256
//   columns of S. The slot's full barrier, armed by its own producer for
//   the whole slot, completes when the six parts have landed (a peer's may
//   land before the arming). A slot is refilled only once the consumers of
//   every block have read it: its empty barrier counts a remote arrival of
//   every consumer warp of the cluster, and every block fills the same
//   slots in the same order (a block past the last tile takes part with a
//   tile it does not compute).
// - Warps 0–7, two consumer warpgroups, take 64 rows each of every stage:
//   3xTF32 wgmma m64n128k8, A from the Y stage (split in registers), B from
//   the staged halves, a partial a stage added into S (Product). When a
//   panel's chunks are done its columns are squared into the rows' sums
//   (Product::squares), panel after panel.
// - Each block then stores its sums of the tile's 128 rows into the
//   shared memory of the blocks that own them (one float a row), and after
//   a second cluster barrier the owner adds them in rank order, s_0 + s_1,
//   decides its rows, writes their logp and flag, and copies the accepted
//   rows' Y from the buffer into the output rows. Every row's sum is taken
//   in one order whatever cluster, block or iteration takes it, so row
//   shards equal one launch bit for bit.
// - What bounds it: the 3xTF32 product (n·6P² FLOP). What it adds to the
//   half-step's bytes: Y written once, read once a round from device
//   memory where the buffers outgrow L2 (n·4P·P/256 B: 44 ms at P = 3000,
//   n = 2^20), the accepted rows' Y read again. What holds it back
//   (PERF.md §6): the wgmma loop alone reaches ~77% of the bound (a drain
//   a stage), every stage's loads alone take as long, and the two overlap
//   only in part; a tile's formation (kYlFormBatch loads in flight a
//   thread) and decisions do not overlap its product (one Y buffer a row
//   group, two cluster barriers a tile).

constexpr int kYlRowGroups = 4;
constexpr int kYlColGroups = 2;
constexpr int kYlCluster = kYlRowGroups * kYlColGroups;
// walker rows of a tile (two consumer warpgroups' wgmma M), and those a
// block forms and owns
constexpr int kYlRows = 2 * kTileRows;
constexpr int kYlOwn = kYlRows / kYlColGroups;
// wgmma N (a panel's columns) and k-steps of 8 a stage
constexpr int kYlN = 128;
constexpr int kYlKc = 4;
constexpr int kYlKRows = 8 * kYlKc;
// consumer warps (two warpgroups), then the producer warp
constexpr int kYlConsumerWarps = 8;
constexpr int kThreadsYl = 32 * kYlConsumerWarps + 32;
// bytes of a Y stage (128 rows × 32 k-rows) and of an L stage (two halves
// of 32 k-rows × 128 columns)
constexpr unsigned kYlYStage = 4u * kYlRows * kYlKRows;
constexpr unsigned kYlLStage = 2u * 4u * kYlKRows * kYlN;
// loads a consumer thread starts before its first store in the formation
constexpr int kYlFormBatch = 16;

// Position of tile row r's k-row k in a Y buffer.
__device__ __forceinline__ int yl_at(int r, int k) {
  return (k / kYlKRows) * (kYlRows * kYlKRows) + r * kYlKRows +
         ((k % kYlKRows) ^ ((r & 3) << 3));
}

__global__ void __launch_bounds__(kThreadsYl, 1)
wide_yl_kernel(const float* __restrict__ act, const float* __restrict__ lp_old,
               const float* __restrict__ other, const int* __restrict__ shift,
               unsigned long long key, const float* __restrict__ lsplit,
               float* ybufs, float* __restrict__ out_act,
               float* __restrict__ out_lp, int* __restrict__ out_acc, int n,
               long long row0, long long m, float a, const Plan plan,
               int loads_only) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = plan.P, Kp = plan.Kp, S = plan.slots;
  const int chunks = Kp / kYlKRows;
  const int rounds = plan.panels / kYlColGroups;
  const unsigned slot_bytes = kYlYStage + kYlLStage;
  const unsigned rank = cluster_rank();
  const int rg = (int)rank / kYlColGroups, cg = (int)rank % kYlColGroups;
  const long long cid = cluster_index(), ncl = cluster_count();
  const long long n_tiles = (n + kYlRows - 1) / kYlRows;
  // the owned rows' offsets of X and of the partner row, z, ue, lp_old and
  // the accept flag; the sums of the tile's rows from each column group
  long long* xoff = reinterpret_cast<long long*>(smem + plan.off_y);
  long long* poff = xoff + kYlOwn;
  float* zs = reinterpret_cast<float*>(smem + plan.off_rows);
  float* ues = zs + kYlOwn;
  float* los = ues + kYlOwn;
  float* flags = los + kYlOwn;
  float* xch = reinterpret_cast<float*>(smem + plan.off_xch);
  unsigned char* ring = smem + plan.off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* empty = full + kMaxSlots;
  // this row group's Y buffer
  float* ybuf = ybufs + (size_t)(cid * kYlRowGroups + rg) * chunks *
                            (kYlRows * kYlKRows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&full[s], 1);
      // every consumer warp of every block of the cluster
      mbar_init(&empty[s], kYlConsumerWarps * kYlCluster);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // every block's barriers exist before a peer's copy or arrival reaches them
  cluster_sync();

  if (warp == kYlConsumerWarps) {
    // ---------------- producer: every stage, in the consumers' order -----
    const unsigned ypart = kYlYStage / kYlColGroups;
    const unsigned lpart = kYlLStage / kYlRowGroups;
    const unsigned short ymask = (unsigned short)(((1u << kYlColGroups) - 1)
                                                  << (rg * kYlColGroups));
    unsigned short lmask = 0;
    for (int r = 0; r < kYlRowGroups; ++r) {
      lmask |= (unsigned short)(1u << (r * kYlColGroups + cg));
    }
    const unsigned char* ysrc =
        reinterpret_cast<const unsigned char*>(ybuf) + cg * ypart;
    const unsigned char* lsrc =
        reinterpret_cast<const unsigned char*>(lsplit) + rg * lpart;
    int g = 0;
    for (long long j = 0; (j * ncl + cid) * kYlRowGroups < n_tiles; ++j) {
      // the tiles' rows formed in every block
      cluster_sync();
      for (int pr = 0; pr < rounds; ++pr) {
        const int pn = pr * kYlColGroups + cg;
        for (int ch = 0; ch < chunks; ++ch, ++g) {
          const int slot = g % S, round = g / S;
          if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
          if (lane == 0) {
            unsigned char* dst = ring + (size_t)slot * slot_bytes;
            mbar_arrive_expect_tx(&full[slot], slot_bytes);
            bulk_load_multicast(dst + cg * ypart,
                                ysrc + (size_t)ch * kYlYStage, ypart,
                                &full[slot], ymask);
            bulk_load_multicast(
                dst + kYlYStage + rg * lpart,
                lsrc + ((size_t)pn * chunks + ch) * kYlLStage, lpart,
                &full[slot], lmask);
          }
          __syncwarp();
        }
      }
      // the row sums exchanged
      cluster_sync();
    }
  } else {
    // ---------------- consumers ----------------
    constexpr int kThreadsC = 32 * kYlConsumerWarps;
    // a stage's n-blocks of 8 columns (32 k-rows each), the small half
    // after the big
    constexpr unsigned kNBlock = kYlKRows * 8 * 4;
    const int ci = warp >> 2, wq = warp & 3, ct = tid;  // ct: 0 … 255
    const int gq = lane >> 2, t = lane & 3;
    // this thread's tile rows r0 and r0 + 8, and their k-steps' swizzle
    const int r0 = kTileRows * ci + 16 * wq + gq;
    const int sw = (r0 & 3) << 3;
    const int first = cg * kYlOwn;
    const int sh = *shift;
    // a stage read: freed in every block of the cluster
    auto release = [&](int slot) {
      __syncwarp();
      if (lane < kYlCluster) {
        mbar_arrive_cluster(map_rank(smem_addr(&empty[slot]), lane));
      }
    };
    int g_at = 0;
    for (long long j = 0; (j * ncl + cid) * kYlRowGroups < n_tiles; ++j) {
      const long long tile = (j * ncl + cid) * kYlRowGroups + rg;
      const bool has = tile < n_tiles;
      const long long i0 = has ? tile * kYlRows : 0;
      const int rows =
          has ? (int)min((long long)kYlRows, (long long)n - i0) : 0;
      const int mine = max(0, min(kYlOwn, rows - first));
      if (ct < mine) {
        const long long gr = i0 + first + ct;
        const float2 uu = unit_uniforms(key, (unsigned long long)(row0 + gr));
        zs[ct] = stretch_z(uu.x, a);
        ues[ct] = uu.y;
        los[ct] = lp_old[gr];
        xoff[ct] = gr * P;
        poff[ct] = partner_row(row0 + gr, sh, m) * P;
      }
      named_bar(1, kThreadsC);

      // the owned proposal rows into the Y buffer, X into the output rows
      const int count = mine * Kp;
      for (TileWalk<1> w(Kp, ct, kThreadsC); w.e < count;) {
        float xv[kYlFormBatch], pv[kYlFormBatch];
        int rr[kYlFormBatch], kk[kYlFormBatch];
#pragma unroll
        for (int b = 0; b < kYlFormBatch; ++b) {
          rr[b] = -1;
          kk[b] = 0;
          xv[b] = pv[b] = 0.0f;
          if (w.e < count) {
            rr[b] = w.row;
            kk[b] = w.k;
            if (w.k < P) {
              xv[b] = act[xoff[w.row] + w.k];
              pv[b] = other[poff[w.row] + w.k];
            }
          }
          w.next(Kp);
        }
#pragma unroll
        for (int b = 0; b < kYlFormBatch; ++b) {
          if (rr[b] >= 0) {
            ybuf[yl_at(first + rr[b], kk[b])] =
                fmaf(zs[rr[b]], xv[b] - pv[b], pv[b]);
            if (kk[b] < P) out_act[xoff[rr[b]] + kk[b]] = xv[b];
          }
        }
      }
      // the Y rows written before any block's producer loads them
      fence_proxy_async_global();
      cluster_sync();

      // S = Y·L panel by panel (3xTF32 on wgmma), each panel's columns
      // squared into the rows' sums when its chunks are done
      const bool product = has && !loads_only;
      float q0 = 0.0f, q1 = 0.0f;
      for (int pr = 0; pr < rounds; ++pr) {
        Product<kYlN> prod;
        for (int ch = 0; ch < chunks; ++ch, ++g_at) {
          const int slot = g_at % S;
          mbar_wait(&full[slot], (g_at / S) & 1);
          if (product) {
            const float* ys =
                reinterpret_cast<const float*>(ring + (size_t)slot * slot_bytes);
            const unsigned lb =
                smem_addr(ring) + slot * slot_bytes + kYlYStage;
            prod.group<kYlKc>(ys + r0 * kYlKRows + 2 * t, kYlKRows, 0, lb,
                              lb + kYlLStage / 2, 0, kNBlock, sw);
          }
          release(slot);
        }
        if (product) prod.squares(q0, q1);
      }
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      // the sums of rows r0 and r0 + 8 to the blocks that own them
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const unsigned owner = rg * kYlColGroups + r / kYlOwn;
          st_cluster(map_rank(smem_addr(xch + cg * kYlRows + r), owner),
                     h ? q1 : q0);
        }
      }
      cluster_sync();

      if (ct < mine) {
        const int r = first + ct;
        float sum = xch[r];
#pragma unroll
        for (int c = 1; c < kYlColGroups; ++c) sum += xch[c * kYlRows + r];
        const float lo = los[ct];
        // loads only: lp_new = lp_old, the decision by the factor alone
        const float lp_new = loads_only ? lo : -0.5f * sum;
        const bool accept = stretch_accepts(
            ues[ct], (float)(P - 1) * logf(zs[ct]), lp_new, lo);
        out_lp[i0 + r] = accept ? lp_new : lo;
        out_acc[i0 + r] = accept ? 1 : 0;
        flags[ct] = accept ? 1.0f : 0.0f;
      }
      named_bar(1, kThreadsC);
      // the accepted rows get Y
      for (TileWalk<1> w(P, ct, kThreadsC); w.e < mine * P; w.next(P)) {
        if (flags[w.row] != 0.0f) {
          out_act[xoff[w.row] + w.k] = ybuf[yl_at(first + w.row, w.k)];
        }
      }
      named_bar(1, kThreadsC);
    }
  }
  // no block exits while a peer may still copy into its shared memory or
  // arrive on its barriers
  cluster_sync();
}

// The plan of route 6 at P on a device whose blocks may have `optin` bytes
// of shared memory: the owned rows' offsets and scalars, the exchange of
// the row sums and one ring of at least two slots (at most kMaxSlots), each
// a Y stage beside an L stage. The same block at every P; false where two
// slots do not fit.
bool plan_yl(int P, int optin, Plan* out) {
  if (P < 1) return false;
  Plan p = {};
  p.P = P;
  p.nsub = kYlN;
  p.cluster = kYlCluster;
  p.lkc = kYlKc;
  p.Kp = round_up(P, kYlKRows);
  p.panels = round_up((P + kYlN - 1) / kYlN, kYlColGroups);
  p.lstage = kYlLStage;
  p.sr = kYlRows;
  p.off_y = 0;
  p.off_rows = 8 * 2 * kYlOwn;
  p.off_xch = p.off_rows + 4 * 4 * kYlOwn;
  p.off_bar = p.off_xch + 4 * kYlColGroups * kYlRows;
  p.off_ring = round_up(p.off_bar + 8 * 2 * kMaxSlots, 128);
  const int slot = (int)(kYlYStage + kYlLStage);
  const int slots = std::min(kMaxSlots, (optin - p.off_ring) / slot);
  if (slots < 2) return false;
  p.slots = slots;
  p.smem = p.off_ring + slots * slot;
  *out = p;
  return true;
}

// Bytes of route 6's scratch: L's split stages, then a Y buffer for each
// row group of each of `clusters` clusters.
size_t yl_scratch_bytes(const Plan& plan, int clusters) {
  return stream_scratch_bytes(plan) + (size_t)clusters * kYlRowGroups *
                                          (plan.Kp / kYlKRows) * kYlYStage;
}

cudaError_t yl_clusters(const Plan& plan, int* clusters) {
  static bool asked[kMaxDevices] = {};
  static int known[kMaxDevices][2] = {};
  return max_active_clusters(wide_yl_kernel, kThreadsYl, plan, asked, known,
                             clusters);
}

cudaError_t launch_yl(const float* act, const float* lp_old,
                      const float* other, const int* shift,
                      unsigned long long key, const float* prec_chol,
                      float* out_act, float* out_lp, int* out_acc, int n,
                      long long row0, long long m, float a, const Plan& plan,
                      float* scratch, int loads_only, cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = yl_clusters(plan, &clusters);
  if (err != cudaSuccess) return err;
  // no cluster of this shape fits the device: refused, no other route
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = split_for_stream(prec_chol, plan, scratch, stream);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n + kYlRows - 1) / kYlRows;
  const int grid = (int)std::min(
      (long long)clusters, (n_tiles + kYlRowGroups - 1) / kYlRowGroups);
  float* ybufs = scratch + stream_scratch_bytes(plan) / 4;
  ClusterLaunch l(grid * kYlCluster, kThreadsYl, plan.smem, kYlCluster,
                  stream);
  err = cudaLaunchKernelEx(&l.cfg, wide_yl_kernel, act, lp_old, other, shift,
                           key, (const float*)scratch, ybufs, out_act,
                           out_lp, out_acc, n, row0, m, a, plan, loads_only);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ===========================================================================
// The mma.sync kernel: every P the kernels above do not take
// ===========================================================================
//
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
//   flight while the warps multiply the one before. The panel's row stride
//   ≡ 8 (mod 16) floats: a B fragment's loads fall into 32 banks.
// - Product: S column panel by column panel, over all of K, in fp32
//   accumulators (32·MT a thread: 16·MT rows × 64 columns a warp); when a
//   panel is complete its accumulators are squared into each row's running
//   sum, the four threads of an mma quad adding their sums with two
//   shuffles. 3xTF32 as above, three m16n8k8 TF32 mma a k-step into a zeroed
//   partial that an fp32 add puts into the accumulator.
// - Epilogue: X goes to the output rows as it is read, as if every row were
//   rejected; after the accept decisions the accepted rows get Y from the
//   tile.
// - What holds it back (PERF.md §6): the blocks of an SM overlap
//   their product poorly with their loads, so the time is near the sum of
//   the two phases.
// - Past the shared memory of the Y tile (19456 + 256·(K + 4) B a block at
//   R = 64, K = P rounded up to 8: P >= 825 on an H100), the streamed
//   variant (STREAM_A) writes Y straight into the output rows, streams it
//   back in 64 × 32 panels beside L's, and writes X over the rejected rows
//   (read again, a batch of loads in flight): no cap on P.

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
  extern __shared__ __align__(16) float smem_f[];
  const int Kp = padded_k(P);
  const int stride = tile_stride(P);
  const int sf = stage_floats(STREAM_A);
  float* ring = smem_f;
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

template <int MT, bool STREAM_A, int VEC>
cudaError_t launch_vec(const float* act, const float* lp_old,
                       const float* other, const int* shift,
                       unsigned long long key, const float* prec_chol,
                       float* out_act, float* out_lp, int* out_acc, int n,
                       long long row0, long long m, int P, float a,
                       cudaStream_t stream) {
  auto kernel = fused_stretch_wide_kernel<MT, STREAM_A, VEC>;
  const size_t bytes = wide_smem_bytes(P, STREAM_A, MT);
  static bool asked[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, bytes, asked);
  if (err != cudaSuccess) return err;
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

// The routes, as wide_layout numbers them.
enum Route {
  kRouteWs = 0,
  kRouteTile = 1,
  kRouteStream = 2,
  kRouteCluster = 3,
  kRouteLStream = 4,
  kRouteKSplit = 5,
  kRouteYl = 6
};

// The route at P on this device: the warp-specialised kernel where plan_for
// takes P, else the cluster kernel where plan_cluster does, else the
// L-streamed kernel where plan_stream does, else the K-split kernel where
// plan_ksplit does, else route 6 where plan_yl does (`plan` for any of the
// five), else the mma.sync kernel with the Y tile or, past its shared
// memory, with Y streamed.
cudaError_t route(int P, Plan* plan, Route* which) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  if (plan_for(P, optin, plan)) {
    *which = kRouteWs;
  } else if (plan_cluster(P, optin, plan)) {
    *which = kRouteCluster;
  } else if (plan_stream(P, optin, plan)) {
    *which = kRouteLStream;
  } else if (plan_ksplit(P, optin, plan)) {
    *which = kRouteKSplit;
  } else if (plan_yl(P, optin, plan)) {
    *which = kRouteYl;
  } else {
    *which = wide_smem_bytes(P, false, 1) > (size_t)optin ? kRouteStream
                                                          : kRouteTile;
  }
  return cudaSuccess;
}

int launch(const float* act, const float* lp_old, const float* other,
           const int* shift, unsigned long long key, const float* prec_chol,
           float* out_act, float* out_lp, int* out_acc, int n, long long row0,
           long long m, int P, float a, void* stream_ptr, void* scratch,
           int loads_only) {
  if (!mcmcpp::valid_rows(n, row0, m) || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Plan plan;
  Route which = kRouteTile;
  const cudaError_t err = route(P, &plan, &which);
  if (err != cudaSuccess) return (int)err;
  if (which == kRouteWs) {
    return (int)launch_planned(act, lp_old, other, shift, key, prec_chol,
                               out_act, out_lp, out_acc, n, row0, m, a, plan,
                               loads_only, stream);
  }
  if (which == kRouteCluster) {
    return (int)launch_cluster_planned(act, lp_old, other, shift, key,
                                       prec_chol, out_act, out_lp, out_acc, n,
                                       row0, m, a, plan, loads_only, stream);
  }
  if (which == kRouteLStream || which == kRouteKSplit) {
    // L's split stages go to the caller's scratch: none, no launch
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    auto planned = which == kRouteLStream ? launch_stream_planned
                                          : launch_ksplit_planned;
    return (int)planned(act, lp_old, other, shift, key, prec_chol, out_act,
                        out_lp, out_acc, n, row0, m, a, plan,
                        static_cast<float*>(scratch), loads_only, stream);
  }
  if (which == kRouteYl) {
    // L's split stages and the Y buffers go to the caller's scratch
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_yl(act, lp_old, other, shift, key, prec_chol, out_act,
                          out_lp, out_acc, n, row0, m, a, plan,
                          static_cast<float*>(scratch), loads_only, stream);
  }
  if (loads_only) return (int)cudaErrorInvalidValue;
  return (int)launch_shape(act, lp_old, other, shift, key, prec_chol, out_act,
                           out_lp, out_acc, n, row0, m, P, a, stream);
}

// Bytes of the scratch a wide launch of `plan` takes (`clusters` those the
// device holds at once): L's split stages on routes 4 and 5, those and the
// Y buffers on route 6, else 0.
long long scratch_bytes(const Plan& plan, Route which, int clusters) {
  if (which == kRouteYl) return (long long)yl_scratch_bytes(plan, clusters);
  if (which == kRouteLStream || which == kRouteKSplit) {
    return (long long)stream_scratch_bytes(plan);
  }
  return 0;
}

}  // namespace

// The block the wide kernel launches at dimension P on the current device,
// as ten ints: route (0: warp-specialised, wgmma; 1: mma.sync with the Y
// tile; 2: mma.sync with Y streamed; 3: wgmma on a thread-block cluster; 4:
// wgmma with L streamed; 5: wgmma with K split over a thread-block
// cluster; 6: wgmma with Y and L streamed, multicast over a 2-D cluster),
// dynamic shared memory (bytes), walkers a block holds at once (on routes
// 5 and 6 a cluster's tile of 128 rows), rows a walker stage and stages a
// ring (a consumer's on route 0; on routes 4 and 5 the one ring's slots,
// each a walker stage or an L stage; on route 6 the 128 rows of a Y stage
// and the ring's slots, each a Y stage beside an L stage), wgmma N (a
// block's columns of S on route 3, a consumer's of a panel on routes 4–6;
// 0 where these do not apply), blocks a cluster (1 but on routes 3–6), the
// clusters the device holds at once (routes 3–6; 0 elsewhere), the k-steps
// of 8 in an L stage and the bytes of the scratch the caller allocates
// (routes 4–6; 0 elsewhere; −1 where they exceed an int:
// mcmcpp_fused_stretch_wide_scratch_bytes gives them). Returns a
// cudaError_t.
extern "C" int mcmcpp_fused_stretch_wide_layout(int P, int* out) {
  if (P <= 0) return (int)cudaErrorInvalidValue;
  Plan plan;
  Route which = kRouteTile;
  cudaError_t err = route(P, &plan, &which);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < 10; ++i) out[i] = 0;
  out[6] = 1;
  if (which == kRouteWs) {
    const int v[6] = {kRouteWs, plan.smem, kConsumers * kTileRows, plan.sr,
                      plan.slots, plan.nsub};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
  }
  if (which == kRouteCluster || which == kRouteLStream ||
      which == kRouteKSplit || which == kRouteYl) {
    int clusters = 0;
    err = which == kRouteCluster   ? cluster_occupancy(plan, &clusters)
          : which == kRouteLStream ? stream_occupancy(plan, &clusters)
          : which == kRouteKSplit  ? ksplit_occupancy(plan, &clusters)
                                   : yl_clusters(plan, &clusters);
    if (err != cudaSuccess) return (int)err;
    const long long bytes = scratch_bytes(plan, which, clusters);
    const bool streamed = which != kRouteCluster;
    const int v[10] = {which,
                       plan.smem,
                       which == kRouteKSplit ? kKsplitRows
                       : which == kRouteYl   ? kYlRows
                                             : kTileRows,
                       plan.sr,
                       plan.slots,
                       plan.nsub,
                       plan.cluster,
                       clusters,
                       streamed ? plan.lkc : 0,
                       bytes > INT_MAX ? -1 : (int)bytes};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
  }
  out[0] = which;
  if (which == kRouteStream) {
    out[1] = (int)wide_smem_bytes(P, true, 1);
    out[2] = kRowsPerMT;
  } else {
    int optin = 0;
    err = smem_optin(&optin);
    if (err != cudaSuccess) return (int)err;
    // launch_shape's choice
    const int mt = 3 * wide_smem_bytes(P, false, 2) <= (size_t)optin ? 2 : 1;
    out[1] = (int)wide_smem_bytes(P, false, mt);
    out[2] = kRowsPerMT * mt;
  }
  return 0;
}

// The wide variant of mcmcpp_fused_stretch_half_f32, with the same arguments
// and outputs, for any P >= 1: rows row0…row0+n−1 of a half of m walkers
// against `other`, the whole opposite half (unsharded: row0 = 0, m = n).
// All pointers are device pointers; `prec_chol` is L, (P, P) row-major;
// `shift` points at one int32 (any value); `key` is the half-step's Philox
// key, local walker i drawing its u and ue from (key, row0 + i). `scratch`
// holds the bytes mcmcpp_fused_stretch_wide_scratch_bytes gives (out[0]),
// 16-B aligned, where that is not 0 (routes 4 and 5 write L's split stages
// there, route 6 those and its Y buffers; a null scratch refuses the
// launch), else may be null. Returns the launch's cudaError_t (0 on
// success).
extern "C" int mcmcpp_fused_stretch_wide_f32(
    const float* act, const float* lp_old, const float* other,
    const int* shift, unsigned long long key, const float* prec_chol,
    float* out_act, float* out_lp, int* out_acc, int n, long long row0,
    long long m, int P, float a, void* stream, void* scratch) {
  return launch(act, lp_old, other, shift, key, prec_chol, out_act, out_lp,
                out_acc, n, row0, m, P, a, stream, scratch, 0);
}

// Debug entry for measurement, not called by the port: the wgmma kernels'
// loads and stores without their product: every X and partner run through
// the ring (on routes 4 and 5 also every stage of L through its ring, after
// the prologue), the proposal rows (on route 3 also sent between the blocks
// of the cluster, whose exchange of the row sums runs on zeros; on route 5
// the exchange of the partial products runs on zeros; on route 6 formed
// into the Y buffers, every Y and L stage through the ring after the
// prologue, the exchange of the row sums on zeros), X and the accepted
// rows written, lp_new taken as lp_old (so the decisions follow the factor
// alone). Refuses (cudaErrorInvalidValue) a P the mma.sync kernel takes.
extern "C" int mcmcpp_fused_stretch_wide_loads_only_f32(
    const float* act, const float* lp_old, const float* other,
    const int* shift, unsigned long long key, const float* prec_chol,
    float* out_act, float* out_lp, int* out_acc, int n, long long row0,
    long long m, int P, float a, void* stream, void* scratch) {
  return launch(act, lp_old, other, shift, key, prec_chol, out_act, out_lp,
                out_acc, n, row0, m, P, a, stream, scratch, 1);
}

// Debug entry for measurement, not called by the port: the prologue of
// routes 4–6 alone, L's split stages into `scratch` (at least the bytes
// mcmcpp_fused_stretch_wide_scratch_bytes gives as out[1]). Refuses
// (cudaErrorInvalidValue) a P that none of them takes.
extern "C" int mcmcpp_fused_stretch_wide_split_l_f32(const float* prec_chol,
                                                     int P, void* scratch,
                                                     void* stream) {
  if (P <= 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  Plan plan;
  Route which = kRouteTile;
  const cudaError_t err = route(P, &plan, &which);
  if (err != cudaSuccess) return (int)err;
  if (which != kRouteLStream && which != kRouteKSplit && which != kRouteYl) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)split_for_stream(prec_chol, plan, static_cast<float*>(scratch),
                               static_cast<cudaStream_t>(stream));
}

// The scratch of a wide launch at P on the current device as two 64-bit
// counts: out[0] the bytes the launch takes (the layout's out[9], which an
// int may not hold), out[1] those of L's split stages at its start, which
// the prologue writes (routes 4–6; both 0 elsewhere). Returns a
// cudaError_t.
extern "C" int mcmcpp_fused_stretch_wide_scratch_bytes(int P,
                                                       long long* out) {
  if (P <= 0) return (int)cudaErrorInvalidValue;
  Plan plan;
  Route which = kRouteTile;
  cudaError_t err = route(P, &plan, &which);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  if (which == kRouteYl) err = yl_clusters(plan, &clusters);
  if (err != cudaSuccess) return (int)err;
  out[0] = scratch_bytes(plan, which, clusters);
  out[1] = which == kRouteYl ? (long long)stream_scratch_bytes(plan) : out[0];
  return 0;
}

// Debug entry for checking and timing, not called by the port: the mma.sync
// kernel (route 1 where its Y tile fits the device's block, else route 2,
// Y streamed) at any P, whatever route the dispatch takes there, with the
// arguments and outputs of mcmcpp_fused_stretch_wide_f32 but the scratch.
extern "C" int mcmcpp_fused_stretch_wide_forced_mma_f32(
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
