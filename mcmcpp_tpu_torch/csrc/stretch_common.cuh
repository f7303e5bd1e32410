// Device functions shared by the stretch kernels: the fused half-step
// (fused_stretch.cu) and the split propose/accept pair (stretch_split.cu).
//
// Both replace parts of mcmcpp_tpu/ops/pallas_stretch.py::_kernel: the
// partner of active walker i is other[(i + shift) % m] (the roll of
// mcmcpp_tpu/ops/partner.py), z ~ g(z) comes from a uniform u by the
// inverse CDF of mcmcpp_tpu/ops/gw.py, and the accept rule is
// log(ue) < (P−1)·log z + lp_new − lp_old.
//
// Row offset. A launch covers n active rows that are rows row0…row0+n−1 of
// a half of m walkers (a rank's shard of a sharded ensemble); `other` is
// the whole opposite half, m rows. Local row i is global row row0 + i: its
// partner is other[(row0 + i + shift) % m] and its Philox counter row0 + i,
// and its outputs go to local row i. So R launches over consecutive row
// shards give the one unsharded launch's outputs, bit for bit. Unsharded,
// row0 = 0 and m = n.
//
// The uniforms u (for z) and ue (for the accept test) are drawn inside the
// kernels, as the Pallas kernel draws them from the TPU's generator
// (pallas_stretch.py:62, :72-73): here by Philox4x32-10, a counter-based
// generator, as a pure function of the half-step's 64-bit key and the
// walker's global index in its half. Its plain twin, bit for bit, is
// mcmcpp_tpu_torch/ops/random.py::philox_unit_uniforms.
//
// Built without --use_fast_math: IEEE logf/sqrtf keep the −inf and NaN
// semantics the accept rule relies on (lp_old = −inf with a finite lp_new
// accepts; a NaN log ratio rejects, as `log_u < nan` is false).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mcmcpp {

// Loads of a tile copy that a thread starts before its first store.
constexpr int kLoadBatch = 8;

// Philox4x32-10 (Salmon, Moraes, Dror, Shaw: "Parallel random numbers: as
// easy as 1, 2, 3", SC'11; the Random123 constants), written out by hand.
constexpr unsigned int kPhiloxM0 = 0xD2511F53u;
constexpr unsigned int kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned int kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned int kPhiloxW1 = 0xBB67AE85u;

// Words 0 and 1 of Philox4x32-10 on counter (i_lo, i_hi, 0, 0) with key
// (key_lo, key_hi): ten rounds, the key bumped by the Weyl constants between
// rounds.
__device__ __forceinline__ uint2 philox_words(unsigned long long key,
                                              unsigned long long i) {
  unsigned int c0 = (unsigned int)i, c1 = (unsigned int)(i >> 32);
  unsigned int c2 = 0u, c3 = 0u;
  unsigned int k0 = (unsigned int)key, k1 = (unsigned int)(key >> 32);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned int hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const unsigned int hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint2(c0, c1);
}

// 32 random bits -> a float32 uniform in [2^-25, 1): the top 24 bits, with
// the floor that keeps its log finite (_bits_to_unit of pallas_stretch.py).
// Exact in float32: a 24-bit integer times 2^-24.
__device__ __forceinline__ float bits_to_unit(unsigned int bits) {
  return fmaxf((float)(bits >> 8) * 5.9604644775390625e-8f,
               2.98023223876953125e-8f);
}

// u (word 0) and ue (word 1) of walker i of the half-step with this key.
__device__ __forceinline__ float2 unit_uniforms(unsigned long long key,
                                                unsigned long long i) {
  const uint2 w = philox_words(key, i);
  return make_float2(bits_to_unit(w.x), bits_to_unit(w.y));
}

// Row of `other` (m rows) that the active walker of global row g pairs
// with, for a shift in any range.
__device__ __forceinline__ long long partner_row(long long g, int shift,
                                                 long long m) {
  long long j = (g + (long long)shift) % m;
  return j < 0 ? j + m : j;
}

// True when rows row0…row0+n−1 of a half of m rows are a valid launch.
inline bool valid_rows(long long n, long long row0, long long m) {
  return n > 0 && row0 >= 0 && m >= n && row0 <= m - n;
}

// True when the float2 copies may be used: for even P every row of a
// contiguous (n, P) float32 array starts 8-B aligned if its base does.
inline bool rows_aligned8(int P, const void* a, const void* b, const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return P % 2 == 0 && bits % 8 == 0;
}

// Walk of a block's threads (or of `threads` of them, this one the
// `first`-th) over the rows·P elements of a tile, VEC consecutive elements a
// thread and threads·VEC a pass: element e is (row, k) of the tile, kept by
// adding the pass's (rows, columns) and one carry, so no element costs a
// division. For VEC = 2 P is even, so e and k stay even and a pair never
// crosses a row.
template <int VEC>
struct TileWalk {
  int e, row, k, step, drow, dk;
  __device__ __forceinline__ explicit TileWalk(int P)
      : TileWalk(P, threadIdx.x, blockDim.x) {}
  __device__ __forceinline__ TileWalk(int P, int first, int threads) {
    e = first * VEC;
    row = e / P;
    k = e - row * P;
    step = threads * VEC;
    drow = step / P;
    dk = step - drow * P;
  }
  __device__ __forceinline__ void next(int P) {
    e += step;
    row += drow;
    k += dk;
    if (k >= P) {
      k -= P;
      ++row;
    }
  }
};

// Cooperative copy of `rows` (at most n) consecutive rows of the (n, P)
// array `src`, from row `row0` on and wrapping at n, into shared memory
// with `stride` floats a row. Neighbouring threads read neighbouring
// addresses; a thread starts up to kLoadBatch loads before it stores the
// first, so that enough bytes are in flight: at P = 10 a 256-row tile is
// five float2 loads a thread, all outstanding at once.
template <int VEC>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          long long row0, int rows,
                                          long long n, int P, int stride,
                                          float* dst) {
  const int count = rows * P;
  TileWalk<VEC> w(P);
  while (w.e < count) {
    float2 v[kLoadBatch];
    int at[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      at[b] = -1;
      if (w.e < count) {
        long long g = row0 + w.row;
        if (g >= n) g -= n;
        const float* s = src + g * P + w.k;
        if (VEC == 2) {
          v[b] = *reinterpret_cast<const float2*>(s);
        } else {
          v[b].x = *s;
        }
        at[b] = w.row * stride + w.k;
      }
      w.next(P);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      if (at[b] >= 0) {
        dst[at[b]] = v[b].x;
        if (VEC == 2) dst[at[b] + 1] = v[b].y;
      }
    }
  }
}

// Cooperative copy of a tile of `rows` rows from shared memory (`stride`
// floats a row) to rows row0… of the contiguous (n, P) array `dst`.
template <int VEC>
__device__ __forceinline__ void store_tile(const float* src, long long row0,
                                           int rows, int P, int stride,
                                           float* __restrict__ dst) {
  const int count = rows * P;
  float* out = dst + row0 * P;
  for (TileWalk<VEC> w(P); w.e < count; w.next(P)) {
    const float* s = src + w.row * stride + w.k;
    if (VEC == 2) {
      *reinterpret_cast<float2*>(out + w.e) = make_float2(s[0], s[1]);
    } else {
      out[w.e] = s[0];
    }
  }
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
