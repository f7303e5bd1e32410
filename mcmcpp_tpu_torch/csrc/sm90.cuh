// Hopper (sm_90a) primitives of the wide kernel, as inline PTX: mbarriers,
// the bulk asynchronous copy (also multicast to the blocks of a cluster, and
// into a peer block's shared memory), the cluster's ranks, barrier and
// distributed shared memory, the wgmma fences and shared-memory matrix
// descriptors, and the named barriers of a warpgroup.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mcmcpp {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (the bulk
// copies that complete on them).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more than
// about 2^32 clocks (~2 s) traps, so that a barrier that can no longer
// complete fails the launch instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  long long start = 0;
  for (unsigned tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries == 1024) start = clock64();
    if (tries > 1024 && (tries & 1023) == 0 && clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// -- copies --------------------------------------------------------------------

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-B aligned) from
// global to shared memory, completing as transactions on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same bulk copy into the same offset of the shared memory of every
// block of the cluster whose bit (its rank) is set in `mask`, completing as
// transactions on the mbarrier at `bar`'s offset in each of them.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src,
                                                    unsigned bytes,
                                                    uint64_t* bar,
                                                    unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// One 4-byte asynchronous copy from global to shared memory.
__device__ __forceinline__ void cp_async4_to(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// `bar`'s current phase also waits for this thread's cp.async copies issued
// so far (the pending count is raised now and lowered when they land).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (wgmma's operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to device memory before later
// async-proxy reads of them (bulk copies issued, after a barrier, by any
// thread of the cluster).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// -- thread-block clusters -----------------------------------------------------

// This block's rank in its cluster, the cluster's index in the grid and the
// number of clusters (a 1-D grid of 1-D clusters).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: arrive (release) and wait (acquire), so that
// each block's shared-memory writes before it are visible to the others,
// and no block goes on (or exits) while a peer still reads or writes it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::
                   : "memory");
}

// The shared::cluster address of the same offset as `local` (a shared::cta
// address) in the shared memory of block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned local, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}

// A float stored into a peer's shared memory (a map_rank address) that
// completes as 4 transaction bytes on the peer's mbarrier `bar` (a map_rank
// address): the peer's wait on that barrier sees the float, and the store
// needs no fence of this thread's other writes.
__device__ __forceinline__ void st_async_cluster(unsigned addr, float v,
                                                 unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

// A plain float store into a peer's shared memory (a map_rank address),
// visible to the peer after the next cluster_sync.
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// Four floats (16 B; `addr` 16-B aligned) stored as st_async_cluster stores
// one: 16 transaction bytes on the peer's mbarrier `bar`.
__device__ __forceinline__ void st_async_cluster_v4(unsigned addr, float a,
                                                    float b, float c, float d,
                                                    unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// Arrive on a peer's mbarrier (a map_rank address). Release at CTA scope,
// the default: this thread's reads of its own shared memory are done before
// the peer, once its wait completes, overwrites them (a bulk copy). (At
// cluster scope the release would first wait for this thread's stores to
// device memory.)
__device__ __forceinline__ void mbar_arrive_cluster(unsigned addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-B aligned) from
// this block's shared memory to a peer's (`dst`, a map_rank address),
// completing as transactions on the peer's mbarrier `bar` (a map_rank
// address). The source's generic-proxy writes need fence_proxy_async first.
__device__ __forceinline__ void bulk_copy_to_peer(unsigned dst, const void* src,
                                                  unsigned bytes,
                                                  unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// -- named barriers ------------------------------------------------------------

// Barrier `id` (1…15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that writes it.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle: core
// matrices of 8 rows × 16 B, each 128 contiguous bytes; `lbo` the byte
// distance between core matrices adjacent in K, `sbo` between those adjacent
// in M or N.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

}  // namespace mcmcpp
