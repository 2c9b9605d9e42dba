// Hopper device helpers for kernels that keep their weights on chip:
// the thread-block-cluster barrier, cp.async copies with zero fill,
// mbarriers and bulk (TMA) copies, and bf16 tensor-core fragments (ldmatrix + mma.sync.m16n8k16, float32
// accumulators).  lstm_fwd.cu and decoder_cluster.cuh use them.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace aocr {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One cluster-wide barrier: every thread of every block of the cluster
// arrives (its earlier stores released at cluster scope, global memory
// included) and waits (acquiring the others').  Call from all threads,
// convergent.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of cluster_barrier, for work between them: arrive
// releases this thread's earlier stores at cluster scope; wait blocks
// until every thread of the cluster has arrived, and acquires.  Each
// arrive is matched by one wait before the next arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cp.async of BYTES (4, 8 or 16) from global src to shared dst; the
// bytes past `valid` (0..BYTES) are filled with zeros and not read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(valid)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An mbarrier in shared memory (8-byte aligned): init with `count`
// arrivals a phase; expect_tx arrives once and adds `bytes` of
// transactions to the phase; arrive arrives once; wait spins until the
// phase of `parity` completes; inval before its memory serves anything
// else.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A bulk copy (the Tensor Memory Accelerator) of `bytes` (a multiple of
// 16; both addresses 16-byte aligned) from global src to shared dst,
// completing as transactions on the mbarrier bar.  One thread issues it.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's generic-proxy memory accesses before its later
// async-proxy ones (bulk copies), in every state space.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// A fragment of m16n8k16 (16 x 16 bf16, row-major in shared memory, row
// stride `ld` elements) at `tile`; 16-byte aligned rows.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const __nv_bfloat16* tile,
                                           int ld) {
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + ((l & 7) + ((l >> 3) & 1) * 8) * ld +
                           (l >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B fragments of two m16n8k16 products from a (16 x N) bf16 tile stored
// [k][n] row-major in shared memory (row stride `ld` elements): columns
// n0..n0+7 into b[0..1] and n1..n1+7 into b[2..3].
__device__ __forceinline__ void ldmatrix_b2(uint32_t (&b)[4],
                                            const __nv_bfloat16* rows,
                                            int ld, int n0, int n1) {
  const int l = threadIdx.x & 31;
  const int m = l >> 3;
  const __nv_bfloat16* p =
      rows + ((l & 7) + (m & 1) * 8) * ld + ((m >> 1) ? n1 : n0);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// d[0..3] += a (16 x 16) @ b (16 x 8), bf16 operands, float32
// accumulators.  Thread l holds d[0..1] at (row l/4, cols 2(l%4) + 0..1)
// and d[2..3] at row l/4 + 8.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace aocr
