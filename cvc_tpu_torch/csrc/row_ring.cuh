// Pieces of the kernels that split an image or a row over a cluster of
// blocks (decoder_step.cu, attention.cu, attention_bwd.cu, topk_select.cu):
// rows of a matrix prefetched into shared memory by the Tensor Memory
// Accelerator (1-D bulk copies, `cp.async.bulk`, completing on an
// `mbarrier`), stores into another block's shared memory counted on its
// mbarrier, the split cluster barrier, the fixed-order sum of thread
// groups' partial sums, and the phase clock stamps.
#pragma once

#include "common.cuh"

namespace cvc {

constexpr int kClusterBlocks = 2;   // blocks of one image (one cluster)
constexpr int kStampSlots = 8;      // clock stamps a block can write

// x rounded up to a multiple of 16 (shared-memory plans).
__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy and the
// cluster; call once after the mbar_init calls, before any copy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same memory (the copies run in the async proxy).
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase `parity` has completed. A copy that never
// lands (a fault) traps after ~2^34 clocks instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The address, in the cluster's shared window, of `p` (a pointer into this
// block's shared memory) in the block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Stores one float at `dst` in a block of the cluster and counts its 4
// bytes on that block's barrier `bar` (both from cluster_addr). A block that
// has waited for the barrier's bytes sees the values: the hand-over needs
// no fence, where a release at a cluster barrier waits for every write the
// thread's block still has in flight.
__device__ __forceinline__ void store_counted(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               :
               : "r"(dst), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// The same for 8 bytes at an 8-byte aligned `dst`: `lo` lands at dst, `hi`
// at dst + 4 (a value with its index, or a pair of floats, in one store).
__device__ __forceinline__ void store_counted(uint32_t dst, uint32_t lo, uint32_t hi,
                                              uint32_t bar) {
  const unsigned long long v = (static_cast<unsigned long long>(hi) << 32) | lo;
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               :
               : "r"(dst), "l"(v), "r"(bar)
               : "memory");
}

// A ring of two shared-memory buffers of `rows` rows each, filled by bulk
// copies of the rows src + slots[i] * stride for i in a list of n. Chunk c
// is list entries [c * rows, min((c + 1) * rows, n)) and lands in buffer
// c % 2, whose barrier completes its (c / 2)-th phase when the bytes are
// in. The block issues chunks 0 and 1 at once and chunk c + 2 after every
// thread is done with chunk c, so up to two chunks stream in while the
// block works. Every chunk issued is waited for before the block exits.
struct RowRing {
  char* buf;             // 2 * rows * row_bytes bytes of shared memory
  uint64_t* bar;         // 2 barriers, initialised with one arrival each
  const char* src;       // row s starts at src + s * stride
  long long stride;      // bytes
  const int* slots;      // the list (shared memory)
  int n;                 // entries in the list
  int rows;              // rows a buffer holds
  int row_bytes;

  __device__ int chunks() const { return (n + rows - 1) / rows; }

  __device__ int chunk_rows(int c) const { return min(rows, n - c * rows); }

  // One warp: lane 0 arms the barrier with the chunk's bytes, then the
  // lanes issue one bulk copy a row. Chunks past the list are skipped.
  __device__ void issue(int c) const {
    if (c >= chunks()) return;
    const int lane = threadIdx.x & 31;
    const int nr = chunk_rows(c);
    uint64_t* b = bar + (c & 1);
    if (lane == 0) mbar_arrive_expect_tx(b, static_cast<uint32_t>(nr) * row_bytes);
    __syncwarp();
    char* dst = buf + static_cast<size_t>(c & 1) * rows * row_bytes;
    for (int i = lane; i < nr; i += 32)
      bulk_copy_g2s(dst + static_cast<size_t>(i) * row_bytes,
                    src + static_cast<long long>(slots[c * rows + i]) * stride, row_bytes, b);
  }

  // Every thread: waits until chunk c is in, returns its first row.
  __device__ const char* wait(int c) const {
    mbar_wait(bar + (c & 1), (c >> 1) & 1);
    return buf + static_cast<size_t>(c & 1) * rows * row_bytes;
  }

  // After the block's __syncthreads that ends its use of chunk c: warp
  // `warp` refills that buffer with chunk c + 2.
  __device__ void refill(int c, int warp) const {
    if ((threadIdx.x >> 5) != warp) return;
    async_proxy_fence();
    issue(c + 2);
  }
};

// The cluster barrier in two halves. Every thread of the cluster's blocks
// arrives once at the start of the kernel and waits before its first write
// into a partner's shared memory, so that no write lands in a block that
// has not started. Call both from code that every thread runs.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// An arrival that orders this thread's earlier writes (the start of its
// block's mbarriers, say) before what the cluster's threads do after their
// cluster_wait. The release waits for every write the thread's block has in
// flight: cheap at a kernel's start, microseconds while rows stream in.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Adds the partial sums of G groups of threads into group 0's registers in
// group order, so the result does not depend on timing. Thread `col` of
// group `grp` (threads [grp * stride, (grp + 1) * stride)) holds acc[0, n),
// n a multiple of 4 and at most M; threads with grp >= G take no part.
// Groups 1 .. G-1 store their sums as float4 in `part`, (G - 1) n stride
// floats of shared memory, float4 m of thread col of group g at
// ((g - 1) n / 4 + m) stride + col: a warp's float4 are consecutive, so no
// access has a bank conflict. Every thread of the block calls it after a
// __syncthreads that ends any other use of `part`.
template <int M>
__device__ __forceinline__ void add_group_partials(float (&acc)[M], int n, float4* part, int G,
                                                   int grp, int col, int stride) {
  if (G <= 1) return;
  const int n4 = n / 4;
  if (grp > 0 && grp < G) {
#pragma unroll
    for (int m = 0; m < M / 4; ++m)
      if (m < n4)
        part[((grp - 1) * n4 + m) * stride + col] =
            make_float4(acc[4 * m], acc[4 * m + 1], acc[4 * m + 2], acc[4 * m + 3]);
  }
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < G; ++g) {
#pragma unroll
      for (int m = 0; m < M / 4; ++m) {
        if (m < n4) {
          const float4 t = part[((g - 1) * n4 + m) * stride + col];
          acc[4 * m] += t.x;
          acc[4 * m + 1] += t.y;
          acc[4 * m + 2] += t.z;
          acc[4 * m + 3] += t.w;
        }
      }
    }
  }
}

// Thread 0 writes the SM's clock to stamps[blockIdx.x * kStampSlots + i]
// when the caller asked for stamps (a null pointer otherwise): the
// per-block phase breakdown that chip_smoke.py prints.
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0)
    stamps[static_cast<long long>(blockIdx.x) * kStampSlots + i] = clock64();
}

}  // namespace cvc
