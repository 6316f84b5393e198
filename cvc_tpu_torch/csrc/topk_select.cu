// Fused per-row top-k + logsumexp over the vocabulary.
//
// Replaces cvc_tpu/ops/pallas/topk_select.py::fused_topk_lse (_kernel).
//   logits [N, V] float32 or bf16, 1 <= k <= min(16, V)
//   -> vals [N, k] float32, idxs [N, k] int32, lse [N] float32
// Order is exactly lax.top_k's: descending value, and among equal values
// the lowest index first.
//
// Bound: bytes on paper (each logit is read once), but a decode step's
// logits are a few megabytes, which the card moves in a few microseconds: a
// call costs a launch, one round trip to memory, the instructions the SMs
// must issue (a compare or two and an exp an element, a selection a warp)
// and the merge. So the kernel is laid out for latency and for few
// instructions, not carried over from the TPU kernel's k sweeps of a tile
// held in fast memory:
//
// - A row is split over the blocks of a thread-block cluster, and the
//   caller picks the cluster's size (1, 2, 4 or 8) and the block's threads
//   from N and V so that the whole launch is resident on the card at once
//   and a thread holds kTopkVecs 16-byte vectors of its row (the rule is
//   `launch_shape` in ops/kernels/topk_select.py; a share too long for
//   that is walked in batches of kTopkVecs vectors a thread).
// - A thread asks for all the vectors of a batch before any math, so a row
//   costs one round trip to memory (RowBatch in vocab_row.cuh, which the
//   cross entropy's forward shares). Then two passes over its registers:
//   its two best elements, and one exp an element against its maximum, with
//   no rescale branch (on the special function unit: see exp2_approx).
//   Columns past V are never read, which is what the TPU kernel's -3e38
//   lane padding stands for.
// - No sorted k-list a thread: with 16 elements a thread, most of them
//   would enter it, and every entry costs the whole warp an insertion. A
//   thread keeps its two best. The warp picks the k best of its lanes'
//   proposals in k rounds of two warp-wide reductions each (redux.sync: the
//   largest order-preserving key, then the lowest index that holds it); a
//   lane whose first was taken goes on with its second, and every lane
//   keeps the picks as the warp's sorted list. Only a lane that lost both
//   can hold more of the warp's k best: it counts its elements at or above
//   the k-th pick, and where there are more than its two (three of a
//   warp's k best in one thread, or equal values) the warp walks its
//   elements once more and inserts.
// - No block-wide barrier. A warp merges its (max, sum) pairs by a
//   reduction and shuffles and stores its k winners and its pair straight
//   into the shared memory of the cluster's block of rank 0, each store
//   counted on that block's mbarrier (st.async). Two warps of rank 0 wait
//   for the bytes of all the row's warps: one merges the pairs, the other
//   picks the k best of the lists, one a lane, in k rounds of the same two
//   reductions over the lists' heads (the winner's lane pops it).
// - The kernel is compiled for k = 1 .. 8, and for 16, which serves k 9 to
//   16: the best k of a row are the first k of its best 16 in the total
//   order, so the launch writes those.
// - Every compare is by the total order (value descending, index
//   ascending) and every list has a fixed slot, so the result does not
//   depend on which block or warp arrives first, and the (max, sum) pairs
//   merge in a fixed tree: the outputs are bit-equal across launches.
// - It is a programmatic dependent launch: its blocks may be scheduled
//   during the tail of the kernel before it on the stream (the logits
//   product or its bias add), and wait for that kernel's completion before
//   their first access to device memory.
//
// Lifetimes in the cluster: only rank 0's shared memory is written from
// other blocks, and nothing is read remotely. No store is sent before every
// block of the cluster has started and rank 0's barrier is initialised (the
// cluster barrier whose arrival stands at the kernel's start and whose wait
// stands after the streaming loop, where it costs nothing). Rank 0 cannot
// exit before every store has landed, because its warp 0 waits for their
// bytes before it writes the row's results; a sender may exit with its
// stores in flight, since they touch nothing of its own.
#include <math.h>

#include <cooperative_groups.h>

#include "row_ring.cuh"
#include "vocab_row.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cvc;

constexpr int kTopkMaxThreads = 512;   // threads a block, at most
constexpr int kTopkVecs = 4;           // 16-byte vectors a thread holds at once
constexpr int kTopkMaxCluster = 8;     // blocks a row, at most (the portable cluster size)
constexpr int kTopkMaxLists = kTopkMaxCluster * kTopkMaxThreads / 32;   // warps a row
constexpr int kNoIndex = 0x7fffffff;   // the index of an empty entry (key 0)
constexpr int kTopkMaxK = 16;          // the largest k, compiled as one list length

// The total order of the selection: value descending, index ascending.
__device__ __forceinline__ bool better(unsigned ak, int ai, unsigned bk, int bi) {
  return ak > bk || (ak == bk && ai < bi);
}

// A sorted list of the K best (key, index) seen, best first. The warp's list
// is one that every lane holds the same copy of (pick, insert_from, spread:
// called by all lanes with the same arguments).
template <int K> struct TopList {
  unsigned k[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      k[j] = 0u;
      i[j] = kNoIndex;
    }
  }

  __device__ __forceinline__ bool admits(unsigned xk, int xi) const {
    return better(xk, xi, k[K - 1], i[K - 1]);
  }

  __device__ __forceinline__ void insert(unsigned xk, int xi) {
    if (!admits(xk, xi)) return;
    k[K - 1] = xk;
    i[K - 1] = xi;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (better(k[j], i[j], k[j - 1], i[j - 1])) {
        const unsigned fk = k[j]; k[j] = k[j - 1]; k[j - 1] = fk;
        const int iv = i[j]; i[j] = i[j - 1]; i[j - 1] = iv;
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      k[j] = k[j + 1];
      i[j] = i[j + 1];
    }
    k[K - 1] = 0u;
    i[K - 1] = kNoIndex;
  }

  // The K best of the lanes' proposals, two a lane in order, (pk, pi) and
  // then (qk, qi) ((0, kNoIndex) for none), in K rounds of two reductions:
  // a lane whose first was taken goes on with its second. Returns how many
  // of the lane's own were taken. Replaces the list.
  __device__ __forceinline__ int pick(unsigned pk, int pi, unsigned qk, int qi) {
    int used = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      k[j] = __reduce_max_sync(kFullWarp, pk);
      i[j] = __reduce_min_sync(kFullWarp, pk == k[j] ? pi : kNoIndex);
      if (pi == i[j] && pi != kNoIndex) {
        ++used;
        pk = qk;
        pi = qi;
        qk = 0u;
        qi = kNoIndex;
      }
    }
    return used;
  }

  // The lanes of `mask` each bring an entry: inserts them all.
  __device__ __forceinline__ void insert_from(unsigned mask, unsigned xk, int xi) {
    while (mask != 0u) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      insert(__shfl_sync(kFullWarp, xk, src), __shfl_sync(kFullWarp, xi, src));
    }
  }

  // Lane j < K gets the j-th entry.
  __device__ __forceinline__ void spread(int lane, unsigned& ok, int& oi) const {
    ok = 0u;
    oi = kNoIndex;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (lane == j) {
        ok = k[j];
        oi = i[j];
      }
    }
  }
};

// Element e of a thread's batch (element e % VEC of vector e / VEC) for an e
// known only at run time: selects, so that the batch stays in registers.
template <typename T>
__device__ __forceinline__ float element(const uint4 (&raw)[kTopkVecs], int e) {
  constexpr int VEC = kVec<T>;
  uint4 r = raw[0];
#pragma unroll
  for (int j = 1; j < kTopkVecs; ++j)
    if (e / VEC == j) r = raw[j];
  const int word = (e % VEC) * static_cast<int>(sizeof(T)) / 4;
  const unsigned w = word == 0 ? r.x : word == 1 ? r.y : word == 2 ? r.z : r.w;
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));   // bf16: a float's upper half
}

// grid: N clusters of C blocks; block b of cluster r takes the b-th share of
// row r's vectors. K: the lists' length, of which the first k <= K are
// written (vals, idxs [N, k]). stamps: null, or [N * C, kStampSlots] clock
// stamps.
template <typename T, int K>
__global__ void __launch_bounds__(kTopkMaxThreads, K <= 5 ? 3 : K <= 8 ? 2 : 1)
topk_lse_kernel(const T* __restrict__ logits, float* __restrict__ vals, int* __restrict__ idxs,
                float* __restrict__ lse, long long* __restrict__ stamps, int V, int C, int k) {
  constexpr int VEC = kVec<T>;
  // rank 0's: the row's lists, K (value, index) pairs each, and their (max, sum) pairs
  __shared__ uint2 cand[kTopkMaxLists * K];
  __shared__ float2 pairs[kTopkMaxLists];
  __shared__ uint64_t bar;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int r = blockIdx.x / C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lists = C * nwarps;
  if (rank == 0 && threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(&bar, static_cast<uint32_t>(lists) * (K + 1) * 8u);
  }
  // after the barrier's start, which mbar_init_fence has released to the
  // cluster; waited for before the first remote store
  cluster_arrive_relaxed();
  grid_dependency_wait();   // ahead of every access to device memory
  stamp(stamps, 0);

  // 1. this block's share of the row, a batch of kTopkVecs vectors a thread
  // at a time (one batch at the model's shapes): all loads, then the math
  const int nvec = V / VEC;
  const int per = (nvec + C - 1) / C;
  const int lo = rank * per;
  const int hi = min(nvec, lo + per);
  const T* row = logits + static_cast<long long>(r) * V;
  TopList<K> top;   // the warp's
  top.clear();
  float m = -INFINITY, s = 0.f;
  for (int b0 = lo; b0 < hi; b0 += blockDim.x * kTopkVecs) {   // the same trips for all
    RowBatch<kTopkVecs> rows;
    rows.load(row, b0 + threadIdx.x, blockDim.x, hi);
    // the thread's two best in the total order: its columns come in
    // increasing order, so "greater" keeps the first of equal values. b1
    // and b2 start as NaN, which the first elements replace whatever they
    // are (x > NaN is false, !(x <= NaN) true); e1 and e2 are the elements'
    // places among the thread's, -1 for none
    float b1 = __uint_as_float(0x7fffffffu), b2 = b1;
    int e1 = -1, e2 = -1;
#pragma unroll
    for (int j = 0; j < kTopkVecs; ++j) {
      if (rows.has(j)) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float xv = rows.at<T>(j, v);
          const bool first = !(xv <= b1), second = !(xv <= b2);
          b2 = first ? b1 : second ? xv : b2;
          e2 = first ? e1 : second ? j * VEC + v : e2;
          b1 = first ? xv : b1;
          e1 = first ? j * VEC + v : e1;
        }
      }
    }
    auto column = [&](int e) { return rows.column<T>(e / VEC, e % VEC); };
    TopList<K> batch;
    const int used = batch.pick(e1 < 0 ? 0u : key_of(b1), e1 < 0 ? kNoIndex : column(e1),
                                e2 < 0 ? 0u : key_of(b2), e2 < 0 ? kNoIndex : column(e2));
    // the sum of exp against the maximum so far
    const float M = e1 < 0 ? m : fmaxf(m, b1);
    const float ref = M > -INFINITY ? M : 0.f;   // nothing but -inf so far: every term is 0
    const float ref2 = -ref * kLog2e;
    float bs = 0.f;
#pragma unroll
    for (int j = 0; j < kTopkVecs; ++j) {
      if (rows.has(j)) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) bs += exp2_approx(fmaf(rows.at<T>(j, v), kLog2e, ref2));
      }
    }
    s = fmaf(s, expf(m - ref), bs);
    m = M;
    // Seldom: both of a lane's were taken. It counts its elements at or above
    // the K-th pick (all of them where fewer than K were picked), and if
    // there are more than its two, the warp walks its elements, one place of
    // every lane at a time, and inserts what beats the K-th
    if (__any_sync(kFullWarp, used == 2)) {
      const float least = batch.k[K - 1] == 0u ? -INFINITY : value_of(batch.k[K - 1]);
      int above = 0;
      if (used == 2) {
#pragma unroll
        for (int j = 0; j < kTopkVecs; ++j) {
          if (rows.has(j)) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) above += rows.at<T>(j, v) >= least ? 1 : 0;
          }
        }
      }
      if (__any_sync(kFullWarp, above > 2)) {
#pragma unroll 1
        for (int e = 0; e < kTopkVecs * VEC; ++e) {
          unsigned xk = 0u;
          if (rows.has(e / VEC) && e != e1 && e != e2)
            xk = key_of(element<T>(rows.raw, e));
          const int xi = column(e);
          batch.insert_from(__ballot_sync(kFullWarp, xk != 0u && batch.admits(xk, xi)), xk, xi);
        }
      }
    }
    if (b0 == lo) {
      top = batch;
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) top.insert(batch.k[j], batch.i[j]);
    }
  }
  stamp(stamps, 1);

  // 2. the warp's pair by shuffles; pair and list into rank 0's slots
  warp_lse_merge(m, s);
  unsigned wk;
  int wi;
  top.spread(lane, wk, wi);
  __syncwarp();
  cluster_wait();   // every block of the cluster runs, rank 0's barrier is set up
  const int slot = rank * nwarps + warp;
  const uint32_t bar0 = cluster_addr(&bar, 0);
  if (lane < K)
    store_counted(cluster_addr(cand + slot * K + lane, 0), wk, static_cast<uint32_t>(wi), bar0);
  else if (lane == K)
    store_counted(cluster_addr(pairs + slot, 0), __float_as_uint(m), __float_as_uint(s), bar0);
  stamp(stamps, 2);
  if (rank != 0 || warp > 1) return;

  // 3. rank 0's warps 0 and 1 wait for the row's lists and pairs. Warp 1
  // merges the pairs (a block of one warp does both). Warp 0 picks from the
  // lists, one a lane: K rounds of two reductions over the lanes' heads
  mbar_wait(&bar, 0);
  stamp(stamps, 3);
  if (warp == 1 || nwarps == 1) {
    m = -INFINITY;
    s = 0.f;
    for (int q = lane; q < lists; q += 32) lse_merge(m, s, pairs[q].x, pairs[q].y);
    warp_lse_merge(m, s);
    if (lane == 0) lse[r] = logf(s) + m;
    if (warp == 1) return;
  }
  // a lane's own list: the row's list of its number (sorted as it came), and
  // where a row has more than 32, every 32nd merged into it
  top.clear();
  if (lane < lists) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      top.k[j] = cand[lane * K + j].x;
      top.i[j] = static_cast<int>(cand[lane * K + j].y);
    }
  }
  for (int q = lane + 32; q < lists; q += 32)
    for (int j = 0; j < K; ++j) top.insert(cand[q * K + j].x, static_cast<int>(cand[q * K + j].y));
#pragma unroll
  for (int j = 0; j < K; ++j) {   // the best head of any lane; its lane pops it
    const unsigned jk = __reduce_max_sync(kFullWarp, top.k[0]);
    const int ji = __reduce_min_sync(kFullWarp, top.k[0] == jk ? top.i[0] : kNoIndex);
    if (top.i[0] == ji && ji != kNoIndex) top.pop();
    if (lane == j && j < k) {
      vals[static_cast<long long>(r) * k + j] = value_of(jk);
      idxs[static_cast<long long>(r) * k + j] = ji;
    }
  }
  stamp(stamps, 4);
}

template <typename T, int K>
int launch_k(const void* logits, void* vals, void* idxs, void* lse, void* stamps, int N, int V,
             int k, int cluster, int threads, cudaStream_t st) {
  return static_cast<int>(launch_dependent_cluster(
      topk_lse_kernel<T, K>, dim3(static_cast<unsigned>(N) * cluster), dim3(threads),
      static_cast<unsigned>(cluster), 0, st, static_cast<const T*>(logits),
      static_cast<float*>(vals), static_cast<int*>(idxs), static_cast<float*>(lse),
      static_cast<long long*>(stamps), V, cluster, k));
}

template <typename T>
int launch(const void* logits, void* vals, void* idxs, void* lse, void* stamps, int N, int V,
           int k, int cluster, int threads, cudaStream_t st) {
  switch (k) {
    case 1: return launch_k<T, 1>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 2: return launch_k<T, 2>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 3: return launch_k<T, 3>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 4: return launch_k<T, 4>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 5: return launch_k<T, 5>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 6: return launch_k<T, 6>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 7: return launch_k<T, 7>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    case 8: return launch_k<T, 8>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
    default:
      return launch_k<T, kTopkMaxK>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads,
                                    st);
  }
}

}  // namespace

// cluster: blocks a row, 1, 2, 4 or 8; threads: a block's, a multiple of 32
// up to 512. stamps: null, or int64 [N * cluster, kStampSlots].
extern "C" int cvc_topk_lse(const void* logits, void* vals, void* idxs, void* lse, void* stamps,
                            int N, int V, int k, int cluster, int threads, int dtype,
                            void* stream) {
  cudaGetLastError();
  if (k < 1 || k > kTopkMaxK || k > V) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster < 1 || cluster > kTopkMaxCluster || (cluster & (cluster - 1)) != 0 ||
      threads < 32 || threads > kTopkMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!aligned16(logits)) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32 && V % kVec<float> == 0) {
    rc = launch<float>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
  } else if (dtype == kBF16 && V % kVec<__nv_bfloat16> == 0) {
    rc = launch<__nv_bfloat16>(logits, vals, idxs, lse, stamps, N, V, k, cluster, threads, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
