// Fused masked additive (Bahdanau) attention, forward.
//
// Replaces cvc_tpu/ops/pallas/attention.py::fused_additive_attention
// (_kernel, _fwd_pallas).
//   keys [B, S, A], q [B, A], w [A], v [B, S, H], mask [B, S] float32
//   -> ctx [B, H] in v's type, alpha [B, S] float32
//   e = tanh(keys + q) (never stored), scores = sum_a rnd(e * w) in float32,
//   alpha = masked softmax in float32, ctx = sum_s rnd(rnd(alpha) * v) in
//   float32, stored in v's type (rnd: to the working type; no-op in float32)
//
// Bound: bytes. Each live key and value row is read once (S (A + H)
// elements an image: 19 MB in bf16, 38 MB in float32 at B 64 with 100 live
// slots, A 512, H 1024; 5.9 and 11.5 us at 3.35 TB/s) against a tanh and a
// few operations an element. A block that reads a row, reduces it and only
// then asks for the next has too few bytes in flight, and which rows are
// live is known from the mask at the start. So the design asks for every
// row at once and computes on them as they land:
//
// A cluster of two blocks of 512 threads takes one image (grid 2B, 128
// blocks for 132 SMs at B 64). Block r owns the live-list entries [0, n0)
// or [n0, n) (n0 = ceil(n / 2)) for the scores and the H columns
// [r H/2, (r + 1) H/2) of ctx over every live row:
//   1. it lists the image's live slots, and its last warp asks the Tensor
//      Memory Accelerator (cp.async.bulk, one 1-D copy a row, on an
//      mbarrier) for its key rows and, right behind them, for its half of
//      every live value row, into two rings of two shared-memory buffers,
//      so the value rows stream in while the scores are computed. The
//      copies queue at the rate the memory serves them, which holds that
//      warp for most of the kernel: it computes no score, and the other
//      warps meet it only where a buffer is to be refilled. In bf16 at
//      S 128 the whole image fits (~150 KB at 100 live slots) and nothing
//      is refilled; in float32 the key rows fit whole and the value ring
//      loops over chunks, as both do at the 1280-slot video width;
//   2. scores of its key rows as they land, one warp a row out of shared
//      memory; this pass is the block's arithmetic (a tanh an element:
//      ~3 us in bf16 on the hardware tanh, more with float32's tanhf);
//   3. each score is stored into both blocks' score arrays (distributed
//      shared memory) by st.async, which counts its bytes on the receiving
//      block's mbarrier; a block waits until the bytes of all n scores are
//      in and runs the masked softmax, the same in both blocks and in the
//      same order; each writes the alpha slots of its parity. A cluster
//      barrier here would need a release, which waits for every write the
//      block has in flight, the streaming value rows among them (3.3 us
//      on the card); the counted stores need no fence. No block touches
//      its partner's memory after its wait;
//   4. context over the prefetched value half-rows: a thread owns 16 bytes
//      of columns, groups of threads split each chunk's rows and group 0
//      adds the groups' partial sums in group order (bf16: rnd(alpha) * v of
//      two bf16 values is one mul.rn.bf16x2).
// Nothing depends on timing, so equal inputs give bit-equal ctx and alpha.
// Padding slots are never read; every element of ctx and alpha is written
// (a fully masked image: zeros). The kernel is launched as a programmatic
// dependent launch: its blocks may be scheduled during the tail of the
// kernel before it on the stream, and wait for that kernel's completion
// before they touch device memory.
//
// Widths: A a multiple of 16 bytes of elements, H of 32 bytes (each block's
// half in whole vectors), H / 2 at most 512 16-byte vectors (one column
// group a thread), 16-byte aligned tensors.
#include <cooperative_groups.h>

#include <type_traits>

#include "attention_common.cuh"
#include "row_ring.cuh"

namespace {

using namespace cvc;
namespace cg = cooperative_groups;

// Rows a buffer of the key ring and of the value ring hold, for an image
// with n live slots, in `bytes` of shared memory (key rows of kb bytes,
// value half-rows of vb): the block's share of the image whole (ceil(n / 2)
// key rows and n value rows, each in two buffers) where that fits; else the
// key rows whole where they leave the value ring at least half of the
// bytes (no key chunk then queues behind the value rows already asked for),
// else a third of the bytes, and the value ring takes what is left.
__host__ __device__ inline void split_rings(int n, size_t bytes, size_t kb, size_t vb, int* kr,
                                            int* vr) {
  const int own = (n + 1) / 2;
  int k = (own + 1) / 2, v = (n + 1) / 2;
  if (2 * (k * kb + v * vb) > bytes) {
    if (2 * k * kb > bytes / 2) k = static_cast<int>(bytes / 3 / (2 * kb));
    const int vcap = static_cast<int>((bytes - 2 * k * kb) / (2 * vb));
    v = v < vcap ? v : vcap;
  }
  *kr = k > 1 ? k : 1;
  *vr = v > 1 ? v : 1;
}

// Shared-memory plan of one block, in bytes; every region 16-byte aligned.
// The rings get what an image of S live slots needs, or what is left of
// the block's shared memory; the kernel splits them by the image's live
// count. The context's partial sums reuse the rings.
struct FwdPlan {
  bool fits;
  size_t bars, n_live, m_s, live, sc, q_t, w_t, rings, ring_bytes, total;
};

template <typename T>
__host__ __device__ inline FwdPlan fwd_plan(int S, int A, int H, int threads) {
  FwdPlan p{};
  const size_t sz = sizeof(T);
  const int HH = H / 2;
  size_t o = 0;
  p.bars = o;   o += 48;                        // five mbarriers
  p.n_live = o; o += 16;
  p.m_s = o;    o += up16(4 * static_cast<size_t>(S));
  p.live = o;   o += up16(4 * static_cast<size_t>(S));
  p.sc = o;     o += up16(4 * static_cast<size_t>(S));
  p.q_t = o;    o += up16(sz * A);              // q in T
  p.w_t = o;    o += up16(sz * A);              // w in T
  p.rings = o;
  const size_t kb = sz * A, vb = sz * HH;
  const size_t left = o < static_cast<size_t>(kMaxSmemBytes) ? kMaxSmemBytes - o : 0;
  const int cols = HH / kVec<T>;
  const int G = cols >= threads ? 1 : threads / cols;
  const size_t part = 4 * static_cast<size_t>(G - 1) * HH;   // the groups' ctx sums
  const size_t whole = 2 * (static_cast<size_t>((S + 3) / 4) * kb + ((S + 1) / 2) * vb);
  p.ring_bytes = whole < left ? whole : left;
  if (p.ring_bytes < part) p.ring_bytes = part;
  p.total = o + up16(p.ring_bytes);
  // a buffer of each ring holds a row or more, whatever the live count
  p.fits = cols <= threads && p.total <= static_cast<size_t>(kMaxSmemBytes) &&
           left / 3 >= 2 * kb && left / 2 >= 2 * vb;
  return p;
}

template <typename T>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kAttnThreads)
additive_attention_kernel(const T* __restrict__ keys, const T* __restrict__ q,
                          const T* __restrict__ w, const T* __restrict__ v,
                          const float* __restrict__ mask, T* __restrict__ ctx,
                          float* __restrict__ alpha, long long* __restrict__ stamps, int S,
                          int A, int H) {
  constexpr int VEC = kVec<T>;
  extern __shared__ __align__(128) char smem[];
  const FwdPlan P = fwd_plan<T>(S, A, H, kAttnThreads);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kClusterBlocks;
  const int HH = H / 2, j0 = rank * HH;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P.bars);
  int* n_live = reinterpret_cast<int*>(smem + P.n_live);
  float* m_s = reinterpret_cast<float*>(smem + P.m_s);
  int* live = reinterpret_cast<int*>(smem + P.live);
  float* sc = reinterpret_cast<float*>(smem + P.sc);   // [S] scores, then rnd(alpha)
  T* q_t = reinterpret_cast<T*>(smem + P.q_t);
  T* w_t = reinterpret_cast<T*>(smem + P.w_t);
  uint64_t* sc_bar = bars + 4;   // counts the bytes of the scores stored into sc
  const long long bS = static_cast<long long>(b) * S;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  cluster_arrive();   // after the barriers' start; waited for before the first remote store
  // The launch may overlap the tail of the kernel before it on the stream
  // (launch_dependent): no access to device memory before this wait.
  grid_dependency_wait();
  stamp(stamps, 0);

  // 1. the live slots and the prefetch of this block's rows
  for (int s = threadIdx.x; s < S; s += blockDim.x) m_s[s] = mask[bS + s];
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    q_t[a] = q[static_cast<long long>(b) * A + a];
    w_t[a] = w[a];
  }
  __syncthreads();
  list_live_slots(m_s, S, live, n_live);
  __syncthreads();
  const int n = *n_live;
  const int n0 = (n + 1) / 2;
  const int own_lo = rank == 0 ? 0 : n0;
  const int n_own = rank == 0 ? n0 : n - n0;
  int key_rows, val_rows;
  split_rings(n, P.ring_bytes, A * sizeof(T), HH * sizeof(T), &key_rows, &val_rows);
  char* ring_v = smem + P.rings + 2 * key_rows * A * sizeof(T);
  const RowRing kr{smem + P.rings, bars, reinterpret_cast<const char*>(keys + bS * A),
                   static_cast<long long>(A * sizeof(T)), live + own_lo, n_own, key_rows,
                   static_cast<int>(A * sizeof(T))};
  const RowRing vr{ring_v, bars + 2, reinterpret_cast<const char*>(v + bS * H + j0),
                   static_cast<long long>(H * sizeof(T)), live, n, val_rows,
                   static_cast<int>(HH * sizeof(T))};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int issue_warp = nwarps - 1;   // the others compute the scores
  if (warp == issue_warp) {
    // The copies queue at the rate the memory serves them, so this warp is
    // held until the last is taken; it computes no score, and the block
    // meets it only where a buffer is to be refilled. The key rows first.
    if (lane == 0 && n > 0) mbar_arrive_expect_tx(sc_bar, 4u * n);
    kr.issue(0);
    kr.issue(1);
    vr.issue(0);
    vr.issue(1);
  }
  cluster_wait();   // the partner's barriers are set up: its shared memory may be written
  stamp(stamps, 1);

  // 2. scores of this block's live rows, chunk by chunk, stored into both
  // blocks and counted on each block's score barrier
  const uint32_t sc_at[kClusterBlocks] = {cluster_addr(sc, 0), cluster_addr(sc, 1)};
  const uint32_t bar_at[kClusterBlocks] = {cluster_addr(sc_bar, 0), cluster_addr(sc_bar, 1)};
  for (int c = 0; c < kr.chunks(); ++c) {
    const T* rows = reinterpret_cast<const T*>(kr.wait(c));
    scores_smem<T, 1>(rows, live + own_lo + c * kr.rows, kr.chunk_rows(c), q_t, w_t, A,
                      issue_warp, [&](int, int s, float t) {
#pragma unroll
                        for (int r = 0; r < kClusterBlocks; ++r)
                          store_counted(sc_at[r] + 4u * s, t, bar_at[r]);
                      });
    if (c + 2 < kr.chunks()) {
      __syncthreads();
      kr.refill(c, issue_warp);
    }
  }
  stamp(stamps, 2);
  if (n > 0) mbar_wait(sc_bar, 0);   // every live slot's score is in; no remote access after this
  stamp(stamps, 3);

  // 3. masked softmax over all live slots, the same in both blocks
  softmax_rows_half<T>(sc, m_s, alpha + bS, 1, S, rank);
  __syncthreads();
  stamp(stamps, 4);

  // 4. ctx[j0 + ..] = sum over live s of rnd(rnd(alpha[s]) v[s, j0 + ..]):
  // threads own VEC columns, G groups split each chunk's rows
  const int cols = HH / VEC;
  const int stride = cols < static_cast<int>(blockDim.x) ? cols : blockDim.x;
  const int G = blockDim.x / stride;
  const int grp = threadIdx.x / stride;
  const int col = threadIdx.x % stride;   // cols <= blockDim.x: one column group a thread
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int c = 0; c < vr.chunks(); ++c) {
    const T* rows = reinterpret_cast<const T*>(vr.wait(c));
    const int nr = vr.chunk_rows(c);
    if (grp < G) {
#pragma unroll 4
      for (int i = grp; i < nr; i += G) {
        const float a = sc[live[c * vr.rows + i]];   // rnd(alpha)
        const uint4 raw =
            *reinterpret_cast<const uint4*>(rows + static_cast<long long>(i) * HH + col * VEC);
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
#pragma unroll
          for (int p = 0; p < VEC / 2; ++p) {
            const float2 av = __bfloat1622float2(mul_rn(a2, v2[p]));
            acc[2 * p] += av.x;
            acc[2 * p + 1] += av.y;
          }
        } else {
          const float* vv = reinterpret_cast<const float*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += __fmul_rn(a, vv[j]);
        }
      }
    }
    if (c + 2 < vr.chunks()) {
      __syncthreads();
      vr.refill(c, issue_warp);
    }
  }
  __syncthreads();
  stamp(stamps, 5);
  // the rings are spent: they hold the groups' partial sums
  add_group_partials(acc, VEC, reinterpret_cast<float4*>(smem + P.rings), G, grp, col, stride);
  if (grp == 0) {
    alignas(16) T out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = from_f<T>(acc[j]);
    store_vec<T>(ctx + static_cast<long long>(b) * H + j0 + col * VEC, out);
  }
  stamp(stamps, 6);
}

template <typename T>
int launch(const void* keys, const void* q, const void* w, const void* v, const void* mask,
           void* ctx, void* alpha, void* stamps, int B, int S, int A, int H,
           cudaStream_t stream) {
  if (A % kVec<T> != 0 || H % (2 * kVec<T>) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan plan = fwd_plan<T>(S, A, H, kAttnThreads);
  if (!plan.fits) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = additive_attention_kernel<T>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_max_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  launch_dependent(kernel, dim3(B * kClusterBlocks), dim3(kAttnThreads), plan.total, stream,
      static_cast<const T*>(keys), static_cast<const T*>(q), static_cast<const T*>(w),
      static_cast<const T*>(v), static_cast<const float*>(mask), static_cast<T*>(ctx),
      static_cast<float*>(alpha), static_cast<long long*>(stamps), S, A, H);
  return 0;
}

}  // namespace

// stamps: null, or int64 [2B, kStampSlots] for the phase clock stamps.
extern "C" int cvc_additive_attention_fwd(const void* keys, const void* q, const void* w,
                                          const void* v, const void* mask, void* ctx,
                                          void* alpha, void* stamps, int B, int S, int A, int H,
                                          int dtype, void* stream) {
  cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(keys) && aligned16(v) && aligned16(ctx)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32) {
    rc = launch<float>(keys, q, w, v, mask, ctx, alpha, stamps, B, S, A, H, st);
  } else if (dtype == kBF16) {
    rc = launch<__nv_bfloat16>(keys, q, w, v, mask, ctx, alpha, stamps, B, S, A, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
