// Fused masked additive (Bahdanau) attention, backward.
//
// Replaces cvc_tpu/ops/pallas/attention.py::fused_additive_attention's
// backward (_bwd_kernel, _bwd_pallas). For each image b, with the forward's
// residuals keys [S, A], q [A], w [A], v [S, H], mask [S], alpha [S] (float32)
// and the incoming g_ctx [H] (v's type) and g_alpha [S] (float32, or none):
//   dv[s, h]   = rnd(alpha[s]) * g_ctx[h]                       (working type)
//   d_alpha[s] = sum_h rnd(v[s, h] * g_ctx[h]) + g_alpha[s]       (float32 sum)
//   d_s[s]     = alpha[s] * (d_alpha[s] - sum_s' alpha * d_alpha) (float32)
//   u          = tanh(keys + q)                 recomputed, never stored
//   de[s, a]   = rnd(d_s[s]) * w[a] * (1 - u * u)                (working type)
//   dkeys = de,  dq[a] = sum_s de[s, a],  dw[a] = sum_b sum_s d_s * u (float32)
// rounding where the Pallas kernel rounds (rnd<T>; no-ops in float32).
//
// Bound: bytes. Each live key and value row is read once and dkeys and dv
// are written whole (2 S (A + H) elements an image) against a few
// operations an element: at the training shape (B 64, S 104 with 100
// live, A 512, H 1024) ~80 MB in float32, 24 us at 3.35 TB/s. So the
// design keeps device memory busy from the first clock: the key rows
// stream in while the value pass reads and writes, and every block of the
// card takes part (the blocks then wait, at the softmax backward, for the
// whole card's traffic of the first two passes: that wait is bandwidth,
// not the barrier).
//
// Design. A cluster of two blocks of 512 threads takes one image (grid 2B,
// 128 blocks for 132 SMs at B 64). Block r owns the live-list entries
// [0, n0) or [n0, n) (n0 = ceil(n / 2)) for both passes, and every other
// padding slot:
//   1. it lists the image's live and padding slots and asks the Tensor
//      Memory Accelerator (cp.async.bulk, one 1-D copy a row, on an
//      mbarrier) for its live key rows, into a ring of two shared-memory
//      buffers (the whole share at the training shape; larger S loops over
//      chunks), so the rows stream in during the value pass;
//   2. value pass, one warp a live row (16-byte loads, eight in flight a
//      lane; the warp that issues the copies takes none): d_alpha and the
//      dv row; then its padding rows of dv and dkeys are written as zeros;
//   3. softmax backward: each block sums alpha * d_alpha over its rows and
//      writes the sum into both blocks' shared memory (distributed shared
//      memory); after a cluster barrier both add the two in rank order;
//   4. key pass over the prefetched rows: threads own 16 bytes of columns,
//      groups of threads split the rows, dkeys rows go out whole, dq and
//      dw sum in registers and the groups' partials are added in group
//      order. In bf16 each rounded step, rnd(a o b) of two bf16 values with
//      o one of *, +, 1 -, is one bf16x2 instruction (mul.rn, add.rn,
//      sub.rn), which rounds the exact result once as rnd<T> does;
//   5. block 1 writes its dq and dw partials into block 0's shared memory;
//      after a cluster barrier block 0 adds them to its own in rank order
//      and writes dq and the image's float32 partial dw.
// dw sums over every image. Float atomics would make it depend on timing, so
// each cluster writes its image's float32 partial dw_part [B, A], and a
// second small kernel sums the partials over b in a fixed order (eight
// interleaved chains a column, added in order): two launches give
// bit-equal dw.
//
// Widths: A and H multiples of 16 bytes of elements, A at most 512 16-byte
// vectors (one column group a thread), 16-byte aligned tensors.
#include <cooperative_groups.h>

#include <type_traits>

#include "attention_common.cuh"
#include "row_ring.cuh"

namespace {

using namespace cvc;
namespace cg = cooperative_groups;

// Shared-memory plan of one block, in bytes; every region 16-byte aligned.
struct BwdPlan {
  int key_rows;   // rows a ring buffer holds; 0 when the widths do not fit
  size_t bars, counts, inner, q_t, w_t, g_s, m_s, al_s, ds_s, live, dead, red, ring, total;
};

template <typename T>
__host__ __device__ inline BwdPlan bwd_plan(int S, int A, int H, int threads) {
  BwdPlan p{};
  const size_t sz = sizeof(T);
  size_t o = 0;
  p.bars = o;   o += 16;                        // two mbarriers
  p.counts = o; o += 16;                        // live and padding slots
  p.inner = o;  o += 16;                        // [2] partial inner, by rank
  p.q_t = o;    o += up16(sz * A);              // q in T
  p.w_t = o;    o += up16(sz * A);              // w in T
  p.g_s = o;    o += up16(4 * static_cast<size_t>(H));
  p.m_s = o;    o += up16(4 * static_cast<size_t>(S));
  p.al_s = o;   o += up16(4 * static_cast<size_t>(S));
  p.ds_s = o;   o += up16(4 * static_cast<size_t>(S));   // d_alpha, then d_s
  p.live = o;   o += up16(4 * static_cast<size_t>(S));
  p.dead = o;   o += up16(4 * static_cast<size_t>(S));
  p.red = o;    o += up16(2 * 4 * static_cast<size_t>(A));   // block 1's dq, dw
  const size_t kb = sz * A;
  const size_t left = o < static_cast<size_t>(kMaxSmemBytes) ? kMaxSmemBytes - o : 0;
  const int own = (S + 1) / 2;
  int kr = (own + 1) / 2;
  const int kcap = static_cast<int>(left / (2 * kb));
  kr = kr < kcap ? kr : kcap;
  const int cols = A / kVec<T>;
  const int G = cols >= threads ? 1 : threads / cols;
  size_t ring = 2 * kr * kb;
  const size_t part = 2 * 4 * static_cast<size_t>(G - 1) * A;   // the groups' dq, dw
  if (ring < part) ring = part;
  p.ring = o;
  p.total = o + up16(ring);
  p.key_rows = kr;
  if (kr < 1 || cols > threads || p.total > static_cast<size_t>(kMaxSmemBytes)) p.key_rows = 0;
  return p;
}

// live[0..counts[0]) = slots with mask > 0, dead[0..counts[1]) the others,
// each in increasing order. Warp 0 compacts 32 slots a ballot.
__device__ void list_slots(const float* mask, int S, int* live, int* dead, int* counts) {
  if ((threadIdx.x >> 5) != 0) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int nl = 0, nd = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    const bool on = in && mask[s] > 0.f;
    const unsigned bl = __ballot_sync(0xffffffffu, on);
    const unsigned bd = __ballot_sync(0xffffffffu, in && !on);
    if (on) live[nl + __popc(bl & below)] = s;
    if (in && !on) dead[nd + __popc(bd & below)] = s;
    nl += __popc(bl);
    nd += __popc(bd);
  }
  if (lane == 0) {
    counts[0] = nl;
    counts[1] = nd;
  }
}

template <typename T>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kAttnThreads)
additive_attention_bwd_kernel(const T* __restrict__ keys, const T* __restrict__ q,
                              const T* __restrict__ w, const T* __restrict__ v,
                              const float* __restrict__ mask, const float* __restrict__ alpha,
                              const T* __restrict__ g_ctx, const float* __restrict__ g_alpha,
                              T* __restrict__ dkeys, T* __restrict__ dq, T* __restrict__ dv,
                              float* __restrict__ dw_part, long long* __restrict__ stamps, int S,
                              int A, int H) {
  constexpr int VEC = kVec<T>;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) char smem[];
  const BwdPlan P = bwd_plan<T>(S, A, H, kAttnThreads);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kClusterBlocks;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P.bars);
  int* counts = reinterpret_cast<int*>(smem + P.counts);
  float* inner = reinterpret_cast<float*>(smem + P.inner);
  T* q_t = reinterpret_cast<T*>(smem + P.q_t);
  T* w_t = reinterpret_cast<T*>(smem + P.w_t);
  float* g_s = reinterpret_cast<float*>(smem + P.g_s);
  float* m_s = reinterpret_cast<float*>(smem + P.m_s);
  float* al_s = reinterpret_cast<float*>(smem + P.al_s);
  float* ds_s = reinterpret_cast<float*>(smem + P.ds_s);
  int* live = reinterpret_cast<int*>(smem + P.live);
  int* dead = reinterpret_cast<int*>(smem + P.dead);
  float* red = reinterpret_cast<float*>(smem + P.red);   // [2][A]: block 1's dq, dw
  const long long bS = static_cast<long long>(b) * S;
  const T* v_b = v + bS * H;
  T* dkeys_b = dkeys + bS * A;
  T* dv_b = dv + bS * H;
  stamp(stamps, 0);
  cluster_arrive_relaxed();   // waited for before the first remote write

  // 1. residuals into shared memory, the slot lists, the key prefetch
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_init_fence();
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    q_t[a] = q[static_cast<long long>(b) * A + a];
    w_t[a] = w[a];
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x)
    g_s[h] = to_f(g_ctx[static_cast<long long>(b) * H + h]);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    m_s[s] = mask[bS + s];
    al_s[s] = alpha[bS + s];
  }
  __syncthreads();
  list_slots(m_s, S, live, dead, counts);
  __syncthreads();
  const int nl = counts[0], nd = counts[1];
  const int n0 = (nl + 1) / 2;
  const int own_lo = rank == 0 ? 0 : n0;
  const int n_own = rank == 0 ? n0 : nl - n0;
  const RowRing kr{smem + P.ring, bars, reinterpret_cast<const char*>(keys + bS * A),
                   static_cast<long long>(A * sizeof(T)), live + own_lo, n_own, P.key_rows,
                   static_cast<int>(A * sizeof(T))};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    kr.issue(0);
    kr.issue(1);
  }
  stamp(stamps, 1);

  // 2. dv rows and d_alpha of this block's live rows, one warp a row; warp 0
  // is still issuing the copies, so warps 1.. take the rows. A lane has up
  // to kRowLoads 16-byte loads of its row in flight before it computes.
  constexpr int kRowLoads = 8;
  for (int i = own_lo + warp - 1; warp > 0 && i < own_lo + n_own; i += nwarps - 1) {
    const int s = live[i];
    const float a_t = rnd<T>(al_s[s]);
    const T* row = v_b + static_cast<long long>(s) * H;
    T* drow = dv_b + static_cast<long long>(s) * H;
    float acc = 0.f;
    for (int h1 = lane * VEC; h1 < H; h1 += kRowLoads * 32 * VEC) {
      alignas(16) T vv[kRowLoads][VEC];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (h1 + u * 32 * VEC < H) load_vec<T>(vv[u], row + h1 + u * 32 * VEC);
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int h0 = h1 + u * 32 * VEC;
        if (h0 >= H) break;
        alignas(16) T out[VEC];
        if constexpr (kBF16) {
          // v * g and alpha * g of two bf16 values: one rounding each
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vv[u]);
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out);
          const __nv_bfloat162 a2 = __float2bfloat162_rn(a_t);
#pragma unroll
          for (int p = 0; p < VEC / 2; ++p) {
            const __nv_bfloat162 g2 = __floats2bfloat162_rn(g_s[h0 + 2 * p], g_s[h0 + 2 * p + 1]);
            const float2 vg = __bfloat1622float2(mul_rn(v2[p], g2));
            acc += vg.x;
            acc += vg.y;
            o2[p] = mul_rn(a2, g2);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float g = g_s[h0 + j];
            acc += to_f(vv[u][j]) * g;
            out[j] = a_t * g;
          }
        }
        store_vec<T>(drow + h0, out);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) ds_s[s] = acc + (g_alpha != nullptr ? g_alpha[bS + s] : 0.f);
  }
  // this block's padding rows (every other entry of the list): zero dv, dkeys
  {
    alignas(16) T zero[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) zero[j] = from_f<T>(0.f);
    const int hv = H / VEC, av = A / VEC;
    const int mine = (nd - rank + 1) / 2;   // entries rank, rank + 2, ...
    for (long long t = threadIdx.x; t < static_cast<long long>(mine) * (hv + av);
         t += blockDim.x) {
      const int i = static_cast<int>(t / (hv + av));
      const int e = static_cast<int>(t - static_cast<long long>(i) * (hv + av));
      const long long s = dead[2 * i + rank];
      if (e < hv)
        store_vec<T>(dv_b + s * H + e * VEC, zero);
      else
        store_vec<T>(dkeys_b + s * A + (e - hv) * VEC, zero);
    }
  }
  __syncthreads();
  stamp(stamps, 2);

  // 3. softmax backward: inner = sum alpha * d_alpha over the image, the two
  // blocks' sums added in rank order
  cluster_wait();   // the partner has started: its shared memory may be written
  if (warp == 0) {
    float acc = 0.f;
    for (int i = own_lo + lane; i < own_lo + n_own; i += 32) acc += al_s[live[i]] * ds_s[live[i]];
    acc = warp_sum(acc);
    if (lane == 0) {
      inner[rank] = acc;
      *cluster.map_shared_rank(inner + rank, rank ^ 1) = acc;
    }
  }
  cluster.sync();
  const float inner_sum = inner[0] + inner[1];
  for (int i = own_lo + threadIdx.x; i < own_lo + n_own; i += blockDim.x) {
    const int s = live[i];
    ds_s[s] = al_s[s] * (ds_s[s] - inner_sum);
  }
  __syncthreads();
  stamp(stamps, 3);

  // 4. dkeys rows, dq and dw over this block's prefetched key rows: threads
  // own VEC columns, G groups split each chunk's rows
  const int cols = A / VEC;
  const int stride = cols < static_cast<int>(blockDim.x) ? cols : blockDim.x;
  const int G = blockDim.x / stride;
  const int grp = threadIdx.x / stride;
  const int col = threadIdx.x % stride;   // cols <= blockDim.x: one column group a thread
  const int a0 = col * VEC;
  float acc[2 * VEC];   // dq's then dw's partial sums of the thread's columns
#pragma unroll
  for (int j = 0; j < 2 * VEC; ++j) acc[j] = 0.f;
  alignas(16) T qv[VEC], wv[VEC];
  *reinterpret_cast<uint4*>(qv) = *reinterpret_cast<const uint4*>(q_t + a0);
  *reinterpret_cast<uint4*>(wv) = *reinterpret_cast<const uint4*>(w_t + a0);
  for (int c = 0; c < kr.chunks(); ++c) {
    const T* rows = reinterpret_cast<const T*>(kr.wait(c));
    const int nr = kr.chunk_rows(c);
    if (grp < G) {
      for (int i = grp; i < nr; i += G) {
        const int s = live[own_lo + c * kr.rows + i];
        const float dsf = ds_s[s];
        alignas(16) T kv[VEC], out[VEC];
        *reinterpret_cast<uint4*>(kv) =
            *reinterpret_cast<const uint4*>(rows + static_cast<long long>(i) * A + a0);
        if constexpr (kBF16) {
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(kv);
          const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qv);
          const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(wv);
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out);
          const __nv_bfloat162 ds2 = __float2bfloat162_rn(dsf);
          const __nv_bfloat162 one2 = __float2bfloat162_rn(1.f);
#pragma unroll
          for (int p = 0; p < VEC / 2; ++p) {
            const float2 x = __bfloat1622float2(add_rn(k2[p], q2[p]));
            const __nv_bfloat162 u = __floats2bfloat162_rn(tanhf(x.x), tanhf(x.y));
            const __nv_bfloat162 de = mul_rn(mul_rn(ds2, w2[p]), sub_rn(one2, mul_rn(u, u)));
            o2[p] = de;
            const float2 df = __bfloat1622float2(de);
            const float2 uf = __bfloat1622float2(u);
            acc[2 * p] += df.x;
            acc[2 * p + 1] += df.y;
            acc[VEC + 2 * p] = fmaf(dsf, uf.x, acc[VEC + 2 * p]);
            acc[VEC + 2 * p + 1] = fmaf(dsf, uf.y, acc[VEC + 2 * p + 1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float u = tanhf(to_f(kv[j]) + to_f(qv[j]));
            const float de = dsf * to_f(wv[j]) * (1.f - u * u);
            out[j] = from_f<T>(de);
            acc[j] += de;
            acc[VEC + j] = fmaf(dsf, u, acc[VEC + j]);
          }
        }
        store_vec<T>(dkeys_b + static_cast<long long>(s) * A + a0, out);
      }
    }
    __syncthreads();
    kr.refill(c, 0);
  }
  // the groups' partials, added by group 0 in group order (the ring is spent)
  add_group_partials(acc, 2 * VEC, reinterpret_cast<float4*>(smem + P.ring), G, grp, col, stride);
  stamp(stamps, 4);

  // 5. block 1's partials into block 0, added there in rank order
  if (rank == 1 && grp == 0) {
    float* peer = cluster.map_shared_rank(red, 0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      peer[a0 + j] = acc[j];
      peer[A + a0 + j] = acc[VEC + j];
    }
  }
  cluster.sync();   // no remote access after this
  if (rank == 0 && grp == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dq[static_cast<long long>(b) * A + a0 + j] = from_f<T>(acc[j] + red[a0 + j]);
      dw_part[static_cast<long long>(b) * A + a0 + j] = acc[VEC + j] + red[A + a0 + j];
    }
  }
  stamp(stamps, 5);
}

// dw[a] = sum over b of dw_part[b, a] in a fixed order: lane l of the
// kSumLanes lanes of a column sums the images b = l, l + kSumLanes, ... in
// increasing order (kSumLanes independent chains of loads instead of one),
// then the lanes' sums are added in lane order.
constexpr int kSumLanes = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_images_kernel(const float* __restrict__ dw_part, T* __restrict__ dw, int B, int A) {
  __shared__ float part[kSumLanes][kThreads / kSumLanes];
  constexpr int kCols = kThreads / kSumLanes;
  const int c = threadIdx.x % kCols, l = threadIdx.x / kCols;
  const int a = blockIdx.x * kCols + c;
  float acc = 0.f;
  if (a < A)
    for (int b = l; b < B; b += kSumLanes) acc += dw_part[static_cast<long long>(b) * A + a];
  part[l][c] = acc;
  __syncthreads();
  if (l == 0 && a < A) {
    float t = part[0][c];
    for (int i = 1; i < kSumLanes; ++i) t += part[i][c];
    dw[a] = from_f<T>(t);
  }
}

template <typename T>
int launch(const void* keys, const void* q, const void* w, const void* v, const void* mask,
           const void* alpha, const void* g_ctx, const void* g_alpha, void* dkeys, void* dq,
           void* dw, void* dv, void* dw_part, void* stamps, int B, int S, int A, int H,
           cudaStream_t stream) {
  if (A % kVec<T> != 0 || H % kVec<T> != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan plan = bwd_plan<T>(S, A, H, kAttnThreads);
  if (plan.key_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = additive_attention_bwd_kernel<T>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_max_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) {
    if (A == 0) return 0;
    return static_cast<int>(cudaMemsetAsync(dw, 0, static_cast<size_t>(A) * sizeof(T), stream));
  }
  kernel<<<B * kClusterBlocks, kAttnThreads, plan.total, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(q), static_cast<const T*>(w),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(alpha), static_cast<const T*>(g_ctx),
      static_cast<const float*>(g_alpha), static_cast<T*>(dkeys), static_cast<T*>(dq),
      static_cast<T*>(dv), static_cast<float*>(dw_part), static_cast<long long*>(stamps), S, A,
      H);
  constexpr int kCols = kThreads / kSumLanes;
  sum_images_kernel<T><<<(A + kCols - 1) / kCols, kThreads, 0, stream>>>(
      static_cast<const float*>(dw_part), static_cast<T*>(dw), B, A);
  return 0;
}

}  // namespace

// g_alpha may be null: alpha then enters no loss and its gradient is zero.
// stamps: null, or int64 [2B, kStampSlots] for the phase clock stamps.
extern "C" int cvc_additive_attention_bwd(const void* keys, const void* q, const void* w,
                                          const void* v, const void* mask, const void* alpha,
                                          const void* g_ctx, const void* g_alpha, void* dkeys,
                                          void* dq, void* dw, void* dv, void* dw_part,
                                          void* stamps, int B, int S, int A, int H, int dtype,
                                          void* stream) {
  cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(keys) && aligned16(v) && aligned16(dkeys) && aligned16(dv)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32) {
    rc = launch<float>(keys, q, w, v, mask, alpha, g_ctx, g_alpha, dkeys, dq, dw, dv, dw_part,
                       stamps, B, S, A, H, st);
  } else if (dtype == kBF16) {
    rc = launch<__nv_bfloat16>(keys, q, w, v, mask, alpha, g_ctx, g_alpha, dkeys, dq, dw, dv,
                               dw_part, stamps, B, S, A, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
