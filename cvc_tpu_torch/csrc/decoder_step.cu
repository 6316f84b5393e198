// Fused beam decoder core: att-LSTM gating -> query projection -> masked
// additive attention -> context, for the K beams of each image.
//
// Replaces cvc_tpu/ops/pallas/decoder_step.py::fused_beam_decoder_core (_kernel).
//   gates1 [B, K, 4H], c_att [B, K, H], keys [B, S, A], v_enc [B, S, H],
//   mask [B, S] float32, att_wh [H, A], att_b [A], att_w [A]
//   -> h_att [B, K, H], c_att' [B, K, H], ctx [B, K, H], alpha [B, K, S] float32
//
// Bounds at the serving shapes (B 64, K 5, S 128 with 100 live, A 512,
// H 1024, bf16): bytes, ~26 MB a launch (the live key and value rows, read
// once for all K beams, are ~19 MB of it) or 7.7 us at 3.35 TB/s; and the
// special-function units, which evaluate the 16.4 M tanh of the scores
// (B K live A) at 16 a clock an SM: ~4.4 us over 132 SMs. The K beams of an
// image share each key and value row, so each live row is read from device
// memory once for all of them (the TPU kernel's reason to exist).
//
// Design. A cluster of two blocks of 512 threads takes one image (grid 2B,
// so 128 blocks for 132 SMs at B 64). Block r of the pair owns:
//   - the H columns [r H/2, (r + 1) H/2): it gates them for the K beams,
//     writes those columns of h and c, and reduces the q product over those
//     rows of att_wh;
//   - half of the live slots (entries [0, n0) or [n0, n) of the list of
//     live slots, n0 = ceil(n / 2)) for the scores;
//   - the same H columns of ctx, over every live row.
// At the start each block lists the live slots and asks the Tensor Memory
// Accelerator (cp.async.bulk, one 1-D copy a row, on an mbarrier) for its
// own live key rows and for its half of every live value row, into two
// rings of two shared-memory buffers; at the serving shape the whole image
// fits, so the rows stream in during the gating and the q product. Warps
// that have no gating to do issue the copies (issuing stalls a warp while
// the copies queue). Larger S (the 1280-slot video width) loops the same
// code over chunks of rows.
//
// The q product, q[k, a] = sum_j h[k, j] att_wh[j, a], runs in bf16 on the
// tensor cores with mma.sync.m16n8k16 (float32 sums) as q^T = att_wh^T h^T:
// A's 16 rows are 16 columns of att_wh and the 8 columns of the product are
// the beams (K <= 8 fills them, so no padding to 16 rows is needed). A warp
// reads att_wh rows with 16-byte loads straight into registers and
// transposes each 8x8 tile with movmatrix, so no staging buffer sits in
// shared memory (which holds the image's rows). wgmma is not the tool: it
// needs a 64-row tile and an image has at most 8 query rows, and the
// product is bound by reading att_wh (half of it, 512 KB, from L2 in every
// block: 64 MB of L2 reads a launch), not by the multiply. In float32 the
// product stays on the CUDA cores with float32 FMAs (TF32 would break
// parity with the plain version); it takes the same split.
//
// Every value that crosses the pair is written into both blocks' shared
// memory (distributed shared memory) before a cluster barrier, and every
// combine reads the two halves in rank order: the q partial sums (q =
// rnd((p0 + p1) + att_b)), then the scores, after which both blocks run the
// same masked softmax over all live slots. Inside a block the context's
// groups of threads add their partial sums in group order. So h, c, ctx and
// alpha are bit-equal across launches, and no block touches its partner's
// memory after the second cluster barrier. The rounding points are the
// Pallas kernel's: h rounded to the working type before the product,
// float32 sums, + att_b, q in the working type; bf16 scores add keys + q as
// bf16 pairs; alpha is rounded to the working type once, after the softmax,
// for the context. The kernel is compiled for each beam count, so that its
// per-beam loops run exactly K times.
//
// Widths: H and A multiples of 64 bytes of elements (the H halves must hold
// whole 16-row mma steps), H / 2 at most 512 16-byte vectors, K <= 8,
// 16-byte aligned tensors.
#include <cooperative_groups.h>

#include <type_traits>

#include "attention_common.cuh"
#include "row_ring.cuh"

namespace {

using namespace cvc;
namespace cg = cooperative_groups;

constexpr int kMmaRows = 8;   // beams in one mma tile (the product's n)

// Gating of units [j0, j0 + HH) for the K beams of image row0 / K, float32
// inside, h and c out in T; h (rounded to T) into h_s [K][hs] (local units).
template <typename T>
__device__ void gate_half(const T* __restrict__ gates1, const T* __restrict__ c_att,
                          T* __restrict__ h_out, T* __restrict__ c_out, T* h_s, int hs,
                          long long row0, int K, int H, int j0, int HH) {
  constexpr int V = kVec<T>;
  const int groups = HH / V;
  for (int idx = threadIdx.x; idx < K * groups; idx += blockDim.x) {
    const int k = idx / groups;
    const int jl = (idx - k * groups) * V;
    const T* g = gates1 + (row0 + k) * 4 * H + j0 + jl;
    const long long o = (row0 + k) * H + j0 + jl;
    alignas(16) T gi[V], gf[V], gg[V], go[V], cc[V], ho[V], co[V];
    load_vec<T>(gi, g);
    load_vec<T>(gf, g + H);
    load_vec<T>(gg, g + 2 * H);
    load_vec<T>(go, g + 3 * H);
    load_vec<T>(cc, c_att + o);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float i_ = sigmoid_f(to_f(gi[v]));
      const float f_ = sigmoid_f(to_f(gf[v]));
      const float g_ = tanhf(to_f(gg[v]));
      const float o_ = sigmoid_f(to_f(go[v]));
      const float c_new = f_ * to_f(cc[v]) + i_ * g_;
      ho[v] = from_f<T>(o_ * tanhf(c_new));
      co[v] = from_f<T>(c_new);
    }
    store_vec<T>(h_out + o, ho);
    store_vec<T>(c_out + o, co);
    *reinterpret_cast<uint4*>(h_s + k * hs + jl) = *reinterpret_cast<const uint4*>(ho);
  }
}

__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 partial q over rows [j0, j0 + HH) of att_wh on the tensor cores:
// qp[k * A + a] = sum_j h_s[k][j - j0] * att_wh[j, a] (float32 sums), for
// k < K, written to qp_own and qp_peer (the same offset in both blocks).
// h_s is bf16 [8][hs] with rows K..7 zero. A warp owns stripes of 32
// columns. Per 16-row step, lane (g = lane / 4, c = lane % 4) loads 16
// bytes of rows j + g and j + 8 + g at columns 8c .. 8c + 7: register p of
// the first load is element (g, 2c..2c+1) of an 8x8 tile V_p whose column
// 2c + e is att_wh column 8c + 2p + e; movmatrix gives V_p^T, an A
// fragment of rows (att_wh columns) 8 (m / 2) + 2p + m % 2, m < 8. Tiles
// p = 0, 1 make the 16 rows of one mma, p = 2, 3 of the next.
__device__ void query_partial_mma(const __nv_bfloat16* __restrict__ att_wh,
                                  const __nv_bfloat16* h_s, int hs, float* qp_own,
                                  float* qp_peer, int K, int A, int j0, int HH) {
  constexpr int U = 8;   // 16-row steps whose loads are in flight together
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int steps = HH / 16;
  const uint32_t* hrow = reinterpret_cast<const uint32_t*>(h_s + g * hs);
  for (int stripe = threadIdx.x >> 5; stripe * 32 < A; stripe += blockDim.x >> 5) {
    const __nv_bfloat16* base =
        att_wh + static_cast<long long>(j0 + g) * A + stripe * 32 + 8 * c;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int s0 = 0; s0 < steps; s0 += U) {
      uint4 lo[U], hi[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u < steps) {
          const __nv_bfloat16* p = base + static_cast<long long>((s0 + u) * 16) * A;
          lo[u] = __ldg(reinterpret_cast<const uint4*>(p));
          hi[u] = __ldg(reinterpret_cast<const uint4*>(p + 8LL * A));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u < steps) {
          const int jl = (s0 + u) * 16;   // local row of h
          const uint32_t b0 = hrow[(jl + 2 * c) >> 1];
          const uint32_t b1 = hrow[(jl + 8 + 2 * c) >> 1];
          mma_16816(acc[0], transpose8x8(lo[u].x), transpose8x8(lo[u].y),
                    transpose8x8(hi[u].x), transpose8x8(hi[u].y), b0, b1);
          mma_16816(acc[1], transpose8x8(lo[u].z), transpose8x8(lo[u].w),
                    transpose8x8(hi[u].z), transpose8x8(hi[u].w), b0, b1);
        }
      }
    }
    // d0: (m g, beam 2c), d1: (g, 2c + 1), d2: (g + 8, 2c), d3: (g + 8, 2c + 1)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 2 * c + (e & 1);
        const int p = 2 * t + (e >> 1);
        const int a = stripe * 32 + 8 * (g >> 1) + 2 * p + (g & 1);
        if (k < K) {
          qp_own[k * A + a] = acc[t][e];
          qp_peer[k * A + a] = acc[t][e];
        }
      }
    }
  }
}

// float32 partial q over rows [j0, j0 + HH) on the CUDA cores. A warp owns
// blocks of 16 columns: lane = 4 jg + cg reads 4 columns of rows jg, jg + 8,
// ... with one 16-byte load; the 8 row groups are summed with shuffles.
template <int KB>
__device__ void query_partial_f32(const float* __restrict__ att_wh, const float* h_s, int hs,
                                  float* qp_own, float* qp_peer, int A, int j0, int HH) {
  constexpr int QV = kVec<float>;
  constexpr int CW = 4 * QV;
  const int lane = threadIdx.x & 31;
  const int jg = lane >> 2;
  const int cg = lane & 3;
  for (int cb = threadIdx.x >> 5; cb * CW < A; cb += blockDim.x >> 5) {
    const int a0 = cb * CW + cg * QV;
    float acc[KB][QV];
#pragma unroll
    for (int k = 0; k < KB; ++k)
#pragma unroll
      for (int v = 0; v < QV; ++v) acc[k][v] = 0.f;
#pragma unroll 8
    for (int j = jg; j < HH; j += 8) {
      alignas(16) float w[QV];
      load_vec<float>(w, att_wh + static_cast<long long>(j0 + j) * A + a0);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const float hv = h_s[k * hs + j];
#pragma unroll
        for (int v = 0; v < QV; ++v) acc[k][v] = fmaf(hv, w[v], acc[k][v]);
      }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
#pragma unroll
      for (int v = 0; v < QV; ++v) {
        float t = acc[k][v];
        t += __shfl_xor_sync(0xffffffffu, t, 4);
        t += __shfl_xor_sync(0xffffffffu, t, 8);
        t += __shfl_xor_sync(0xffffffffu, t, 16);
        if (jg == 0) {
          qp_own[k * A + a0 + v] = t;
          qp_peer[k * A + a0 + v] = t;
        }
      }
    }
  }
}

// Shared-memory plan of one block, in bytes; every region 16-byte aligned.
struct CorePlan {
  int hs, key_rows, val_rows;
  size_t bars, n_live, m_s, live, w_s, h_s, qp, q, sc, ring_k, ring_v, total;
};

// Rings sized to the image's need (own keys: ceil(S / 2) rows, values: S
// rows, each in two buffers) or, where that does not fit, to what is left
// of the block's shared memory; the context's partial sums reuse the rings.
// key_rows == 0 when the widths do not fit at all.
template <typename T>
__host__ __device__ inline CorePlan core_plan(int K, int S, int A, int H, int threads) {
  CorePlan p{};
  const int HH = H / 2;
  const int sz = static_cast<int>(sizeof(T));
  p.hs = HH + 16 / sz;   // padded rows: the mma's B loads hit 8 banks
  size_t o = 0;
  p.bars = o;   o += 64;
  p.n_live = o; o += 16;
  p.m_s = o;    o += up16(4 * static_cast<size_t>(S));
  p.live = o;   o += up16(4 * static_cast<size_t>(S));
  p.w_s = o;    o += up16(4 * static_cast<size_t>(A));
  p.h_s = o;    o += up16(static_cast<size_t>(kMmaRows) * p.hs * sz);
  p.qp = o;     o += up16(2 * 4 * static_cast<size_t>(K) * A);
  p.q = o;      o += up16(static_cast<size_t>(K) * A * sz);
  p.sc = o;     o += up16(4 * static_cast<size_t>(K) * S);
  const size_t kb = static_cast<size_t>(A) * sz, vb = static_cast<size_t>(HH) * sz;
  const size_t left = o < static_cast<size_t>(kMaxSmemBytes) ? kMaxSmemBytes - o : 0;
  const int own = (S + 1) / 2;
  int kr = (own + 1) / 2, vr = (S + 1) / 2;
  if (2 * (kr * kb + vr * vb) > left) {   // a third of what is left for keys
    const int kcap = static_cast<int>(left / 3 / (2 * kb));
    kr = kr < kcap ? kr : kcap;
    const int vcap = static_cast<int>((left - 2 * kr * kb) / (2 * vb));
    vr = vr < vcap ? vr : vcap;
  }
  const int cols = HH / kVec<T>;
  const int G = cols >= threads ? 1 : threads / cols;
  const size_t part = 4 * static_cast<size_t>(G - 1) * K * HH;
  size_t rings = 2 * (kr * kb + vr * vb);
  if (rings < part) rings = part;
  p.ring_k = o;
  p.ring_v = o + 2 * kr * kb;
  p.total = o + up16(rings);
  p.key_rows = kr;
  p.val_rows = vr;
  if (kr < 1 || vr < 1 || p.total > static_cast<size_t>(kMaxSmemBytes)) p.key_rows = 0;
  return p;
}

template <typename T, int KB>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kAttnThreads)
beam_decoder_core_kernel(const T* __restrict__ gates1, const T* __restrict__ c_att,
                         const T* __restrict__ keys, const T* __restrict__ v_enc,
                         const float* __restrict__ mask, const T* __restrict__ att_wh,
                         const T* __restrict__ att_b, const T* __restrict__ att_w,
                         T* __restrict__ h_out, T* __restrict__ c_out, T* __restrict__ ctx,
                         float* __restrict__ alpha, long long* __restrict__ stamps, int S,
                         int A, int H) {
  constexpr int VEC = kVec<T>;
  constexpr int K = KB;
  extern __shared__ __align__(128) char smem[];
  const CorePlan P = core_plan<T>(K, S, A, H, kAttnThreads);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int peer = rank ^ 1;
  const int b = blockIdx.x / kClusterBlocks;
  const long long row0 = static_cast<long long>(b) * K;
  const int HH = H / 2, j0 = rank * HH;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P.bars);
  int* n_live = reinterpret_cast<int*>(smem + P.n_live);
  float* m_s = reinterpret_cast<float*>(smem + P.m_s);
  int* live = reinterpret_cast<int*>(smem + P.live);
  float* w_s = reinterpret_cast<float*>(smem + P.w_s);
  T* h_s = reinterpret_cast<T*>(smem + P.h_s);
  float* qp = reinterpret_cast<float*>(smem + P.qp);   // [2][K][A], by rank
  T* q = reinterpret_cast<T*>(smem + P.q);              // [K][A]
  float* sc = reinterpret_cast<float*>(smem + P.sc);    // [K][S]
  float* qp_peer = cluster.map_shared_rank(qp, peer);
  float* sc_peer = cluster.map_shared_rank(sc, peer);
  stamp(stamps, 0);
  cluster_arrive_relaxed();   // waited for before the first remote write

  // 1. the live slots, the prefetch of this block's rows, the gating
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    m_s[s] = mask[static_cast<long long>(b) * S + s];
  for (int a = threadIdx.x; a < A; a += blockDim.x) w_s[a] = to_f(att_w[a]);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {   // mma rows K..7 are zero
    for (int i = threadIdx.x; i < (kMmaRows - K) * P.hs; i += blockDim.x)
      h_s[K * P.hs + i] = from_f<T>(0.f);
  }
  __syncthreads();
  list_live_slots(m_s, S, live, n_live);
  __syncthreads();
  const int n = *n_live;
  const int n0 = (n + 1) / 2;
  const int own_lo = rank == 0 ? 0 : n0;
  const int n_own = rank == 0 ? n0 : n - n0;
  const RowRing kr{smem + P.ring_k, bars,
                   reinterpret_cast<const char*>(keys + static_cast<long long>(b) * S * A),
                   static_cast<long long>(A * sizeof(T)), live + own_lo, n_own, P.key_rows,
                   static_cast<int>(A * sizeof(T))};
  const RowRing vr{smem + P.ring_v, bars + 2,
                   reinterpret_cast<const char*>(v_enc + static_cast<long long>(b) * S * H + j0),
                   static_cast<long long>(H * sizeof(T)), live, n, P.val_rows,
                   static_cast<int>(HH * sizeof(T))};
  // the last four warps issue the copies: the gating's items go to the
  // first threads, and up to K = 6 beams leave these warps without any
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (warp == nwarps - 4) kr.issue(0);
  if (warp == nwarps - 3) kr.issue(1);
  if (warp == nwarps - 2) vr.issue(0);
  if (warp == nwarps - 1) vr.issue(1);
  gate_half<T>(gates1, c_att, h_out, c_out, h_s, P.hs, row0, K, H, j0, HH);
  __syncthreads();
  cluster_wait();   // the partner has started: its shared memory may be written
  stamp(stamps, 1);

  // 2. partial q over this block's rows of att_wh, into both blocks
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    query_partial_mma(att_wh, h_s, P.hs, qp + rank * K * A, qp_peer + rank * K * A, K, A, j0, HH);
  else
    query_partial_f32<KB>(att_wh, h_s, P.hs, qp + rank * K * A, qp_peer + rank * K * A, A, j0, HH);
  stamp(stamps, 2);
  cluster.sync();
  for (int i = threadIdx.x; i < K * A; i += blockDim.x)
    q[i] = from_f<T>((qp[i] + qp[K * A + i]) + to_f(att_b[i % A]));
  __syncthreads();
  stamp(stamps, 3);

  // 3. scores of this block's live rows, chunk by chunk, into both blocks
  for (int c = 0; c < kr.chunks(); ++c) {
    const T* rows = reinterpret_cast<const T*>(kr.wait(c));
    scores_smem<T, KB>(rows, live + own_lo + c * kr.rows, kr.chunk_rows(c), q, w_s, A, nwarps,
                       [&](int k, int s, float t) {
                         sc[k * S + s] = t;
                         sc_peer[k * S + s] = t;
                       });
    __syncthreads();
    kr.refill(c, 0);
  }
  stamp(stamps, 4);
  cluster.sync();   // every score in both blocks; no remote access after this

  // 4. masked softmax over all live slots, the same in both blocks
  softmax_rows_half<T>(sc, m_s, alpha + row0 * S, K, S, rank);
  __syncthreads();
  stamp(stamps, 5);

  // 5. ctx[k, j0 + ..] = sum over live s of rnd(alpha[k, s]) v[s, j0 + ..]:
  // threads own VEC columns, G groups split each chunk's rows, group 0 adds
  // the others' partial sums in group order
  const int cols = HH / VEC;
  const int stride = cols < static_cast<int>(blockDim.x) ? cols : blockDim.x;
  const int G = blockDim.x / stride;
  const int grp = threadIdx.x / stride;
  const int col = threadIdx.x % stride;   // cols <= blockDim.x: one column a thread
  float acc[KB * VEC];   // [k][j]
#pragma unroll
  for (int i = 0; i < KB * VEC; ++i) acc[i] = 0.f;
  for (int c = 0; c < vr.chunks(); ++c) {
    const T* rows = reinterpret_cast<const T*>(vr.wait(c));
    const int nr = vr.chunk_rows(c);
    if (grp < G) {
      for (int i = grp; i < nr; i += G) {
        const int s = live[c * vr.rows + i];
        alignas(16) T vv[VEC];
        *reinterpret_cast<uint4*>(vv) =
            *reinterpret_cast<const uint4*>(rows + static_cast<long long>(i) * HH + col * VEC);
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          const float a = sc[k * S + s];   // rnd(alpha)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[k * VEC + j] = fmaf(a, to_f(vv[j]), acc[k * VEC + j]);
        }
      }
    }
    __syncthreads();
    vr.refill(c, 1);
  }
  // the rings are spent: they hold the groups' partial sums
  add_group_partials(acc, K * VEC, reinterpret_cast<float4*>(smem + P.ring_k), G, grp, col,
                     stride);
  if (grp == 0) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      alignas(16) T out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = from_f<T>(acc[k * VEC + j]);
      store_vec<T>(ctx + (row0 + k) * H + j0 + col * VEC, out);
    }
  }
  __syncthreads();
  stamp(stamps, 6);
}

template <typename T, int KB>
int launch(const void* gates1, const void* c_att, const void* keys, const void* v_enc,
           const void* mask, const void* att_wh, const void* att_b, const void* att_w,
           void* h_out, void* c_out, void* ctx, void* alpha, void* stamps, int B, int K, int S,
           int A, int H, cudaStream_t stream) {
  constexpr int W = 64 / static_cast<int>(sizeof(T));   // 64 bytes of elements
  if (A % W != 0 || H % W != 0 || H / 2 / kVec<T> > kAttnThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const CorePlan plan = core_plan<T>(K, S, A, H, kAttnThreads);
  if (plan.key_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = beam_decoder_core_kernel<T, KB>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_max_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  kernel<<<B * kClusterBlocks, kAttnThreads, plan.total, stream>>>(
      static_cast<const T*>(gates1), static_cast<const T*>(c_att), static_cast<const T*>(keys),
      static_cast<const T*>(v_enc), static_cast<const float*>(mask),
      static_cast<const T*>(att_wh), static_cast<const T*>(att_b), static_cast<const T*>(att_w),
      static_cast<T*>(h_out), static_cast<T*>(c_out), static_cast<T*>(ctx),
      static_cast<float*>(alpha), static_cast<long long*>(stamps), S, A, H);
  return 0;
}

// The kernel is compiled for each beam count K = 1 .. kMaxBeams, so that
// its per-beam loops run exactly K times.
template <typename T>
int launch_k(const void* gates1, const void* c_att, const void* keys, const void* v_enc,
             const void* mask, const void* att_wh, const void* att_b, const void* att_w,
             void* h_out, void* c_out, void* ctx, void* alpha, void* stamps, int B, int K, int S,
             int A, int H, cudaStream_t stream) {
  switch (K) {
#define CVC_BEAMS(k)                                                                          \
  case k:                                                                                     \
    return launch<T, k>(gates1, c_att, keys, v_enc, mask, att_wh, att_b, att_w, h_out, c_out, \
                        ctx, alpha, stamps, B, K, S, A, H, stream);
    CVC_BEAMS(1) CVC_BEAMS(2) CVC_BEAMS(3) CVC_BEAMS(4)
    CVC_BEAMS(5) CVC_BEAMS(6) CVC_BEAMS(7) CVC_BEAMS(8)
#undef CVC_BEAMS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// stamps: null, or int64 [2B, kStampSlots] for the phase clock stamps.
extern "C" int cvc_beam_decoder_core(const void* gates1, const void* c_att, const void* keys,
                                     const void* v_enc, const void* mask, const void* att_wh,
                                     const void* att_b, const void* att_w, void* h_out,
                                     void* c_out, void* ctx, void* alpha, void* stamps, int B,
                                     int K, int S, int A, int H, int dtype, void* stream) {
  cudaGetLastError();
  if (K < 1 || K > kMaxBeams) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(keys) && aligned16(v_enc) && aligned16(ctx) && aligned16(gates1) &&
        aligned16(c_att) && aligned16(h_out) && aligned16(c_out) && aligned16(att_wh)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32) {
    rc = launch_k<float>(gates1, c_att, keys, v_enc, mask, att_wh, att_b, att_w, h_out, c_out,
                       ctx, alpha, stamps, B, K, S, A, H, st);
  } else if (dtype == kBF16) {
    rc = launch_k<__nv_bfloat16>(gates1, c_att, keys, v_enc, mask, att_wh, att_b, att_w, h_out,
                               c_out, ctx, alpha, stamps, B, K, S, A, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
