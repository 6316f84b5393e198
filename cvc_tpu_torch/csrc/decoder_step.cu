// Fused beam decoder core: att-LSTM gating -> query projection -> masked
// additive attention -> context, for the K beams of each image.
//
// Replaces cvc_tpu/ops/pallas/decoder_step.py::fused_beam_decoder_core (_kernel).
//   gates1 [B, K, 4H], c_att [B, K, H], keys [B, S, A], v_enc [B, S, H],
//   mask [B, S] float32, att_wh [H, A], att_b [A], att_w [A]
//   -> h_att [B, K, H], c_att' [B, K, H], ctx [B, K, H], alpha [B, K, S] float32
//
// Bound: bytes at the serving shapes (B = 64, K = 5, S = 128 with 100 live,
// A = 512, H = 1024 in bf16: ~6 MB of live keys and ~13 MB of live values
// per step against ~0.4 GFLOP). The region tensors are shared by the K
// beams of an image and are the bulk of the traffic, so the design is one
// block of 512 threads per image that reads each live key row and value
// row from device memory once and applies it to all K beams (the TPU
// kernel's reason to exist: the beams never repeat the region tensors K
// times). Inside the block:
//   1. gating in float32 with 16-byte accesses; the K new h rows, rounded
//      to the working type, go to shared memory ([K, H] floats); the live
//      slots are listed;
//   2. q = h @ att_wh + att_b with an FMA loop on the CUDA cores, float32
//      sums, rounded to the working type ([K, A] in shared memory). Each
//      lane reads 16 bytes of a row and a warp eight rows at once, so many
//      loads are in flight; att_wh (1 MB in bf16) is read by every block
//      and stays in L2;
//   3. scores: one warp per live region row, tanh(keys + q) never stored;
//   4. masked softmax per beam row (float32, fully masked image -> 0);
//   5. ctx = alpha @ v_enc[b]: each thread owns 16 bytes of columns and
//      all K beams, four groups of threads split the live rows.
// Rows move in 16-byte vectors only: H a multiple of kVec, A a multiple of
// 4 * kVec (the q product's warp width), 16-byte aligned tensors.
// The S axis is looped over, so S = 1280 (the video width) fits in shared
// memory. Steps 2 and 3 run on the CUDA cores; putting step 2 on the
// tensor cores, sharing att_wh across blocks, and spreading an image over
// more than one SM are left for later.
#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace cvc;

// Step 1, att-LSTM gating for the K beams of image row0 / K: float32
// inside, h and c out in T, and h (rounded to T) into h_s [K, H]. Each
// thread takes kVec consecutive units of one beam (one 16-byte access per
// gate block).
template <typename T>
__device__ void gate_beams(const T* __restrict__ gates1, const T* __restrict__ c_att,
                           T* __restrict__ h_out, T* __restrict__ c_out, float* h_s,
                           long long row0, int K, int H) {
  constexpr int V = kVec<T>;
  const int groups = H / V;
  for (int idx = threadIdx.x; idx < K * groups; idx += blockDim.x) {
    const int k = idx / groups;
    const int j = (idx - k * groups) * V;
    const T* g = gates1 + (row0 + k) * 4 * H + j;
    const long long o = (row0 + k) * H + j;
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
      const float h_new = o_ * tanhf(c_new);
      ho[v] = from_f<T>(h_new);
      co[v] = from_f<T>(c_new);
      h_s[k * H + j + v] = rnd<T>(h_new);
    }
    store_vec<T>(h_out + o, ho);
    store_vec<T>(c_out + o, co);
  }
}

// Step 2, q[k, a] = rnd(sum_j h[k, j] * att_wh[j, a] + att_b[a]) with
// float32 sums, into q_s [K, A]. Each warp owns a block of 4 * QV columns:
// lane = 4 * jg + cg reads QV consecutive columns of rows j = jg, jg + 8, ...
// with one 16-byte load, so a warp keeps eight rows' loads in flight; the
// eight row groups are summed with shuffles at the end. Needs A % (4 * QV)
// == 0 and a 16-byte aligned att_wh.
template <typename T>
__device__ void query_product(const T* __restrict__ att_wh, const T* __restrict__ att_b,
                              const float* h_s, float* q_s, int K, int A, int H) {
  constexpr int QV = kVec<T>;
  constexpr int CW = 4 * QV;
  const int lane = threadIdx.x & 31;
  const int jg = lane >> 2;
  const int cg = lane & 3;
  for (int cb = threadIdx.x >> 5; cb * CW < A; cb += blockDim.x >> 5) {
    const int a0 = cb * CW + cg * QV;
    float acc[kMaxBeams][QV];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
      for (int v = 0; v < QV; ++v) acc[k][v] = 0.f;
#pragma unroll 8
    for (int j = jg; j < H; j += 8) {
      alignas(16) T w[QV];
      load_vec<T>(w, att_wh + static_cast<long long>(j) * A + a0);
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) {
        if (k < K) {
          const float hv = h_s[k * H + j];
#pragma unroll
          for (int v = 0; v < QV; ++v) acc[k][v] = fmaf(hv, to_f(w[v]), acc[k][v]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < K) {
#pragma unroll
        for (int v = 0; v < QV; ++v) {
          float t = acc[k][v];
          t += __shfl_xor_sync(0xffffffffu, t, 4);
          t += __shfl_xor_sync(0xffffffffu, t, 8);
          t += __shfl_xor_sync(0xffffffffu, t, 16);
          if (jg == 0) q_s[k * A + a0 + v] = rnd<T>(t + to_f(att_b[a0 + v]));
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
beam_decoder_core_kernel(const T* __restrict__ gates1, const T* __restrict__ c_att,
                         const T* __restrict__ keys, const T* __restrict__ v_enc,
                         const float* __restrict__ mask, const T* __restrict__ att_wh,
                         const T* __restrict__ att_b, const T* __restrict__ att_w,
                         T* __restrict__ h_out, T* __restrict__ c_out, T* __restrict__ ctx,
                         float* __restrict__ alpha, int K, int S, int A, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                                    // [K, H]
  float* q_s = h_s + K * H;                             // [K, A]
  float* w_s = q_s + K * A;                             // [A]
  float* m_s = w_s + A;                                 // [S]
  float* sc_s = m_s + S;                                // [K, S]
  int* live = reinterpret_cast<int*>(sc_s + K * S);     // [S]
  int* n_live = live + S;                               // [1]
  // context partial sums; in bf16, q as bf16 pairs [K, A/2] first
  float* part = reinterpret_cast<float*>(n_live + 1);
  const int b = blockIdx.x;
  const long long row0 = static_cast<long long>(b) * K;

  // 1. att-LSTM gating, then the list of live slots
  gate_beams<T>(gates1, c_att, h_out, c_out, h_s, row0, K, H);
  for (int a = threadIdx.x; a < A; a += blockDim.x) w_s[a] = to_f(att_w[a]);
  for (int s = threadIdx.x; s < S; s += blockDim.x) m_s[s] = mask[static_cast<long long>(b) * S + s];
  __syncthreads();
  list_live_slots(m_s, S, live, n_live);

  // 2. attention query for the K beams
  query_product<T>(att_wh, att_b, h_s, q_s, K, A, H);
  __syncthreads();

  // 3-5. scores, softmax, context
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(part);
    pack_bf16x2(q_s, q2, K * A);
    __syncthreads();
    attention_scores_bf16x2<false>(keys + static_cast<long long>(b) * S * A, live, *n_live,
                                   q2, w_s, nullptr, sc_s, K, S, A);
  } else {
    attention_scores_f32(keys + static_cast<long long>(b) * S * A, live, *n_live, q_s, w_s,
                         sc_s, K, S, A);
  }
  __syncthreads();
  masked_softmax_rows(sc_s, m_s, alpha + row0 * S, K, S);
  __syncthreads();
  attention_context<T, false>(v_enc + static_cast<long long>(b) * S * H, live, *n_live, sc_s,
                              ctx + row0 * H, part, K, S, H);
}

template <typename T>
int launch(const void* gates1, const void* c_att, const void* keys, const void* v_enc,
           const void* mask, const void* att_wh, const void* att_b, const void* att_w,
           void* h_out, void* c_out, void* ctx, void* alpha, int B, int K, int S, int A,
           int H, cudaStream_t stream) {
  if (A % (4 * kVec<T>) != 0 || H % kVec<T> != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int part = context_partial_floats<T>(K, H, kAttnThreads);
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) * (H + A + S) + A + 2 * S + 1 +
                                       (part > K * A / 2 ? part : K * A / 2));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = beam_decoder_core_kernel<T>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_max_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  kernel<<<B, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(gates1), static_cast<const T*>(c_att), static_cast<const T*>(keys),
      static_cast<const T*>(v_enc), static_cast<const float*>(mask),
      static_cast<const T*>(att_wh), static_cast<const T*>(att_b), static_cast<const T*>(att_w),
      static_cast<T*>(h_out), static_cast<T*>(c_out), static_cast<T*>(ctx),
      static_cast<float*>(alpha), K, S, A, H);
  return 0;
}

}  // namespace

extern "C" int cvc_beam_decoder_core(const void* gates1, const void* c_att, const void* keys,
                                     const void* v_enc, const void* mask, const void* att_wh,
                                     const void* att_b, const void* att_w, void* h_out,
                                     void* c_out, void* ctx, void* alpha, int B, int K, int S,
                                     int A, int H, int dtype, void* stream) {
  cudaGetLastError();
  if (K < 1 || K > kMaxBeams) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(keys) && aligned16(v_enc) && aligned16(ctx) && aligned16(gates1) &&
        aligned16(c_att) && aligned16(h_out) && aligned16(c_out) && aligned16(att_wh)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32) {
    rc = launch<float>(gates1, c_att, keys, v_enc, mask, att_wh, att_b, att_w, h_out, c_out,
                       ctx, alpha, B, K, S, A, H, st);
  } else if (dtype == kBF16) {
    rc = launch<__nv_bfloat16>(gates1, c_att, keys, v_enc, mask, att_wh, att_b, att_w, h_out,
                               c_out, ctx, alpha, B, K, S, A, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
