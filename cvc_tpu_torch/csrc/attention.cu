// Fused masked additive (Bahdanau) attention, forward.
//
// Replaces cvc_tpu/ops/pallas/attention.py::fused_additive_attention
// (_kernel, _fwd_pallas).
//   keys [B, S, A], q [B, A], w [A], v [B, S, H], mask [B, S] float32
//   -> ctx [B, H] in v's type, alpha [B, S] float32
//   e = tanh(keys + q) (never stored), scores = e . w, alpha = masked softmax,
//   ctx = alpha . v
//
// Bound: bytes. keys and v are read once (2 * S * (A + H) bytes in bf16 for
// each image) against about 2 * S * (A + H) multiply-adds and S * A tanh, so
// the arithmetic per byte is low. The design keeps every intermediate out of
// device memory: one block of 512 threads per image lists its live slots,
// streams each live key row once (one warp per row, 16-byte loads) into S
// scores in shared memory, softmaxes them there and streams each live value
// row once for the context, four groups of threads splitting the rows so
// that enough loads are in flight. Padding slots (mask 0) are not read at
// all. The S axis is looped over, so the 1280-slot video width needs only
// 12 * S bytes of shared memory.
#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace cvc;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
additive_attention_kernel(const T* __restrict__ keys, const T* __restrict__ q,
                          const T* __restrict__ w, const T* __restrict__ v,
                          const float* __restrict__ mask, T* __restrict__ ctx,
                          float* __restrict__ alpha, int S, int A, int H) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                    // [A]
  float* w_s = q_s + A;                                 // [A]
  float* m_s = w_s + A;                                 // [S]
  float* sc_s = m_s + S;                                // [S]
  int* live = reinterpret_cast<int*>(sc_s + S);         // [S]
  int* n_live = live + S;                               // [1]
  // context partial sums; in bf16, q and w as bf16 pairs first
  float* part = reinterpret_cast<float*>(n_live + 1);
  const int b = blockIdx.x;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    q_s[a] = to_f(q[static_cast<long long>(b) * A + a]);
    w_s[a] = to_f(w[a]);
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) m_s[s] = mask[static_cast<long long>(b) * S + s];
  __syncthreads();
  list_live_slots(m_s, S, live, n_live);
  __syncthreads();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(part);   // [A/2]
    __nv_bfloat162* w2 = q2 + A / 2;                                // [A/2]
    pack_bf16x2(q_s, q2, A);
    pack_bf16x2(w_s, w2, A);
    __syncthreads();
    attention_scores_bf16x2<true>(keys + static_cast<long long>(b) * S * A, live, *n_live, q2,
                                  w_s, w2, sc_s, 1, S, A);
  } else {
    attention_scores_f32(keys + static_cast<long long>(b) * S * A, live, *n_live, q_s, w_s,
                         sc_s, 1, S, A);
  }
  __syncthreads();
  masked_softmax_rows(sc_s, m_s, alpha + static_cast<long long>(b) * S, 1, S);
  __syncthreads();
  attention_context<T, true>(v + static_cast<long long>(b) * S * H, live, *n_live, sc_s,
                             ctx + static_cast<long long>(b) * H, part, 1, S, H);
}

template <typename T>
int launch(const void* keys, const void* q, const void* w, const void* v, const void* mask,
           void* ctx, void* alpha, int B, int S, int A, int H, cudaStream_t stream) {
  if (A % kVec<T> != 0 || H % kVec<T> != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int part = context_partial_floats<T>(1, H, kAttnThreads);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(A) + 3 * static_cast<size_t>(S) + 1 +
                                       (part > A ? part : A));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = additive_attention_kernel<T>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_max_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  kernel<<<B, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(q), static_cast<const T*>(w),
      static_cast<const T*>(v), static_cast<const float*>(mask), static_cast<T*>(ctx),
      static_cast<float*>(alpha), S, A, H);
  return 0;
}

}  // namespace

extern "C" int cvc_additive_attention_fwd(const void* keys, const void* q, const void* w,
                                          const void* v, const void* mask, void* ctx,
                                          void* alpha, int B, int S, int A, int H, int dtype,
                                          void* stream) {
  cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(keys) && aligned16(v) && aligned16(ctx)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32) {
    rc = launch<float>(keys, q, w, v, mask, ctx, alpha, B, S, A, H, st);
  } else if (dtype == kBF16) {
    rc = launch<__nv_bfloat16>(keys, q, w, v, mask, ctx, alpha, B, S, A, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
