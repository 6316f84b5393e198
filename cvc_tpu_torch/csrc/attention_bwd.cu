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
// Bound: bytes. The kernel reads each live key and value row once and writes
// dkeys and dv whole (2 * S * (A + H) elements an image) against a few
// operations per element. One block of 512 threads per image lists its live
// slots, streams each live value row once (one warp per row, 16-byte loads)
// for d_alpha and dv, keeps d_alpha and the softmax backward in shared
// memory, then streams each live key row once with the threads owning
// columns, so dkeys rows go out whole and dq sums in registers. Padding slots
// (mask 0) are not read: alpha is 0 there, so their dkeys and dv rows are
// written as zeros and they add nothing to dq or dw. S is looped over, so
// shared memory holds only [S] vectors.
//
// dw sums over every image. Float atomics would make it depend on timing, so
// each block writes its image's float32 partial dw_part [B, A], and a second
// small kernel sums the partials over b in a fixed order: two launches give
// bit-equal dw.
#include "attention_common.cuh"

namespace {

using namespace cvc;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
additive_attention_bwd_kernel(const T* __restrict__ keys, const T* __restrict__ q,
                              const T* __restrict__ w, const T* __restrict__ v,
                              const float* __restrict__ mask, const float* __restrict__ alpha,
                              const T* __restrict__ g_ctx, const float* __restrict__ g_alpha,
                              T* __restrict__ dkeys, T* __restrict__ dq, T* __restrict__ dv,
                              float* __restrict__ dw_part, int S, int A, int H) {
  constexpr int VEC = kVec<T>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                  // [A]
  float* w_s = q_s + A;                               // [A]
  float* g_s = w_s + A;                               // [H]
  float* m_s = g_s + H;                               // [S]
  float* al_s = m_s + S;                              // [S]
  float* ds_s = al_s + S;                             // [S] d_alpha, then d_s
  int* live = reinterpret_cast<int*>(ds_s + S);       // [S]
  int* n_live = live + S;                             // [1]
  float* inner = reinterpret_cast<float*>(n_live + 1);  // [1]
  float* part = inner + 1;                            // [2 (G - 1) A]
  const int b = blockIdx.x;
  const long long bS = static_cast<long long>(b) * S;
  const T* keys_b = keys + bS * A;
  const T* v_b = v + bS * H;
  T* dkeys_b = dkeys + bS * A;
  T* dv_b = dv + bS * H;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    q_s[a] = to_f(q[static_cast<long long>(b) * A + a]);
    w_s[a] = to_f(w[a]);
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x)
    g_s[h] = to_f(g_ctx[static_cast<long long>(b) * H + h]);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    m_s[s] = mask[bS + s];
    al_s[s] = alpha[bS + s];
  }
  __syncthreads();
  list_live_slots(m_s, S, live, n_live);
  __syncthreads();
  const int nl = *n_live;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // dv rows and d_alpha: one warp per live value row
  for (int i = warp; i < nl; i += nwarps) {
    const int s = live[i];
    const float a_t = rnd<T>(al_s[s]);
    const T* row = v_b + static_cast<long long>(s) * H;
    T* drow = dv_b + static_cast<long long>(s) * H;
    float acc = 0.f;
    for (int h0 = lane * VEC; h0 < H; h0 += 32 * VEC) {
      alignas(16) T vv[VEC], out[VEC];
      load_vec<T>(vv, row + h0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float g = g_s[h0 + j];
        acc += rnd<T>(to_f(vv[j]) * g);
        out[j] = from_f<T>(a_t * g);
      }
      store_vec<T>(drow + h0, out);
    }
    acc = warp_sum(acc);
    if (lane == 0) ds_s[s] = acc + (g_alpha != nullptr ? g_alpha[bS + s] : 0.f);
  }
  // dead slots: zero dv and dkeys rows
  {
    alignas(16) T zero[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) zero[j] = from_f<T>(0.f);
    const int hv = H / VEC, av = A / VEC;
    for (long long t = threadIdx.x; t < static_cast<long long>(S) * hv; t += blockDim.x) {
      const int s = static_cast<int>(t / hv);
      if (!(m_s[s] > 0.f)) store_vec<T>(dv_b + t * VEC, zero);
    }
    for (long long t = threadIdx.x; t < static_cast<long long>(S) * av; t += blockDim.x) {
      const int s = static_cast<int>(t / av);
      if (!(m_s[s] > 0.f)) store_vec<T>(dkeys_b + t * VEC, zero);
    }
  }
  __syncthreads();

  // softmax backward in float32: inner = sum alpha * d_alpha, then d_s
  if (warp == 0) {
    float acc = 0.f;
    for (int i = lane; i < nl; i += 32) acc += al_s[live[i]] * ds_s[live[i]];
    acc = warp_sum(acc);
    if (lane == 0) *inner = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl; i += blockDim.x) {
    const int s = live[i];
    ds_s[s] = al_s[s] * (ds_s[s] - *inner);
  }
  __syncthreads();

  // dkeys rows, dq and this image's dw: threads own VEC columns; when the
  // columns need fewer threads than the block has, G groups split the live
  // rows and group 0 adds the others' partials in group order.
  const int cols = A / VEC;
  const int stride = cols < static_cast<int>(blockDim.x) ? cols : blockDim.x;
  const int G = blockDim.x / stride;
  const int grp = threadIdx.x / stride;
  float* part_dq = part;
  float* part_dw = part + (G - 1) * A;
  for (int c = threadIdx.x % stride; c < cols; c += stride) {
    const int a0 = c * VEC;
    float acc_q[VEC], acc_w[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_q[j] = acc_w[j] = 0.f;
    if (grp < G) {
      for (int i = grp; i < nl; i += G) {
        const int s = live[i];
        const float dsf = ds_s[s];
        const float ds_t = rnd<T>(dsf);
        alignas(16) T kv[VEC], out[VEC];
        load_vec<T>(kv, keys_b + static_cast<long long>(s) * A + a0);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float u = rnd<T>(tanhf(rnd<T>(to_f(kv[j]) + q_s[a0 + j])));
          const float t1 = rnd<T>(ds_t * w_s[a0 + j]);
          const float one_m = rnd<T>(1.f - rnd<T>(u * u));
          const float de = rnd<T>(t1 * one_m);
          out[j] = from_f<T>(de);
          acc_q[j] += de;
          acc_w[j] = fmaf(dsf, u, acc_w[j]);
        }
        store_vec<T>(dkeys_b + static_cast<long long>(s) * A + a0, out);
      }
    }
    if (G > 1) {  // block-uniform; then every thread has exactly one c
      if (grp > 0 && grp < G) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          part_dq[(grp - 1) * A + a0 + j] = acc_q[j];
          part_dw[(grp - 1) * A + a0 + j] = acc_w[j];
        }
      }
      __syncthreads();
      if (grp != 0) continue;
      for (int gg = 1; gg < G; ++gg)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc_q[j] += part_dq[(gg - 1) * A + a0 + j];
          acc_w[j] += part_dw[(gg - 1) * A + a0 + j];
        }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dq[static_cast<long long>(b) * A + a0 + j] = from_f<T>(acc_q[j]);
      dw_part[static_cast<long long>(b) * A + a0 + j] = acc_w[j];
    }
  }
}

// dw[a] = sum over b of dw_part[b, a], b in increasing order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_images_kernel(const float* __restrict__ dw_part, T* __restrict__ dw, int B, int A) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += dw_part[static_cast<long long>(b) * A + a];
  dw[a] = from_f<T>(acc);
}

template <typename T>
int launch(const void* keys, const void* q, const void* w, const void* v, const void* mask,
           const void* alpha, const void* g_ctx, const void* g_alpha, void* dkeys, void* dq,
           void* dw, void* dv, void* dw_part, int B, int S, int A, int H,
           cudaStream_t stream) {
  if (A % kVec<T> != 0 || H % kVec<T> != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = A / kVec<T>;
  const int G = cols >= kAttnThreads ? 1 : kAttnThreads / cols;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(A) + H + 4 * static_cast<size_t>(S) +
                                       2 + 2 * static_cast<size_t>(G - 1) * A);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = additive_attention_bwd_kernel<T>;
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t e = allow_max_smem(kernel, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) {
    if (A == 0) return 0;
    return static_cast<int>(cudaMemsetAsync(dw, 0, static_cast<size_t>(A) * sizeof(T), stream));
  }
  kernel<<<B, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(q), static_cast<const T*>(w),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(alpha), static_cast<const T*>(g_ctx),
      static_cast<const float*>(g_alpha), static_cast<T*>(dkeys), static_cast<T*>(dq),
      static_cast<T*>(dv), static_cast<float*>(dw_part), S, A, H);
  sum_images_kernel<T><<<(A + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(dw_part), static_cast<T*>(dw), B, A);
  return 0;
}

}  // namespace

// g_alpha may be null: alpha then enters no loss and its gradient is zero.
extern "C" int cvc_additive_attention_bwd(const void* keys, const void* q, const void* w,
                                          const void* v, const void* mask, const void* alpha,
                                          const void* g_ctx, const void* g_alpha, void* dkeys,
                                          void* dq, void* dw, void* dv, void* dw_part, int B,
                                          int S, int A, int H, int dtype, void* stream) {
  cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(keys) && aligned16(v) && aligned16(dkeys) && aligned16(dv)))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32) {
    rc = launch<float>(keys, q, w, v, mask, alpha, g_ctx, g_alpha, dkeys, dq, dw, dv, dw_part,
                       B, S, A, H, st);
  } else if (dtype == kBF16) {
    rc = launch<__nv_bfloat16>(keys, q, w, v, mask, alpha, g_ctx, g_alpha, dkeys, dq, dw, dv,
                               dw_part, B, S, A, H, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
