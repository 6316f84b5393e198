// Fused masked softmax cross-entropy over the vocabulary, forward and
// backward.
//
// Replaces cvc_tpu/ops/pallas/xent.py::fused_masked_xent (_fwd_kernel in
// _nll_rows, _bwd_kernel in _bwd).
//   forward:  logits [N, V], targets [N] int32, mask [N] float32
//             -> nll [N] float32 = (logsumexp(logits[n]) - logits[n, t_n]) * mask[n]
//   backward: the same and g (one float32 on the device, the incoming
//             gradient of sum(nll)) -> dlogits [N, V] in the logits' type
//             = (softmax(logits[n]) - onehot(t_n)) * mask[n] * g
// computed in float32. A target outside [0, V) matches no column, as the
// Pallas kernels' one-hot does. Summing nll over the rows stays outside the
// kernel, as in the JAX package.
//
// Bound: bytes. One block per row reads the row once with 16-byte loads and
// keeps a running (max, sum of exp) per thread, rescaled when the max moves,
// so max and sum come out of one pass; the block then combines the threads'
// pairs. The backward reads the row a second time for the softmax; that read
// hits the L1 and L2 caches (a row of 8704 floats is 34 KB), so device
// memory sees the logits once and dlogits once. A row whose mask is 0 gives
// nll 0 and a zero dlogits row without being read: a decode step after the
// caption's end costs only its writes.
#include <math.h>

#include "common.cuh"

namespace {

using namespace cvc;

constexpr int kMaxWarps = kThreads / 32;

// exp(m_old - m_new), and 0 for a thread that has seen no element yet.
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.f : expf(m_old - m_new);
}

// (max, sum of exp(x - max)) of row[0..V) over the block, in every thread.
template <typename T>
__device__ void row_max_sumexp(const T* __restrict__ row, int V, float* red, float& m_out,
                               float& s_out) {
  constexpr int VEC = kVec<T>;
  float m = -INFINITY, s = 0.f;
  for (int v0 = threadIdx.x * VEC; v0 < V; v0 += blockDim.x * VEC) {
    alignas(16) T x[VEC];
    load_vec<T>(x, row + v0);
    float vm = to_f(x[0]);
#pragma unroll
    for (int j = 1; j < VEC; ++j) vm = fmaxf(vm, to_f(x[j]));
    const float m_new = fmaxf(m, vm);
    float acc = s * rescale(m, m_new);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc += expf(to_f(x[j]) - m_new);
    m = m_new;
    s = acc;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    const float m_new = fmaxf(m, m2);
    s = s * rescale(m, m_new) + s2 * rescale(m2, m_new);
    m = m_new;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = m;
    red[kMaxWarps + warp] = s;
  }
  __syncthreads();
  m = -INFINITY;
  s = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int i = 0; i < nwarps; ++i) {  // in warp order: the same in every thread
    const float m2 = red[i], s2 = red[kMaxWarps + i];
    const float m_new = fmaxf(m, m2);
    s = s * rescale(m, m_new) + s2 * rescale(m2, m_new);
    m = m_new;
  }
  m_out = m;
  s_out = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_xent_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
                       const float* __restrict__ mask, float* __restrict__ nll, int V) {
  __shared__ float red[2 * kMaxWarps];
  const int n = blockIdx.x;
  const float mk = mask[n];
  if (mk == 0.f) {
    if (threadIdx.x == 0) nll[n] = 0.f;
    return;
  }
  const T* row = logits + static_cast<long long>(n) * V;
  float m, s;
  row_max_sumexp<T>(row, V, red, m, s);
  if (threadIdx.x == 0) {
    const int t = targets[n];
    const float tl = (t >= 0 && t < V) ? to_f(row[t]) : 0.f;
    nll[n] = (logf(s) + m - tl) * mk;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_xent_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
                       const float* __restrict__ mask, const float* __restrict__ g,
                       T* __restrict__ dlogits, int V) {
  constexpr int VEC = kVec<T>;
  __shared__ float red[2 * kMaxWarps];
  const int n = blockIdx.x;
  const float mk = mask[n];
  const T* row = logits + static_cast<long long>(n) * V;
  T* out = dlogits + static_cast<long long>(n) * V;
  if (mk == 0.f) {
    alignas(16) T zero[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) zero[j] = from_f<T>(0.f);
    for (int v0 = threadIdx.x * VEC; v0 < V; v0 += blockDim.x * VEC) store_vec<T>(out + v0, zero);
    return;
  }
  float m, s;
  row_max_sumexp<T>(row, V, red, m, s);
  const float scale = mk * g[0];
  const int t = targets[n];
  for (int v0 = threadIdx.x * VEC; v0 < V; v0 += blockDim.x * VEC) {
    alignas(16) T x[VEC], d[VEC];
    load_vec<T>(x, row + v0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float p = expf(to_f(x[j]) - m) / s;
      d[j] = from_f<T>((p - (v0 + j == t ? 1.f : 0.f)) * scale);
    }
    store_vec<T>(out + v0, d);
  }
}

template <typename T>
void launch_fwd(const void* logits, const void* targets, const void* mask, void* nll, int N,
                int V, cudaStream_t stream) {
  masked_xent_fwd_kernel<T><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(targets),
      static_cast<const float*>(mask), static_cast<float*>(nll), V);
}

template <typename T>
void launch_bwd(const void* logits, const void* targets, const void* mask, const void* g,
                void* dlogits, int N, int V, cudaStream_t stream) {
  masked_xent_bwd_kernel<T><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(targets),
      static_cast<const float*>(mask), static_cast<const float*>(g), static_cast<T*>(dlogits),
      V);
}

}  // namespace

extern "C" int cvc_masked_xent_fwd(const void* logits, const void* targets, const void* mask,
                                   void* nll, int N, int V, int dtype, void* stream) {
  cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!aligned16(logits) || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (dtype == kF32 && V % kVec<float> == 0) {
    launch_fwd<float>(logits, targets, mask, nll, N, V, st);
  } else if (dtype == kBF16 && V % kVec<__nv_bfloat16> == 0) {
    launch_fwd<__nv_bfloat16>(logits, targets, mask, nll, N, V, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cvc_masked_xent_bwd(const void* logits, const void* targets, const void* mask,
                                   const void* g, void* dlogits, int N, int V, int dtype,
                                   void* stream) {
  cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(aligned16(logits) && aligned16(dlogits)) || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (dtype == kF32 && V % kVec<float> == 0) {
    launch_bwd<float>(logits, targets, mask, g, dlogits, N, V, st);
  } else if (dtype == kBF16 && V % kVec<__nv_bfloat16> == 0) {
    launch_bwd<__nv_bfloat16>(logits, targets, mask, g, dlogits, N, V, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
