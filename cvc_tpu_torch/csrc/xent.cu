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
// Bound: bytes. One block takes a row. A row whose mask is 0 gives nll 0 and
// a zero dlogits row without being read: a decode step after the caption's
// end costs only its writes.
//
// The forward is laid out for latency, since at the train step's shape (N
// 1344 rows of V 8704, 813 live) its 28 MB take the card 8.5 us: a block
// reads its row's mask and target in one first batch, and then, for a live
// row, asks for every 16-byte vector of the row at once (RowBatch in
// vocab_row.cuh, the top-k's way of reading a row: a template on the loads
// a thread holds, one batch up to V 9216 in float32 and 18432 in bf16, a loop
// of such batches beyond), so that the row costs one round trip to memory.
// The thread whose registers hold column t takes the target logit from
// there. Then two passes over the registers, max and sum of exp against it
// (on the special function unit), one round of warp shuffles and one of
// shared memory, with no rescale and no second read. It is a programmatic
// dependent launch: its blocks may start during the tail of the kernel
// before it and wait for that kernel's completion before they read.
//
// The backward keeps a running (max, sum of exp) per thread, rescaled when
// the max moves, over one pass of 16-byte loads, and combines the threads'
// pairs; it then reads the row a second time for the softmax. That read hits
// the L1 and L2 caches (a row of 8704 floats is 34 KB), so device memory
// sees the logits once and dlogits once.
#include <math.h>

#include "vocab_row.cuh"

namespace {

using namespace cvc;

constexpr int kMaxWarps = kThreads / 32;

// The forward's block, and the 16-byte loads a thread holds at once there.
constexpr int kXentFwdThreads = kThreads;
constexpr int kXentMaxLoads = 9;

// exp(m_old - m_new), and 0 for a thread that has seen no element yet.
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.f : expf(m_old - m_new);
}

// (max, sum of exp(x - max)) of row[0..V) over the block, in every thread:
// the backward's one streaming pass.
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

// grid: one block a row. LOADS: the 16-byte vectors a thread holds, a batch
// of LOADS * blockDim.x vectors a trip (one trip where V fits).
template <typename T, int LOADS>
__global__ void __launch_bounds__(kXentFwdThreads)
masked_xent_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
                       const float* __restrict__ mask, float* __restrict__ nll, int V) {
  constexpr int VEC = kVec<T>;
  __shared__ float2 pairs[kXentFwdThreads / 32];
  __shared__ float target_logit;
  grid_dependency_wait();   // ahead of every access to device memory
  const int n = blockIdx.x;
  const float mk = mask[n];
  const int t = targets[n];
  if (mk == 0.f) {
    if (threadIdx.x == 0) nll[n] = 0.f;
    return;
  }
  const T* row = logits + static_cast<long long>(n) * V;
  const int nvec = V / VEC;
  const bool valid = t >= 0 && t < V;   // no column matches a target outside [0, V)
  if (!valid && threadIdx.x == 0) target_logit = 0.f;
  const int stride = static_cast<int>(blockDim.x);
  float m = -INFINITY, s = 0.f;
  for (int b0 = 0; b0 < nvec; b0 += LOADS * stride) {   // the same trips for all
    RowBatch<LOADS> rows;
    rows.load(row, b0 + static_cast<int>(threadIdx.x), stride, nvec);
    // the target: vector t / VEC of the row is this thread's j-th of the
    // batch where t / VEC - b0 - threadIdx.x is j * stride
    const int rel = t / VEC - b0 - static_cast<int>(threadIdx.x);
    if (valid && rel >= 0 && rel % stride == 0 && rel / stride < LOADS) {
      const int jt = rel / stride, vt = t % VEC;
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < LOADS; ++j)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (j == jt && v == vt) x = rows.template at<T>(j, v);
      target_logit = x;
    }
    float bm, bs;
    rows.template max_sumexp<T>(bm, bs);
    lse_merge(m, s, bm, bs);
  }
  // the threads' pairs: a warp's by shuffles, then the warps' in warp 0
  warp_lse_merge(m, s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) pairs[warp] = make_float2(m, s);
  __syncthreads();
  if (warp != 0) return;
  const bool has = lane < (stride >> 5);
  m = has ? pairs[lane].x : -INFINITY;
  s = has ? pairs[lane].y : 0.f;
  warp_lse_merge(m, s);
  if (lane == 0) nll[n] = (logf(s) + m - target_logit) * mk;
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

template <typename T, int LOADS>
void launch_fwd_loads(const void* logits, const void* targets, const void* mask, void* nll,
                      int N, int V, cudaStream_t stream) {
  launch_dependent(masked_xent_fwd_kernel<T, LOADS>, dim3(static_cast<unsigned>(N)),
                   dim3(kXentFwdThreads), 0, stream, static_cast<const T*>(logits),
                   static_cast<const int*>(targets), static_cast<const float*>(mask),
                   static_cast<float*>(nll), V);
}

// A thread's loads: the fewest with which a block holds the row in one
// batch, rounded up to 1, 2, 3, 5 or kXentMaxLoads (more trips beyond that);
// the model's V 8704 takes 9 in float32 and 5 in bf16.
template <typename T>
void launch_fwd(const void* logits, const void* targets, const void* mask, void* nll, int N,
                int V, cudaStream_t stream) {
  const int loads = (V / kVec<T> + kXentFwdThreads - 1) / kXentFwdThreads;
  if (loads <= 1)
    launch_fwd_loads<T, 1>(logits, targets, mask, nll, N, V, stream);
  else if (loads <= 2)
    launch_fwd_loads<T, 2>(logits, targets, mask, nll, N, V, stream);
  else if (loads <= 3)
    launch_fwd_loads<T, 3>(logits, targets, mask, nll, N, V, stream);
  else if (loads <= 5)
    launch_fwd_loads<T, 5>(logits, targets, mask, nll, N, V, stream);
  else
    launch_fwd_loads<T, kXentMaxLoads>(logits, targets, mask, nll, N, V, stream);
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
