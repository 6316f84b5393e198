// Fused per-row top-k + logsumexp over the vocabulary.
//
// Replaces cvc_tpu/ops/pallas/topk_select.py::fused_topk_lse (_kernel).
//   logits [N, V] float32 or bf16, k <= 8
//   -> vals [N, k] float32, idxs [N, k] int32, lse [N] float32
// Order is exactly lax.top_k's: descending value, and among equal values
// the lowest index first.
//
// Bound: bytes. Each logit is read once (N * V * 2 bytes in bf16) and takes
// a handful of compares and one exp. One thread block per row; each thread
// walks its strided share of the row once with 16-byte loads (so V must be
// a multiple of 16 bytes of elements, as the vocabulary padded to 128 is), keeping a
// running (max, sum of exp) pair and its own sorted top-k list in registers.
// The block then merges: the (max, sum) pairs by a shuffle-and-shared-memory
// reduction, the lists by k rounds of "best head of any list" (value, then
// lowest index), popping the winner's head each round. Each thread sees its
// indices in increasing order and keeps ties in index order, so the merged
// order is exact. Columns past V are never read, which is what the TPU
// kernel's -3e38 lane padding stands for.
#include <math.h>

#include "common.cuh"

namespace {

using namespace cvc;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// (m, s) <- the pair for the union of both sets, s = sum exp(x - m)
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float M = fmaxf(m, om);
  if (M == -INFINITY) return;  // both sets empty
  s = s * expf(m - M) + os * expf(om - M);
  m = M;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
topk_lse_kernel(const T* __restrict__ logits, float* __restrict__ vals, int* __restrict__ idxs,
                float* __restrict__ lse, int V) {
  constexpr int VEC = kVec<T>;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ float red_s[kThreads / 32];
  __shared__ float win_v;
  __shared__ int win_i;
  const int r = blockIdx.x;
  const T* row = logits + static_cast<long long>(r) * V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float tv[K];
  int ti[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tv[j] = -INFINITY;
    ti[j] = 0x7fffffff;
  }
  float m = -INFINITY, s = 0.f;

  for (int c0 = threadIdx.x * VEC; c0 < V; c0 += blockDim.x * VEC) {
    alignas(16) T x[VEC];
    load_vec<T>(x, row + c0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xv = to_f(x[v]);
      const int xi = c0 + v;
      if (xv > m) {
        s = s * expf(m - xv) + 1.f;
        m = xv;
      } else if (m > -INFINITY) {
        s += expf(xv - m);
      }
      if (better(xv, xi, tv[K - 1], ti[K - 1])) {
        tv[K - 1] = xv;
        ti[K - 1] = xi;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (better(tv[j], ti[j], tv[j - 1], ti[j - 1])) {
            const float fv = tv[j]; tv[j] = tv[j - 1]; tv[j - 1] = fv;
            const int iv = ti[j]; ti[j] = ti[j - 1]; ti[j - 1] = iv;
          }
        }
      }
    }
  }

  // logsumexp of the row
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, om, os);
  }
  if (lane == 0) {
    red_v[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = red_v[0], Ssum = red_s[0];
    for (int w = 1; w < nwarps; ++w) lse_merge(M, Ssum, red_v[w], red_s[w]);
    lse[r] = logf(Ssum) + M;
  }
  __syncthreads();

  // k rounds: the best head of all the per-thread lists
  for (int j = 0; j < K; ++j) {
    float cv = tv[0];
    int ci = ti[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
      if (better(ov, oi, cv, ci)) {
        cv = ov;
        ci = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = cv;
      red_i[warp] = ci;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float bv = red_v[0];
      int bi = red_i[0];
      for (int w = 1; w < nwarps; ++w)
        if (better(red_v[w], red_i[w], bv, bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      win_v = bv;
      win_i = bi;
      vals[static_cast<long long>(r) * K + j] = bv;
      idxs[static_cast<long long>(r) * K + j] = bi;
    }
    __syncthreads();
    if (ti[0] == win_i) {  // each column belongs to one thread: pop its head
#pragma unroll
      for (int q = 0; q < K - 1; ++q) {
        tv[q] = tv[q + 1];
        ti[q] = ti[q + 1];
      }
      tv[K - 1] = -INFINITY;
      ti[K - 1] = 0x7fffffff;
    }
  }
}

template <typename T>
int launch(const void* logits, void* vals, void* idxs, void* lse, int N, int V, int k,
             cudaStream_t st) {
  const T* x = static_cast<const T*>(logits);
  float* v = static_cast<float*>(vals);
  int* i = static_cast<int*>(idxs);
  float* l = static_cast<float*>(lse);
  switch (k) {
    case 1: topk_lse_kernel<T, 1><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 2: topk_lse_kernel<T, 2><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 3: topk_lse_kernel<T, 3><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 4: topk_lse_kernel<T, 4><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 5: topk_lse_kernel<T, 5><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 6: topk_lse_kernel<T, 6><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 7: topk_lse_kernel<T, 7><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    case 8: topk_lse_kernel<T, 8><<<N, kThreads, 0, st>>>(x, v, i, l, V); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" int cvc_topk_lse(const void* logits, void* vals, void* idxs, void* lse, int N,
                            int V, int k, int dtype, void* stream) {
  cudaGetLastError();
  if (k < 1 || k > kMaxBeams || k > V) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!aligned16(logits)) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kF32 && V % kVec<float> == 0) {
    rc = launch<float>(logits, vals, idxs, lse, N, V, k, st);
  } else if (dtype == kBF16 && V % kVec<__nv_bfloat16> == 0) {
    rc = launch<__nv_bfloat16>(logits, vals, idxs, lse, N, V, k, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
