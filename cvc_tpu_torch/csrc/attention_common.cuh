// Block-level pieces of masked additive attention, shared by the attention
// kernel (attention.cu) and the beam decoder core (decoder_step.cu).
//
// One thread block owns one image b and K query rows (K = 1 for the plain
// attention, the K beams for the decoder core). The block first lists the
// image's live region slots (mask > 0) in shared memory, then streams each
// live row keys[b, s, :] and v[b, s, :] from device memory once and uses it
// for all K queries. Padding slots are never read: their weight is exactly 0.
// Only scores [K, S] and a few [K, A] and [K, H] vectors live in shared
// memory, so S is bounded by shared memory at ~4 (K + 2) S bytes, not by
// [S, A] tiles.
#pragma once

#include "common.cuh"

namespace cvc {

constexpr int kAttnThreads = 512;      // threads per attention block
constexpr float kMaskedScore = -1e30f;

// The hardware tanh (tanh.approx.f32, relative error below 2^-10.9). The
// bf16 scores round its result to bf16 (steps of 2^-8), so it moves a
// rounded e by at most one step and only near a rounding boundary; the
// float32 scores use the accurate tanhf.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// live[0..*n_live) = the slots s with mask[s] > 0, in increasing order.
// Warp 0 compacts 32 slots per ballot.
__device__ inline void list_live_slots(const float* mask, int S, int* live, int* n_live) {
  if ((threadIdx.x >> 5) != 0) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool on = s < S && mask[s] > 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, on);
    if (on) live[base + __popc(bits & ((1u << lane) - 1u))] = s;
    base += __popc(bits);
  }
  if (lane == 0) *n_live = base;
}

// float32: scores[k * S + s] = sum_a tanh(keys[s, a] + q[k * A + a]) * w[a]
// for each live slot s (the Pallas kernels' rounding points are no-ops in
// float32). One warp per live row, 16-byte loads; q, w and scores are in
// shared memory.
__device__ inline void attention_scores_f32(const float* __restrict__ keys, const int* live,
                                            int n_live, const float* q, const float* w,
                                            float* scores, int K, int S, int A) {
  constexpr int VEC = kVec<float>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < n_live; i += nwarps) {
    const int s = live[i];
    float acc[kMaxBeams];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) acc[k] = 0.f;
    const float* row = keys + static_cast<long long>(s) * A;
    for (int a0 = lane * VEC; a0 < A; a0 += 32 * VEC) {
      alignas(16) float kv[VEC];
      load_vec<float>(kv, row + a0);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float wv = w[a0 + v];
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k)
          if (k < K) acc[k] = fmaf(tanhf(kv[v] + q[k * A + a0 + v]), wv, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < K) {
        const float t = warp_sum(acc[k]);
        if (lane == 0) scores[k * S + s] = t;
      }
    }
  }
}

// tanh of two bf16 values: the float32 hardware tanh of each, rounded to
// bf16 by one paired conversion. (tanh.approx.bf16x2 is cheaper, but its
// error moved alpha ~50x further from the plain version on the card.)
__device__ __forceinline__ __nv_bfloat162 tanh_bf16x2(__nv_bfloat162 x) {
  return __floats2bfloat162_rn(tanh_approx(__low2float(x)), tanh_approx(__high2float(x)));
}

// bf16 scores, on pairs: keys + q
// is one bf16x2 add (it rounds once, as rnd(float sum) does: the float
// sum of two bf16 values is exact at these magnitudes) and the two tanh
// results are rounded by one paired conversion, so a pair needs one
// float-to-bf16 conversion instead of four. q2 [K, A/2] and w2 [A/2] are q and w as
// bf16 pairs; w is float. ROUND_PROD multiplies e * w as bf16x2 (the
// product of two bf16 is exact in float, so this is rnd(e * w)), as
// cvc_tpu/ops/pallas/attention.py sums e * w formed in the working type;
// decoder_step.py multiplies in float32. Otherwise as attention_scores_f32.
template <bool ROUND_PROD>
__device__ void attention_scores_bf16x2(const __nv_bfloat16* __restrict__ keys, const int* live,
                                        int n_live, const __nv_bfloat162* q2, const float* w,
                                        const __nv_bfloat162* w2, float* scores, int K, int S,
                                        int A) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int A2 = A / 2;
  for (int i = warp; i < n_live; i += nwarps) {
    const int s = live[i];
    float acc[kMaxBeams];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) acc[k] = 0.f;
    const __nv_bfloat16* row = keys + static_cast<long long>(s) * A;
    for (int a0 = lane * 8; a0 < A; a0 += 32 * 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + a0));
      const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ap = a0 / 2 + p;
        const float w0 = w[2 * ap];
        const float w1 = w[2 * ap + 1];
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (k < K) {
            __nv_bfloat162 e = tanh_bf16x2(__hadd2(kv[p], q2[k * A2 + ap]));
            if (ROUND_PROD) {
              e = __hmul2(e, w2[ap]);
              acc[k] += __low2float(e);
              acc[k] += __high2float(e);
            } else {
              acc[k] = fmaf(__low2float(e), w0, acc[k]);
              acc[k] = fmaf(__high2float(e), w1, acc[k]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < K) {
        const float t = warp_sum(acc[k]);
        if (lane == 0) scores[k * S + s] = t;
      }
    }
  }
}

// pairs[i] = (x[2i], x[2i + 1]) as bf16 for i < n / 2 (x holds bf16 values).
__device__ inline void pack_bf16x2(const float* x, __nv_bfloat162* pairs, int n) {
  for (int i = threadIdx.x; i < n / 2; i += blockDim.x)
    pairs[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
}

// In place over scores [K, S]: masked softmax in float32, as the Pallas
// kernels do it (max over live slots, exp, sum clamped to 1e-9, divide).
// Masked slots, and every slot of a row with none live, come out 0.
// alpha_out gets the same [K, S] values. One warp per query row.
__device__ inline void masked_softmax_rows(float* scores, const float* mask,
                                           float* __restrict__ alpha_out, int K, int S) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = warp; k < K; k += nwarps) {
    float* row = scores + k * S;
    float m = kMaskedScore;
    for (int s = lane; s < S; s += 32)
      if (mask[s] > 0.f) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) sum += mask[s] > 0.f ? expf(row[s] - m) : 0.f;
    const float denom = fmaxf(warp_sum(sum), 1e-9f);
    for (int s = lane; s < S; s += 32) {
      const float a = mask[s] > 0.f ? expf(row[s] - m) / denom : 0.f;
      row[s] = a;
      alpha_out[k * S + s] = a;
    }
  }
}

// Shared-memory floats attention_context<T> needs for its partial sums.
template <typename T>
int context_partial_floats(int K, int H, int threads) {
  const int cols = H / kVec<T>;
  const int groups = cols >= threads ? 1 : threads / cols;
  return (groups - 1) * K * H;
}

// ctx[k * H + h] = sum over live s of rnd(alpha[k * S + s]) * v[s, h], summed
// in float32 (ROUND_PROD rounds each product to T first, as the attention
// kernel's multiply-reduce does). Each thread owns kVec<T> columns; when the
// columns need fewer threads than the block has, G groups of threads split
// the live rows and group 0 adds the others' partial sums (kept in `part`)
// in group order, so the result does not depend on timing.
template <typename T, bool ROUND_PROD>
__device__ void attention_context(const T* __restrict__ v, const int* live, int n_live,
                                  const float* alpha, T* __restrict__ ctx, float* part,
                                  int K, int S, int H) {
  constexpr int VEC = kVec<T>;
  const int cols = H / VEC;
  const int stride = cols < static_cast<int>(blockDim.x) ? cols : blockDim.x;
  const int G = blockDim.x / stride;
  const int g = threadIdx.x / stride;
  for (int c = threadIdx.x % stride; c < cols; c += stride) {
    const int h0 = c * VEC;
    float acc[kMaxBeams][VEC];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] = 0.f;
    if (g < G) {
#pragma unroll 4
      for (int i = g; i < n_live; i += G) {
        const int s = live[i];
        alignas(16) T vv[VEC];
        load_vec<T>(vv, v + static_cast<long long>(s) * H + h0);
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (k < K) {
            const float a = rnd<T>(alpha[k * S + s]);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float p = a * to_f(vv[j]);
              acc[k][j] += ROUND_PROD ? rnd<T>(p) : p;
            }
          }
        }
      }
    }
    if (G > 1) {  // block-uniform; then every thread has exactly one c
      if (g > 0 && g < G) {
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k)
          if (k < K)
#pragma unroll
            for (int j = 0; j < VEC; ++j) part[((g - 1) * K + k) * H + h0 + j] = acc[k][j];
      }
      __syncthreads();
      if (g != 0) continue;
      for (int gg = 1; gg < G; ++gg)
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k)
          if (k < K)
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[k][j] += part[((gg - 1) * K + k) * H + h0 + j];
    }
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < K) {
        alignas(16) T out[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) out[j] = from_f<T>(acc[k][j]);
        store_vec<T>(ctx + static_cast<long long>(k) * H + h0, out);
      }
    }
  }
}

}  // namespace cvc
