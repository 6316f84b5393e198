// Block-level pieces of masked additive attention, shared by the attention
// kernels (attention.cu, attention_bwd.cu) and the beam decoder core
// (decoder_step.cu).
//
// A pair of thread blocks owns one image b and K query rows (K = 1 for the
// plain attention, the K beams for the decoder core). Each block first
// lists the image's live region slots (mask > 0) in shared memory; the live
// rows keys[b, s, :] and v[b, s, :] then come from device memory once, into
// shared memory (row_ring.cuh), and serve all K queries. Padding slots are
// never read: their weight is exactly 0.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace cvc {

constexpr int kAttnThreads = 512;      // threads per attention block
constexpr float kMaskedScore = -1e30f;

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

// tanh of two bf16 values: the float32 hardware tanh of each (tanh_approx:
// it moves a rounded e by at most one bf16 step, and only near a rounding
// boundary; the float32 scores use the accurate tanhf), rounded to bf16 by
// one paired conversion. (tanh.approx.bf16x2 is cheaper, but its
// error moved alpha ~50x further from the plain version on the card.)
__device__ __forceinline__ __nv_bfloat162 tanh_bf16x2(__nv_bfloat162 x) {
  return __floats2bfloat162_rn(tanh_approx(__low2float(x)), tanh_approx(__high2float(x)));
}

// bf16x2 add, subtract and multiply with an explicit round-to-nearest:
// each rounds the exact result once, as rnd<T> of the float result does,
// and the explicit rounding keeps the compiler from fusing a multiply and
// an add into one fma (which would skip the rounding of the product).
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ __nv_bfloat162 from_bits(uint32_t x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}

__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(d);
}

__device__ __forceinline__ __nv_bfloat162 sub_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(d);
}

__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(d);
}

// Scores of `nr` key rows held in shared memory (row i at rows + i * A, slot
// slots[i]) for KB query rows q [KB, A] (working type, shared memory):
// the score of query row k and slot s, sum_a tanh(keys + q) * w in float32,
// one warp a row (warps 0 .. nwarps - 1 of the block; the others return at
// once); lane 0 hands it to emit(k, s, score), which stores it for both
// blocks of the image's pair. bf16: keys + q is one
// bf16x2 add (it rounds once, as rnd(float sum) does: the float sum of two
// bf16 values is exact at these magnitudes) and the two hardware tanh
// results are rounded by one paired conversion. w's type sets where the
// product rounds: w [A] in the working type rounds each e * w to it before
// the float32 sum (one mul.rn.bf16x2 a pair), as
// cvc_tpu/ops/pallas/attention.py forms e * w in the working type; w in
// float32 multiplies in float32, as decoder_step.py does. In float32 the
// two are the same.
template <typename T, int KB, typename W, typename Emit>
__device__ void scores_smem(const T* rows, const int* slots, int nr, const T* q, const W* w,
                            int A, int nwarps, Emit emit) {
  constexpr int V = kVec<T>;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kRoundProduct = kBF16 && std::is_same<W, T>::value;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nr && (threadIdx.x >> 5) < nwarps; i += nwarps) {
    const T* row = rows + static_cast<long long>(i) * A;
    float acc[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[k] = 0.f;
    for (int a0 = lane * V; a0 < A; a0 += 32 * V) {
      // 16 bytes of the key row, of each query row and the matching w
      const uint4 raw = *reinterpret_cast<const uint4*>(row + a0);
      alignas(16) W wv[V];
#pragma unroll
      for (int v = 0; v < V; v += 16 / static_cast<int>(sizeof(W)))
        *reinterpret_cast<uint4*>(wv + v) = *reinterpret_cast<const uint4*>(w + a0 + v);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const uint4 qr = *reinterpret_cast<const uint4*>(q + k * A + a0);
        if constexpr (kBF16) {
          const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qr);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const __nv_bfloat162 e = tanh_bf16x2(__hadd2(kv[p], q2[p]));
            if constexpr (kRoundProduct) {
              const float2 ew = __bfloat1622float2(
                  mul_rn(e, reinterpret_cast<const __nv_bfloat162*>(wv)[p]));
              acc[k] += ew.x;
              acc[k] += ew.y;
            } else {
              acc[k] = fmaf(__low2float(e), wv[2 * p], acc[k]);
              acc[k] = fmaf(__high2float(e), wv[2 * p + 1], acc[k]);
            }
          }
        } else {
          const float* kk = reinterpret_cast<const float*>(&raw);
          const float* qq = reinterpret_cast<const float*>(&qr);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[k] = fmaf(tanhf(kk[v] + qq[v]), wv[v], acc[k]);
        }
      }
    }
    const int s = slots[i];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const float t = warp_sum(acc[k]);
      if (lane == 0) emit(k, s, t);
    }
  }
}

// In place over scores [K, S] (every live slot's score present): the masked
// softmax in float32, as the Pallas kernels do it (max over live slots,
// exp, sum clamped to 1e-9, divide); masked slots, and every slot of a row
// with none live, come out 0. One warp a query row. Both blocks of an
// image's pair run it on the same values in the same order; block `rank`
// writes the slots s with s % 2 == rank of alpha_out. scores then hold
// alpha rounded to T, the weights of the context sum.
template <typename T>
__device__ void softmax_rows_half(float* scores, const float* mask, float* __restrict__ alpha_out,
                                  int K, int S, int rank) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < K; k += blockDim.x >> 5) {
    float* row = scores + k * S;
    float m = kMaskedScore;
    for (int s = lane; s < S; s += 32)
      if (mask[s] > 0.f) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {   // a lane reads back only its own slots
      const float e = mask[s] > 0.f ? expf(row[s] - m) : 0.f;
      row[s] = e;
      sum += e;
    }
    const float denom = fmaxf(warp_sum(sum), 1e-9f);
    for (int s = lane; s < S; s += 32) {
      const float a = row[s] / denom;
      row[s] = rnd<T>(a);
      if ((s & 1) == rank) alpha_out[k * S + s] = a;
    }
  }
}

}  // namespace cvc
