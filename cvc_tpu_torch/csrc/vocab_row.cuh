// Reading a vocabulary row of logits for a per-row reduction
// (topk_select.cu, xent.cu's forward).
//
// A decode step's or a loss's logits are a few to a few tens of megabytes,
// which the card moves in microseconds, so a row's reduction is laid out for
// latency: a thread asks for all the 16-byte vectors of a batch before it
// uses any (`RowBatch::load`), so a row costs one round trip to memory and
// not one a vector, and then passes over its registers. Vector j of a thread
// is vector first + j * stride of the row: consecutive threads read
// consecutive vectors. Columns past the row's end are never read.
//
// The exponentials of a row's logsumexp run on the special function unit
// (exp2_approx), and (max, sum of exp) pairs merge with one expf each, in a
// fixed order, so that the results do not depend on timing.
#pragma once

#include <math.h>

#include "common.cuh"

namespace cvc {

constexpr unsigned kFullWarp = 0xffffffffu;

// 2^x on the special function unit (ex2.approx.ftz.f32, relative error below
// 2^-22). exp(x - m) as exp2_approx(fmaf(x, kLog2e, -m * kLog2e)) is two
// instructions where expf is nine; the argument's rounding adds under 2^-24
// of |x - m| log2(e), which only terms far below the maximum feel, so a row's
// logsumexp stays within 1e-6 of the exact one.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A float as an unsigned key of the same order (a > b <=> key(a) > key(b),
// -0 as +0), so that a warp-wide integer reduction finds a maximum. No
// number has key 0.
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned b = __float_as_uint(x + 0.f);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float(k ^ (static_cast<unsigned>(static_cast<int>(~k) >> 31) | 0x80000000u));
}

// (m, s) <- the pair of the union of both sets, s = sum exp(x - m); (-inf, 0)
// is the empty set. One expf and two selects, no branch.
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float d = m == om ? 1.f : expf(-fabsf(m - om));
  s = m >= om ? fmaf(os, d, s) : fmaf(s, d, os);
  m = fmaxf(m, om);
}

// The same over a warp's 32 pairs, in every lane: the largest maximum by a
// reduction of keys, one expf a lane, and the sums by shuffles in a fixed tree.
__device__ __forceinline__ void warp_lse_merge(float& m, float& s) {
  const float wm = value_of(__reduce_max_sync(kFullWarp, key_of(m)));
  s *= expf(m - (wm > -INFINITY ? wm : 0.f));   // an empty lane's 0 stays 0
  m = wm;
  s = warp_sum(s);
}

// Up to NV 16-byte vectors of a row in a thread's registers: vector j is
// vector first + j * stride of the row, where that is below end.
template <int NV>
struct RowBatch {
  uint4 raw[NV];
  int first, stride, end;

  // Asks for every load of the batch before any is used.
  __device__ __forceinline__ void load(const void* row, int first_, int stride_, int end_) {
    first = first_;
    stride = stride_;
    end = end_;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (has(j)) raw[j] = __ldg(reinterpret_cast<const uint4*>(row) + first + j * stride);
  }

  __device__ __forceinline__ bool has(int j) const { return first + j * stride < end; }

  // The row's column of element v of vector j.
  template <typename T>
  __device__ __forceinline__ int column(int j, int v) const {
    return (first + j * stride) * kVec<T> + v;
  }

  // Element v of vector j as a float (j and v known at compile time).
  template <typename T>
  __device__ __forceinline__ float at(int j, int v) const {
    return to_f(reinterpret_cast<const T*>(&raw[j])[v]);
  }

  // (max, sum of exp(x - max)) of the batch's elements, in two passes over
  // the registers; (-inf, 0) for a thread with none.
  template <typename T>
  __device__ __forceinline__ void max_sumexp(float& m, float& s) const {
    m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (has(j))
#pragma unroll
        for (int v = 0; v < kVec<T>; ++v) m = fmaxf(m, at<T>(j, v));
    const float ref2 = -(m > -INFINITY ? m : 0.f) * kLog2e;   // all -inf: every term 0
    s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (has(j))
#pragma unroll
        for (int v = 0; v < kVec<T>; ++v) s += exp2_approx(fmaf(at<T>(j, v), kLog2e, ref2));
  }
};

}  // namespace cvc
