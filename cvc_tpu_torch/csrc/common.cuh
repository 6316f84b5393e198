// Device helpers shared by the cvc_tpu_torch kernels.
//
// Every kernel takes float32 or bfloat16 storage and computes in float32.
// `rnd<T>` rounds a float32 value to T's precision and back; the kernels
// call it exactly where the Pallas kernels they replace round to the
// working type, so bf16 results follow the same rounding points.
//
// Every kernel moves its rows in 16-byte vectors (kVec<T> elements) and
// takes no other layout: the row widths must be multiples of kVec<T> and
// the vector-read tensors 16-byte aligned. The Python wrappers raise on
// anything else, and the C entry points return cudaErrorInvalidValue.
// The model's widths (H, A, the vocabulary padded to 128) all qualify.
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cvc {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;              // threads per block in every kernel
constexpr int kMaxBeams = 8;               // largest K the beam kernels accept
constexpr int kMaxSmemBytes = 227 * 1024;  // dynamic shared memory per block, sm_90

template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// The hardware tanh (tanh.approx.f32, relative error below 2^-10.9): for
// results that are rounded to bf16 (steps of 2^-8 relative) right away.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One 16-byte access of kVec<T> consecutive elements (src 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_vec(T (&dst)[kVec<T>], const T* __restrict__ src) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ dst, const T (&src)[kVec<T>]) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Programmatic dependent launch. A kernel launched with launch_dependent
// may be scheduled while the kernel before it on the stream is still
// running, so that its launch overlaps that kernel's tail; it calls
// grid_dependency_wait before its first access to device memory, which
// holds it until that kernel's grid has completed and its writes are
// visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Lets `kernel` take up to kMaxSmemBytes of dynamic shared memory on the
// current device. The attribute is set once for each kernel and device
// (`done` holds a bit per device), not on every launch.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace cvc
