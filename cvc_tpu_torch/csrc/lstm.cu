// Fused LSTM gate nonlinearity, forward.
//
// Replaces cvc_tpu/ops/pallas/lstm.py::fused_lstm_gates (_fwd_kernel).
//   gates [R, 4H] (i, f, g, o), c [R, H]  ->  h' [R, H], c' [R, H]
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')
// computed in float32, stored in c's type.
//
// Bound: bytes. Each element is read once and written once with about ten
// operations between, far below the card's ~295 operations per byte, so the
// kernel's only job is to stream: each thread owns kVec consecutive units of
// one row and moves them with one 16-byte access per gate block, the block
// stride loop keeps every SM busy, and nothing is staged in shared memory.
#include "common.cuh"

namespace {

using namespace cvc;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_gates_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                      T* __restrict__ h_out, T* __restrict__ c_out, int R, int H) {
  constexpr int VEC = kVec<T>;
  const int groups = H / VEC;
  const long long n = static_cast<long long>(R) * groups;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < n;
       t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(t / groups);
    const int j = static_cast<int>(t - static_cast<long long>(r) * groups) * VEC;
    const T* g = gates + static_cast<long long>(r) * 4 * H + j;
    const long long o = static_cast<long long>(r) * H + j;
    alignas(16) T gi[VEC], gf[VEC], gg[VEC], go[VEC], cc[VEC], ho[VEC], co[VEC];
    load_vec<T>(gi, g);
    load_vec<T>(gf, g + H);
    load_vec<T>(gg, g + 2 * H);
    load_vec<T>(go, g + 3 * H);
    load_vec<T>(cc, c + o);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float i_ = sigmoid_f(to_f(gi[v]));
      const float f_ = sigmoid_f(to_f(gf[v]));
      const float g_ = tanhf(to_f(gg[v]));
      const float o_ = sigmoid_f(to_f(go[v]));
      const float c_new = f_ * to_f(cc[v]) + i_ * g_;
      ho[v] = from_f<T>(o_ * tanhf(c_new));
      co[v] = from_f<T>(c_new);
    }
    store_vec<T>(h_out + o, ho);
    store_vec<T>(c_out + o, co);
  }
}

template <typename T>
void launch(const void* gates, const void* c, void* h, void* c_new, int R, int H,
            cudaStream_t stream) {
  const long long n = static_cast<long long>(R) * (H / kVec<T>);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (blocks == 0) return;
  lstm_gates_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<T*>(h),
      static_cast<T*>(c_new), R, H);
}

}  // namespace

extern "C" int cvc_lstm_gates_fwd(const void* gates, const void* c, void* h, void* c_new,
                                  int R, int H, int dtype, void* stream) {
  cudaGetLastError();  // report only what this launch does
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(aligned16(gates) && aligned16(c) && aligned16(h) && aligned16(c_new)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32 && H % kVec<float> == 0) {
    launch<float>(gates, c, h, c_new, R, H, s);
  } else if (dtype == kBF16 && H % kVec<__nv_bfloat16> == 0) {
    launch<__nv_bfloat16>(gates, c, h, c_new, R, H, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cvc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
