// Fused LSTM gate nonlinearity, forward and backward.
//
// Replaces cvc_tpu/ops/pallas/lstm.py::fused_lstm_gates (_fwd_kernel and
// _bwd_kernel).
//   forward:  gates [R, 4H] (i, f, g, o), c [R, H]  ->  h' [R, H], c' [R, H]
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g),  h' = sigmoid(o) * tanh(c')
//   backward: gates, c, gh = dL/dh', gc = dL/dc'  ->  dgates [R, 4H], dc [R, H]
//     recomputes i, f, g, o and tanh(c') instead of loading saved ones
// computed in float32, stored in c's type.
//
// Bound: bytes. Each element is read once and written once with a few tens
// of operations between, far below the card's ~295 operations per byte, so
// the kernels' only job is to stream: each thread owns kVec consecutive
// units of one row and moves them with one 16-byte access per gate block,
// the block stride loop keeps every SM busy, and nothing is staged in
// shared memory.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_gates_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                      const T* __restrict__ gh, const T* __restrict__ gc,
                      T* __restrict__ dgates, T* __restrict__ dc, int R, int H) {
  constexpr int VEC = kVec<T>;
  const int groups = H / VEC;
  const long long n = static_cast<long long>(R) * groups;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < n;
       t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(t / groups);
    const int j = static_cast<int>(t - static_cast<long long>(r) * groups) * VEC;
    const long long go_ = static_cast<long long>(r) * 4 * H + j;
    const long long o = static_cast<long long>(r) * H + j;
    alignas(16) T gi[VEC], gf[VEC], gg[VEC], gov[VEC], cc[VEC], hh[VEC], hc[VEC];
    alignas(16) T di[VEC], df[VEC], dg[VEC], dov[VEC], dcv[VEC];
    load_vec<T>(gi, gates + go_);
    load_vec<T>(gf, gates + go_ + H);
    load_vec<T>(gg, gates + go_ + 2 * H);
    load_vec<T>(gov, gates + go_ + 3 * H);
    load_vec<T>(cc, c + o);
    load_vec<T>(hh, gh + o);
    load_vec<T>(hc, gc + o);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float i_ = sigmoid_f(to_f(gi[v]));
      const float f_ = sigmoid_f(to_f(gf[v]));
      const float g_ = tanhf(to_f(gg[v]));
      const float o_ = sigmoid_f(to_f(gov[v]));
      const float c_ = to_f(cc[v]);
      const float tanh_c = tanhf(f_ * c_ + i_ * g_);
      const float ghv = to_f(hh[v]);
      const float dc_total = to_f(hc[v]) + ghv * o_ * (1.f - tanh_c * tanh_c);
      di[v] = from_f<T>(dc_total * g_ * i_ * (1.f - i_));
      df[v] = from_f<T>(dc_total * c_ * f_ * (1.f - f_));
      dg[v] = from_f<T>(dc_total * i_ * (1.f - g_ * g_));
      dov[v] = from_f<T>(ghv * tanh_c * o_ * (1.f - o_));
      dcv[v] = from_f<T>(dc_total * f_);
    }
    store_vec<T>(dgates + go_, di);
    store_vec<T>(dgates + go_ + H, df);
    store_vec<T>(dgates + go_ + 2 * H, dg);
    store_vec<T>(dgates + go_ + 3 * H, dov);
    store_vec<T>(dc + o, dcv);
  }
}

template <typename T>
void launch_bwd(const void* gates, const void* c, const void* gh, const void* gc,
                void* dgates, void* dc, int R, int H, cudaStream_t stream) {
  const long long n = static_cast<long long>(R) * (H / kVec<T>);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (blocks == 0) return;
  lstm_gates_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<const T*>(gh),
      static_cast<const T*>(gc), static_cast<T*>(dgates), static_cast<T*>(dc), R, H);
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

extern "C" int cvc_lstm_gates_bwd(const void* gates, const void* c, const void* gh,
                                  const void* gc, void* dgates, void* dc, int R, int H,
                                  int dtype, void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(aligned16(gates) && aligned16(c) && aligned16(gh) && aligned16(gc) &&
        aligned16(dgates) && aligned16(dc)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32 && H % kVec<float> == 0) {
    launch_bwd<float>(gates, c, gh, gc, dgates, dc, R, H, s);
  } else if (dtype == kBF16 && H % kVec<__nv_bfloat16> == 0) {
    launch_bwd<__nv_bfloat16>(gates, c, gh, gc, dgates, dc, R, H, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cvc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
