// SwiGLU gate: out = round(round(h1 * sigmoid(h1)) * h3), each round to the
// rows' dtype, sigmoid and products in float32.
//
// Replaces llama2_tpu/ops/pallas/swiglu.py::swiglu (K20): the Pallas kernel
// computes silu in float32, casts it to h1's dtype, multiplies by h3 and
// stores in h1's dtype. Sigmoid is 1 / (1 + expf(-h)) with the accurate expf
// (not __expf), so the kernel matches the plain version to its tolerance.
// h1 and h3 share one dtype here.
//
// Bound on this card: bytes, h1 and h3 read once and out written once: 33.8
// MB for 256 rows of 11008 f32, 10.1 us at 3.35 TB/s. The rows are one flat
// array: a grid-stride loop over 16-byte vectors, then the elements past the
// last whole vector one by one (all of them where a pointer is not 16-byte
// aligned).
#include "vec.cuh"

namespace {

using llama2::aligned16;
using llama2::from_f32;
using llama2::round_to;
using llama2::to_f32;
using llama2::Vec16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // eight blocks an SM

// silu as the plain version computes it: a * (1 / (1 + exp(-a))), rounded
// to T, times b
template <typename T>
__device__ __forceinline__ float gate(float a, float b) {
  return round_to<T>(a * (1.f / (1.f + expf(-a)))) * b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ h1, const T* __restrict__ h3, T* __restrict__ out, size_t n,
              size_t n_vec) {
  constexpr int N = Vec16<T>::N;
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t v = first; v < n_vec; v += stride) {
    float a[N], b[N];
    Vec16<T>::load(h1 + v * N, a);
    Vec16<T>::load(h3 + v * N, b);
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = gate<T>(a[j], b[j]);
    Vec16<T>::store(out + v * N, a);
  }
  for (size_t i = n_vec * N + first; i < n; i += stride)
    out[i] = from_f32<T>(gate<T>(to_f32(h1[i]), to_f32(h3[i])));
}

template <typename T>
cudaError_t launch(const void* h1, const void* h3, void* out, size_t n, cudaStream_t st) {
  const bool vec = aligned16(h1) && aligned16(h3) && aligned16(out);
  const size_t n_vec = vec ? n / Vec16<T>::N : 0;
  const size_t work = n_vec + (n - n_vec * Vec16<T>::N);
  const size_t want = (work + kThreads - 1) / kThreads;
  const int blocks = want < kMaxBlocks ? (int)want : kMaxBlocks;
  swiglu_kernel<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(h1), static_cast<const T*>(h3),
                                                static_cast<T*>(out), n, n_vec);
  return cudaGetLastError();
}

}  // namespace

// h1, h3 and out: n contiguous elements of one dtype (codes as
// csrc/common.cuh). Returns the launch's cudaError_t.
extern "C" int swiglu(const void* h1, const void* h3, void* out, int dtype, long long n,
                      void* stream) {
  if (n <= 0 || !h1 || !h3 || !out) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32) return launch<float>(h1, h3, out, (size_t)n, st);
  if (dtype == llama2::kBF16) return launch<__nv_bfloat16>(h1, h3, out, (size_t)n, st);
  return cudaErrorInvalidValue;
}
