// Row RMS norm: out[r] = round(round(x[r] * rsqrt(mean(x[r]^2) + eps)) * w),
// each round to x's dtype, the mean and the products in float32.
//
// Replaces llama2_tpu/ops/pallas/rmsnorm.py::rmsnorm (K19): the Pallas
// kernel normalizes in float32, stores x * inv as x's dtype, then multiplies
// by the weight into an output of x's dtype; the two roundings are kept here
// (for bf16 rows they change the bits). eps is added after the mean.
//
// Bound on this card: bytes, each row read once and written once (and the
// weight once): 8.4 MB for 256 rows of 4096 f32, 2.5 us at 3.35 TB/s. One
// block a row, any row count (no padding to 256 rows). The block sums the
// squares over 16-byte loads (a scalar loop where the row length or the
// pointers do not allow them), reduces through warp shuffles and shared
// memory, then reads the row again to scale and store it: the second read
// finds the row in L1 or L2, so device memory sees it once.
#include "vec.cuh"

namespace {

using llama2::aligned16;
using llama2::from_f32;
using llama2::round_to;
using llama2::to_f32;
using llama2::Vec16;
using llama2::warp_sum;

constexpr int kThreads = 256;

template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int D,
               float eps) {
  constexpr int N = VEC ? Vec16<TX>::N : 1;
  const TX* xr = x + (size_t)blockIdx.x * D;
  TX* orow = out + (size_t)blockIdx.x * D;

  float ss = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x * N; i < D; i += kThreads * N) {
    float v[N];
    if constexpr (VEC)
      Vec16<TX>::load(xr + i, v);
    else
      v[0] = to_f32(xr[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) ss = fmaf(v[j], v[j], ss);
  }
  __shared__ float part[kThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) total += part[k];
  const float inv = 1.f / sqrtf(total / (float)D + eps);

#pragma unroll 4
  for (int i = threadIdx.x * N; i < D; i += kThreads * N) {
    float v[N];
    if constexpr (VEC)
      Vec16<TX>::load(xr + i, v);
    else
      v[0] = to_f32(xr[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = round_to<TX>(v[j] * inv) * to_f32(w[i + j]);
    if constexpr (VEC)
      Vec16<TX>::store(orow + i, v);
    else
      orow[i] = from_f32<TX>(v[0]);
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int R, int D, float eps,
                   cudaStream_t st) {
  const bool vec = D % Vec16<TX>::N == 0 && aligned16(x) && aligned16(out);
  if (vec)
    rmsnorm_kernel<TX, TW, true><<<R, kThreads, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), D, eps);
  else
    rmsnorm_kernel<TX, TW, false><<<R, kThreads, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace

// x (R, D) and out (R, D) in x's dtype, w (D,) in its own; contiguous; dtype
// codes as csrc/common.cuh. Returns the launch's cudaError_t.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int x_dtype, int w_dtype, int R,
                       int D, float eps, void* stream) {
  using llama2::kBF16;
  using llama2::kF32;
  if (R <= 0 || D <= 0 || !x || !w || !out) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && w_dtype == kF32) return launch<float, float>(x, w, out, R, D, eps, st);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, w, out, R, D, eps, st);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, w, out, R, D, eps, st);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, st);
  return cudaErrorInvalidValue;
}
