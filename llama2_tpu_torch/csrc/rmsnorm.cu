// Row RMS norm: out[r] = round(round(x[r] * rsqrt(mean(x[r]^2) + eps)) * w),
// each round to x's dtype, the mean and the products in float32.
//
// Replaces llama2_tpu/ops/pallas/rmsnorm.py::rmsnorm (K19): the Pallas
// kernel normalizes in float32, stores x * inv as x's dtype, then multiplies
// by the weight into an output of x's dtype; the two roundings are kept here
// (for bf16 rows they change the bits). eps is added after the mean.
//
// Bound on this card: bytes, each row read once and written once (and the
// weight once): 8.4 MB for 256 rows of 4096 f32, 2.5 us at 3.35 TB/s. Three
// forms, chosen on the host (ops/cuda/rmsnorm.py::plan):
//
// * registers (rmsnorm_regs): a group of TPR threads a row (32 to 256, a
//   power of two), each thread holding up to kVecs 16-byte vectors of the
//   row AND the matching vectors of the weight. Every load of the row and
//   the weight is issued before the first FMA, so one row costs one round
//   trip to memory, and the row stays in registers between the reduction
//   and the scale (the loop form below reads it twice). Short rows run
//   several to a block (a warp each), so that a launch of few rows still
//   spreads over the SMs. Taken for rows of up to 256 * kVecs vectors
//   (8192 f32, 16384 bf16) whose pointers allow 16-byte loads;
// * loop (rmsnorm_loop, VEC): one 256-thread block a row over 16-byte loads,
//   the sum of squares, then a second read of the row to scale it: the
//   general form for longer rows;
// * scalar (rmsnorm_loop, !VEC): the loop one element at a time, for rows
//   whose length or pointers do not allow 16-byte loads.
#include "vec.cuh"

namespace {

using llama2::aligned16;
using llama2::from_f32;
using llama2::round_to;
using llama2::to_f32;
using llama2::Vec16;
using llama2::warp_sum;

constexpr int kThreads = 256;  // the loop form's block; the register form's largest
constexpr int kVecs = 8;       // 16-byte vectors of the row a thread of the register form holds

// N weight elements as float32 from a pointer aligned to their size (8, 16 or
// 32 bytes): the weight's slice that matches one 16-byte vector of x
template <typename TW, int N>
__device__ __forceinline__ void load_w(const TW* p, float (&v)[N]) {
  if constexpr (sizeof(TW) * N == 8) {  // 4 bf16 beside 4 f32 of x
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const unsigned w[2] = {r.x, r.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    constexpr int M = Vec16<TW>::N;
#pragma unroll
    for (int k = 0; k < N / M; ++k) {
      float part[M];
      Vec16<TW>::load(p + k * M, part);
#pragma unroll
      for (int j = 0; j < M; ++j) v[k * M + j] = part[j];
    }
  }
}

// The register form: blockDim.x / TPR rows a block, TPR threads a row.
template <typename TX, typename TW, int TPR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_regs(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int R,
             int D, float eps) {
  constexpr int N = Vec16<TX>::N;
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  const bool live = row < R;  // a dead group still takes part in the barrier
  const int nvec = D / N;
  const TX* xr = x + (size_t)row * D;

  float v[kVecs][N], wv[kVecs][N];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = t + j * TPR;
    if (live && c < nvec) {
      Vec16<TX>::load(xr + (size_t)c * N, v[j]);
      load_w<TW, N>(w + (size_t)c * N, wv[j]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) v[j][k] = 0.f;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
#pragma unroll
    for (int k = 0; k < N; ++k) ss = fmaf(v[j][k], v[j][k], ss);
  ss = warp_sum(ss);
  if constexpr (TPR > 32) {
    __shared__ float part[kThreads / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    const float* mine = part + (threadIdx.x / TPR) * (TPR / 32);
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < TPR / 32; ++k) ss += mine[k];
  }
  if (!live) return;
  const float inv = 1.f / sqrtf(ss / (float)D + eps);
  TX* orow = out + (size_t)row * D;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = t + j * TPR;
    if (c < nvec) {
#pragma unroll
      for (int k = 0; k < N; ++k) v[j][k] = round_to<TX>(v[j][k] * inv) * wv[j][k];
      Vec16<TX>::store(orow + (size_t)c * N, v[j]);
    }
  }
}

template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int D,
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

// form codes as ops/cuda/rmsnorm.py::FORMS
constexpr int kScalar = 0;
constexpr int kLoop = 1;
constexpr int kRegs = 2;

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int R, int D, float eps, int form,
                   int tpr, int rows, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  constexpr int N = Vec16<TX>::N;
  const bool vec = D % N == 0 && aligned16(x) && aligned16(out);
  if (form == kScalar) {
    rmsnorm_loop<TX, TW, false><<<R, kThreads, 0, st>>>(xp, wp, op, D, eps);
    return cudaGetLastError();
  }
  if (!vec) return cudaErrorInvalidValue;
  if (form == kLoop) {
    rmsnorm_loop<TX, TW, true><<<R, kThreads, 0, st>>>(xp, wp, op, D, eps);
    return cudaGetLastError();
  }
  if (form != kRegs || !aligned16(w) || rows < 1 || rows * tpr > kThreads ||
      D / N > tpr * kVecs)
    return cudaErrorInvalidValue;
  const dim3 grid((R + rows - 1) / rows), block(rows * tpr);
  switch (tpr) {
    case 32: rmsnorm_regs<TX, TW, 32><<<grid, block, 0, st>>>(xp, wp, op, R, D, eps); break;
    case 64: rmsnorm_regs<TX, TW, 64><<<grid, block, 0, st>>>(xp, wp, op, R, D, eps); break;
    case 128: rmsnorm_regs<TX, TW, 128><<<grid, block, 0, st>>>(xp, wp, op, R, D, eps); break;
    case 256: rmsnorm_regs<TX, TW, 256><<<grid, block, 0, st>>>(xp, wp, op, R, D, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (R, D) and out (R, D) in x's dtype, w (D,) in its own; contiguous; dtype
// codes as csrc/common.cuh. ``form``, ``tpr`` (threads a row) and ``rows``
// (rows a block) from ops/cuda/rmsnorm.py::plan; the last two are read by the
// register form only. Returns the launch's cudaError_t.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int x_dtype, int w_dtype, int R,
                       int D, float eps, int form, int tpr, int rows, void* stream) {
  using llama2::kBF16;
  using llama2::kF32;
  if (R <= 0 || D <= 0 || !x || !w || !out) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch<float, float>(x, w, out, R, D, eps, form, tpr, rows, st);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, w, out, R, D, eps, form, tpr, rows, st);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, w, out, R, D, eps, form, tpr, rows, st);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, form, tpr, rows, st);
  return cudaErrorInvalidValue;
}
