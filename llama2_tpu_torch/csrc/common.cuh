// Helpers shared by the attention kernels: element conversion and warp
// reductions. Arithmetic is float32 for every storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace llama2 {

// dtype codes passed over the C interface (ops/cuda/build.py::DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as astype does
}

// an activation of either dtype, by element index, as float32 and back
__device__ __forceinline__ float load_act(const void* p, size_t i, int dtype) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_act(void* p, size_t i, int dtype, float v) {
  if (dtype == kF32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// butterfly reductions: every lane ends with the result
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

}  // namespace llama2
