// 16-byte vector loads and stores of f32 or bf16 elements as float32, for the
// elementwise kernels (rmsnorm.cu, swiglu.cu). The pointer must be 16-byte
// aligned; the caller checks that and takes a scalar path where it is not.
#pragma once

#include "common.cuh"

namespace llama2 {

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// bf16: two elements a 32-bit word, element 2j in the low half
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// v rounded to T and back: the value a store of T would keep
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace llama2
