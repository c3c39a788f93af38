// The decode-row pieces of the INT8 dequant-matmul, shared by the kernels of
// quant_matmul.cu and mlp_block.cu: one 128-column strip of
// y (MT, N) += x (MT, K) @ dequant(q (K, N) int8, scale (K/G, N) f32), a
// quant group a warp at a time.
//
// A block has 8 warps. A thread owns 4 consecutive columns (one 4-byte load
// per weight row; a warp reads one 128-byte line per row) and all MT rows. A
// warp stages its group's x rows in shared memory (stage_group), then streams
// the group's weight rows U at a time (group_dot). At the end the 8 warps'
// sums are added in warp order through shared memory (put_warp_sums,
// sum_warps), so a result does not depend on how the warps were scheduled.
//
// Fast mode: x is rounded to bf16 by the caller's loader; the products
// x * float(q) of one group are summed in float32 (a bf16 x times an int8 w is
// exact in float32), the group's partial is multiplied by the f32 scale and
// added to the float32 accumulator. Accurate mode: w = float(q) * scale,
// float32 FMA into the accumulator. A group is never split between threads.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace llama2 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 128;        // largest quant group the decode-row code stages
constexpr int VEC = 4;            // columns a thread
constexpr int TILE_N = 32 * VEC;  // columns a block: one 128-byte line a row
static_assert(TILE_N >= kMaxG, "the reduce buffer also stages x");

// shared memory of one block, in floats: first the per-warp staged x rows
// [warp][m][kMaxG], then the warps' sums [warp][m][TILE_N]
template <int MT>
constexpr int kStripSmemFloats = kWarps * MT * TILE_N;

// byte c of a little-endian word, as a float
__device__ __forceinline__ float byte_f32(uint32_t word, int c) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * c)));
}

__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// 1 / sqrt(mean(v[k]^2) + eps) over k < K with v[k] = load(k), by the whole
// block; `buf` is shared scratch of at least kWarps floats. Every thread
// returns the value.
template <typename Load>
__device__ __forceinline__ float block_rstd(int K, float eps, float* buf, Load load) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = load(k);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = ss;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += buf[w];
  return 1.0f / sqrtf(t / (float)K + eps);
}

// This warp's x rows of one quant group into its shared rows xs[m][kMaxG]:
// xs[m][j] = load_x(m, j) for j < G, and 0 up to the next multiple of U.
template <int MT, int U, typename LoadX>
__device__ __forceinline__ void stage_group(float* xs, int G, int lane, LoadX load_x) {
  const int g_pad = (G + U - 1) / U * U;  // rows past G are staged as 0
  __syncwarp();
  for (int j = lane; j < g_pad; j += 32) {
#pragma unroll
    for (int m = 0; m < MT; ++m) xs[m * kMaxG + j] = j < G ? load_x(m, j) : 0.f;
  }
  __syncwarp();
}

// acc[m][c] += sum over the rows of group g of xs[m][row] * w[row][col + c],
// in the mode's arithmetic; q and scale point at the (K, N) matrix.
template <int MT, int U, bool FAST>
__device__ __forceinline__ void group_dot(const int8_t* q, const float* scale, int N, int G,
                                          int g, int col, const float* xs,
                                          float (&acc)[MT][VEC]) {
  const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + (size_t)g * N + col));
  const float s[VEC] = {s4.x, s4.y, s4.z, s4.w};
  float part[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) part[m][c] = 0.f;

  const int8_t* qp = q + (size_t)g * G * N + col;
  for (int r = 0; r < G; r += U) {
    uint32_t wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // a row past the group re-reads the group's last row; its x is 0
      const int rr = min(r + u, G - 1);
      wv[u] = load_word(qp + (size_t)rr * N);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) xv[m] = xs[m * kMaxG + r + u];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float wf = byte_f32(wv[u], c);
        if (!FAST) wf *= s[c];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (FAST)
            part[m][c] = fmaf(xv[m], wf, part[m][c]);
          else
            acc[m][c] = fmaf(xv[m], wf, acc[m][c]);
        }
      }
    }
  }
  if (FAST) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(part[m][c], s[c], acc[m][c]);
  }
}

// A warp's sums into the block's reduce buffer; column c of lane l sits at
// c * 32 + l. Call between two __syncthreads().
template <int MT>
__device__ __forceinline__ void put_warp_sums(float* sm, int warp, int lane,
                                              const float (&acc)[MT][VEC]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) sm[(warp * MT + m) * TILE_N + c * 32 + lane] = acc[m][c];
}

// The 8 warps' sums of element j of row m, added in warp order; element j is
// column strip_col(j) of the strip.
template <int MT>
__device__ __forceinline__ float sum_warps(const float* sm, int m, int j) {
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sm[(w * MT + m) * TILE_N + j];
  return t;
}

__device__ __forceinline__ int strip_col(int j) { return (j & 31) * VEC + (j >> 5); }

}  // namespace llama2
