// Flash decode attention over the layer-stacked KV cache, with this step's
// K/V rows appended in place.
//
// Replaces llama2_tpu/ops/pallas/attention.py::flash_decode_attention_stacked
// (decode_kernel) and ::flash_decode_attention_fused (decode_fused_kernel,
// which takes the raw fused-QKV rows and applies RoPE itself; see below), and
// ::flash_decode_attention (decode_read_kernel, K3: one layer's read-only
// (B, KVH, S, hs) cache, no append; see the end of this header).
//
// Computes, for each batch row b and query head h (one query token):
//   k_cache[layer, b, kvh, pos_b] = k_new[b, kvh];  v likewise
//   out[b, h] = softmax(q[b, h] * scale . K[0..pos_b]) V[0..pos_b]
// with kvh = h / (H / KVH). Only keys 0..pos_b are read.
//
// Bound on this card: bytes. Each (b, kv head) reads its (pos_b + 1) K and V
// rows once per query head of its group, two FMAs per element read. One
// block per (b, query head) streams those rows; 8 warps interleave chunks of
// KC keys, and each warp issues a whole chunk's K and V loads before it
// reduces, so about 8 * KC rows per block are in flight to cover memory
// latency. Each warp keeps its own online-softmax state; the warps merge
// through shared memory at the end. At batch 1 the grid is only B * H blocks
// (32 at Llama-2-7B widths on 132 SMs); splitting the key range across more
// blocks is later work.
//
// The append: the row at pos_b is taken from k_new/v_new, never from the
// cache, so no block depends on the write; the first query head of each
// group writes the row back. Arithmetic is float32 FMA for f32 and bf16
// inputs (no TF32), matching the JAX kernel's Precision.HIGHEST dots.
//
// The glue-fused form (decode_fused_kernel) reads this step's rows from the
// QKV projection's raw output qkv (B, H + 2*KVH, hs): every block rotates its
// query row and its group's key row by the step's pair-duplicated cos/sin
// tables (interleaved pairs sit in neighbouring lanes, one shuffle apart;
// x0*c - x1*s and x0*s + x1*c with separately rounded products, bit for bit
// what the plain rope computes). The query stays float32 and is scaled in
// float32; the rotated key row is rounded to the cache dtype and staged in
// shared memory BEFORE it is dotted, because the TPU kernel reads it back
// from the cache; the value row is the raw qkv row. The same loop then runs
// with the new rows taken from shared memory and qkv instead of k_new/v_new.
// The loop and the prologue live in decode_attention.cuh, shared with the
// paged kernels of paged_attention.cu, which differ only in where a key row
// lives.
//
// K3 is the same loop over one layer's cache with a read-only row policy
// (DenseReadRows): no new-row operands, no write, each row b at its own
// pos[b]. Bound on this card: bytes, the K and V rows 0..pos[b] of every
// (b, kv head) once: 4.2 MB at B = 1, KVH = 4, hs = 128, f32 and pos 1023,
// 1.25 us at 3.35 TB/s. At B = 1 and H = 32 the grid is 32 blocks on 132
// SMs, K2's underfill at batch 1.
#include "decode_attention.cuh"

namespace {

using llama2::fpa::attend;
using llama2::fpa::DenseReadRows;
using llama2::fpa::DenseRows;
using llama2::fpa::kWarps;
using llama2::fpa::rope_prologue;
using llama2::to_f32;

template <typename T, int NPL, int KC>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, T* k_cache, T* v_cache,
              const T* __restrict__ k_new, const T* __restrict__ v_new,
              const int* __restrict__ pos, T* __restrict__ out, int layer,
              int B, int H, int KVH, int S, int hs, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int kvh = h / G;
  const int lane = threadIdx.x & 31;
  const DenseRows rows{(((size_t)layer * B + b) * KVH + kvh) * (size_t)S * hs, hs, pos[b]};

  // q pre-scaled in f32, as the JAX kernel does before its dot
  float qr[NPL];
  const T* qh = q + ((size_t)b * H + h) * hs;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hs ? to_f32(qh[d]) * scale : 0.f;
  }
  attend<T, NPL, KC>(qr, k_cache, v_cache, k_new + ((size_t)b * KVH + kvh) * hs,
                     v_new + ((size_t)b * KVH + kvh) * hs,
                     out + ((size_t)b * H + h) * hs, rows, rows.pos, hs, h % G == 0);
}

template <typename T, int NPL, int KC>
__global__ void __launch_bounds__(kWarps * 32)
decode_fused_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_il,
                    const float* __restrict__ sin_il, T* k_cache, T* v_cache,
                    const int* __restrict__ pos, T* __restrict__ out, int layer,
                    int B, int H, int KVH, int S, int hs, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int kvh = h / G;
  const DenseRows rows{(((size_t)layer * B + b) * KVH + kvh) * (size_t)S * hs, hs, pos[b]};
  const T* v_raw = qkv + ((size_t)b * (H + 2 * KVH) + H + KVH + kvh) * hs;

  __shared__ T k_roped[NPL * 32];
  float qr[NPL];
  rope_prologue<T, NPL>(qkv, cos_il, sin_il, b, h, kvh, H, KVH, hs, scale, qr, k_roped);
  attend<T, NPL, KC>(qr, k_cache, v_cache, k_roped, v_raw,
                     out + ((size_t)b * H + h) * hs, rows, rows.pos, hs, h % G == 0);
}

template <typename T, int NPL>
cudaError_t launch(const void* q, void* kc, void* vc, const void* kn,
                   const void* vn, const void* pos, void* out, int layer, int B,
                   int H, int KVH, int S, int hs, float scale,
                   cudaStream_t stream) {
  constexpr int KC = NPL >= 8 ? 4 : 8;  // keeps the chunk within registers
  dim3 grid(H, B);
  decode_kernel<T, NPL, KC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<const int*>(pos), static_cast<T*>(out), layer, B, H, KVH, S,
      hs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, void* kc, void* vc, const void* kn,
                     const void* vn, const void* pos, void* out, int layer,
                     int B, int H, int KVH, int S, int hs, float scale,
                     cudaStream_t st) {
  if (hs <= 32) return launch<T, 1>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 64) return launch<T, 2>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 128) return launch<T, 4>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 256) return launch<T, 8>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T, int NPL>
cudaError_t launch_fused(const void* qkv, const void* cos_il, const void* sin_il,
                         void* kc, void* vc, const void* pos, void* out, int layer,
                         int B, int H, int KVH, int S, int hs, float scale,
                         cudaStream_t stream) {
  constexpr int KC = NPL >= 8 ? 4 : 8;
  dim3 grid(H, B);
  decode_fused_kernel<T, NPL, KC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos_il),
      static_cast<const float*>(sin_il), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<const int*>(pos), static_cast<T*>(out), layer, B, H, KVH, S, hs,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fused(const void* qkv, const void* c, const void* s, void* kc,
                           void* vc, const void* pos, void* out, int layer, int B,
                           int H, int KVH, int S, int hs, float scale,
                           cudaStream_t st) {
  if (hs <= 32) return launch_fused<T, 1>(qkv, c, s, kc, vc, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 64) return launch_fused<T, 2>(qkv, c, s, kc, vc, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 128) return launch_fused<T, 4>(qkv, c, s, kc, vc, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 256) return launch_fused<T, 8>(qkv, c, s, kc, vc, pos, out, layer, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T, int NPL, int KC>
__global__ void __launch_bounds__(kWarps * 32)
decode_read_kernel(const T* __restrict__ q, const T* k_cache, const T* v_cache,
                   const int* __restrict__ pos, T* __restrict__ out, int H, int KVH,
                   int S, int hs, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int lane = threadIdx.x & 31;
  const DenseReadRows rows{{((size_t)b * KVH + kvh) * (size_t)S * hs, hs, 0}};
  float qr[NPL];
  const T* qh = q + ((size_t)b * H + h) * hs;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hs ? to_f32(qh[d]) * scale : 0.f;
  }
  attend<T, NPL, KC>(qr, k_cache, v_cache, nullptr, nullptr,
                     out + ((size_t)b * H + h) * hs, rows, pos[b], hs, false);
}

template <typename T, int NPL>
cudaError_t launch_read(const void* q, const void* kc, const void* vc, const void* pos,
                        void* out, int B, int H, int KVH, int S, int hs, float scale,
                        cudaStream_t stream) {
  constexpr int KC = NPL >= 8 ? 4 : 8;
  decode_read_kernel<T, NPL, KC><<<dim3(H, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(pos), static_cast<T*>(out), H, KVH, S, hs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_read(const void* q, const void* kc, const void* vc, const void* pos,
                          void* out, int B, int H, int KVH, int S, int hs, float scale,
                          cudaStream_t st) {
  if (hs <= 32) return launch_read<T, 1>(q, kc, vc, pos, out, B, H, KVH, S, hs, scale, st);
  if (hs <= 64) return launch_read<T, 2>(q, kc, vc, pos, out, B, H, KVH, S, hs, scale, st);
  if (hs <= 128) return launch_read<T, 4>(q, kc, vc, pos, out, B, H, KVH, S, hs, scale, st);
  if (hs <= 256) return launch_read<T, 8>(q, kc, vc, pos, out, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// K3. q (B, H, hs); one layer's caches (B, KVH, S, hs), read only; pos (B,)
// int32 on the device, 0 <= pos[b] < S; out (B, H, hs). All contiguous, one
// dtype. Returns the launch's cudaError_t.
extern "C" int flash_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* pos, void* out, int dtype, int B, int H,
                                      int KVH, int S, int hs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || hs <= 0)
    return cudaErrorInvalidValue;
  if (!q || !k_cache || !v_cache || !pos || !out) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32)
    return dispatch_read<float>(q, k_cache, v_cache, pos, out, B, H, KVH, S, hs, scale, st);
  if (dtype == llama2::kBF16)
    return dispatch_read<__nv_bfloat16>(q, k_cache, v_cache, pos, out, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}

// q (B, H, hs); caches (L, B, KVH, S, hs), updated in place; k_new/v_new
// (B, KVH, 1, hs); pos (B,) int32 on the device; out (B, H, hs). All
// contiguous, one dtype. Returns the launch's cudaError_t.
extern "C" int flash_decode_attention_stacked(
    const void* q, void* k_cache, void* v_cache, const void* k_new,
    const void* v_new, const void* pos, void* out, int dtype, int layer, int B,
    int H, int KVH, int S, int hs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32)
    return dispatch<float>(q, k_cache, v_cache, k_new, v_new, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (dtype == llama2::kBF16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, k_new, v_new, pos, out, layer, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}

// qkv (B, H + 2*KVH, hs), the raw pre-RoPE projection rows; cos_il/sin_il
// (B, hs) float32 with each pair's value on both of its elements; caches
// (L, B, KVH, S, hs), updated in place with the rotated K row and the raw V
// row; pos (B,) int32 on the device; out (B, H, hs). qkv, caches and out
// share one dtype; hs is even. Returns the launch's cudaError_t.
extern "C" int flash_decode_attention_fused(
    const void* qkv, const void* cos_il, const void* sin_il, void* k_cache,
    void* v_cache, const void* pos, void* out, int dtype, int layer, int B, int H,
    int KVH, int S, int hs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || hs % 2 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32)
    return dispatch_fused<float>(qkv, cos_il, sin_il, k_cache, v_cache, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (dtype == llama2::kBF16)
    return dispatch_fused<__nv_bfloat16>(qkv, cos_il, sin_il, k_cache, v_cache, pos, out, layer, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}
