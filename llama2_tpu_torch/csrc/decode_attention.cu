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
// rows once per query head of its group, two FMAs per element read: at
// Llama-2-7B widths, batch 1 and pos 4095 in bf16, 64 MiB, 0.020 ms at
// 3.35 TB/s. Filling the card takes more bytes in flight than one block per
// (b, query head) holds (32 blocks on 132 SMs at batch 1), so the key range
// is cut into splits: a block per (b, query head, split), grid (nsplit, H, B).
// The host picks nsplit from the shapes and the SM count
// (ops/cuda/attention.py::plan), never from pos, so the launch shape is
// static; each block derives its keys from pos[b] on the device, and a row
// with a short context takes only the splits it fills with at least a chunk
// (one pass of the block), the others returning at once. Inside a split,
// each lane loads 16-byte vectors (a bf16 row of 128 elements is 16 lanes,
// so one warp load reads two whole rows), and each warp issues all U loads
// of its chunk of K and V before it reduces: 8 warps, 32 KiB a block in
// flight. The blocks of a (b, query head) merge their float32 states (m, l,
// acc) in split order through the workspace of ops/cuda/build.py: an integer
// ticket finds the last, which merges, writes out and zeroes the ticket. No
// float atomics: a rerun gives the same bits. A row that fills one split
// writes out directly. A head size that is no multiple of the vector, or an
// operand not 16-byte aligned, takes the same loop with one element a lane
// (the host's plan says which; the entry refuses a plan it cannot take).
//
// The append: the row at pos_b is taken from k_new/v_new, never from the
// cache, so no block depends on the write; the block whose split holds pos_b
// (the last) of the first query head of each group writes the row back.
// Arithmetic is float32 FMA for f32 and bf16 inputs (no TF32), matching the
// JAX kernel's Precision.HIGHEST dots.
//
// The glue-fused form (decode_fused_kernel) reads this step's rows from the
// QKV projection's raw output qkv (B, H + 2*KVH, hs): every block rotates its
// query row and its group's key row by the step's pair-duplicated cos/sin
// tables (x0*c - x1*s and x0*s + x1*c with separately rounded products, bit
// for bit what the plain rope computes). The query stays float32 and is
// scaled in float32; the rotated key row is rounded to the cache dtype and
// staged in shared memory BEFORE it is dotted, because the TPU kernel reads
// it back from the cache; the value row is the raw qkv row. The same loop
// then runs with the new rows taken from shared memory and qkv instead of
// k_new/v_new. The loops and the prologues live in decode_attention.cuh,
// shared with the paged kernels of paged_attention.cu, which differ only in
// where a key row lives.
//
// K3 keeps the single-block loop (attend): one block per (b, query head)
// over one layer's cache, read only (DenseRows' addresses, no new-row
// operands, no write), each row b at its own pos[b]. Bound on this
// card: bytes, the K and V rows 0..pos[b] of every (b, kv head) once: 4.2 MB
// at B = 1, KVH = 4, hs = 128, f32 and pos 1023, 1.25 us at 3.35 TB/s. At
// B = 1 and H = 32 its grid is 32 blocks on 132 SMs: the split form is the
// cure, not yet applied to it.
#include "decode_attention.cuh"

namespace {

using llama2::fpa::attend;
using llama2::fpa::DenseRows;
using llama2::fpa::kWarps;
using llama2::fpa::Launch;
using llama2::fpa::run_split;
using llama2::to_f32;

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(Launch a) {
  llama2::fpa::split_block<T, VE, LPR, NV, U, DenseRows>(a);
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_fused_kernel(Launch a) {
  llama2::fpa::split_block_fused<T, VE, LPR, NV, U, DenseRows>(a);
}

// K2 and K4's kernels, for run_split
struct DenseKernels {
  template <typename T, int VE, int LPR, int NV, int U>
  static void launch(dim3 grid, const Launch& a, bool fused, cudaStream_t st) {
    if (fused)
      decode_fused_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
    else
      decode_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
  }
};

template <typename T, int NPL, int KC>
__global__ void __launch_bounds__(kWarps * 32)
decode_read_kernel(const T* __restrict__ q, const T* k_cache, const T* v_cache,
                   const int* __restrict__ pos, T* __restrict__ out, int H, int KVH,
                   int S, int hs, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int lane = threadIdx.x & 31;
  const DenseRows rows{((size_t)b * KVH + kvh) * (size_t)S * hs, hs, 0};
  float qr[NPL];
  const T* qh = q + ((size_t)b * H + h) * hs;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hs ? to_f32(qh[d]) * scale : 0.f;
  }
  attend<T, NPL, KC>(qr, k_cache, v_cache, out + ((size_t)b * H + h) * hs, rows, pos[b], hs);
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

// K2 and K4 take the split form's plan (nsplit, vec, chunk) and workspace
// (ws, ws_floats, tickets, n_tickets) as decode_attention.cuh's run_split
// says.

// q (B, H, hs); caches (L, B, KVH, S, hs), updated in place; k_new/v_new
// (B, KVH, 1, hs); pos (B,) int32 on the device; out (B, H, hs). All
// contiguous, one dtype. Returns the launch's cudaError_t.
extern "C" int flash_decode_attention_stacked(
    const void* q, void* k_cache, void* v_cache, const void* k_new, const void* v_new,
    const void* pos, void* out, void* ws, void* tickets, long long ws_floats, int n_tickets,
    int dtype, int layer, int B, int H, int KVH, int S, int hs, int nsplit, int vec, int chunk,
    float scale, void* stream) {
  const Launch a{q, nullptr, nullptr, nullptr, k_cache, v_cache, k_new, v_new,
                 static_cast<const int*>(pos), out, static_cast<float*>(ws),
                 static_cast<int*>(tickets), layer, B, H, KVH, S, hs, nsplit, scale};
  return run_split<DenseKernels>(a, dtype, vec, chunk, ws_floats, n_tickets, false, stream);
}

// qkv (B, H + 2*KVH, hs), the raw pre-RoPE projection rows; cos_il/sin_il
// (B, hs) float32 with each pair's value on both of its elements; caches
// (L, B, KVH, S, hs), updated in place with the rotated K row and the raw V
// row; pos (B,) int32 on the device; out (B, H, hs). qkv, caches and out
// share one dtype; hs is even. Returns the launch's cudaError_t.
extern "C" int flash_decode_attention_fused(
    const void* qkv, const void* cos_il, const void* sin_il, void* k_cache, void* v_cache,
    const void* pos, void* out, void* ws, void* tickets, long long ws_floats, int n_tickets,
    int dtype, int layer, int B, int H, int KVH, int S, int hs, int nsplit, int vec, int chunk,
    float scale, void* stream) {
  const Launch a{nullptr, qkv, static_cast<const float*>(cos_il), static_cast<const float*>(sin_il),
                 k_cache, v_cache, nullptr, nullptr, static_cast<const int*>(pos), out,
                 static_cast<float*>(ws), static_cast<int*>(tickets), layer, B, H, KVH, S, hs,
                 nsplit, scale};
  return run_split<DenseKernels>(a, dtype, vec, chunk, ws_floats, n_tickets, true, stream);
}
