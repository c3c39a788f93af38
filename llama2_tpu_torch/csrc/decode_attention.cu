// Flash decode attention over the layer-stacked KV cache, with this step's
// K/V rows appended in place.
//
// Replaces llama2_tpu/ops/pallas/attention.py::flash_decode_attention_stacked
// (decode_kernel) and ::flash_decode_attention_fused (decode_fused_kernel,
// which takes the raw fused-QKV rows and applies RoPE itself; see below), and
// ::flash_decode_attention (K3: one layer's read-only (B, KVH, S, hs) cache,
// no append; see the end of this header).
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
// K3 runs the same split form read only (split_block_read: the ReadOnly
// policy over DenseRows at layer 0 of its one-layer cache, no new-row
// operands, no write), each row b at its own pos[b], at a given scale; its
// plan is K2's at S. Bound on this card: bytes, the K and V rows 0..pos[b] of
// every (b, kv head) once: 33.5 MB at the kernel benchmarks' B = 1, KVH = 4,
// hs = 128, f32 and pos 8191, 0.010 ms at 3.35 TB/s. There each kv head
// serves G = 8 query heads, and each query head is its own block (32 x 8
// splits = 256 blocks), so the group's rows are read 8 times: once from the
// card's memory, the rest from the L2.
#include "decode_attention.cuh"

namespace {

using llama2::fpa::DenseRows;
using llama2::fpa::Form;
using llama2::fpa::kWarps;
using llama2::fpa::Launch;
using llama2::fpa::run_split;

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(Launch a) {
  llama2::fpa::split_block<T, VE, LPR, NV, U, DenseRows>(a);
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_fused_kernel(Launch a) {
  llama2::fpa::split_block_fused<T, VE, LPR, NV, U, DenseRows>(a);
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_read_split_kernel(Launch a) {
  llama2::fpa::split_block_read<T, VE, LPR, NV, U, DenseRows>(a);
}

// K2, K4 and K3's kernels, for run_split
struct DenseKernels {
  template <typename T, int VE, int LPR, int NV, int U>
  static void launch(dim3 grid, const Launch& a, Form form, cudaStream_t st) {
    if (form == Form::fused)
      decode_fused_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
    else if (form == Form::append)
      decode_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
    else
      decode_read_split_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
  }
};

}  // namespace

// K2, K3 and K4 take the split form's plan (nsplit, vec, chunk) and
// workspace (ws, ws_floats, tickets, n_tickets) as decode_attention.cuh's
// run_split says.

// K3. q (B, H, hs); one layer's caches (B, KVH, S, hs), read only; pos (B,)
// int32 on the device, 0 <= pos[b] < S; out (B, H, hs). All contiguous, one
// dtype; hs <= 256; the caches aligned to the vector. Returns the launch's
// cudaError_t.
extern "C" int flash_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* pos, void* out, void* ws, void* tickets,
                                      long long ws_floats, int n_tickets, int dtype, int B, int H,
                                      int KVH, int S, int hs, int nsplit, int vec, int chunk,
                                      float scale, void* stream) {
  Launch a{};
  a.q = q;
  a.kc = const_cast<void*>(k_cache);
  a.vc = const_cast<void*>(v_cache);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.layer = 0;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.hs = hs;
  a.nsplit = nsplit;
  a.scale = scale;
  return run_split<DenseKernels>(a, dtype, vec, chunk, ws_floats, n_tickets, Form::read, stream);
}

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
  return run_split<DenseKernels>(a, dtype, vec, chunk, ws_floats, n_tickets, Form::append, stream);
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
  return run_split<DenseKernels>(a, dtype, vec, chunk, ws_floats, n_tickets, Form::fused, stream);
}
