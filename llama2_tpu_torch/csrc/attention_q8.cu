// Decode and verify-window attention over the int8 KV cache (K7, K8, K9).
//
// Replaces, in llama2_tpu/ops/pallas/attention_q8.py:
//   ::flash_decode_attention_q8 (K7): a window of T <= 16 query rows over the
//     (B, KVH, S, hs) int8 cache of one layer, read only (mode kWindow);
//   ::flash_decode_attention_q8_stacked (K8): T = 1 over the layer-stacked
//     cache, appending this step's already-quantized rows and scales in place
//     (mode kAppend);
//   ::flash_decode_attention_q8_fused (K9): K8 on the raw pre-RoPE QKV rows,
//     with RoPE and the row quantization in the kernel (mode kFused).
// The Pallas kernels' aligned read-modify-write windows around the new row
// have no counterpart: a block writes the new row's bytes and scale directly.
//
// The arithmetic, the bound and the layout are in attention_q8.cuh, shared
// with the whole-layer kernel (K13) of mlp_block.cu. One launch: a block a
// work item (b, kv head, group of query rows, split of the keys).
#include "attention_q8.cuh"

namespace {

using namespace llama2;

__global__ void __launch_bounds__(q8a::kThreads) attention_q8_kernel(const q8a::Params a) {
  __shared__ q8a::Smem sm;
  q8a::att_item(a, blockIdx.x, sm);
}

}  // namespace

// mode: 0 window (K7; q (B, T, H, hs), caches (B, KVH, S, hs) / (B, KVH, S),
//   L = 1, layer = 0, read only), 1 stacked append (K8; q (B, H, hs), caches
//   (L, B, KVH, S, hs) / (L, B, KVH, S), k_new / v_new (B, KVH, hs) int8 and
//   ks_new / vs_new (B, KVH) float32), 2 glue-fused (K9; qkv (B, H + 2 KVH, hs)
//   pre-RoPE, cos_il / sin_il (B, hs) float32).
// pos (B,) int32 on the device: the position of the LAST query row.
// out: like q ((B, H, hs) for mode 2), in the activation dtype `dtype`.
// ws: float32 workspace of ws_floats >= items * 16 * (hs + 2); tickets:
//   n_tickets >= B * KVH * n_rg int32, zero on entry, left zero. items =
//   B * KVH * n_rg * nsplit, n_rg = ceil(rows / 16), rows = T * H / KVH.
// hs even and <= 256; int8 pointers 16-byte aligned where hs % 16 == 0. All
// tensors contiguous. Returns the launch's cudaError_t.
extern "C" int attention_q8(int mode, const void* q, const void* qkv, const void* cos_il,
                            const void* sin_il, void* k8, void* ks, void* v8, void* vs,
                            const void* k_new, const void* ks_new, const void* v_new,
                            const void* vs_new, const void* pos, void* out, void* ws,
                            void* tickets, long long ws_floats, int n_tickets, int dtype,
                            int layer, int L, int B, int T, int H, int KVH, int S, int hs,
                            int nsplit, float scale, void* stream) {
  if (mode != q8a::kWindow && mode != q8a::kAppend && mode != q8a::kFused) return cudaErrorInvalidValue;
  if (mode != q8a::kWindow && T != 1) return cudaErrorInvalidValue;
  q8a::Params a{};
  a.q = q;
  a.qkv = qkv;
  a.cos_il = static_cast<const float*>(cos_il);
  a.sin_il = static_cast<const float*>(sin_il);
  a.k8 = static_cast<int8_t*>(k8);
  a.ks = static_cast<float*>(ks);
  a.v8 = static_cast<int8_t*>(v8);
  a.vs = static_cast<float*>(vs);
  a.k_new = static_cast<const int8_t*>(k_new);
  a.ks_new = static_cast<const float*>(ks_new);
  a.v_new = static_cast<const int8_t*>(v_new);
  a.vs_new = static_cast<const float*>(vs_new);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.mode = mode;
  a.dtype = dtype;
  a.layer = layer;
  a.L = L;
  a.B = B;
  a.T = T;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.hs = hs;
  a.nsplit = nsplit;
  a.scale = scale;
  if (H > 0 && KVH > 0)
    a.n_rg = (q8a::rows_per_head(mode, T, H, KVH) + q8a::kRB - 1) / q8a::kRB;
  const int err = q8a::check(a, ws_floats, n_tickets);
  if (err != cudaSuccess) return err;
  const bool need_q = mode == q8a::kFused ? (qkv && cos_il && sin_il) : q != nullptr;
  const bool need_new = mode != q8a::kAppend || (k_new && ks_new && v_new && vs_new);
  if (!need_q || !need_new || !k8 || !ks || !v8 || !vs || !pos || !out) return cudaErrorInvalidValue;
  attention_q8_kernel<<<q8a::items(a), q8a::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
