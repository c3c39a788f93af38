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
// One kernel, three modes, on attention_q8.cuh's split decode loop over dense
// planes (att_split with DenseRows; the arithmetic, the bound and the layout
// are described there): a block a work item (b, kv head, group of up to 8
// query rows, split of the keys). A window's T * G query rows of a kv head
// come in groups of the plan's nq; each group reads the kv head's K/V rows.
// The instance (vector width, lanes a row, query rows a block) is the plan's
// (ops/cuda/attention_q8.py::q8_plan).
#include "attention_q8.cuh"

namespace {

using namespace llama2;

// two blocks an SM where the registers allow (up to 4 query rows a block):
// the plan's grid is two blocks an SM, one wave
template <int VB, int LPR, int NV, int NQ>
__global__ void __launch_bounds__(q8a::kThreads, NQ <= 4 ? 2 : 1) attention_q8_kernel(const q8a::Params a) {
  __shared__ __align__(16) q8a::SplitSmem sm;
  extern __shared__ float wacc[];  // the warps' acc: split_acc_floats(NQ, hs)
  q8a::att_split<q8a::DenseRows, VB, LPR, NV, NQ, q8a::unroll(NQ, 4)>(a, blockIdx.x, sm, wacc);
}

template <int VB, int LPR, int NV, int NQ>
cudaError_t launch(const q8a::Params& a, cudaStream_t st) {
  const int smem = q8a::split_acc_floats(NQ, a.hs) * (int)sizeof(float);
  auto kernel = attention_q8_kernel<VB, LPR, NV, NQ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.B * a.KVH * a.n_rg * a.nsplit, q8a::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 window (K7; q (B, T, H, hs), caches (B, KVH, S, hs) / (B, KVH, S),
//   L = 1, layer = 0, read only), 1 stacked append (K8; q (B, H, hs), caches
//   (L, B, KVH, S, hs) / (L, B, KVH, S), k_new / v_new (B, KVH, hs) int8 and
//   ks_new / vs_new (B, KVH) float32), 2 glue-fused (K9; qkv (B, H + 2 KVH, hs)
//   pre-RoPE, cos_il / sin_il (B, hs) float32).
// pos (B,) int32 on the device: the position of the LAST query row.
// out: like q ((B, H, hs) for mode 2), in the activation dtype `dtype`.
// The plan (ops/cuda/attention_q8.py::q8_plan): nsplit splits of the key
// range, nq query rows a block, vb bytes a vector load, chunk the keys of one
// block pass, which must be the instance's. ws: float32 workspace of
// ws_floats >= B * KVH * n_rg * nsplit * nq * (hs + 2), n_rg = ceil(T * H /
// KVH / nq); tickets: n_tickets >= B * KVH * n_rg int32, zero on entry, left
// zero. hs even and <= 256; int8 pointers aligned to vb. All tensors
// contiguous. Returns the launch's cudaError_t.
extern "C" int attention_q8(int mode, const void* q, const void* qkv, const void* cos_il,
                            const void* sin_il, void* k8, void* ks, void* v8, void* vs,
                            const void* k_new, const void* ks_new, const void* v_new,
                            const void* vs_new, const void* pos, void* out, void* ws,
                            void* tickets, long long ws_floats, int n_tickets, int dtype,
                            int layer, int L, int B, int T, int H, int KVH, int S, int hs,
                            int nsplit, int nq, int vb, int chunk, float scale, void* stream) {
  if (mode != q8a::kWindow && mode != q8a::kAppend && mode != q8a::kFused) return cudaErrorInvalidValue;
  if (mode != q8a::kWindow && T != 1) return cudaErrorInvalidValue;
  if (H <= 0 || KVH <= 0 || nq <= 0) return cudaErrorInvalidValue;
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
  a.nq = nq;
  a.vb = vb;
  a.n_rg = (T * (H / KVH) + nq - 1) / nq;
  a.scale = scale;
  const int err = q8a::check(a, ws_floats, n_tickets, chunk, 4);
  if (err != cudaSuccess) return err;
  const bool need_q = mode == q8a::kFused ? (qkv && cos_il && sin_il) : q != nullptr;
  const bool need_new = mode != q8a::kAppend || (k_new && ks_new && v_new && vs_new);
  if (!need_q || !need_new || !k8 || !ks || !v8 || !vs || !pos || !out) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LLAMA2_Q8A_LAUNCH(i, VB, LPR, NV, NQ) \
  case i:                                     \
    return launch<VB, LPR, NV, NQ>(a, st);
  switch (q8a::instance(vb, nq, hs)) { LLAMA2_Q8A_INSTANCES(LLAMA2_Q8A_LAUNCH) }
#undef LLAMA2_Q8A_LAUNCH
  return cudaErrorInvalidValue;
}
