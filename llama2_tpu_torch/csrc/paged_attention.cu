// Paged decode attention over layer-stacked page pools, with this step's K/V
// rows appended in place at per-slot write coordinates (K15, K16, K17, K18),
// and over one layer's read-only pools (K14).
//
// Replaces, in llama2_tpu/ops/pallas/paged_attention.py:
//   ::paged_decode_attention (K14): one layer's fp pools (P, KVH, page, hs),
//     the query (B, H, hs), no append: K15's split form read only
//     (split_block_read, the ReadOnly policy over PagedRows at layer 0), so
//     it writes nothing and reads no table entry past pos[b] / page (a
//     split's last key is at most pos[b]);
//   ::paged_decode_attention_stacked (K15): fp pools; the roped query
//     (B, H, hs) and this step's rows k_new/v_new (B, KVH, hs) in the pool
//     dtype;
//   ::paged_decode_attention_q8_stacked (K16): int8 pools with float32 scale
//     pools; this step's rows already quantized, with their scales;
//   ::paged_decode_attention_fused (K17): K15 on the QKV projection's raw
//     pre-RoPE rows (B, H + 2 KVH, hs), RoPE on q and k in the kernel, the
//     rotated K row rounded to the pool dtype before it is dotted;
//   ::paged_decode_attention_q8_fused (K18): K16 on the raw rows, with RoPE
//     and the float32 row quantization (__fdiv_rn, rintf) in the kernel.
//
// Pools (L, P, KVH, page, hs), scale pools (L, P, KVH, page). Row t of slot b
// lives at [layer, table[b, t / page], kvh, t % page]; table entries past
// pos[b] / page are never read. This step's row is written at
// [layer, write_page[b], kvh, write_row[b]], and attention runs over keys
// 0..pos[b]; a key whose address is the write address takes the new row.
//
// The fp pools take the dense kernels' device code: K15, K17 and K14 are K2,
// K4 and K3's split form (decode_attention.cuh: split_block,
// split_block_fused, split_block_read, attend_split) with a row-address
// policy that reads through the table (PagedRows): a block per (b, query
// head, split), grid (nsplit, H, B), the split count from the shapes
// (ops/cuda/attention.py::plan at the table's reach, max_pages * page rows),
// 16-byte loads, the splits merged in split order through the workspace by
// a ticketed last split. The int8 pools take attention_q8.cuh's split decode loop
// (att_split): a block a (b, kv head, group of query rows, split of the
// keys), each warp on its own runs of keys with 16-byte loads, the splits
// merged in split order by a ticketed last split. Neither uses float
// atomics: a rerun gives the same bits. The int8 arithmetic is the dense
// K8/K9's. Offsets are 64-bit: at Llama-2-7B widths a pool of 64 pages holds
// 2^31 elements over its 32 layers.
//
// Bound on this card: bytes. A step reads the K/V rows of keys 0..pos[b] of
// every (b, kv head) once (plus two float32 scales a row over an int8 pool):
// at 7B widths, 8 slots at pos 4095 and a bf16 pool, 537 MB, 0.160 ms at
// 3.35 TB/s; K14 reads the same rows without this step's row compare. The
// table lookup costs an integer division a key (fp) or a chunk (int8) over
// the dense kernels. At the 7B layout (G = 1) no fp block rereads another's
// rows; under GQA a group's rows are read once a query head (see
// decode_attention.cu).
//
// Inactive slots: the engine gives them all-zero table rows, so they read
// the scratch page 0 and write their rows there; several may write the same
// scratch row in one launch, and read rows another writes. That race is
// harmless only because nothing live reads page 0 (the engine never hands it
// out): those slots' outputs are discarded, and they stay finite because
// every row ever written to page 0 is a finite row.
//
// The Pallas kernels' TPU rules have no counterpart: no aligned
// read-modify-write window around an int8 row (a block writes the row's
// bytes and scale directly), so no page_size % 128 for int8 pools; no
// hs % 128; no padding of the new rows to 8.
#include "attention_q8.cuh"
#include "decode_attention.cuh"

namespace {

using llama2::fpa::Form;
using llama2::fpa::kWarps;
using llama2::fpa::Launch;
using llama2::fpa::PagedRows;
using llama2::fpa::run_split;

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(Launch a) {
  llama2::fpa::split_block<T, VE, LPR, NV, U, PagedRows>(a);
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_fused_kernel(Launch a) {
  llama2::fpa::split_block_fused<T, VE, LPR, NV, U, PagedRows>(a);
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) paged_read_split_kernel(Launch a) {
  llama2::fpa::split_block_read<T, VE, LPR, NV, U, PagedRows>(a);
}

// K15, K17 and K14's kernels, for run_split
struct PagedKernels {
  template <typename T, int VE, int LPR, int NV, int U>
  static void launch(dim3 grid, const Launch& a, Form form, cudaStream_t st) {
    if (form == Form::fused)
      paged_decode_fused_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
    else if (form == Form::append)
      paged_decode_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
    else
      paged_read_split_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
  }
};

// K15 (append: q, k_new, v_new), K17 (fused: qkv, cos_il, sin_il in their
// places) and K14 (read: q alone, no new rows or write coordinates; layer 0
// of one layer's pools) over the pools; the plan and workspace as run_split
// takes them.
int paged_split(Form form, const void* q, void* kp, void* vp, const void* kn, const void* vn,
                const void* table, const void* wpage, const void* wrow, const void* pos, void* out,
                void* ws, void* tickets, long long ws_floats, int n_tickets, int dtype, int layer,
                int B, int H, int KVH, int P, int page, int max_pages, int hs, int nsplit, int vec,
                int chunk, float scale, void* stream) {
  if (P <= 0 || page <= 0 || max_pages <= 0 || !table) return cudaErrorInvalidValue;
  if (form != Form::read && (hs % 2 != 0 || !wpage || !wrow)) return cudaErrorInvalidValue;
  Launch a{};
  if (form == Form::fused) {
    a.qkv = q;
    a.cos_il = static_cast<const float*>(kn);
    a.sin_il = static_cast<const float*>(vn);
  } else {
    a.q = q;
    a.kn = kn;
    a.vn = vn;
  }
  a.kc = kp;
  a.vc = vp;
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.layer = layer;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.S = max_pages * page;  // the table's reach
  a.hs = hs;
  a.nsplit = nsplit;
  a.scale = scale;
  a.table = static_cast<const int*>(table);
  a.wpage = static_cast<const int*>(wpage);
  a.wrow = static_cast<const int*>(wrow);
  a.P = P;
  a.page = page;
  a.max_pages = max_pages;
  return run_split<PagedKernels>(a, dtype, vec, chunk, ws_floats, n_tickets, form, stream);
}

template <int VB, int LPR, int NV, int NQ>
__global__ void __launch_bounds__(llama2::q8a::kThreads) paged_attention_q8_kernel(const llama2::q8a::Params a) {
  namespace q8a = llama2::q8a;  // its PagedRows, not fpa's
  __shared__ __align__(16) q8a::SplitSmem sm;
  extern __shared__ float wacc[];  // the warps' acc: split_acc_floats(NQ, hs)
  q8a::att_split<q8a::PagedRows, VB, LPR, NV, NQ, q8a::unroll(NQ, 4)>(a, blockIdx.x, sm, wacc);
}

// One launch of the instance (VB, LPR, NV, NQ)
template <int VB, int LPR, int NV, int NQ>
cudaError_t launch_q8(const llama2::q8a::Params& a, cudaStream_t st) {
  using namespace llama2::q8a;
  const int smem = split_acc_floats(NQ, a.hs) * (int)sizeof(float);
  auto kernel = paged_attention_q8_kernel<VB, LPR, NV, NQ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.B * a.KVH * a.n_rg * a.nsplit, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The instance of the plan (ops/cuda/attention_q8.py::q8_plan), if `chunk`
// is its block pass
cudaError_t dispatch_q8(const llama2::q8a::Params& a, int chunk, cudaStream_t st) {
  using namespace llama2::q8a;
  const int inst = instance(a.vb, a.nq, a.hs);
  if (inst < 0 || chunk_of(inst, 4) != chunk) return cudaErrorInvalidValue;
#define LLAMA2_Q8A_LAUNCH(i, VB, LPR, NV, NQ) \
  case i:                                     \
    return launch_q8<VB, LPR, NV, NQ>(a, st);
  switch (inst) { LLAMA2_Q8A_INSTANCES(LLAMA2_Q8A_LAUNCH) }
#undef LLAMA2_Q8A_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// K14. q (B, H, hs); one layer's pools (P, KVH, page, hs), read only; table
// (B, max_pages), pos (B,) int32 on the device; out (B, H, hs). One dtype,
// contiguous; hs <= 256; the pools aligned to the vector. The plan and
// workspace as K15's. Returns the launch's cudaError_t.
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* table, const void* pos, void* out, void* ws,
                                      void* tickets, long long ws_floats, int n_tickets, int dtype,
                                      int B, int H, int KVH, int P, int page, int max_pages, int hs,
                                      int nsplit, int vec, int chunk, float scale, void* stream) {
  return paged_split(Form::read, q, const_cast<void*>(k_pool), const_cast<void*>(v_pool), nullptr, nullptr,
                     table, nullptr, nullptr, pos, out, ws, tickets, ws_floats, n_tickets, dtype, 0, B, H,
                     KVH, P, page, max_pages, hs, nsplit, vec, chunk, scale, stream);
}

// K15. q (B, H, hs); pools (L, P, KVH, page, hs), updated in place; k_new /
// v_new (B, KVH, 1, hs); table (B, max_pages), write_page / write_row / pos (B,)
// int32 on the device; out (B, H, hs). One dtype, contiguous; hs even and
// <= 256. The plan (ops/cuda/attention.py::plan at S = max_pages * page):
// nsplit splits of the key range, vec elements a vector load (16 bytes'
// worth, or 1; the pools and k_new / v_new aligned to it), chunk the keys of
// one block pass, which must be the instantiation's; ws (ws_floats float32)
// holds B * H * nsplit states of hs + 2 floats, tickets (n_tickets int32, at
// least B * H) are zero on entry and left zero. Returns the launch's
// cudaError_t.
extern "C" int paged_decode_attention_stacked(
    const void* q, void* k_pool, void* v_pool, const void* k_new, const void* v_new,
    const void* table, const void* write_page, const void* write_row, const void* pos, void* out,
    void* ws, void* tickets, long long ws_floats, int n_tickets, int dtype, int layer, int B, int H,
    int KVH, int P, int page, int max_pages, int hs, int nsplit, int vec, int chunk, float scale,
    void* stream) {
  return paged_split(Form::append, q, k_pool, v_pool, k_new, v_new, table, write_page, write_row, pos, out,
                     ws, tickets, ws_floats, n_tickets, dtype, layer, B, H, KVH, P, page, max_pages,
                     hs, nsplit, vec, chunk, scale, stream);
}

// K17. qkv (B, H + 2 KVH, hs), the raw pre-RoPE rows (aligned to the vector
// in K15's k_new / v_new stead); cos_il / sin_il (B, hs) float32, each
// pair's value on both of its elements (in K15's k_new / v_new places); the
// rest as K15's.
extern "C" int paged_decode_attention_fused(
    const void* qkv, void* k_pool, void* v_pool, const void* cos_il, const void* sin_il,
    const void* table, const void* write_page, const void* write_row, const void* pos, void* out,
    void* ws, void* tickets, long long ws_floats, int n_tickets, int dtype, int layer, int B, int H,
    int KVH, int P, int page, int max_pages, int hs, int nsplit, int vec, int chunk, float scale,
    void* stream) {
  return paged_split(Form::fused, qkv, k_pool, v_pool, cos_il, sin_il, table, write_page, write_row, pos, out,
                     ws, tickets, ws_floats, n_tickets, dtype, layer, B, H, KVH, P, page, max_pages,
                     hs, nsplit, vec, chunk, scale, stream);
}

// K16 (mode 1: q (B, H, hs); k_new / v_new (B, KVH, hs) int8 and ks_new /
// vs_new (B, KVH) float32) and K18 (mode 2: qkv (B, H + 2 KVH, hs) pre-RoPE,
// cos_il / sin_il (B, hs) float32). Pools: k8 / v8 (L, P, KVH, page, hs) int8
// and ks / vs (L, P, KVH, page) float32, updated in place; table
// (B, max_pages), write_page / write_row / pos (B,) int32; out (B, H, hs) in
// the activation dtype. The plan (ops/cuda/attention_q8.py::q8_plan):
// nsplit splits of the key range, nq query rows a block, vb bytes a vector
// load, chunk the keys of one block pass, which must be the instance's; ws
// (ws_floats float32) holds B * KVH * n_rg * nsplit states of nq * (hs + 2)
// floats, n_rg = ceil((H / KVH) / nq); tickets (n_tickets int32, at least
// B * KVH * n_rg) are zero on entry and left zero. Rows of the vb-byte loads
// are vb-aligned. Returns the launch's cudaError_t.
extern "C" int paged_attention_q8(
    int mode, const void* q, const void* qkv, const void* cos_il, const void* sin_il, void* k8,
    void* ks, void* v8, void* vs, const void* k_new, const void* ks_new, const void* v_new,
    const void* vs_new, const void* table, const void* write_page, const void* write_row,
    const void* pos, void* out, void* ws, void* tickets, long long ws_floats, int n_tickets,
    int dtype, int layer, int L, int B, int H, int KVH, int P, int page, int max_pages, int hs,
    int nsplit, int nq, int vb, int chunk, float scale, void* stream) {
  using namespace llama2;
  if (mode != q8a::kAppend && mode != q8a::kFused) return cudaErrorInvalidValue;
  if (P <= 0 || page <= 0 || max_pages <= 0 || !table || !write_page || !write_row)
    return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || hs <= 0 || hs > q8a::kMaxHs || hs % 2 != 0)
    return cudaErrorInvalidValue;
  if (nsplit < 1 || nsplit > q8a::kMaxSplit || layer < 0 || layer >= L) return cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (nq != 1 && nq != 4 && nq != 8) return cudaErrorInvalidValue;
  const int G = H / KVH;
  const int n_rg = (G + nq - 1) / nq;
  if (ws == nullptr || tickets == nullptr || n_tickets < B * KVH * n_rg) return cudaErrorInvalidValue;
  if (ws_floats < (long long)B * KVH * n_rg * nsplit * nq * (hs + 2)) return cudaErrorInvalidValue;
  const bool need_q = mode == q8a::kFused ? (qkv && cos_il && sin_il) : q != nullptr;
  const bool need_new = mode != q8a::kAppend || (k_new && ks_new && v_new && vs_new);
  if (!need_q || !need_new || !k8 || !ks || !v8 || !vs || !pos || !out) return cudaErrorInvalidValue;
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
  a.T = 1;
  a.H = H;
  a.KVH = KVH;
  a.S = max_pages * page;  // the table's reach
  a.hs = hs;
  a.nsplit = nsplit;
  a.n_rg = n_rg;
  a.nq = nq;
  a.vb = vb;
  a.scale = scale;
  a.table = static_cast<const int*>(table);
  a.wpage = static_cast<const int*>(write_page);
  a.wrow = static_cast<const int*>(write_row);
  a.P = P;
  a.page = page;
  a.max_pages = max_pages;
  return dispatch_q8(a, chunk, static_cast<cudaStream_t>(stream));
}
