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
// over one layer's cache with a read-only row policy (DenseReadRows): no
// new-row operands, no write, each row b at its own pos[b]. Bound on this
// card: bytes, the K and V rows 0..pos[b] of every (b, kv head) once: 4.2 MB
// at B = 1, KVH = 4, hs = 128, f32 and pos 1023, 1.25 us at 3.35 TB/s. At
// B = 1 and H = 32 its grid is 32 blocks on 132 SMs: the split form is the
// cure, not yet applied to it.
#include "decode_attention.cuh"

namespace {

using llama2::fpa::attend;
using llama2::fpa::attend_split;
using llama2::fpa::DenseReadRows;
using llama2::fpa::DenseRows;
using llama2::fpa::kMaxHs;
using llama2::fpa::kMaxSplit;
using llama2::fpa::kWarps;
using llama2::fpa::rope_rows;
using llama2::fpa::split_range;
using llama2::fpa::SplitRange;
using llama2::fpa::SplitShape;
using llama2::fpa::SplitWork;
using llama2::to_f32;

// The split form's launch: operands, workspace and plan.
struct Launch {
  const void* q;       // K2: (B, H, hs)
  const void* qkv;     // K4: (B, H + 2 KVH, hs), raw
  const float* cos_il;  // K4: (B, hs)
  const float* sin_il;
  void* kc;
  void* vc;
  const void* kn;  // K2: (B, KVH, 1, hs)
  const void* vn;
  const int* pos;
  void* out;
  float* ws;
  int* tickets;
  int layer, B, H, KVH, S, hs, nsplit;
  float scale;
};

// The key range and state slots of this block's split (blockIdx.x) of row b,
// query head h; false where the split lies past the row's n_keys keys (the
// block returns at once).
__device__ __forceinline__ bool split_work(const Launch& a, int chunk, int b, int h, int n_keys,
                                           SplitWork& sw) {
  const int split = blockIdx.x;
  const SplitRange sr = split_range(n_keys, a.nsplit, chunk);
  if (split >= sr.ns) return false;
  const size_t item = (size_t)b * a.H + h;
  sw = {split * sr.per, min(n_keys, (split + 1) * sr.per), split, sr.ns, a.hs,
        a.ws + item * a.nsplit * (a.hs + 2), a.tickets + item};
  return true;
}

// this lane's query vectors (attend_split's layout) from float32 values
template <int VE, int LPR, int NV, typename F>
__device__ __forceinline__ void lane_query(float (&qv)[NV][VE], int hs, F value) {
  const int j = (threadIdx.x & 31) % LPR;
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
    const int d0 = (nv * LPR + j) * VE;
#pragma unroll
    for (int i = 0; i < VE; ++i) qv[nv][i] = d0 < hs ? value(d0 + i) : 0.f;
  }
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(Launch a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int hs = a.hs, G = a.H / a.KVH, kvh = h / G;
  // pos and q are loaded together: neither waits on the other
  const int pos = a.pos[b];
  // q pre-scaled in f32, as the JAX kernel does before its dot
  const T* qh = static_cast<const T*>(a.q) + ((size_t)b * a.H + h) * hs;
  float qv[NV][VE];
  lane_query<VE, LPR>(qv, hs, [&](int d) { return to_f32(qh[d]) * a.scale; });
  SplitWork sw;
  if (!split_work(a, SplitShape<VE, LPR, NV, U>::kChunk, b, h, pos + 1, sw)) return;
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  const DenseRows rows{(((size_t)a.layer * a.B + b) * a.KVH + kvh) * (size_t)a.S * hs, hs, pos};
  const T* kn = static_cast<const T*>(a.kn) + ((size_t)b * a.KVH + kvh) * hs;
  const T* vn = static_cast<const T*>(a.vn) + ((size_t)b * a.KVH + kvh) * hs;
  if (h % G == 0 && sw.split == sw.ns - 1) {  // the split that holds pos
    for (int d = threadIdx.x; d < hs; d += blockDim.x) {
      kc[rows.new_row() + d] = kn[d];
      vc[rows.new_row() + d] = vn[d];
    }
  }
  attend_split<T, VE, LPR, NV, U>(qv, kc, vc, kn, vn,
                                  static_cast<T*>(a.out) + ((size_t)b * a.H + h) * hs, rows, sw);
}

template <typename T, int VE, int LPR, int NV, int U>
__global__ void __launch_bounds__(kWarps * 32) decode_fused_kernel(Launch a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int hs = a.hs, G = a.H / a.KVH, kvh = h / G;
  const int pos = a.pos[b];  // in flight during the prologue
  const T* qkv = static_cast<const T*>(a.qkv);
  __shared__ float q_s[kMaxHs];
  __shared__ __align__(16) T k_roped[kMaxHs];
  rope_rows<T>(qkv, a.cos_il, a.sin_il, b, h, kvh, a.H, a.KVH, hs, a.scale, q_s, k_roped);
  SplitWork sw;
  if (!split_work(a, SplitShape<VE, LPR, NV, U>::kChunk, b, h, pos + 1, sw)) return;
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  const DenseRows rows{(((size_t)a.layer * a.B + b) * a.KVH + kvh) * (size_t)a.S * hs, hs, pos};
  const T* v_raw = qkv + ((size_t)b * (a.H + 2 * a.KVH) + a.H + a.KVH + kvh) * hs;
  if (h % G == 0 && sw.split == sw.ns - 1) {
    for (int d = threadIdx.x; d < hs; d += blockDim.x) {
      kc[rows.new_row() + d] = k_roped[d];
      vc[rows.new_row() + d] = v_raw[d];
    }
  }
  float qv[NV][VE];
  lane_query<VE, LPR>(qv, hs, [&](int d) { return q_s[d]; });
  attend_split<T, VE, LPR, NV, U>(qv, kc, vc, k_roped, v_raw,
                                  static_cast<T*>(a.out) + ((size_t)b * a.H + h) * hs, rows, sw);
}

// one instantiation of the split form: launch it if the host's chunk is its
template <typename T, int VE, int LPR, int NV, int U>
cudaError_t launch(const Launch& a, bool fused, int chunk, cudaStream_t st) {
  if (chunk != SplitShape<VE, LPR, NV, U>::kChunk) return cudaErrorInvalidValue;
  const dim3 grid(a.nsplit, a.H, a.B);
  if (fused)
    decode_fused_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
  else
    decode_kernel<T, VE, LPR, NV, U><<<grid, kWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

// The lane layout for (vec, hs), as ops/cuda/attention.py::plan picks it:
// vec = 16 / sizeof(T) takes LPR = the power of two in 4..32 that covers
// hs / vec vectors (NV = 2 for fp32 past 128 elements), U = 4 / NV; vec = 1
// takes LPR = 32, NV = hs / 32 rounded up to a power of two, U = 8 / NV.
template <typename T>
cudaError_t dispatch(const Launch& a, bool fused, int vec, int chunk, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int hs = a.hs;
  if (vec == V && hs % V == 0) {
    const int n = hs / V;
    if (n <= 4) return launch<T, V, 4, 1, 4>(a, fused, chunk, st);
    if (n <= 8) return launch<T, V, 8, 1, 4>(a, fused, chunk, st);
    if (n <= 16) return launch<T, V, 16, 1, 4>(a, fused, chunk, st);
    if (n <= 32) return launch<T, V, 32, 1, 4>(a, fused, chunk, st);
    if constexpr (V == 4) {
      if (n <= 64) return launch<T, V, 32, 2, 2>(a, fused, chunk, st);
    }
    return cudaErrorInvalidValue;
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (hs <= 32) return launch<T, 1, 32, 1, 8>(a, fused, chunk, st);
  if (hs <= 64) return launch<T, 1, 32, 2, 4>(a, fused, chunk, st);
  if (hs <= 128) return launch<T, 1, 32, 4, 2>(a, fused, chunk, st);
  return launch<T, 1, 32, 8, 1>(a, fused, chunk, st);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<size_t>(p) % bytes == 0; }

// What the split form takes; 0 or a cudaError_t.
int check(const Launch& a, int dtype, int vec, long long ws_floats, int n_tickets, bool fused) {
  if (a.B <= 0 || a.H <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.S <= 0) return cudaErrorInvalidValue;
  if (a.hs <= 0 || a.hs > kMaxHs || (fused && a.hs % 2 != 0)) return cudaErrorInvalidValue;
  if (a.layer < 0 || a.nsplit < 1 || a.nsplit > kMaxSplit) return cudaErrorInvalidValue;
  if (dtype != llama2::kF32 && dtype != llama2::kBF16) return cudaErrorInvalidValue;
  if (!a.kc || !a.vc || !a.pos || !a.out || !a.ws || !a.tickets) return cudaErrorInvalidValue;
  if (fused ? (!a.qkv || !a.cos_il || !a.sin_il) : (!a.q || !a.kn || !a.vn)) return cudaErrorInvalidValue;
  if (ws_floats < (long long)a.B * a.H * a.nsplit * (a.hs + 2)) return cudaErrorInvalidValue;
  if (n_tickets < a.B * a.H) return cudaErrorInvalidValue;
  // the vector loads' operands: every row start a multiple of the vector
  const int vbytes = vec * (dtype == llama2::kF32 ? 4 : 2);
  if (vec < 1 || a.hs % vec != 0) return cudaErrorInvalidValue;
  const void* rows[] = {a.kc, a.vc, fused ? a.qkv : a.kn, fused ? a.qkv : a.vn};
  for (const void* p : rows)
    if (!aligned(p, vbytes)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

int run(const Launch& a, int dtype, int vec, int chunk, long long ws_floats, int n_tickets,
        bool fused, void* stream) {
  const int err = check(a, dtype, vec, ws_floats, n_tickets, fused);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32) return dispatch<float>(a, fused, vec, chunk, st);
  return dispatch<__nv_bfloat16>(a, fused, vec, chunk, st);
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

// The split form's plan (ops/cuda/attention.py::plan): nsplit splits of the
// key range, vec elements a vector load (16 / sizeof(T), or 1), chunk the
// keys of one block pass, which must be the instantiation's; ws (ws_floats
// float32) holds B * H * nsplit states of hs + 2 floats, tickets (n_tickets
// int32, at least B * H) are zero on entry and left zero.

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
  return run(a, dtype, vec, chunk, ws_floats, n_tickets, false, stream);
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
  return run(a, dtype, vec, chunk, ws_floats, n_tickets, true, stream);
}
