// Single-query decode attention over an fp KV cache: the device code shared
// by the dense kernels of decode_attention.cu (K2, K3, K4) and the paged
// kernels of paged_attention.cu (K14, K15, K17). They differ only in where
// key row t of a (b, kv head) lives, which a row-address policy says:
//   DenseRows: the (layer, b, kv head) plane of an (L, B, KVH, S, hs) cache,
//     row t at plane + t * hs; this step's row is the one at pos;
//   PagedRows: an (L, P, KVH, page, hs) pool, row t in page table[t / page]
//     at row t % page; this step's row is the one at the write coordinates
//     (write_page, write_row), whatever position it holds;
//   DenseReadRows, PagedReadRows: the same addresses with no step's row
//     (K3, K14: the caches are read-only; kAppends is false, so the new-row
//     operands are never dereferenced and nothing is written).
// A key whose address is this step's row is taken from the new-row operand
// (registers, shared or global memory of the caller's choice), never from the
// cache, so no block depends on another block's write; the caller names the
// one block of each (b, kv head) that writes the row back.
//
// Bound on this card: bytes (see decode_attention.cu). One block per (b,
// query head) streams keys 0..pos: 8 warps interleave chunks of KC keys, each
// warp issues a whole chunk's K and V loads before it reduces, keeps its own
// online-softmax state, and the warps merge through shared memory at the
// end. Arithmetic is float32 FMA (no TF32), as the JAX kernels' HIGHEST dots.
#pragma once

#include <math.h>

#include "common.cuh"

namespace llama2 {
namespace fpa {

constexpr int kWarps = 8;

// Rows of one (layer, b, kv head) plane of a dense (L, B, KVH, S, hs) cache.
struct DenseRows {
  static constexpr bool kAppends = true;
  size_t plane;  // element offset of the plane's row 0
  int hs, pos;
  __device__ __forceinline__ size_t row(int t) const { return plane + (size_t)t * hs; }
  __device__ __forceinline__ bool is_new(int t, size_t) const { return t == pos; }
  __device__ __forceinline__ size_t new_row() const { return plane + (size_t)pos * hs; }
};

// Rows of one (b, kv head) through a page table over an (L, P, KVH, page, hs)
// pool. Offsets are 64-bit: a pool of 64 pages at Llama-2-7B widths holds
// 2^31 elements over its 32 layers.
struct PagedRows {
  static constexpr bool kAppends = true;
  const int* table;  // this slot's row of the (B, max_pages) table
  size_t layer_pages;  // layer * P
  int KVH, kvh, page, hs;
  size_t woff;  // element offset of the write coordinates' row
  __device__ __forceinline__ size_t at(int pg, int r) const {
    return (((layer_pages + pg) * KVH + kvh) * (size_t)page + r) * hs;
  }
  __device__ __forceinline__ size_t row(int t) const { return at(table[t / page], t % page); }
  __device__ __forceinline__ bool is_new(int, size_t off) const { return off == woff; }
  __device__ __forceinline__ size_t new_row() const { return woff; }
};

// The read-only forms (K3: one layer's (B, KVH, S, hs) cache is the plane of
// layer 0; K14: one layer's (P, KVH, page, hs) pool has layer_pages 0).
struct DenseReadRows : DenseRows {
  static constexpr bool kAppends = false;
  __device__ __forceinline__ bool is_new(int, size_t) const { return false; }
};

struct PagedReadRows : PagedRows {
  static constexpr bool kAppends = false;
  __device__ __forceinline__ bool is_new(int, size_t) const { return false; }
};

// The online-softmax read over keys 0..p of one (b, query head), then the
// append and the merge of the warps. qr: this lane's query elements, scaled.
// kn/vn: the step's new rows (unused, and may be null, where the policy does
// not append). C: T, or const T for a read-only cache. NPL: head elements per
// lane (hs <= 32 * NPL); KC: keys per warp chunk.
template <typename T, int NPL, int KC, typename Rows, typename C>
__device__ __forceinline__ void attend(const float (&qr)[NPL], C* k_cache, C* v_cache,
                                       const T* kn, const T* vn, T* oh, const Rows& rows,
                                       int p, int hs, bool write_back) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float m = -INFINITY, l = 0.f;
  float acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.f;

  for (int base = warp * KC; base <= p; base += kWarps * KC) {
    // Every load is unconditional and raw, converted only after all are
    // issued, so the chunk's loads are in flight together (predicated bf16
    // loads converted one at a time compile to loads that wait on each
    // other). A chunk row past p re-reads row p (its score is masked
    // below); a lane past hs re-reads element hs-1 (its q is 0).
    T kraw[KC][NPL], vraw[KC][NPL];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int t = min(base + c, p);
      const size_t off = rows.row(t);
      const bool fresh = rows.is_new(t, off);
      const T* kr = fresh ? kn : k_cache + off;
      const T* vr = fresh ? vn : v_cache + off;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = min(lane + 32 * i, hs - 1);
        kraw[c][i] = kr[d];
        vraw[c][i] = vr[d];
      }
    }
    float s[KC];
    float smax = -INFINITY;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) part = fmaf(qr[i], to_f32(kraw[c][i]), part);
      s[c] = base + c <= p ? warp_sum(part) : -INFINITY;
      smax = fmaxf(smax, s[c]);
    }
    // finite: key `base` <= p is always in the window
    const float m_new = fmaxf(m, smax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float pc = expf(s[c] - m_new);
      l += pc;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] = fmaf(pc, to_f32(vraw[c][i]), acc[i]);
    }
    m = m_new;
  }

  if constexpr (Rows::kAppends) {
    if (write_back) {
      T* kw = k_cache + rows.new_row();
      T* vw = v_cache + rows.new_row();
      for (int d = threadIdx.x; d < hs; d += blockDim.x) {
        kw[d] = kn[d];
        vw[d] = vn[d];
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][NPL * 32];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f;
  float wscale[kWarps];  // a warp that saw no key has m = -inf: weight 0
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wscale[w] = expf(sm_m[w] - M);
    L = fmaf(sm_l[w], wscale[w], L);
  }
  for (int d = threadIdx.x; d < hs; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(sm_acc[w][d], wscale[w], o);
    oh[d] = from_f32<T>(o / L);
  }
}

// one interleaved-pair rotation: the pair's other element is one lane away
// (the lane's element index has the lane's parity); products are rounded
// separately so no FMA contraction changes the bits
__device__ __forceinline__ float rope_interleaved(float x, float c, float s, int lane) {
  const float other = __shfl_xor_sync(0xffffffffu, x, 1);
  const float xc = __fmul_rn(x, c);
  const float os = __fmul_rn(other, s);
  return (lane & 1) ? __fadd_rn(os, xc) : __fsub_rn(xc, os);
}

// The glue-fused prologue of one (b, query head): rotate the query row (kept
// float32, scaled) into qr and the group's key row into k_roped, rounded to
// the cache dtype there, because the TPU kernels read it back from the cache.
// qkv: the raw (B, H + 2 KVH, hs) rows; the value row is the raw qkv row.
template <typename T, int NPL>
__device__ __forceinline__ void rope_prologue(const T* qkv, const float* cos_il, const float* sin_il,
                                              int b, int h, int kvh, int H, int KVH, int hs,
                                              float scale, float (&qr)[NPL], T* k_roped) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)b * (H + 2 * KVH);
  const T* q_raw = qkv + (row0 + h) * hs;
  const T* k_raw = qkv + (row0 + H + kvh) * hs;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    const bool ok = d < hs;  // hs is even: a pair is in or out whole
    const float c = ok ? cos_il[(size_t)b * hs + d] : 0.f;
    const float s = ok ? sin_il[(size_t)b * hs + d] : 0.f;
    const float xq = ok ? to_f32(q_raw[d]) : 0.f;
    const float xk = ok ? to_f32(k_raw[d]) : 0.f;
    qr[i] = rope_interleaved(xq, c, s, lane) * scale;
    const float kr = rope_interleaved(xk, c, s, lane);
    if (warp == 0 && ok) k_roped[d] = from_f32<T>(kr);
  }
  __syncthreads();
}

}  // namespace fpa
}  // namespace llama2
