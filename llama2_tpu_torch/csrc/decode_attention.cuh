// Single-query decode attention over an fp KV cache: the device code shared
// by the dense kernels of decode_attention.cu (K2, K3, K4) and the paged
// kernels of paged_attention.cu (K14, K15, K17). They differ only in where
// key row t of a (b, kv head) lives, which a row-address policy says:
//   DenseRows: the (layer, b, kv head) plane of an (L, B, KVH, S, hs) cache,
//     row t at plane + t * hs; this step's row is the one at pos;
//   PagedRows: an (L, P, KVH, page, hs) pool, row t in page table[t / page]
//     at row t % page; this step's row is the one at the write coordinates
//     (write_page, write_row), whatever position it holds.
// In the appending kernels (K2, K4, K15, K17) a key whose address is this
// step's row is taken from the new-row operand (shared or global memory of
// the caller's choice), never from the cache, so no block depends on another
// block's write; the caller names the one block of each (b, kv head) that
// writes the row back. The read-only kernels (K3, K14) take either policy
// through ReadOnly, whose is_new is false: every key comes from the cache,
// and nothing is written back.
//
// Bound on this card: bytes (see decode_attention.cu). One loop,
// attend_split, serves all six: the key range is cut into splits, one block
// per (b, query head, split); lanes load 16-byte vectors (LPR lanes a row,
// 32 / LPR rows a warp load), and the blocks of one (b, query head) merge
// their float32 states in split order through a workspace, the last to
// finish found by an integer ticket. split_block, split_block_fused and
// split_block_read are a whole block of K2 / K15, K4 / K17 and K3 / K14 over
// either policy, and run_split the host side of their launch: the C entries
// of both sources share them. Under grouped-query attention each of a kv
// head's G query heads is its own block, so a group's rows are read G times
// (from the 50 MB L2, where they fit; the card's memory sees them about once).
// Arithmetic is float32 FMA (no TF32), as the JAX kernels' HIGHEST dots.
#pragma once

#include <math.h>

#include "common.cuh"

namespace llama2 {
namespace fpa {

constexpr int kWarps = 8;

// The split form's launch (K2, K3, K4, K14, K15, K17): operands, workspace,
// plan and the cache's layout. K3 and K14 read one layer's cache or pools
// (layer 0 of L = 1) and take no new rows and no write coordinates.
struct Launch {
  const void* q;        // K2, K3, K14, K15: (B, H, hs)
  const void* qkv;      // K4, K17: (B, H + 2 KVH, hs), raw
  const float* cos_il;  // K4, K17: (B, hs)
  const float* sin_il;
  void* kc;  // dense (L, B, KVH, S, hs); paged (L, P, KVH, page, hs)
  void* vc;
  const void* kn;  // K2, K15: (B, KVH, 1, hs)
  const void* vn;
  const int* pos;
  void* out;
  float* ws;
  int* tickets;
  int layer, B, H, KVH, S, hs, nsplit;  // paged: S = max_pages * page, the table's reach
  float scale;
  const int* table;  // paged: (B, max_pages), and the write coordinates (B,)
  const int* wpage;
  const int* wrow;
  int P, page, max_pages;
};

// Rows of one (layer, b, kv head) plane of a dense (L, B, KVH, S, hs) cache.
struct DenseRows {
  size_t plane;  // element offset of the plane's row 0
  int hs, pos;
  __device__ __forceinline__ size_t row(int t) const { return plane + (size_t)t * hs; }
  __device__ __forceinline__ bool is_new(int t, size_t) const { return t == pos; }
  __device__ __forceinline__ size_t new_row() const { return plane + (size_t)pos * hs; }
  static __device__ __forceinline__ DenseRows of(const Launch& a, int b, int kvh, int pos) {
    return {(((size_t)a.layer * a.B + b) * a.KVH + kvh) * (size_t)a.S * a.hs, a.hs, pos};
  }
  // the rows alone, for a read-only block: no row is this step's
  static __device__ __forceinline__ DenseRows read(const Launch& a, int b, int kvh) { return of(a, b, kvh, -1); }
};

// Rows of one (b, kv head) through a page table over an (L, P, KVH, page, hs)
// pool. Offsets are 64-bit: a pool of 64 pages at Llama-2-7B widths holds
// 2^31 elements over its 32 layers.
struct PagedRows {
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
  // the rows alone, for a read-only block: no write coordinates are read
  static __device__ __forceinline__ PagedRows read(const Launch& a, int b, int kvh) {
    return {a.table + (size_t)b * a.max_pages, (size_t)a.layer * a.P, a.KVH, kvh, a.page, a.hs, 0};
  }
  static __device__ __forceinline__ PagedRows of(const Launch& a, int b, int kvh, int) {
    PagedRows r = read(a, b, kvh);
    r.woff = r.at(a.wpage[b], a.wrow[b]);
    return r;
  }
};

// Either policy read only (K3, K14): no key is this step's row, so every key
// comes from the cache and attend_split's choice of operand folds away.
template <typename Rows>
struct ReadOnly : Rows {
  __device__ __forceinline__ bool is_new(int, size_t) const { return false; }
  static __device__ __forceinline__ ReadOnly of(const Launch& a, int b, int kvh) { return {Rows::read(a, b, kvh)}; }
};

// one interleaved-pair rotation of element x with its partner `other`;
// products are rounded separately so no FMA contraction changes the bits
__device__ __forceinline__ float rope_pair(float x, float other, float c, float s, bool odd) {
  const float xc = __fmul_rn(x, c);
  const float os = __fmul_rn(other, s);
  return odd ? __fadd_rn(os, xc) : __fsub_rn(xc, os);
}

// ---------------------------------------------------------------- split form

constexpr int kMaxSplit = 32;  // splits of the key range
constexpr int kMaxHs = 256;

// The keys of one split: a row with n_keys keys fills ns <= nsplit splits of
// `per` keys each, per a multiple of `chunk` (the keys one pass of a block
// covers), the last split cut at n_keys. Every split s < ns holds at least
// one key, and the ns splits cover 0..n_keys-1 once
// (tests/test_torch_decode_split.py mirrors it).
struct SplitRange {
  int ns, per;
};

__device__ __forceinline__ SplitRange split_range(int n_keys, int nsplit, int chunk) {
  const int ns0 = max(1, min(nsplit, (n_keys + chunk - 1) / chunk));
  const int per = ((n_keys + ns0 - 1) / ns0 + chunk - 1) / chunk * chunk;
  return {(n_keys + per - 1) / per, per};
}

// VE elements of T loaded as one vector of VE * sizeof(T) bytes (16 at most;
// the address aligned to it) and read back as float32
template <typename T, int VE>
struct RowVec {
  static constexpr int kBytes = VE * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  unsigned w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      w[0] = r.x;
      w[1] = r.y;
      w[2] = r.z;
      w[3] = r.w;
    } else if constexpr (kBytes == 8) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x;
      w[1] = r.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  // element i (bf16: two a word, element 2j in the low half)
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[i]);
    else if constexpr (kBytes == 2)
      return __uint_as_float(w[0] << 16);
    else
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
};

// The lane layout of attend_split: VE elements a vector, LPR lanes a row
// (a power of two, 4..32), NV vectors a lane a row, U warp loads a chunk.
template <int VE, int LPR, int NV, int U>
struct SplitShape {
  static constexpr int kRowsPerWarp = 32 / LPR;
  static constexpr int kWarpKeys = U * kRowsPerWarp;  // keys of one warp pass
  static constexpr int kChunk = kWarps * kWarpKeys;   // keys of one block pass
};

// What one block of attend_split works on: keys t_begin..t_end-1 of split
// `split` of ns; `ws` the (b, query head)'s nsplit states of hs + 2 floats
// (m, l, acc), `ticket` its counter (zero on entry and on exit).
struct SplitWork {
  int t_begin, t_end, split, ns, hs;
  float* ws;
  int* ticket;
};

// The split form of the read over keys t_begin..t_end-1, then the merge.
// Lane = (row slot r, vector slot j): in each warp load, row slot r takes key
// base + u * (32 / LPR) + r and lane j its vectors nv * LPR + j, so a load
// instruction reads 32 / LPR whole neighbouring rows. Every load of a chunk
// is issued before any is used. A score is summed over the LPR lanes of its
// row; the warp shares one running max, so its row slots' l and acc add up at
// the end. The warps merge through shared memory into the block's state; a
// row that fills one split writes out at once, else the block publishes its
// state to ws and the last of the ns blocks (the ticket) merges the states in
// split order (weight 0 for a state that saw no key), writes out and zeroes
// the ticket. qv: this lane's query elements, scaled (0 past hs); kn/vn this
// step's new rows, read in place of the cache row rows.is_new names (16-byte
// aligned where VE * sizeof(T) is 16).
template <typename T, int VE, int LPR, int NV, int U, typename Rows, typename C>
__device__ __forceinline__ void attend_split(const float (&qv)[NV][VE], C* k_cache, C* v_cache,
                                             const T* kn, const T* vn, T* oh, const Rows& rows,
                                             const SplitWork& sw) {
  using Shape = SplitShape<VE, LPR, NV, U>;
  constexpr int RPW = Shape::kRowsPerWarp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = lane / LPR, j = lane % LPR;
  const int hs = sw.hs;
  // a lane past hs re-reads the last vector (its q is 0)
  int e[NV];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) e[nv] = min((nv * LPR + j) * VE, hs - VE);

  float m = -INFINITY, l = 0.f;
  float acc[NV][VE];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[nv][i] = 0.f;

  for (int base = sw.t_begin + warp * Shape::kWarpKeys; base < sw.t_end;
       base += kWarps * Shape::kWarpKeys) {
    // a key past t_end re-reads key t_end - 1 (its score is masked)
    RowVec<T, VE> kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = min(base + u * RPW + r, sw.t_end - 1);
      const size_t off = rows.row(t);
      const bool fresh = rows.is_new(t, off);
      const T* kp = fresh ? kn : k_cache + off;
      const T* vp = fresh ? vn : v_cache + off;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        kr[u][nv].load(kp + e[nv]);
        vr[u][nv].load(vp + e[nv]);
      }
    }
    float s[U];
    float smax = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part = 0.f;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int i = 0; i < VE; ++i) part = fmaf(qv[nv][i], kr[u][nv].at(i), part);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      s[u] = base + u * RPW + r < sw.t_end ? part : -INFINITY;
      smax = fmaxf(smax, s[u]);
    }
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, o));
    // finite: key `base` < t_end is always in the chunk
    const float m_new = fmaxf(m, smax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[nv][i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int i = 0; i < VE; ++i) acc[nv][i] = fmaf(p, vr[u][nv].at(i), acc[nv][i]);
    }
    m = m_new;
  }
  // the warp's row slots share m: add their l and acc
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[nv][i] += __shfl_xor_sync(0xffffffffu, acc[nv][i], o);
  }

  // merge the warps' states into the block's
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHs];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (r == 0) {
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int d0 = (nv * LPR + j) * VE;
      if (d0 < hs) {
#pragma unroll
        for (int i = 0; i < VE; ++i) sm_acc[warp][d0 + i] = acc[nv][i];
      }
    }
  }
  __syncthreads();
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f;
  float wscale[kWarps];  // a warp that saw no key has m = -inf: weight 0
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wscale[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - M);
    L = fmaf(sm_l[w], wscale[w], L);
  }
  if (sw.ns == 1) {
    for (int d = threadIdx.x; d < hs; d += blockDim.x) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o = fmaf(sm_acc[w][d], wscale[w], o);
      oh[d] = from_f32<T>(o / L);
    }
    return;
  }

  // publish this split's state: m, l, then acc
  const int stride = hs + 2;
  float* mine = sw.ws + (size_t)sw.split * stride;
  for (int d = threadIdx.x; d < hs; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(sm_acc[w][d], wscale[w], o);
    mine[2 + d] = o;
  }
  if (threadIdx.x == 0) {
    mine[0] = M;
    mine[1] = L;
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(sw.ticket, 1) == sw.ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last split merges the ns states in split order
  __shared__ float sm_w[kMaxSplit], sm_sl[kMaxSplit];
  if (threadIdx.x < sw.ns) {
    sm_w[threadIdx.x] = __ldcg(sw.ws + (size_t)threadIdx.x * stride);
    sm_sl[threadIdx.x] = __ldcg(sw.ws + (size_t)threadIdx.x * stride + 1);
  }
  __syncthreads();
  float MS = -INFINITY;
  for (int sp = 0; sp < sw.ns; ++sp) MS = fmaxf(MS, sm_w[sp]);
  float LS = 0.f;
  for (int sp = 0; sp < sw.ns; ++sp)
    LS = fmaf(sm_sl[sp], sm_w[sp] == -INFINITY ? 0.f : expf(sm_w[sp] - MS), LS);
  for (int d = threadIdx.x; d < hs; d += blockDim.x) {
    float o = 0.f;
    for (int sp = 0; sp < sw.ns; ++sp) {
      const float wt = sm_w[sp] == -INFINITY ? 0.f : expf(sm_w[sp] - MS);
      o = fmaf(__ldcg(sw.ws + (size_t)sp * stride + 2 + d), wt, o);
    }
    oh[d] = from_f32<T>(o / LS);
  }
  if (threadIdx.x == 0) *sw.ticket = 0;
}

// The glue-fused prologue (K4, K17), one element a thread: the rotated query
// row (float32, scaled) into q_s and the group's rotated key row into
// k_roped, rounded to the cache dtype there, because the TPU kernels read it
// back from the cache. qkv: the raw (B, H + 2 KVH, hs) rows.
template <typename T>
__device__ __forceinline__ void rope_rows(const T* qkv, const float* cos_il, const float* sin_il,
                                          int b, int h, int kvh, int H, int KVH, int hs,
                                          float scale, float* q_s, T* k_roped) {
  const size_t row0 = (size_t)b * (H + 2 * KVH);
  const T* q_raw = qkv + (row0 + h) * hs;
  const T* k_raw = qkv + (row0 + H + kvh) * hs;
  for (int d = threadIdx.x; d < hs; d += blockDim.x) {
    const float c = cos_il[(size_t)b * hs + d];
    const float s = sin_il[(size_t)b * hs + d];
    q_s[d] = rope_pair(to_f32(q_raw[d]), to_f32(q_raw[d ^ 1]), c, s, d & 1) * scale;
    k_roped[d] = from_f32<T>(rope_pair(to_f32(k_raw[d]), to_f32(k_raw[d ^ 1]), c, s, d & 1));
  }
  __syncthreads();
}

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

// One block of K2 (Rows = DenseRows) or K15 (PagedRows), grid (nsplit, H, B):
// query head h = blockIdx.y of row b = blockIdx.z over its split of keys
// 0..pos[b]; the new rows from k_new / v_new. The split that holds pos[b] (the
// last) of the group's first query head writes them back.
template <typename T, int VE, int LPR, int NV, int U, typename Rows>
__device__ __forceinline__ void split_block(const Launch& a) {
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
  const Rows rows = Rows::of(a, b, kvh, pos);
  const T* kn = static_cast<const T*>(a.kn) + ((size_t)b * a.KVH + kvh) * hs;
  const T* vn = static_cast<const T*>(a.vn) + ((size_t)b * a.KVH + kvh) * hs;
  if (h % G == 0 && sw.split == sw.ns - 1) {
    for (int d = threadIdx.x; d < hs; d += blockDim.x) {
      kc[rows.new_row() + d] = kn[d];
      vc[rows.new_row() + d] = vn[d];
    }
  }
  attend_split<T, VE, LPR, NV, U>(qv, kc, vc, kn, vn,
                                  static_cast<T*>(a.out) + ((size_t)b * a.H + h) * hs, rows, sw);
}

// The glue-fused block of K4 (DenseRows) or K17 (PagedRows): rope_rows
// rotates the query and the group's key row first; the new rows are the
// rotated key row in shared memory and the raw qkv value row.
template <typename T, int VE, int LPR, int NV, int U, typename Rows>
__device__ __forceinline__ void split_block_fused(const Launch& a) {
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
  const Rows rows = Rows::of(a, b, kvh, pos);
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

// One block of K3 (Rows = DenseRows over one layer's cache) or K14
// (PagedRows over one layer's pools), grid (nsplit, H, B): query head h =
// blockIdx.y of row b = blockIdx.z over its split of keys 0..pos[b], read
// only (ReadOnly: no new rows, nothing written but the output and, over more
// than one split, the block's state).
template <typename T, int VE, int LPR, int NV, int U, typename Rows>
__device__ __forceinline__ void split_block_read(const Launch& a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int hs = a.hs, kvh = h / (a.H / a.KVH);
  const int pos = a.pos[b];
  const T* qh = static_cast<const T*>(a.q) + ((size_t)b * a.H + h) * hs;
  float qv[NV][VE];
  lane_query<VE, LPR>(qv, hs, [&](int d) { return to_f32(qh[d]) * a.scale; });
  SplitWork sw;
  if (!split_work(a, SplitShape<VE, LPR, NV, U>::kChunk, b, h, pos + 1, sw)) return;
  const T* none = nullptr;
  attend_split<T, VE, LPR, NV, U>(qv, static_cast<const T*>(a.kc), static_cast<const T*>(a.vc), none, none,
                                  static_cast<T*>(a.out) + ((size_t)b * a.H + h) * hs,
                                  ReadOnly<Rows>::of(a, b, kvh), sw);
}

// ------------------------------------------------ the split form's host side

// Which block a launch runs: split_block (K2, K15), split_block_fused (K4,
// K17) or split_block_read (K3, K14).
enum class Form { append, fused, read };

// One instantiation of the split form: launch it (K::launch, the source's
// kernels) if the host's chunk is its.
template <typename K, typename T, int VE, int LPR, int NV, int U>
cudaError_t launch_split(const Launch& a, Form form, int chunk, cudaStream_t st) {
  if (chunk != SplitShape<VE, LPR, NV, U>::kChunk) return cudaErrorInvalidValue;
  K::template launch<T, VE, LPR, NV, U>(dim3(a.nsplit, a.H, a.B), a, form, st);
  return cudaGetLastError();
}

// The lane layout for (vec, hs), as ops/cuda/attention.py::plan picks it:
// vec = 16 / sizeof(T) takes LPR = the power of two in 4..32 that covers
// hs / vec vectors (NV = 2 for fp32 past 128 elements), U = 4 / NV; vec = 1
// takes LPR = 32, NV = hs / 32 rounded up to a power of two, U = 8 / NV.
template <typename K, typename T>
cudaError_t dispatch_split(const Launch& a, Form form, int vec, int chunk, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int hs = a.hs;
  if (vec == V && hs % V == 0) {
    const int n = hs / V;
    if (n <= 4) return launch_split<K, T, V, 4, 1, 4>(a, form, chunk, st);
    if (n <= 8) return launch_split<K, T, V, 8, 1, 4>(a, form, chunk, st);
    if (n <= 16) return launch_split<K, T, V, 16, 1, 4>(a, form, chunk, st);
    if (n <= 32) return launch_split<K, T, V, 32, 1, 4>(a, form, chunk, st);
    if constexpr (V == 4) {
      if (n <= 64) return launch_split<K, T, V, 32, 2, 2>(a, form, chunk, st);
    }
    return cudaErrorInvalidValue;
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (hs <= 32) return launch_split<K, T, 1, 32, 1, 8>(a, form, chunk, st);
  if (hs <= 64) return launch_split<K, T, 1, 32, 2, 4>(a, form, chunk, st);
  if (hs <= 128) return launch_split<K, T, 1, 32, 4, 2>(a, form, chunk, st);
  return launch_split<K, T, 1, 32, 8, 1>(a, form, chunk, st);
}

inline bool aligned(const void* p, int bytes) { return reinterpret_cast<size_t>(p) % bytes == 0; }

// What the split form takes; 0 or a cudaError_t. One split writes out
// directly, so it takes the workspace and tickets at any size.
inline int check_split(const Launch& a, int dtype, int vec, long long ws_floats, int n_tickets, Form form) {
  if (a.B <= 0 || a.H <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.S <= 0) return cudaErrorInvalidValue;
  if (a.hs <= 0 || a.hs > kMaxHs || (form == Form::fused && a.hs % 2 != 0)) return cudaErrorInvalidValue;
  if (a.layer < 0 || a.nsplit < 1 || a.nsplit > kMaxSplit) return cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (!a.kc || !a.vc || !a.pos || !a.out || !a.ws || !a.tickets) return cudaErrorInvalidValue;
  if (form == Form::fused ? (!a.qkv || !a.cos_il || !a.sin_il)
                          : (!a.q || (form == Form::append && (!a.kn || !a.vn))))
    return cudaErrorInvalidValue;
  if (a.nsplit > 1 && (ws_floats < (long long)a.B * a.H * a.nsplit * (a.hs + 2) || n_tickets < a.B * a.H))
    return cudaErrorInvalidValue;
  // the vector loads' operands: every row start a multiple of the vector
  // (the caches, and the new rows where the block reads them)
  const int vbytes = vec * (dtype == kF32 ? 4 : 2);
  if (vec < 1 || a.hs % vec != 0) return cudaErrorInvalidValue;
  const void* rows[] = {a.kc, a.vc, form == Form::fused ? a.qkv : a.kn, form == Form::fused ? a.qkv : a.vn};
  for (int i = 0; i < (form == Form::read ? 2 : 4); ++i)
    if (!aligned(rows[i], vbytes)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The split form's plan (ops/cuda/attention.py::plan): nsplit splits of the
// key range, vec elements a vector load (16 / sizeof(T), or 1), chunk the
// keys of one block pass, which must be the instantiation's; ws (ws_floats
// float32) holds B * H * nsplit states of hs + 2 floats, tickets (n_tickets
// int32, at least B * H) are zero on entry and left zero (one split uses
// neither). Checks the plan and the operands, then launches K's kernel of
// `form`; 0 or a cudaError_t.
template <typename K>
int run_split(const Launch& a, int dtype, int vec, int chunk, long long ws_floats, int n_tickets,
              Form form, void* stream) {
  const int err = check_split(a, dtype, vec, ws_floats, n_tickets, form);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_split<K, float>(a, form, vec, chunk, st);
  return dispatch_split<K, __nv_bfloat16>(a, form, vec, chunk, st);
}

}  // namespace fpa
}  // namespace llama2
