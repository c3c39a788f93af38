// Attention over the int8 KV cache: one split decode loop, att_split, shared
// by every int8-cache attention kernel. Over dense planes (DenseRows): the
// kernels of attention_q8.cu (K7 window, K8 stacked append, K9 glue-fused)
// and the attention phase of the whole-layer kernel in mlp_block.cu (K13).
// Over page pools read through a page table (PagedRows): the paged kernels of
// paged_attention.cu (K16 append, K18 glue-fused).
//
// Cache: int8 K/V rows with one float32 scale per row. Dense planes are
// (L, B, KVH, S, hs) and (L, B, KVH, S): key t of (b, kv head) is row t of
// its plane. Pools are (L, P, KVH, page, hs) and (L, P, KVH, page): key t of
// slot b is row t % page of page table[b, t / page]. Arithmetic, as the
// Pallas kernels of llama2_tpu/ops/pallas/attention_q8.py, layer_block.py and
// paged_attention.py have it:
//   - the query is rounded to bf16, whatever the activation dtype (int8 ->
//     bf16 is exact, so the int8 route is a bf16-dot route);
//   - score = (q . k8[t]) accumulated in float32, times (k_scale[t] * scale),
//     the product of the two scalars taken first;
//   - online softmax in float32; the value side rounds p * v_scale[t] to bf16
//     and accumulates its product with the int8 row in float32;
//   - out = acc / l (IEEE division).
// Query row r of a T-row window (K7, read only) sees keys
// t <= pos - (T - 1) + r / G. K8, K9, K16 and K18 (T = 1) see keys t <= pos,
// the row at pos being this step's new row, taken from shared memory and
// never read back from the cache. K13 reads the cache with t < pos and adds
// this step's row as a "virtual row": its score from the int8 row, its value
// the float32 dequantized row (not rounded to bf16), joined by one more
// online-softmax update.
//
// Quantization of a new row (K9, K13, K18): RoPE in float32 on the raw QKV
// values, then scale = amax / 127 (IEEE division), safe = max(scale, 1e-20),
// q = clip(rint(x / safe), -127, 127), in float32, so the same rows give the
// same bytes and scales as the plain version.
//
// Bound on this card: bytes. A step reads the K/V rows of every visible key
// of every (b, kv head) once (hs bytes each, plus two scales): 34.6 MB at
// Llama-2-7B widths, batch 1 and pos 4095, 0.010 ms at 3.35 TB/s.
//
// The loop (att_split). A block takes one work item: (b, kv head, group of
// up to NQ query rows, split of the key range). Each warp walks its own runs
// of keys with no block barrier in the loop: lane (r, j) takes key
// base + u * RPW + r (RPW = 32 / LPR rows a warp load, U loads a pass, all
// issued before any is used) and bytes (nv * LPR + j) * VB .. + VB of its K
// and V rows, with the rows' scales; a 7B row (128 bytes) is 8 lanes of
// 16-byte loads, 4 rows a warp load. Every query row of the group shares each
// K/V row the block reads (one at 7B, up to eight under GQA or in a window).
// A score is summed over the LPR lanes of its row; the warp keeps one running
// max a query row, so the row slots' l and acc add up at the end. The warps'
// states (m, l, acc) merge in warp order in shared memory (weight
// exp(m_w - M), 0 for a warp that saw no key); the splits of a (b, kv head,
// group) merge in split order through the workspace, the last to draw the
// ticket merging, writing out and zeroing the ticket (a row whose keys fill
// one split writes out at once). No float atomics: the same inputs give the
// same bits. Where the key lives is the row policy's (a template parameter,
// no runtime flag): DenseRows adds t to the plane's first row; PagedRows
// finds the page of a pass's first key with one division, and a key past the
// page's end moves to the next table entry.
//
// The split count and the instance (VB, LPR, NV, NQ, U) come from the host's
// plan (ops/cuda/attention_q8.py::q8_plan: the shapes, the keys the cache can
// hold and the blocks of the launch, never pos); row b's keys are cut into at
// most nsplit runs of whole block passes (split_keys), so a short context
// takes only the splits it fills. This step's row, where there is one, is
// made once, by the block of the last split (K9, K13, K18: RoPE and
// quantization; K8, K16: the given row), which holds it in shared memory and
// (its first row group) writes it to the cache. K8/K9/K16/K18 read it from
// shared memory as key pos; K13's block folds it into its own state as the
// virtual row before the states merge.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace llama2 {
namespace q8a {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHs = 256;
constexpr int kMaxSplit = 32;  // splits of the key range
constexpr int kMaxNQ = 8;      // query rows a work item

enum Mode { kWindow = 0, kAppend = 1, kFused = 2, kLayer = 3 };

struct Params {
  const void* q;        // kWindow (B, T, H, hs), kAppend (B, H, hs); activation dtype
  const void* qkv;      // kFused, kLayer: (B, H + 2 KVH, hs) raw pre-RoPE rows
  const float* cos_il;  // kFused, kLayer: (B, hs), each pair's value on both elements
  const float* sin_il;
  int8_t* k8;           // dense (L, B, KVH, S, hs); paged (L, P, KVH, page, hs)
  float* ks;            // dense (L, B, KVH, S); paged (L, P, KVH, page)
  int8_t* v8;
  float* vs;
  const int8_t* k_new;  // kAppend: (B, KVH, hs) quantized rows, (B, KVH) scales
  const float* ks_new;
  const int8_t* v_new;
  const float* vs_new;
  const int* pos;       // (B,): the last query row's position
  void* out;            // kWindow (B, T, H, hs), else (B, H, hs); activation dtype
  float* out32;         // kLayer: (B, H * hs) float32
  float* ws;            // groups * nsplit * nq * (hs + 2) floats: the splits' states
  int* tickets;         // B * KVH * n_rg; zero on entry and on exit
  int mode, dtype, layer, L, B, T, H, KVH, S, hs, nsplit, n_rg;
  int nq, vb;           // the plan's instance: query rows a block, bytes a vector load
  float scale;
  // paged pools: this step's row written at (wpage[b], wrow[b])
  const int* table;  // (B, max_pages)
  const int* wpage;  // (B,)
  const int* wrow;   // (B,)
  int P, page, max_pages;
};

// one interleaved-pair rotation of element x with its partner `other`;
// products rounded separately (no FMA contraction), as the plain rope
__device__ __forceinline__ float rope_elem(float x, float other, float c, float s, bool odd) {
  const float xc = __fmul_rn(x, c);
  const float os = __fmul_rn(other, s);
  return odd ? __fadd_rn(os, xc) : __fsub_rn(xc, os);
}

__device__ __forceinline__ int8_t quant_elem(float x, float safe) {
  const float r = rintf(__fdiv_rn(x, safe));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// max over the block of one value a thread; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

template <int VB>
struct I8Vec {  // VB int8 values loaded as one vector (the address aligned to it)
  static constexpr int kWords = VB >= 4 ? VB / 4 : 1;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (VB == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (VB == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else if constexpr (VB == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      static_assert(VB == 2, "16-, 8-, 4- or 2-byte vectors");
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ float at(int i) const {
    return static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
  }
};

// The lane layout: VB bytes a vector, LPR lanes a row (a power of two), NV
// vectors a lane a row, NQ query rows a block; U warp loads a pass.
template <int VB, int LPR, int NV, int NQ, int U>
struct SplitShape {
  static constexpr int kRowsPerWarp = 32 / LPR;
  static constexpr int kWarpKeys = U * kRowsPerWarp;  // keys of one warp pass
  static constexpr int kChunk = kWarps * kWarpKeys;   // keys of one block pass
  static constexpr int kElems = NV * VB;              // elements a lane holds of a row
};

// Every instance a plan can name: X(index, VB, LPR, NV, NQ). One query row
// a block takes 16-byte loads, up to four (a verify window at the 7B layout)
// 8-byte loads, eight 4-byte loads (LPR and NV from hs); 2-byte loads where
// the rows are not aligned to those. The registers of a lane's query rows
// and accumulators (2 * NQ * NV * VB floats) bound the vector.
#define LLAMA2_Q8A_INSTANCES(X) \
  X(0, 16, 4, 1, 1)             \
  X(1, 16, 8, 1, 1)             \
  X(2, 16, 16, 1, 1)            \
  X(3, 8, 8, 1, 4)              \
  X(4, 8, 16, 1, 4)             \
  X(5, 8, 32, 1, 4)             \
  X(6, 4, 16, 1, 8)             \
  X(7, 4, 32, 1, 8)             \
  X(8, 4, 32, 2, 8)             \
  X(9, 2, 32, 4, 1)             \
  X(10, 2, 32, 4, 8)

// the index of the instance for nq query rows a block, vb bytes a vector
// load and head size hs (q8_plan's rule), or -1
__host__ __device__ inline int instance(int vb, int nq, int hs) {
  if (nq == 1 && vb == 16 && hs % 16 == 0) return hs <= 64 ? 0 : hs <= 128 ? 1 : 2;
  if (nq == 4 && vb == 8 && hs % 8 == 0) return hs <= 64 ? 3 : hs <= 128 ? 4 : 5;
  if (nq == 8 && vb == 4 && hs % 4 == 0) return hs <= 64 ? 6 : hs <= 128 ? 7 : 8;
  if (vb == 2) return nq == 1 ? 9 : nq == 8 ? 10 : -1;
  return -1;
}

// warp loads a pass: u1 for one query row a block, else 2
__host__ __device__ constexpr int unroll(int nq, int u1) { return nq == 1 ? u1 : 2; }

// The whole-layer kernel's attention phase (K13) carries one loop: one
// query row a block, 16-byte loads, 8 lanes a row, so head sizes that are
// multiples of 16 up to 128. A GQA kv head's query rows are each a group of
// their own, which reads the kv head's rows again (from L2: a kv head's
// groups are neighbouring items). One loop only: with a second instance in
// the same cooperative kernel its gemv phases spilled, and K13 ran a fifth
// slower even where the second loop never ran (PERF.md, section 6).
constexpr int kLayerVB = 16, kLayerLanes = 8, kLayerMaxHs = kLayerLanes * kLayerVB;

// keys of one block pass of the instance `inst` (unroll u1 for one row), or -1
__host__ __device__ inline int chunk_of(int inst, int u1) {
#define LLAMA2_Q8A_CHUNK(i, VB, LPR, NV, NQ) \
  case i:                                    \
    return kWarps * unroll(NQ, u1) * (32 / LPR);
  switch (inst) { LLAMA2_Q8A_INSTANCES(LLAMA2_Q8A_CHUNK) }
#undef LLAMA2_Q8A_CHUNK
  return -1;
}

// (ns, per): row b's n_keys keys in ns runs of per keys (whole chunks; the
// last cut at n_keys), ns <= nsplit; no key (K13 at pos 0): one empty run
struct KeySplit {
  int ns, per;
};
__host__ __device__ inline KeySplit split_keys(int n_keys, int nsplit, int chunk) {
  const int n = n_keys > 0 ? n_keys : 1;
  const int chunks = (n + chunk - 1) / chunk;
  const int ns0 = nsplit < chunks ? nsplit : chunks;
  const int per = ((n + ns0 - 1) / ns0 + chunk - 1) / chunk * chunk;
  return {(n + per - 1) / per, per};
}

struct SplitSmem {
  float q[kMaxNQ * kMaxHs];                         // the group's query rows (bf16 values)
  float wm[kWarps * kMaxNQ], wl[kWarps * kMaxNQ];  // the warps' (m, l) a query row
  float w[kMaxSplit * kMaxNQ];                      // the merge: each state's weight
  float M[kMaxNQ], L[kMaxNQ];
  float sv[kMaxNQ], wv[kMaxNQ];  // K13: the virtual row's score, then its weight
  float kf[kMaxHs], vf[kMaxHs];  // kFused, kLayer: the new rows in float32
  alignas(16) int8_t kn[kMaxHs];  // this step's quantized K and V rows (vector loads)
  alignas(16) int8_t vn[kMaxHs];
  float kn_s, vn_s;
  float red[kWarps];
  int last;
};

// floats of the dynamic shared memory att_split takes: the warps' acc
__host__ __device__ constexpr int split_acc_floats(int nq, int hs) { return kWarps * nq * hs; }

// Row policies: where key t of (b, kv head) lives, as a row index (of the
// scales; times hs for the int8 rows), and where this step's row goes.
struct DenseRows {  // row t of the (L, B, KVH, S) plane
  size_t row0;
  __device__ DenseRows(const Params& a, int b, int kvh)
      : row0((((size_t)a.layer * a.B + b) * a.KVH + kvh) * (size_t)a.S) {}
  __device__ size_t new_row(const Params&, int, int pos) const { return row0 + pos; }
  __device__ void pass(int) {}
  __device__ size_t at(int t, int) const { return row0 + t; }
};

struct PagedRows {  // row t % page of page table[b, t / page]
  const int* table;
  size_t layer_pages;
  int KVH, kvh, page, pb, rb;
  __device__ PagedRows(const Params& a, int b, int kvh_)
      : table(a.table + (size_t)b * a.max_pages), layer_pages((size_t)a.layer * a.P), KVH(a.KVH),
        kvh(kvh_), page(a.page), pb(0), rb(0) {}
  __device__ size_t new_row(const Params& a, int b, int) const {
    return ((layer_pages + a.wpage[b]) * KVH + kvh) * (size_t)page + a.wrow[b];
  }
  __device__ void pass(int base) {  // the pass's first key: page, row
    pb = base / page;
    rb = base - pb * page;
  }
  __device__ size_t at(int t, int base) const {
    int pi = pb, rr = rb + (t - base);
    while (rr >= page) {
      rr -= page;
      ++pi;
    }
    return ((layer_pages + table[pi]) * KVH + kvh) * (size_t)page + rr;
  }
};

// One work item. Called by all threads of a block of kThreads; `wacc` is
// split_acc_floats(NQ, hs) floats of shared memory.
template <class Rows, int VB, int LPR, int NV, int NQ, int U>
__device__ void att_split(const Params& a, int item, SplitSmem& sm, float* wacc) {
  using Shape = SplitShape<VB, LPR, NV, NQ, U>;
  constexpr int RPW = Shape::kRowsPerWarp, E = Shape::kElems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane / LPR, j = lane % LPR;
  const int hs = a.hs, H = a.H, KVH = a.KVH, G = H / KVH;
  const int T = a.mode == kWindow ? a.T : 1;
  const int split = item % a.nsplit;
  const int group = item / a.nsplit;  // (b, kv head, row group): its ticket
  const int rg = group % a.n_rg;
  const int kvh = (group / a.n_rg) % KVH;
  const int b = group / a.n_rg / KVH;
  const int q0 = rg * NQ;  // the group's first query row of the kv head (row t * G + g)
  const int nq = min(NQ, T * G - q0);
  const int pos = a.pos[b];
  const int n_keys = a.mode == kLayer ? pos : pos + 1;
  const KeySplit ks = split_keys(n_keys, a.nsplit, Shape::kChunk);
  if (split >= ks.ns) return;
  const int t_begin = split * ks.per;
  const int t_end = min(n_keys, t_begin + ks.per);
  // the last split makes this step's row (no row in a window)
  const bool holds_new = a.mode != kWindow && t_end == n_keys;
  const bool fused = a.mode == kFused || a.mode == kLayer;
  const bool virt = a.mode == kLayer && holds_new;  // K13: the virtual row joins this state
  const size_t qkv_row = (size_t)b * (H + 2 * KVH);
  Rows rows(a, b, kvh);
  __syncthreads();  // the block's previous item (K13 deals several) is done with sm

  // the group's query rows, rotated (kFused, kLayer) and rounded to bf16,
  // once a block into shared memory (a thread an element: one round of
  // loads, where each lane's own elements took several)
  for (int i = tid; i < nq * hs; i += kThreads) {
    const int qq = i / hs, d = i - qq * hs;
    const int rr = q0 + qq, t = rr / G, h = kvh * G + rr % G;
    float val;
    if (fused) {
      const size_t base = (qkv_row + h) * hs;
      val = rope_elem(load_act(a.qkv, base + d, a.dtype), load_act(a.qkv, base + (d ^ 1), a.dtype),
                      a.cos_il[(size_t)b * hs + d], a.sin_il[(size_t)b * hs + d], d & 1);
    } else {
      val = load_act(a.q, (((size_t)b * T + t) * H + h) * hs + d, a.dtype);
    }
    sm.q[i] = round_bf16(val);
  }
  __syncthreads();

  // this lane's elements of a row: e[nv] .. e[nv] + VB - 1 (a lane past hs
  // re-reads the last vector; its q is 0)
  int e[NV];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) e[nv] = min((nv * LPR + j) * VB, hs - VB);
  float qv[NQ][E];
  int hz[NQ];  // the last key each query row sees
#pragma unroll
  for (int qq = 0; qq < NQ; ++qq) {
    hz[qq] = pos - (T - 1) + (q0 + qq) / G;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int i = 0; i < VB; ++i) {
        const int d = (nv * LPR + j) * VB + i;
        qv[qq][nv * VB + i] = qq < nq && d < hs ? sm.q[qq * hs + d] : 0.f;
      }
  }

  // this step's K and V rows: rotated and quantized here, or given
  if (holds_new) {
    if (fused) {
      const size_t kb = (qkv_row + H + kvh) * hs, vb = (qkv_row + H + KVH + kvh) * hs;
      float kmax = 0.f, vmax = 0.f;
      for (int d = tid; d < hs; d += kThreads) {
        const float kr = rope_elem(load_act(a.qkv, kb + d, a.dtype), load_act(a.qkv, kb + (d ^ 1), a.dtype),
                                   a.cos_il[(size_t)b * hs + d], a.sin_il[(size_t)b * hs + d], d & 1);
        const float vr = load_act(a.qkv, vb + d, a.dtype);
        sm.kf[d] = kr;
        sm.vf[d] = vr;
        kmax = fmaxf(kmax, fabsf(kr));
        vmax = fmaxf(vmax, fabsf(vr));
      }
      kmax = block_max(kmax, sm.red);
      vmax = block_max(vmax, sm.red);
      const float ksc = __fdiv_rn(kmax, 127.f), vsc = __fdiv_rn(vmax, 127.f);
      const float ksafe = fmaxf(ksc, 1e-20f), vsafe = fmaxf(vsc, 1e-20f);
      for (int d = tid; d < hs; d += kThreads) {
        sm.kn[d] = quant_elem(sm.kf[d], ksafe);
        sm.vn[d] = quant_elem(sm.vf[d], vsafe);
      }
      if (tid == 0) {
        sm.kn_s = ksc;
        sm.vn_s = vsc;
      }
    } else {
      const size_t nb = (size_t)b * KVH + kvh;
      for (int d = tid; d < hs; d += kThreads) {
        sm.kn[d] = a.k_new[nb * hs + d];
        sm.vn[d] = a.v_new[nb * hs + d];
      }
      if (tid == 0) {
        sm.kn_s = a.ks_new[nb];
        sm.vn_s = a.vs_new[nb];
      }
    }
    __syncthreads();
    if (rg == 0) {  // the append, once a (b, kv head); no block reads it back
      const size_t at = rows.new_row(a, b, pos);
      for (int d = tid; d < hs; d += kThreads) {
        a.k8[at * hs + d] = sm.kn[d];
        a.v8[at * hs + d] = sm.vn[d];
      }
      if (tid == 0) {
        a.ks[at] = sm.kn_s;
        a.vs[at] = sm.vn_s;
      }
    }
  }

  float m[NQ], l[NQ], acc[NQ][E];
#pragma unroll
  for (int qq = 0; qq < NQ; ++qq) {
    m[qq] = -INFINITY;
    l[qq] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[qq][i] = 0.f;
  }
  for (int base = t_begin + warp * Shape::kWarpKeys; base < t_end; base += kWarps * Shape::kWarpKeys) {
    rows.pass(base);
    I8Vec<VB> kr[U][NV], vr[U][NV];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // a key past t_end re-reads key t_end - 1 (its score is masked)
      const int t = min(base + u * RPW + r, t_end - 1);
      if (holds_new && t == pos) {  // K8, K9, K16, K18: key pos is this step's row
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          kr[u][nv].load(sm.kn + e[nv]);
          vr[u][nv].load(sm.vn + e[nv]);
        }
        ksc[u] = sm.kn_s;
        vsc[u] = sm.vn_s;
      } else {
        const size_t row = rows.at(t, base);
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          kr[u][nv].load(a.k8 + row * hs + e[nv]);
          vr[u][nv].load(a.v8 + row * hs + e[nv]);
        }
        ksc[u] = a.ks[row];
        vsc[u] = a.vs[row];
      }
    }
    float s[U][NQ];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPW + r;
      const float kscale = ksc[u] * a.scale;
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq) {
        float part = 0.f;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int i = 0; i < VB; ++i) part = fmaf(qv[qq][nv * VB + i], kr[u][nv].at(i), part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        s[u][qq] = t < t_end && t <= hz[qq] ? part * kscale : -INFINITY;
      }
    }
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      float smax = s[0][qq];
#pragma unroll
      for (int u = 1; u < U; ++u) smax = fmaxf(smax, s[u][qq]);
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, o));
      const float m_new = fmaxf(m[qq], smax);
      // a window row that sees no key yet keeps m = -inf, l = 0, acc = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[qq] - m_use);
      l[qq] *= alpha;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[qq][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u][qq] - m_use);
        l[qq] += p;
        const float pv = round_bf16(p * vsc[u]);
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int i = 0; i < VB; ++i)
            acc[qq][nv * VB + i] = fmaf(pv, vr[u][nv].at(i), acc[qq][nv * VB + i]);
      }
      m[qq] = m_new;
    }
  }
  // the warp's row slots share m: add their l and acc
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      l[qq] += __shfl_xor_sync(0xffffffffu, l[qq], o);
#pragma unroll
      for (int i = 0; i < E; ++i) acc[qq][i] += __shfl_xor_sync(0xffffffffu, acc[qq][i], o);
    }
  // K13: the virtual row's score, (q . k8_new) * (k_scale * scale)
  if (virt && warp == 0) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      float part = 0.f;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        I8Vec<VB> kn;
        kn.load(sm.kn + e[nv]);
#pragma unroll
        for (int i = 0; i < VB; ++i) part = fmaf(qv[qq][nv * VB + i], kn.at(i), part);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sm.sv[qq] = part * (sm.kn_s * a.scale);
    }
  }

  // the warps' states into shared memory, merged in warp order (and K13's
  // virtual row, its value the float32 dequantized row)
  if (lane == 0)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      sm.wm[warp * NQ + qq] = m[qq];
      sm.wl[warp * NQ + qq] = l[qq];
    }
  if (r == 0)
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int d0 = (nv * LPR + j) * VB;
      if (d0 < hs)
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
          for (int i = 0; i < VB; ++i) wacc[(warp * NQ + qq) * hs + d0 + i] = acc[qq][nv * VB + i];
    }
  __syncthreads();
  if (tid < nq) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm.wm[w * NQ + tid]);
    const float sv = virt ? sm.sv[tid] : -INFINITY;
    M = fmaxf(M, sv);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = sm.wm[w * NQ + tid] == -INFINITY ? 0.f : expf(sm.wm[w * NQ + tid] - M);
      sm.w[w * NQ + tid] = wt;
      L = fmaf(sm.wl[w * NQ + tid], wt, L);
    }
    const float wv = virt ? expf(sv - M) : 0.f;
    sm.M[tid] = M;
    sm.L[tid] = L + wv;
    sm.wv[tid] = wv;
  }
  __syncthreads();
  auto warp_merged = [&](int qq, int d) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(wacc[(w * NQ + qq) * hs + d], sm.w[w * NQ + qq], o);
    if (virt) o = fmaf(sm.wv[qq], static_cast<float>(sm.vn[d]) * sm.vn_s, o);
    return o;
  };
  auto store = [&](int qq, int d, float o) {
    const int rr = q0 + qq, t = rr / G, h = kvh * G + rr % G;
    if (a.mode == kLayer)
      a.out32[((size_t)b * H + h) * hs + d] = o;
    else
      store_act(a.out, (((size_t)b * T + t) * H + h) * hs + d, a.dtype, o);
  };
  if (ks.ns == 1) {
    for (int i = tid; i < nq * hs; i += kThreads) {
      const int qq = i / hs, d = i % hs;
      store(qq, d, __fdiv_rn(warp_merged(qq, d), sm.L[qq]));
    }
    return;
  }

  // publish this split's state: m, l, then acc, a query row
  const int stride = hs + 2;
  float* states = a.ws + (size_t)group * a.nsplit * NQ * stride;
  float* mine = states + (size_t)split * NQ * stride;
  for (int i = tid; i < nq * hs; i += kThreads) {
    const int qq = i / hs, d = i % hs;
    mine[qq * stride + 2 + d] = warp_merged(qq, d);
  }
  if (tid < nq) {
    mine[tid * stride] = sm.M[tid];
    mine[tid * stride + 1] = sm.L[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(&a.tickets[group], 1) == ks.ns - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();

  // the last split merges the ns states in split order
  if (tid < nq) {
    float M = -INFINITY;
    for (int sp = 0; sp < ks.ns; ++sp) M = fmaxf(M, __ldcg(states + ((size_t)sp * NQ + tid) * stride));
    float L = 0.f;
    for (int sp = 0; sp < ks.ns; ++sp) {
      const float* st = states + ((size_t)sp * NQ + tid) * stride;
      const float ms = __ldcg(st);
      const float wt = ms == -INFINITY ? 0.f : expf(ms - M);
      sm.w[sp * NQ + tid] = wt;
      L = fmaf(__ldcg(st + 1), wt, L);
    }
    sm.L[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < nq * hs; i += kThreads) {
    const int qq = i / hs, d = i % hs;
    float o = 0.f;
    for (int sp = 0; sp < ks.ns; ++sp)
      o = fmaf(__ldcg(states + ((size_t)sp * NQ + qq) * stride + 2 + d), sm.w[sp * NQ + qq], o);
    store(qq, d, __fdiv_rn(o, sm.L[qq]));
  }
  if (tid == 0) a.tickets[group] = 0;
}

// The launch's work items, dealt to its blocks round-robin (one each where
// the grid has as many blocks as items).
template <class Rows, int VB, int LPR, int NV, int NQ, int U>
__device__ void split_items(const Params& a, SplitSmem& sm, float* wacc) {
  const int n = a.B * a.KVH * a.n_rg * a.nsplit;
  for (int item = blockIdx.x; item < n; item += gridDim.x) att_split<Rows, VB, LPR, NV, NQ, U>(a, item, sm, wacc);
}

// The whole-layer kernel's attention phase over the dense planes (U warp
// loads a pass).
template <int U>
__device__ void layer_items(const Params& a, SplitSmem& sm, float* wacc) {
  split_items<DenseRows, kLayerVB, kLayerLanes, 1, 1, U>(a, sm, wacc);
}

// What the device code takes, for a launch whose block passes are `chunk`
// keys (unroll u1 for one query row a block; `layer`: the whole-layer
// kernel's one loop); 0 or a cudaError_t.
inline int check(const Params& a, long long ws_floats, int n_tickets, int chunk, int u1, bool layer = false) {
  if (a.B <= 0 || a.H <= 0 || a.KVH <= 0 || a.H % a.KVH != 0) return cudaErrorInvalidValue;
  if (a.hs <= 0 || a.hs > kMaxHs || a.hs % 2 != 0) return cudaErrorInvalidValue;
  if (a.T <= 0 || a.S <= 0 || a.nsplit < 1 || a.nsplit > kMaxSplit || a.layer < 0 || a.layer >= a.L)
    return cudaErrorInvalidValue;
  if (a.dtype != kF32 && a.dtype != kBF16) return cudaErrorInvalidValue;
  if (layer) {
    if (a.vb != kLayerVB || a.nq != 1 || a.hs % 16 != 0 || a.hs > kLayerMaxHs ||
        chunk != kWarps * u1 * (32 / kLayerLanes))
      return cudaErrorInvalidValue;
  } else {
    const int inst = instance(a.vb, a.nq, a.hs);
    if (inst < 0 || chunk_of(inst, u1) != chunk) return cudaErrorInvalidValue;
  }
  const int rows = (a.mode == kWindow ? a.T : 1) * (a.H / a.KVH);
  if (a.n_rg != (rows + a.nq - 1) / a.nq) return cudaErrorInvalidValue;
  if (a.ws == nullptr || a.tickets == nullptr) return cudaErrorInvalidValue;
  const long long groups = (long long)a.B * a.KVH * a.n_rg;
  if (ws_floats < groups * a.nsplit * a.nq * (a.hs + 2) || n_tickets < groups) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace q8a
}  // namespace llama2
