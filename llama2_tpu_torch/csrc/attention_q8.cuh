// Attention over the int8 KV cache: the device code shared by the kernels of
// attention_q8.cu (K7 window, K8 stacked append, K9 glue-fused) and by the
// attention phase of the whole-layer kernel in mlp_block.cu (K13).
//
// Cache: int8 K/V rows (L, B, KVH, S, hs) with one float32 scale per row,
// (L, B, KVH, S). Arithmetic, as the Pallas kernels of
// llama2_tpu/ops/pallas/attention_q8.py and layer_block.py have it:
//   - the query is rounded to bf16, whatever the activation dtype (int8 ->
//     bf16 is exact, so the int8 route is a bf16-dot route);
//   - score = (q . k8[t]) accumulated in float32, times (k_scale[t] * scale),
//     the product of the two scalars taken first;
//   - online softmax in float32; the value side rounds p * v_scale[t] to bf16
//     and accumulates its product with the int8 row in float32;
//   - out = acc / l.
// Query row r of a T-row window (K7) sees keys t <= pos - (T - 1) + r / G.
// K8 and K9 (T = 1) see keys t <= pos, the row at pos being this step's new
// row, taken from the new-row operand and never read back from the cache.
// K13 masks the cache with t < pos and adds this step's row as a "virtual
// row": its score from the int8 row, its value the float32 dequantized row
// (not rounded to bf16), joined by one more online-softmax update.
//
// Quantization of a new row (K9, K13): RoPE in float32 on the raw QKV values,
// then scale = amax / 127 (IEEE division), safe = max(scale, 1e-20),
// q = clip(rint(x / safe), -127, 127), in float32, so the same rows give the
// same bytes and scales as the plain version.
//
// Bound on this card: bytes. At batch 1 the work is the (pos + 1) K and V rows
// (hs bytes each, plus two scales) of every (b, kv head): 34.6 MB at
// Llama-2-7B widths and pos 4095, 0.010 ms at 3.35 TB/s. A work item is one
// (b, kv head, group of up to kRB query rows, split of the key range): its
// query rows share every K/V row it stages, so a K/V row is read once per
// window (per group of kRB rows where a GQA window has more). The key range is
// cut into `nsplit` (at most kMaxSplit) splits so that the blocks of a launch
// about fill the card at batch 1 and full context (the whole-layer kernel:
// its grid); a row with a shorter context takes only the splits it fills
// with at least a chunk each, from its position on the device. A split
// walks its keys kCK at a time: the whole block stages the chunk's int8 rows
// and scales in shared memory (16-byte loads where hs % 16 == 0), computes
// the scores (2 to 8 threads a (row, key) for up to 4 rows, one for more),
// updates each row's softmax state (one warp a row, one lane a key), then the
// value products (one thread a (row, element)). Each split writes its state
// (m, l, acc) to a workspace; an integer ticket per (b, kv head, row group)
// finds the split that finishes last, which merges the states in split order
// (each split's (m, l) fetched at once into shared memory). No float atomics:
// the same inputs give the same bits. One item of each (b, kv head) writes
// the new row.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace llama2 {
namespace q8a {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCK = 32;       // keys a chunk: one a lane in the softmax update
constexpr int kRB = 16;       // query rows a work item
constexpr int kMaxHs = 256;
constexpr int kMaxSplit = 32;  // splits of the key range
constexpr int kNJ = kRB * kMaxHs / kThreads;  // (row, element) pairs a thread

enum Mode { kWindow = 0, kAppend = 1, kFused = 2, kLayer = 3 };

struct Params {
  const void* q;        // kWindow (B, T, H, hs), kAppend (B, H, hs); activation dtype
  const void* qkv;      // kFused, kLayer: (B, H + 2 KVH, hs) raw pre-RoPE rows
  const float* cos_il;  // kFused, kLayer: (B, hs), each pair's value on both elements
  const float* sin_il;
  int8_t* k8;           // (L, B, KVH, S, hs)
  float* ks;            // (L, B, KVH, S)
  int8_t* v8;
  float* vs;
  const int8_t* k_new;  // kAppend: (B, KVH, hs) quantized rows, (B, KVH) scales
  const float* ks_new;
  const int8_t* v_new;
  const float* vs_new;
  const int* pos;       // (B,): the last query row's position
  void* out;            // kWindow (B, T, H, hs), kAppend / kFused (B, H, hs); activation dtype
  float* out32;         // kLayer: (B, H * hs) float32
  float* ws;            // items * kRB * (hs + 2) floats: the splits' states
  int* tickets;         // B * KVH * n_rg; zero on entry and on exit
  int mode, dtype, layer, L, B, T, H, KVH, S, hs, nsplit, n_rg;
  float scale;
};

struct Smem {
  float q[kRB * kMaxHs];   // the item's query rows (bf16 values), row stride round4(hs)
  float p[kRB * kCK];      // scores, then bf16(p * v_scale); first the new rows' float32 values
  int8_t k[kCK * (kMaxHs + 4)];  // the chunk's rows, row stride round4(hs) + 4 bytes
  int8_t v[kCK * (kMaxHs + 4)];
  float ks[kCK], vs[kCK];
  float m[kRB], l[kRB], alpha[kRB];
  float ml[2 * kMaxSplit * kRB];  // the merge: each split's (m, then its weight; l) a row
  int8_t kn[kMaxHs], vn[kMaxHs];  // this step's quantized K and V rows
  float kn_s, vn_s;
  float red[kWarps];
  int last;
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// query rows per (b, kv head), and row groups of kRB
__host__ __device__ inline int rows_per_head(int mode, int T, int H, int KVH) {
  return (mode == kWindow ? T : 1) * (H / KVH);
}

__host__ __device__ inline int items(const Params& a) {
  return a.B * a.KVH * a.n_rg * a.nsplit;
}

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

__device__ __forceinline__ float byte_at(int word, int i) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * i)));
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

// nbytes contiguous bytes of int8 rows (hs a row) into shared rows of stride rsb
__device__ __forceinline__ void stage_rows(const int8_t* src, int8_t* dst, int nbytes, int hs,
                                           int rsb, bool vec16) {
  if (vec16) {
    for (int u = threadIdx.x; u < nbytes / 16; u += kThreads) {
      const int e = u * 16;
      const int4 w = *reinterpret_cast<const int4*>(src + e);
      int* o = reinterpret_cast<int*>(dst + (e / hs) * rsb + e % hs);
      o[0] = w.x;
      o[1] = w.y;
      o[2] = w.z;
      o[3] = w.w;
    }
  } else {  // hs even: 2-byte units never cross a row
    for (int u = threadIdx.x; u < nbytes / 2; u += kThreads) {
      const int e = u * 2;
      *reinterpret_cast<short*>(dst + (e / hs) * rsb + e % hs) =
          *reinterpret_cast<const short*>(src + e);
    }
  }
}

// One work item: (b, kv head, row group, split). Called by all threads of a
// block of kThreads; `sm` is the block's shared memory.
__device__ void att_item(const Params& a, int item, Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hs = a.hs, H = a.H, KVH = a.KVH, G = H / KVH;
  const int T = a.mode == kWindow ? a.T : 1;
  const int R = T * G;
  const int split = item % a.nsplit;
  int rest = item / a.nsplit;
  const int group = rest;  // (b, kv head, row group): its ticket
  const int rg = rest % a.n_rg;
  rest /= a.n_rg;
  const int kvh = rest % KVH;
  const int b = rest / KVH;
  const int r0 = rg * kRB;
  const int nr = min(kRB, R - r0);
  const int pos = a.pos[b];
  const int qs = round4(hs);      // query row stride, floats
  const int rsb = round4(hs) + 4;  // staged row stride, bytes (4-byte words, no bank conflicts at 128)
  const bool fused = a.mode == kFused || a.mode == kLayer;
  const bool has_new = a.mode != kWindow;
  const size_t row0 = (((size_t)a.layer * a.B + b) * KVH + kvh) * (size_t)a.S;  // plane's first row
  const size_t qkv_row = (size_t)b * (H + 2 * KVH);
  // the splits this row's context fills, a chunk each at least (the launch
  // has nsplit for the whole cache): the others return at once, and the last
  // of these merges only their states
  const int n_keys = a.mode == kLayer ? pos : pos + 1;
  const int ns = max(1, min(a.nsplit, (n_keys + kCK - 1) / kCK));
  if (split >= ns) return;

  __syncthreads();  // the block's previous item is done with sm

  // the item's query rows, rounded to bf16; zero past hs and past nr
  for (int e = tid; e < kRB * qs; e += kThreads) {
    const int r = e / qs, d = e % qs;
    float val = 0.f;
    if (r < nr && d < hs) {
      const int rr = r0 + r, t = rr / G, h = kvh * G + rr % G;
      if (fused) {
        const size_t base = (qkv_row + h) * hs;
        val = rope_elem(load_act(a.qkv, base + d, a.dtype), load_act(a.qkv, base + (d ^ 1), a.dtype),
                        a.cos_il[(size_t)b * hs + d], a.sin_il[(size_t)b * hs + d], d & 1);
      } else {
        val = load_act(a.q, (((size_t)b * T + t) * H + h) * hs + d, a.dtype);
      }
      val = round_bf16(val);
    }
    sm.q[e] = val;
  }

  // this step's K and V rows: rotated and quantized here, or given
  if (fused) {
    float* kf = sm.p;
    float* vf = sm.p + kMaxHs;
    const size_t kb = (qkv_row + H + kvh) * hs, vb = (qkv_row + H + KVH + kvh) * hs;
    float kmax = 0.f, vmax = 0.f;
    for (int d = tid; d < hs; d += kThreads) {
      const float kr = rope_elem(load_act(a.qkv, kb + d, a.dtype), load_act(a.qkv, kb + (d ^ 1), a.dtype),
                                 a.cos_il[(size_t)b * hs + d], a.sin_il[(size_t)b * hs + d], d & 1);
      const float vr = load_act(a.qkv, vb + d, a.dtype);
      kf[d] = kr;
      vf[d] = vr;
      kmax = fmaxf(kmax, fabsf(kr));
      vmax = fmaxf(vmax, fabsf(vr));
    }
    kmax = block_max(kmax, sm.red);
    vmax = block_max(vmax, sm.red);
    const float ksc = __fdiv_rn(kmax, 127.f), vsc = __fdiv_rn(vmax, 127.f);
    const float ksafe = fmaxf(ksc, 1e-20f), vsafe = fmaxf(vsc, 1e-20f);
    for (int d = tid; d < hs; d += kThreads) {
      sm.kn[d] = quant_elem(kf[d], ksafe);
      sm.vn[d] = quant_elem(vf[d], vsafe);
    }
    if (tid == 0) {
      sm.kn_s = ksc;
      sm.vn_s = vsc;
    }
  } else if (a.mode == kAppend) {
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
  if (tid < kRB) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  // the append: one item of each (b, kv head) writes the new row; no item
  // reads that row back from the cache
  if (has_new && split == 0 && rg == 0) {
    const size_t at = row0 + pos;
    for (int d = tid; d < hs; d += kThreads) {
      a.k8[at * hs + d] = sm.kn[d];
      a.v8[at * hs + d] = sm.vn[d];
    }
    if (tid == 0) {
      a.ks[at] = sm.kn_s;
      a.vs[at] = sm.vn_s;
    }
  }

  // this split's keys: whole chunks, the last split's cut at n_keys
  const int per = ((n_keys + ns - 1) / ns + kCK - 1) / kCK * kCK;
  const int t_begin = split * per;
  const int t_end = min(n_keys, t_begin + per);
  const bool vec16 = hs % 16 == 0;
  const int hz_last = a.mode == kLayer ? pos - 1 : pos;  // the last row's horizon
  const int rows_pad = nr <= 1 ? 1 : nr <= 2 ? 2 : nr <= 4 ? 4 : nr <= 8 ? 8 : kRB;
  const int np = rows_pad * kCK >= kThreads ? 1 : kThreads / (rows_pad * kCK);

  float acc[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) acc[j] = 0.f;

  for (int c0 = t_begin; c0 < t_end; c0 += kCK) {
    const int nvalid = min(kCK, t_end - c0);
    __syncthreads();  // the previous chunk's rows and products are read
    stage_rows(a.k8 + (row0 + c0) * hs, sm.k, nvalid * hs, hs, rsb, vec16);
    stage_rows(a.v8 + (row0 + c0) * hs, sm.v, nvalid * hs, hs, rsb, vec16);
    for (int c = tid; c < nvalid; c += kThreads) {
      sm.ks[c] = a.ks[row0 + c0 + c];
      sm.vs[c] = a.vs[row0 + c0 + c];
    }
    __syncthreads();
    if ((a.mode == kAppend || a.mode == kFused) && pos >= c0 && pos < c0 + nvalid) {
      const int c = pos - c0;  // the new row, from the operand
      for (int d = tid; d < hs; d += kThreads) {
        sm.k[c * rsb + d] = sm.kn[d];
        sm.v[c * rsb + d] = sm.vn[d];
      }
      if (tid == 0) {
        sm.ks[c] = sm.kn_s;
        sm.vs[c] = sm.vn_s;
      }
      __syncthreads();
    }

    // scores: np threads a (row, key), np = 8, 4, 2 for 1, 2, 4 rows (all
    // threads busy), each a strided part of the dot, summed by a fixed
    // butterfly over adjacent lanes
    for (int e = tid; e < rows_pad * kCK * np; e += kThreads) {
      const int part = e % np, pair = e / np;
      const int r = pair / kCK, c = pair % kCK;
      const int hz = hz_last - (T - 1) + (r0 + r) / G;
      const bool live = r < nr && c < nvalid && c0 + c <= hz;
      float dot = 0.f;
      if (live) {
        const float* qr = sm.q + r * qs;
        const int8_t* kr = sm.k + c * rsb;
        for (int w = part; w < qs / 4; w += np) {
          const int kw = *reinterpret_cast<const int*>(kr + 4 * w);
          dot = fmaf(qr[4 * w], byte_at(kw, 0), dot);
          dot = fmaf(qr[4 * w + 1], byte_at(kw, 1), dot);
          dot = fmaf(qr[4 * w + 2], byte_at(kw, 2), dot);
          dot = fmaf(qr[4 * w + 3], byte_at(kw, 3), dot);
        }
      }
      for (int o = np / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (part == 0 && r < nr) sm.p[r * kCK + c] = live ? dot * (sm.ks[c] * a.scale) : -INFINITY;
    }
    __syncthreads();

    // softmax state: one warp a row, one lane a key
    for (int r = warp; r < nr; r += kWarps) {
      const float s = sm.p[r * kCK + lane];
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      // a row with no live key yet (K13's strict mask at pos 0, a window
      // row's later chunks never are): zero contributions, not NaN
      const bool dead = m_new == -INFINITY;
      const float alpha = dead ? 0.f : expf(m_old - m_new);
      const float p = dead ? 0.f : expf(s - m_new);
      const float psum = warp_sum(p);
      sm.p[r * kCK + lane] = lane < nvalid ? round_bf16(p * sm.vs[lane]) : 0.f;
      if (lane == 0) {
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * alpha + psum;
        sm.alpha[r] = alpha;
      }
    }
    __syncthreads();

    // values: one thread a (row, element)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int e = tid + kThreads * j;
      const int r = e / hs, d = e % hs;
      if (r < nr) {
        const float* pr = sm.p + r * kCK;
        float o = acc[j] * sm.alpha[r];
        for (int c = 0; c < nvalid; ++c) o = fmaf(pr[c], static_cast<float>(sm.v[c * rsb + d]), o);
        acc[j] = o;
      }
    }
  }
  __syncthreads();

  // publish this split's state: m, l, then acc, a row
  const int stride = hs + 2;
  float* mine = a.ws + (size_t)item * kRB * stride;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    const int e = tid + kThreads * j;
    const int r = e / hs, d = e % hs;
    if (r < nr) mine[r * stride + 2 + d] = acc[j];
  }
  if (tid < nr) {
    mine[tid * stride] = sm.m[tid];
    mine[tid * stride + 1] = sm.l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(&a.tickets[group], 1) == ns - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();

  // the last split merges the states in split order (and K13's virtual
  // row). The splits' (m, l) are fetched together into shared memory, and
  // m is replaced there by the split's weight exp(m - M), 0 for a split
  // that saw no live key (its l and acc are 0).
  const float* states = a.ws + (size_t)group * a.nsplit * kRB * stride;
  for (int e = tid; e < ns * nr; e += kThreads) {
    const float* st = states + ((size_t)(e / nr) * kRB + e % nr) * stride;
    sm.ml[2 * e] = __ldcg(st);
    sm.ml[2 * e + 1] = __ldcg(st + 1);
  }
  __syncthreads();
  if (tid < nr) {
    const int r = tid;
    float M = -INFINITY;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, sm.ml[2 * (s * nr + r)]);
    float sv = -INFINITY;
    if (a.mode == kLayer) {
      float dot = 0.f;
      for (int d = 0; d < hs; ++d) dot = fmaf(sm.q[r * qs + d], static_cast<float>(sm.kn[d]), dot);
      sv = dot * (sm.kn_s * a.scale);
      M = fmaxf(M, sv);
    }
    float L = 0.f;
    for (int s = 0; s < ns; ++s) {
      float* ml = sm.ml + 2 * (s * nr + r);
      const float w = ml[0] != -INFINITY ? expf(ml[0] - M) : 0.f;
      L = fmaf(ml[1], w, L);
      ml[0] = w;
    }
    if (a.mode == kLayer) L += expf(sv - M);
    sm.m[r] = M;
    sm.l[r] = L;
    sm.alpha[r] = sv;
  }
  __syncthreads();
  for (int e = tid; e < nr * hs; e += kThreads) {
    const int r = e / hs, d = e % hs;
    const float M = sm.m[r];
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s)
      o = fmaf(__ldcg(states + ((size_t)s * kRB + r) * stride + 2 + d), sm.ml[2 * (s * nr + r)], o);
    if (a.mode == kLayer) {
      const float vd = static_cast<float>(sm.vn[d]) * sm.vn_s;  // float32, not rounded to bf16
      o = fmaf(expf(sm.alpha[r] - M), vd, o);
    }
    o = __fdiv_rn(o, sm.l[r]);
    const int rr = r0 + r, t = rr / G, h = kvh * G + rr % G;
    if (a.mode == kLayer)
      a.out32[((size_t)b * H + h) * hs + d] = o;
    else
      store_act(a.out, (((size_t)b * T + t) * H + h) * hs + d, a.dtype, o);
  }
  if (tid == 0) a.tickets[group] = 0;
}

// What the device code takes; 0 or a cudaError_t.
inline int check(const Params& a, long long ws_floats, int n_tickets) {
  if (a.B <= 0 || a.H <= 0 || a.KVH <= 0 || a.H % a.KVH != 0) return cudaErrorInvalidValue;
  if (a.hs <= 0 || a.hs > kMaxHs || a.hs % 2 != 0) return cudaErrorInvalidValue;
  if (a.T <= 0 || a.S <= 0 || a.nsplit < 1 || a.nsplit > kMaxSplit || a.layer < 0 || a.layer >= a.L)
    return cudaErrorInvalidValue;
  if (a.dtype != kF32 && a.dtype != kBF16) return cudaErrorInvalidValue;
  if (a.n_rg != (rows_per_head(a.mode, a.T, a.H, a.KVH) + kRB - 1) / kRB) return cudaErrorInvalidValue;
  if (a.ws == nullptr || a.tickets == nullptr) return cudaErrorInvalidValue;
  if (ws_floats < (long long)items(a) * kRB * (a.hs + 2)) return cudaErrorInvalidValue;
  if (n_tickets < a.B * a.KVH * a.n_rg) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace q8a
}  // namespace llama2
