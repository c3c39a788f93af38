// The post-attention half of a decode layer over layer-stacked INT8 weights,
// in ONE launch:
//
//   r    = x + att @ Wo[l]                                        (wo)
//   out  = r + swiglu(rmsnorm(r, rms_ffn) @ W1[l], .. @ W3[l]) @ W2[l]
//   qkv' = rmsnorm(out, rms_att[l']) @ Wqkv[l'],  l' = min(l + 1, L - 1)  (qkv)
//
// Replaces llama2_tpu/ops/pallas/mlp_block.py::mlp_block_stacked (neither
// bracketed phase; r = x, and `out` optionally without the residual),
// ::attn_mlp_block_stacked (the wo phase) and ::layer_tail_qkv_stacked (both);
// and, with a leading attention phase, llama2_tpu/ops/pallas/layer_block.py::
// layer_block_stacked (K13, the whole decode layer over the int8 KV cache):
//
//   att  = attention(rope(qkv), int8 cache; append this step's rows)  (att)
//
// then the wo phase on the float32 `att` (rounded to bf16 where it is used, as
// every matmul operand), with or without the qkv phase. The attention phase is
// attention_q8.cuh's split decode loop over the dense planes (layer_items: its
// one loop for this kernel, one query row a block), its work items (b, kv
// head, query row, key split) dealt to the blocks round-robin, merged by the
// last split of each into a float32 workspace, then one more grid-wide
// barrier. The loop's warp accumulators take the dynamic shared memory that
// the tensor-core form's rings use in the later phases. It differs from
// the glue-fused attention kernel (K9) followed by this kernel in two ways,
// as the Pallas kernel does: this step's row joins as a virtual row with a
// float32 value (attention_q8.cuh), and `att` is never rounded to the
// activation dtype.
//
// Arithmetic, as the Pallas kernels have it (fast mode only): every matmul
// operand (att, the normed rows, the swiglu product) is rounded to bf16 where
// it is used; the products of one quant group are summed in float32, times the
// group's f32 scale, into a float32 accumulator (q8_gemv.cuh, shared with
// quant_matmul.cu). r, the normed rows, h1, h3, the swiglu product, out and
// qkv' stay float32 between the phases: only the two outputs are rounded to
// the activation dtype, and the second rmsnorm reads the float32 `out`.
// rmsnorm: float32 sum of squares, eps after the mean, times the weight;
// swiglu: h1 * sigmoid(h1) * h3 in float32.
//
// Bound on this card: bytes. A decode row (M <= 8) reads every weight byte
// once: at Llama-2-7B widths 144 to 215 MB a call, which only all 132 SMs
// together stream at the memory's rate. But each phase needs ALL of the one
// before it: rmsnorm the whole of r, W2 every column of the swiglu product,
// the next layer's rmsnorm the whole of out. On the TPU the phases follow each
// other on one core's sequential grid with the rows in VMEM. Here the kernel
// is a persistent grid of as many blocks as are resident together, started
// with cudaLaunchCooperativeKernel, with a grid-wide barrier
// (cooperative_groups grid.sync()) between phases; the rows between phases
// live in a small float32 workspace in global memory (MT * (3 D + HD) floats:
// it stays in L2) that the wrapper owns.
//
// Within a phase the work is quant_matmul.cu's decode-row split: items of
// (matrix, 128-column strip, split of the contraction over whole quant
// groups), dealt to the blocks round-robin. A block writes its item's partial
// sums to the workspace; an integer ticket per strip finds the block that
// finishes the strip last, and that block adds the partials in split order
// and applies the phase's epilogue (residual, swiglu, store). No float
// atomics: the same inputs give the same bits. W1 and W3 are two matrices of
// one phase over the same strips, so the finishing block has both h1 and h3.
// Rows past 8 are taken 8 at a time, each pass streaming the weights again.
//
// An item's product has two forms (ops/cuda/mlp_block.py::plan picks one
// before the launch). One or two rows, or a group size or width that is no
// multiple of 16: the FMA form of q8_gemv.cuh, one thread 4 columns and MT
// rows, a weight byte an I2F and MT FMAs on the CUDA cores; at 8 rows it
// took 2.7x its 1-row time for the same weight bytes. 3 to 8 rows: the
// tensor-core form (mma_item), 8 rows a pass, mma.sync taking 8 rows of 16
// products a lane in one instruction (at 2 rows the FMA form is the faster
// on the H100).
//
// Workspace reads go through L2 (__ldcg): another block wrote them in this
// launch, and L1 is not coherent between SMs.
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "attention_q8.cuh"
#include "mma.cuh"
#include "q8_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace llama2;

struct Mat {
  const int8_t* q;     // (K, N), already at its layer
  const float* scale;  // (K / G, N)
};

struct Args {
  const void* att;      // (M, D) dtype, or null: no wo phase (unless att32)
  const float* att32;   // (M, D) float32 from the attention phase, or null
  q8a::Params q8;       // the attention phase (kLayer), when att32
  const void* x;        // (M, D) dtype
  const void* rms_ffn;  // (D,) dtype, at its layer
  const void* rms_att;  // (D,) dtype, at layer l', or null: no qkv phase
  Mat wo, w13[2], w2, wqkv;
  void* out;            // (M, D) dtype
  void* qkv;            // (M, Dq) dtype, or null
  float* r;             // (MT, D) workspace: x + att @ Wo
  float* hs;            // (MT, HD) workspace: the swiglu product
  float* o32;           // (MT, D) workspace: out in float32
  __nv_bfloat16* xb0;   // the tensor-core form: (8, D) bf16 x of wo, w1/w3 and wqkv
  __nv_bfloat16* xb1;   // and (8, HD) of w2
  float* partial;       // the items' partial sums
  int* tickets;         // one per column strip; zero on entry and on exit
  int M, D, HD, Dq;
  int G0, G1, G2, Gq;      // group sizes of wo, w1/w3, w2, wqkv
  int ks0, ks1, ks2, ksq;  // splits of the contraction, per phase
  int dtype, residual;
  float eps;
};

// The FMA form of one item's product (1 to 8 rows, any group size): each
// warp stages its groups' x rows as floats and streams the strip's weight
// rows with one 4-byte load a lane a row (q8_gemv.cuh); the warps' sums go to
// the reduce buffer (put_warp_sums), read back by sum_warps.
template <int MT, int U, typename LoadX>
__device__ __forceinline__ void fma_item(const Mat& w, int N, int G, int g0, int g1, int strip,
                                         int rows, float* sm, LoadX load_x) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = strip * TILE_N + lane * VEC;
  const bool col_ok = col < N;  // N % 4 == 0: a thread's columns are in or out whole
  float* xs = sm + warp * MT * kMaxG;
  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;
  for (int g = g0 + warp; g < g1; g += kWarps) {
    stage_group<MT, U>(xs, G, lane, [&](int m, int j) {
      return m < rows ? load_x(m, g * G + j) : 0.f;
    });
    if (col_ok) group_dot<MT, U, true>(w.q, w.scale, N, G, g, col, xs, acc);
  }
  __syncthreads();  // every warp is done with its staged x (the buffer is shared)
  put_warp_sums<MT>(sm, warp, lane, acc);
}

// The tensor-core form (3 to 8 rows, G % 16 == 0, N % 16 == 0): per quant
// group, y^T (16 columns x 8 rows) += W^T (16 x 16 of the group's rows) .
// X^T (16 x 8) with mma.sync m16n8k16 in bf16, float32 accumulators: the
// rows are the n8 side (absent rows zero), so at 8 rows no part of the tile
// idles. The order of a group's rows inside the product is free, which lets
// a lane's fragment bytes come straight from its own copies: lane (gq, t)
// takes 16 bytes (columns 16 gq .. 16 gq + 15) of rows 4t .. 4t + 3 of each
// 16-row step, so a warp reads four whole 128-byte lines of the strip;
// those rows are the lane's k slots 2t, 2t + 1, 2t + 8, 2t + 9, and column
// 16 gq + 2j + h is m slot gq + 8h of column tile j. The bytes become bf16
// pairs exactly (int8_pair_bf16). The lane's B fragment is 8 bytes of the
// phase's x rows, staged once as bf16 by the whole grid (stage_x: row gq,
// the same four rows). Each warp streams both through its own ring of kRing
// stages in dynamic shared memory, cp.async kRing - 1 steps ahead, so the
// next step's reads are in flight while it converts and multiplies (deeper
// rings ran slower on the H100: PERF.md); a lane reads back only what it
// copied, so no barrier. A group's products are summed in a fresh
// fragment, then acc += part * scale, group by group: fast mode's
// arithmetic, only the order inside a group differs from the FMA form.
constexpr int kMmaRows = 8;  // the n8 side: x's rows a pass
constexpr int kRing = 2;     // stages of a warp's ring (a power of two)
constexpr size_t kRingBytes = (size_t)kWarps * kRing * 32 * (4 * 16 + 8);

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Where (row m, strip column j) of a warp's sums lies in its part of the
// reduce buffer: 4-float chunks XOR (m / 2) % 4, so that each quarter warp's
// float4 stores, and a warp's reads of one row, meet 32 distinct banks.
__device__ __forceinline__ int mma_sum_at(int m, int j) {
  return m * TILE_N + (((j >> 2) ^ ((m >> 1) & 3)) << 2) + (j & 3);
}

__device__ __forceinline__ float mma_sum(const float* sm, int m, int j) {
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sm[w * kMmaRows * TILE_N + mma_sum_at(m, j)];
  return t;
}

// xb (kMmaRows, K) bf16 = load_x(m, k) for m < rows, 0 below: the whole grid
// writes a phase's x once, before a grid barrier
template <typename LoadX>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xb, int rows, int K, LoadX load_x) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < kMmaRows * K; i += gridDim.x * kThreads) {
    const int m = i / K, k = i - m * K;
    xb[i] = __float2bfloat16_rn(m < rows ? load_x(m, k) : 0.f);
  }
}

__device__ __forceinline__ void mma_item(const Mat& w, const __nv_bfloat16* xb, int K, int N,
                                         int G, int g0, int g1, int strip, float* sm,
                                         unsigned char* rings) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int col = strip * TILE_N + gq * 16;  // this lane's 16 columns
  const bool col_ok = col < N;               // N % 16 == 0
  const int spg = G / 16;                    // 16-row steps a group
  const int n_groups = g1 > g0 + warp ? (g1 - g0 - warp + kWarps - 1) / kWarps : 0;
  const int n_steps = n_groups * spg;
  // this warp's ring: stage st holds the lane's weight rows at wr[(st * 4 + r) * 32]
  // and its x fragment at xr[st * 32]
  uint4* wr = reinterpret_cast<uint4*>(rings) + (size_t)warp * kRing * 4 * 32 + lane;
  uint2* xr = reinterpret_cast<uint2*>(rings + (size_t)kWarps * kRing * 4 * 32 * 16) +
              (size_t)warp * kRing * 32 + lane;
  int ig = g0 + warp, is = 0, iq = 0;  // the next step to copy: group, step in it, count
  auto issue = [&]() {
    if (iq < n_steps) {
      const int k = ig * G + 16 * is + 4 * t;  // the lane's first row
      const int st = iq & (kRing - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cp_async16(wr + (st * 4 + r) * 32, col_ok ? w.q + (size_t)(k + r) * N + col : w.q,
                   col_ok ? 16 : 0);
      cp_async8(xr + st * 32, xb + (size_t)gq * K + k, 8);
      if (++is == spg) {
        is = 0;
        ig += kWarps;
      }
      ++iq;
    }
    cp_async_commit();
  };

  float acc[8][4], part[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = part[j][c] = 0.f;
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) issue();
  int g = g0 + warp, s = 0;  // the step being multiplied: group, step in it
  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait<kRing - 2>();  // step q's copies are in
    const int st = q & (kRing - 1);
    uint4 wv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wv[r] = wr[(st * 4 + r) * 32];
    const uint2 xv = xr[st * 32];
    issue();  // into the stage step q - 1 used
    const uint32_t b[2] = {xv.x, xv.y};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int wi = j >> 1, c = 2 * (j & 1);
      const uint32_t sel0 = 0x0400u + c * 0x0101u, sel1 = sel0 + 0x0101u;
      const uint32_t a[4] = {int8_pair_bf16(word_of(wv[0], wi), word_of(wv[1], wi), sel0),
                             int8_pair_bf16(word_of(wv[0], wi), word_of(wv[1], wi), sel1),
                             int8_pair_bf16(word_of(wv[2], wi), word_of(wv[3], wi), sel0),
                             int8_pair_bf16(word_of(wv[2], wi), word_of(wv[3], wi), sel1)};
      mma_m16n8k16_bf16(part[j], a, b);
    }
    if (++s == spg) {  // the group's last step: acc += part * scale
      if (col_ok) {
        // part[j]: (column 2j, rows 2t, 2t + 1), then (column 2j + 1, the same rows)
        const float4* sp = reinterpret_cast<const float4*>(w.scale + (size_t)g * N + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 s4 = __ldg(sp + i);
          const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 2 * i + (c >> 1), h = c & 1;
            acc[j][2 * h] = fmaf(part[j][2 * h], sc[c], acc[j][2 * h]);
            acc[j][2 * h + 1] = fmaf(part[j][2 * h + 1], sc[c], acc[j][2 * h + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
      s = 0;
      g += kWarps;
    }
  }
  cp_async_wait<0>();  // nothing of this item left in flight in the ring
  float* sums = sm + warp * kMmaRows * TILE_N;  // gemv_phase synced: the last sums are read
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sums + mma_sum_at(2 * t + r, 16 * gq + 4 * i)) =
          make_float4(acc[2 * i][r], acc[2 * i][2 + r], acc[2 * i + 1][r], acc[2 * i + 1][2 + r]);
}

// The finishing block's reduce: the partials of its E elements a thread
// (element i = threadIdx.x + e * kThreads of the strip's MT x TILE_N),
// added in split order, then the epilogue. Every load of four splits, for
// all E elements and both matrices, is issued before its adds.
template <int MT, typename Epilogue>
__device__ __forceinline__ void strip_reduce(const float* partial, int ksplit, int nmat, int strip,
                                             int rows, int N, Epilogue epi) {
  constexpr int E = (MT * TILE_N + kThreads - 1) / kThreads;
  int m[E], n[E];
  bool ok[E];
  float t0[E], t1[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = threadIdx.x + e * kThreads;
    m[e] = i / TILE_N;
    n[e] = strip * TILE_N + i % TILE_N;
    ok[e] = i < MT * TILE_N && m[e] < rows && n[e] < N;
    t0[e] = t1[e] = 0.f;
  }
  auto at = [&](int s, int i, int e) {
    return ok[e] ? __ldcg(&partial[((size_t)(s * nmat + i) * MT + m[e]) * N + n[e]]) : 0.f;
  };
  for (int s0 = 0; s0 < ksplit; s0 += 4) {
    float v0[4][E], v1[4][E];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool live = s0 + u < ksplit;
        v0[u][e] = live ? at(s0 + u, 0, e) : 0.f;
        v1[u][e] = live && nmat == 2 ? at(s0 + u, 1, e) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (s0 + u < ksplit) {
          t0[e] += v0[u][e];
          t1[e] += v1[u][e];
        }
      }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (ok[e]) epi(m[e], n[e], t0[e], t1[e]);
}

// One phase: y (rows, N) = X (rows, K) @ mats[i] for i < nmat, X[m][k] =
// load_x(m, k) (already rounded to bf16); epi(m, n, y0, y1) is called once
// for every output element by the block that finishes its strip. `partial`
// holds nmat * ksplit * MT * N floats. MMA: the tensor-core form (MT = 8),
// its rings in `rings` (kRingBytes of dynamic shared memory), x from the
// staged rows xb (kMmaRows, K), not from load_x.
template <int MT, int U, bool MMA, typename LoadX, typename Epilogue>
__device__ __forceinline__ void gemv_phase(const Mat* mats, int nmat, int K, int N, int G,
                                           int ksplit, int rows, float* partial, int* tickets,
                                           float* sm, unsigned char* rings,
                                           const __nv_bfloat16* xb, int* last, LoadX load_x,
                                           Epilogue epi) {
  static_assert(!MMA || MT == kMmaRows, "the tensor-core form takes 8 rows a pass");
  const int strips = (N + TILE_N - 1) / TILE_N;
  const int KG = K / G;
  const int per = (KG + ksplit - 1) / ksplit;
  const int n_items = strips * nmat * ksplit;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int strip = item % strips;
    const int ms = item / strips;  // split * nmat + matrix
    const Mat w = mats[ms % nmat];
    const int g0 = (ms / nmat) * per;
    const int g1 = min(KG, g0 + per);

    __syncthreads();  // the previous item's sums have been read
    if constexpr (MMA)
      mma_item(w, xb, K, N, G, g0, g1, strip, sm, rings);
    else
      fma_item<MT, U>(w, N, G, g0, g1, strip, rows, sm, load_x);

    // the warps' sums, added in warp order, are this item's partial
    __syncthreads();
    for (int i = threadIdx.x; i < MT * TILE_N; i += kThreads) {
      const int m = i / TILE_N;
      const int j = i % TILE_N;
      const int n = strip * TILE_N + (MMA ? j : strip_col(j));
      if (m < rows && n < N)
        partial[((size_t)ms * MT + m) * N + n] = MMA ? mma_sum(sm, m, j) : sum_warps<MT>(sm, m, j);
    }

    // the block that draws the strip's last ticket adds the partials in
    // split order
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(&tickets[strip], 1) == nmat * ksplit - 1;
    __syncthreads();
    if (!*last) continue;
    __threadfence();
    strip_reduce<MT>(partial, ksplit, nmat, strip, rows, N, epi);
    if (threadIdx.x == 0) tickets[strip] = 0;
  }
}

// rstd[m] = 1 / rms of row m < rows, row[m][k] = load(m, k); 0 for the
// others. One pass over k for all rows (their loads in flight together):
// a thread's float32 FMAs in k order, a warp butterfly, the warps in order.
// rstd[m] from each thread's partial sums of squares ss[m]: a warp
// butterfly, the warps in order; 0 for rows past `rows`
template <int MT>
__device__ __forceinline__ void rstd_reduce(float* rstd, int rows, int K, float eps, float* buf,
                                            const float (&ss)[MT]) {
  __syncthreads();  // the last phase is done with rstd and buf
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float v = warp_sum(ss[m]);
    if ((threadIdx.x & 31) == 0) buf[m * kWarps + (threadIdx.x >> 5)] = v;
  }
  __syncthreads();
  if (threadIdx.x < MT) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += buf[threadIdx.x * kWarps + w];
    rstd[threadIdx.x] = threadIdx.x < rows ? 1.0f / sqrtf(t / (float)K + eps) : 0.f;
  }
  __syncthreads();
}

template <int MT, typename Load>
__device__ __forceinline__ void rows_rstd(float* rstd, int rows, int K, float eps, float* buf,
                                          Load load) {
  float ss[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) ss[m] = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < rows) {
        const float v = load(m, k);
        ss[m] = fmaf(v, v, ss[m]);
      }
    }
  }
  rstd_reduce<MT>(rstd, rows, K, eps, buf, ss);
}

// rows_rstd of rows (MT, K) of the float32 workspace at `ws` (K % 4 == 0),
// read as float4: a thread's FMAs in order over its vectors
template <int MT>
__device__ __forceinline__ void rows_rstd_ws(float* rstd, int rows, int K, float eps, float* buf,
                                             const float* ws) {
  float ss[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) ss[m] = 0.f;
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kThreads) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < rows) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)m * K + k));
        ss[m] = fmaf(v.x, v.x, ss[m]);
        ss[m] = fmaf(v.y, v.y, ss[m]);
        ss[m] = fmaf(v.z, v.z, ss[m]);
        ss[m] = fmaf(v.w, v.w, ss[m]);
      }
    }
  }
  rstd_reduce<MT>(rstd, rows, K, eps, buf, ss);
}

// Blocks the compiler must fit on an SM (65,536 registers over 256 threads a
// block): three for one or two rows a thread (80 registers, no spills). Left
// alone the compiler takes 128 registers, two blocks fit, and a decode row is
// a fifth slower (PERF.md); four blocks (64 registers) spill and are slower
// than three. Two for more rows a thread, and for the tensor-core form.
template <int MT, bool MMA>
constexpr int kMinBlocks = !MMA && MT <= 2 ? 3 : 2;

// shared memory of one block: the gemv phases' buffer, or (ATT) the
// attention phase's, which the barrier after it frees
template <int MT, bool ATT>
constexpr size_t kSmemBytes = ATT && sizeof(q8a::SplitSmem) > kStripSmemFloats<MT> * sizeof(float)
                                  ? sizeof(q8a::SplitSmem)
                                  : kStripSmemFloats<MT> * sizeof(float);

// warp loads a pass of the attention phase's loop for one query row a block:
// 2 where three blocks share an SM's registers (the FMA form at 1-2 rows, 80
// registers a thread), else 4
__host__ __device__ constexpr int att_unroll(int mt, bool mma) { return !mma && mt <= 2 ? 2 : 4; }

template <int MT, int U, bool ATT, bool MMA>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT, MMA>) mlp_block_kernel(const Args a) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes<MT, ATT>];
  // MMA: the warps' rings; ATT: first the attention phase's warp accumulators
  extern __shared__ __align__(16) unsigned char rings[];
  float* sm = reinterpret_cast<float*>(smem);
  __shared__ float rstd[MT];
  __shared__ int last;
  cg::grid_group grid = cg::this_grid();
  if constexpr (ATT) {
    q8a::layer_items<att_unroll(MT, MMA)>(a.q8, *reinterpret_cast<q8a::SplitSmem*>(smem),
                                          reinterpret_cast<float*>(rings));
    grid.sync();
  }
  const bool has_wo = ATT || a.att != nullptr;
  const bool has_qkv = a.qkv != nullptr;
  const int D = a.D, HD = a.HD;

  for (int m0 = 0; m0 < a.M; m0 += MT) {
    const int rows = min(MT, a.M - m0);
    const size_t row0 = (size_t)m0 * D;  // this pass's first element of att, x and out
    auto load_x = [&](int m, int k) { return load_act(a.x, row0 + (size_t)m * D + k, a.dtype); };
    // the residual stream after attention: float32 r, or x itself
    auto load_r = [&](int m, int k) {
      return has_wo ? __ldcg(&a.r[(size_t)m * D + k]) : load_x(m, k);
    };

    if (has_wo) {
      auto load_att = [&](int m, int k) {
        const size_t i = row0 + (size_t)m * D + k;
        return round_bf16(ATT ? __ldcg(&a.att32[i]) : load_act(a.att, i, a.dtype));
      };
      if constexpr (MMA) {
        stage_x(a.xb0, rows, D, load_att);
        grid.sync();
      }
      gemv_phase<MT, U, MMA>(
          &a.wo, 1, D, D, a.G0, a.ks0, rows, a.partial, a.tickets, sm, rings, a.xb0, &last, load_att,
          [&](int m, int n, float t, float) { a.r[(size_t)m * D + n] = load_x(m, n) + t; });
      grid.sync();
    }

    if (has_wo)
      rows_rstd_ws<MT>(rstd, rows, D, a.eps, sm, a.r);
    else
      rows_rstd<MT>(rstd, rows, D, a.eps, sm, load_r);
    auto load_n = [&](int m, int k) {
      return round_bf16(load_r(m, k) * rstd[m] * load_act(a.rms_ffn, k, a.dtype));
    };
    if constexpr (MMA) {
      stage_x(a.xb0, rows, D, load_n);
      // the rows past `rows` of w2's x, which the epilogue below leaves alone
      for (int i = blockIdx.x * kThreads + threadIdx.x; i < (kMmaRows - rows) * HD; i += gridDim.x * kThreads)
        a.xb1[(size_t)rows * HD + i] = __float2bfloat16_rn(0.f);
      grid.sync();
    }
    gemv_phase<MT, U, MMA>(
        a.w13, 2, D, HD, a.G1, a.ks1, rows, a.partial, a.tickets, sm, rings, a.xb0, &last, load_n,
        [&](int m, int n, float h1, float h3) {
          const float h = h1 * (1.0f / (1.0f + expf(-h1))) * h3;
          if constexpr (MMA)
            a.xb1[(size_t)m * HD + n] = __float2bfloat16_rn(h);  // w2's x, staged
          else
            a.hs[(size_t)m * HD + n] = h;
        });
    grid.sync();

    gemv_phase<MT, U, MMA>(
        &a.w2, 1, HD, D, a.G2, a.ks2, rows, a.partial, a.tickets, sm, rings, a.xb1, &last,
        [&](int m, int k) { return round_bf16(__ldcg(&a.hs[(size_t)m * HD + k])); },
        [&](int m, int n, float t, float) {
          const float v = a.residual ? t + load_r(m, n) : t;
          store_act(a.out, row0 + (size_t)m * D + n, a.dtype, v);
          if (has_qkv) a.o32[(size_t)m * D + n] = v;
        });

    if (has_qkv) {
      grid.sync();
      rows_rstd_ws<MT>(rstd, rows, D, a.eps, sm, a.o32);
      auto load_q = [&](int m, int k) {
        return round_bf16(__ldcg(&a.o32[(size_t)m * D + k]) * rstd[m] * load_act(a.rms_att, k, a.dtype));
      };
      if constexpr (MMA) {
        stage_x(a.xb0, rows, D, load_q);
        grid.sync();
      }
      gemv_phase<MT, U, MMA>(
          &a.wqkv, 1, D, a.Dq, a.Gq, a.ksq, rows, a.partial, a.tickets, sm, rings, a.xb0, &last,
          load_q,
          [&](int m, int n, float t, float) {
            store_act(a.qkv, (size_t)(m0 + m) * a.Dq + n, a.dtype, t);
          });
    }
    if (m0 + MT < a.M) grid.sync();  // the next pass reuses the workspace
  }
}

// dynamic shared memory of an instance: the tensor-core form's rings and
// (ATT) the attention phase's att_floats warp accumulators, which share it;
// the attribute raised where the instance needs more than it allows
template <int MT, int U, bool ATT, bool MMA>
cudaError_t dyn_smem(int att_floats, size_t* bytes) {
  *bytes = std::max(MMA ? kRingBytes : (size_t)0, ATT ? (size_t)att_floats * sizeof(float) : (size_t)0);
  static size_t allowed = 0;
  if (*bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(mlp_block_kernel<MT, U, ATT, MMA>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  if (e == cudaSuccess) allowed = *bytes;
  return e;
}

template <int MT, int U, bool MMA>
cudaError_t occupancy(int* blocks_per_sm, int att_floats) {
  size_t dyn = 0;
  if (att_floats > 0) {
    const cudaError_t err = dyn_smem<MT, U, true, MMA>(att_floats, &dyn);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, mlp_block_kernel<MT, U, true, MMA>,
                                                         kThreads, dyn);
  }
  const cudaError_t err = dyn_smem<MT, U, false, MMA>(0, &dyn);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, mlp_block_kernel<MT, U, false, MMA>,
                                                       kThreads, dyn);
}

template <int MT, int U, bool MMA>
cudaError_t launch(Args& a, int grid, cudaStream_t st) {
  size_t dyn = 0;
  const bool att = a.att32 != nullptr;
  const cudaError_t err = att ? dyn_smem<MT, U, true, MMA>(q8a::split_acc_floats(a.q8.nq, a.q8.hs), &dyn)
                              : dyn_smem<MT, U, false, MMA>(0, &dyn);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  const void* fn = att ? reinterpret_cast<const void*>(&mlp_block_kernel<MT, U, true, MMA>)
                       : reinterpret_cast<const void*>(&mlp_block_kernel<MT, U, false, MMA>);
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, dyn, st);
}

// mma: the tensor-core form (mt 8); else the FMA form at mt rows a thread
cudaError_t launch_mt(Args& a, int mt, bool mma, int grid, cudaStream_t st) {
  if (mma) return launch<8, 8, true>(a, grid, st);
  switch (mt) {
    case 1: return launch<1, 16, false>(a, grid, st);
    case 2: return launch<2, 16, false>(a, grid, st);
    case 4: return launch<4, 16, false>(a, grid, st);
    default: return launch<8, 8, false>(a, grid, st);
  }
}

// a matrix the phases cannot take; the tensor-core form also needs whole
// 16-row steps and 16-byte column runs
bool bad_matrix(int K, int N, int G, int ksplit, bool mma) {
  return K <= 0 || N <= 0 || G <= 0 || G > kMaxG || K % G != 0 || N % 4 != 0 || ksplit < 1 ||
         ksplit > K / G || (mma && (G % 16 != 0 || N % 16 != 0));
}

}  // namespace

// The most blocks of the kernel for `mt` rows a thread (1, 2, 4 or 8; the
// tensor-core form, mma != 0, only 8), with the attention phase whose warp
// accumulators take att_floats floats of shared memory (att_floats > 0;
// q8a::split_acc_floats of the plan's nq and hs) or without (0), that are
// resident together on the current device: *blocks_per_sm times *sms. A
// cooperative launch takes no more. Returns a cudaError_t.
extern "C" int mlp_block_occupancy(int mt, int att_floats, int mma, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (mma) return mt == 8 ? occupancy<8, 8, true>(blocks_per_sm, att_floats) : cudaErrorInvalidValue;
  switch (mt) {
    case 1: return occupancy<1, 16, false>(blocks_per_sm, att_floats);
    case 2: return occupancy<2, 16, false>(blocks_per_sm, att_floats);
    case 4: return occupancy<4, 16, false>(blocks_per_sm, att_floats);
    case 8: return occupancy<8, 8, false>(blocks_per_sm, att_floats);
    default: return cudaErrorInvalidValue;
  }
}

namespace {

// Args of one launch, checked; `att32` non-null adds the wo phase without
// `att` (the attention phase fills it). Returns 0 or a cudaError_t; *need is
// the workspace floats and *strips the tickets that the gemv phases use.
int make_args(Args& a, const void* att, const float* att32, const void* x, const void* wo_q,
              const void* wo_s, const void* rms_ffn, const void* w1_q, const void* w1_s,
              const void* w3_q, const void* w3_s, const void* w2_q, const void* w2_s,
              const void* rms_att, const void* wqkv_q, const void* wqkv_s, void* out, void* qkv,
              void* ws, void* tickets, int dtype, int layer, int L, int M, int D, int HD, int Dq,
              int G0, int G1, int G2, int Gq, int ks0, int ks1, int ks2, int ksq, int mt, int mma,
              int grid, int residual, int rms_stacked, float eps, size_t* need, int* strips) {
  const bool has_wo = att != nullptr || att32 != nullptr, has_qkv = qkv != nullptr;
  if (layer < 0 || layer >= L || M <= 0 || grid < 1) return cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (mt != 1 && mt != 2 && mt != 4 && mt != 8) return cudaErrorInvalidValue;
  if (mma && mt != 8) return cudaErrorInvalidValue;
  if (bad_matrix(D, HD, G1, ks1, mma) || bad_matrix(HD, D, G2, ks2, mma)) return cudaErrorInvalidValue;
  if (has_wo && bad_matrix(D, D, G0, ks0, mma)) return cudaErrorInvalidValue;
  if (has_qkv && (bad_matrix(D, Dq, Gq, ksq, mma) || rms_att == nullptr)) return cudaErrorInvalidValue;
  if (!residual && (has_wo || has_qkv)) return cudaErrorInvalidValue;
  if (ws == nullptr || tickets == nullptr) return cudaErrorInvalidValue;

  const size_t l = (size_t)layer, lq = (size_t)std::min(layer + 1, L - 1);
  const size_t esize = dtype == kF32 ? 4 : 2;
  const size_t d = (size_t)D, hd = (size_t)HD, dq = (size_t)Dq;
  auto mat = [](const void* q, const void* s, size_t layer_i, size_t K, size_t N, size_t G) {
    return Mat{static_cast<const int8_t*>(q) + layer_i * K * N,
               static_cast<const float*>(s) + layer_i * (K / G) * N};
  };
  auto rms = [&](const void* p, size_t layer_i) {
    return static_cast<const char*>(p) + (rms_stacked ? layer_i * d * esize : 0);
  };

  a.att = att;
  a.att32 = att32;
  a.x = x;
  a.rms_ffn = rms(rms_ffn, l);
  a.rms_att = has_qkv ? rms(rms_att, lq) : nullptr;
  if (has_wo) a.wo = mat(wo_q, wo_s, l, d, d, G0);
  a.w13[0] = mat(w1_q, w1_s, l, d, hd, G1);
  a.w13[1] = mat(w3_q, w3_s, l, d, hd, G1);
  a.w2 = mat(w2_q, w2_s, l, hd, d, G2);
  if (has_qkv) a.wqkv = mat(wqkv_q, wqkv_s, lq, d, dq, Gq);
  a.out = out;
  a.qkv = qkv;

  size_t part = std::max((size_t)2 * ks1 * hd, (size_t)ks2 * d);
  if (has_wo) part = std::max(part, (size_t)ks0 * d);
  if (has_qkv) part = std::max(part, (size_t)ksq * dq);
  const size_t xb_floats = mma ? (size_t)kMmaRows * (d + hd) / 2 : 0;  // bf16, two a float
  *need = (size_t)mt * (3 * d + hd + part) + xb_floats;
  *strips = (std::max(std::max(D, HD), has_qkv ? Dq : 0) + TILE_N - 1) / TILE_N;
  a.r = static_cast<float*>(ws);
  a.hs = a.r + mt * d;
  a.o32 = a.hs + mt * hd;
  a.xb0 = reinterpret_cast<__nv_bfloat16*>(a.o32 + mt * d);
  a.xb1 = a.xb0 + (size_t)kMmaRows * d;
  a.partial = a.o32 + mt * d + xb_floats;
  a.tickets = static_cast<int*>(tickets);
  a.M = M; a.D = D; a.HD = HD; a.Dq = Dq;
  a.G0 = G0; a.G1 = G1; a.G2 = G2; a.Gq = Gq;
  a.ks0 = ks0; a.ks1 = ks1; a.ks2 = ks2; a.ksq = ksq;
  a.dtype = dtype;
  a.residual = residual;
  a.eps = eps;
  return cudaSuccess;
}

}  // namespace

// One cooperative launch of the whole block on layer `layer` of the stacks
// (L, K, N) int8 / (L, K / G, N) f32.
//   att (M, D) or null: with it, r = x + att @ wo[layer]; without, r = x and
//     wo_q / wo_s are not read.
//   rms_ffn: (D,), or with rms_stacked (L, D), read at `layer`.
//   qkv (M, Dq) or null: with it, qkv = rmsnorm(out, rms_att[l']) @ wqkv[l'],
//     l' = min(layer + 1, L - 1), rms_att (L, D) when rms_stacked else (D,).
//   residual: 0 leaves `r +` out of `out` (only without att and qkv).
//   ws: float32 workspace of ws_floats >= mt * (3 D + HD) + the largest
//     phase's mt * N * matrices * ksplit, and with mma 4 (D + HD) more (the
//     staged bf16 x rows); tickets: n_tickets >= the widest
//     matrix's 128-column strips, zero on entry, left zero.
//   ks0, ks1, ks2, ksq: blocks over the contraction of wo, w1/w3, w2, wqkv.
//   mt in {1, 2, 4, 8}: rows a thread; mma != 0: the tensor-core form (mt 8,
//     every group size a multiple of 16, every width of 16); grid: blocks, at
//     most what mlp_block_occupancy reports for mt and mma.
// All tensors contiguous; x, att, rms_*, out, qkv share `dtype`. Returns the
// launch's cudaError_t.
extern "C" int mlp_block(const void* att, const void* x, const void* wo_q, const void* wo_s,
                         const void* rms_ffn, const void* w1_q, const void* w1_s,
                         const void* w3_q, const void* w3_s, const void* w2_q,
                         const void* w2_s, const void* rms_att, const void* wqkv_q,
                         const void* wqkv_s, void* out, void* qkv, void* ws, void* tickets,
                         long long ws_floats, int n_tickets, int dtype, int layer, int L, int M,
                         int D, int HD, int Dq, int G0, int G1, int G2, int Gq, int ks0, int ks1,
                         int ks2, int ksq, int mt, int mma, int grid, int residual, int rms_stacked,
                         float eps, void* stream) {
  Args a{};
  size_t need = 0;
  int strips = 0;
  int err = make_args(a, att, nullptr, x, wo_q, wo_s, rms_ffn, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s,
                      rms_att, wqkv_q, wqkv_s, out, qkv, ws, tickets, dtype, layer, L, M, D, HD,
                      Dq, G0, G1, G2, Gq, ks0, ks1, ks2, ksq, mt, mma, grid, residual, rms_stacked, eps,
                      &need, &strips);
  if (err != cudaSuccess) return err;
  if ((size_t)ws_floats < need || n_tickets < strips) return cudaErrorInvalidValue;
  return launch_mt(a, mt, mma != 0, grid, static_cast<cudaStream_t>(stream));
}

// The whole decode layer over the int8 KV cache in one cooperative launch
// (K13): the attention phase on qkv3 (M, H + 2 KVH, hs), pre-RoPE, with
// cos_il / sin_il (M, hs) float32 and pos (M,) int32 on the device, appending
// this step's quantized K/V rows and scales to layer `layer` of the caches
// k8 / v8 (L, M, KVH, S, hs) int8 and ks / vs (L, M, KVH, S) float32 in place;
// then mlp_block's phases with att from it (x, weights, rms_*, out, qkv as
// there; rms_* layer-stacked; qkv null for the last layer).
//   nsplit, nq, vb, chunk: the attention phase's plan (ops/cuda/
//     attention_q8.py::q8_plan for this grid, unroll att_unroll(mt, mma)),
//     chunk the keys of one block pass, which must be the instance's.
//   ws: float32 workspace of ws_floats >= mlp_block's need + M * D + M * KVH
//     * n_rg * nsplit * nq * (hs + 2), n_rg = ceil(H / KVH / nq); tickets:
//     n_tickets >= the strips + M * KVH * n_rg, zero on entry, left zero.
//     D = H * hs. Returns the launch's cudaError_t.
extern "C" int layer_block(const void* qkv3, const void* cos_il, const void* sin_il, void* k8,
                           void* ks, void* v8, void* vs, const void* pos, const void* x,
                           const void* wo_q, const void* wo_s, const void* rms_ffn,
                           const void* w1_q, const void* w1_s, const void* w3_q,
                           const void* w3_s, const void* w2_q, const void* w2_s,
                           const void* rms_att, const void* wqkv_q, const void* wqkv_s,
                           void* out, void* qkv, void* ws, void* tickets, long long ws_floats,
                           int n_tickets, int dtype, int layer, int L, int M, int D, int HD,
                           int Dq, int G0, int G1, int G2, int Gq, int ks0, int ks1, int ks2,
                           int ksq, int mt, int mma, int grid, float eps, int H, int KVH, int S, int hs,
                           int nsplit, int nq, int vb, int chunk, float scale, void* stream) {
  if (H <= 0 || KVH <= 0 || H % KVH != 0 || H * hs != D || nq <= 0) return cudaErrorInvalidValue;
  if (!qkv3 || !cos_il || !sin_il || !k8 || !ks || !v8 || !vs || !pos) return cudaErrorInvalidValue;
  Args a{};
  size_t need = 0;
  int strips = 0;
  // att32 is placed after the gemv workspace below; any non-null value marks the wo phase here
  int err = make_args(a, nullptr, static_cast<const float*>(ws), x, wo_q, wo_s, rms_ffn, w1_q,
                      w1_s, w3_q, w3_s, w2_q, w2_s, rms_att, wqkv_q, wqkv_s, out, qkv, ws,
                      tickets, dtype, layer, L, M, D, HD, Dq, G0, G1, G2, Gq, ks0, ks1, ks2, ksq,
                      mt, mma, grid, 1, 1, eps, &need, &strips);
  if (err != cudaSuccess) return err;
  float* att32 = static_cast<float*>(ws) + need;
  q8a::Params& p = a.q8;
  p.qkv = qkv3;
  p.cos_il = static_cast<const float*>(cos_il);
  p.sin_il = static_cast<const float*>(sin_il);
  p.k8 = static_cast<int8_t*>(k8);
  p.ks = static_cast<float*>(ks);
  p.v8 = static_cast<int8_t*>(v8);
  p.vs = static_cast<float*>(vs);
  p.pos = static_cast<const int*>(pos);
  p.out32 = att32;
  p.ws = att32 + (size_t)M * D;
  p.tickets = static_cast<int*>(tickets) + strips;
  p.mode = q8a::kLayer;
  p.dtype = dtype;
  p.layer = layer;
  p.L = L;
  p.B = M;
  p.T = 1;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.hs = hs;
  p.nsplit = nsplit;
  p.nq = nq;
  p.vb = vb;
  p.scale = scale;
  p.n_rg = (H / KVH + nq - 1) / nq;
  a.att32 = att32;
  const long long att_floats = ws_floats - (long long)need - (long long)M * D;
  err = q8a::check(p, att_floats, n_tickets - strips, chunk, att_unroll(mt, mma != 0), true);
  if (err != cudaSuccess) return err;
  return launch_mt(a, mt, mma != 0, grid, static_cast<cudaStream_t>(stream));
}
