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
// attention_q8.cuh's work items (b, kv head, query-row group, key split) dealt
// to the blocks round-robin, merged by the last split of each (b, kv head)
// into a float32 workspace, then one more grid-wide barrier. It differs from
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
// Rows past 8 are taken 8 at a time, each pass streaming the weights again;
// tensor-core tiles for M > 8 are later work.
//
// Workspace reads go through L2 (__ldcg): another block wrote them in this
// launch, and L1 is not coherent between SMs.
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "attention_q8.cuh"
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
  float* partial;       // the items' partial sums
  int* tickets;         // one per column strip; zero on entry and on exit
  int M, D, HD, Dq;
  int G0, G1, G2, Gq;      // group sizes of wo, w1/w3, w2, wqkv
  int ks0, ks1, ks2, ksq;  // splits of the contraction, per phase
  int dtype, residual;
  float eps;
};

// One phase: y (rows, N) = X (rows, K) @ mats[i] for i < nmat, X[m][k] =
// load_x(m, k) (already rounded to bf16); epi(m, n, y0, y1) is called once
// for every output element by the block that finishes its strip. `partial`
// holds nmat * ksplit * MT * N floats.
template <int MT, int U, typename LoadX, typename Epilogue>
__device__ __forceinline__ void gemv_phase(const Mat* mats, int nmat, int K, int N, int G,
                                           int ksplit, int rows, float* partial, int* tickets,
                                           float* sm, int* last, LoadX load_x, Epilogue epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int strips = (N + TILE_N - 1) / TILE_N;
  const int KG = K / G;
  const int per = (KG + ksplit - 1) / ksplit;
  const int n_items = strips * nmat * ksplit;
  float* xs = sm + warp * MT * kMaxG;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int strip = item % strips;
    const int ms = item / strips;  // split * nmat + matrix
    const Mat w = mats[ms % nmat];
    const int g0 = (ms / nmat) * per;
    const int g1 = min(KG, g0 + per);
    const int col = strip * TILE_N + lane * VEC;
    const bool col_ok = col < N;  // N % 4 == 0: a thread's columns are in or out whole

    float acc[MT][VEC];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

    __syncthreads();  // the previous item's sums have been read
    for (int g = g0 + warp; g < g1; g += kWarps) {
      stage_group<MT, U>(xs, G, lane, [&](int m, int j) {
        return m < rows ? load_x(m, g * G + j) : 0.f;
      });
      if (col_ok) group_dot<MT, U, true>(w.q, w.scale, N, G, g, col, xs, acc);
    }

    // the warps' sums, added in warp order, are this item's partial
    __syncthreads();
    put_warp_sums<MT>(sm, warp, lane, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * TILE_N; i += kThreads) {
      const int m = i / TILE_N;
      const int j = i % TILE_N;
      const int n = strip * TILE_N + strip_col(j);
      if (m < rows && n < N) partial[((size_t)ms * MT + m) * N + n] = sum_warps<MT>(sm, m, j);
    }

    // the block that draws the strip's last ticket adds the partials in
    // split order
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(&tickets[strip], 1) == nmat * ksplit - 1;
    __syncthreads();
    if (!*last) continue;
    __threadfence();
    for (int i = threadIdx.x; i < MT * TILE_N; i += kThreads) {
      const int m = i / TILE_N;
      const int n = strip * TILE_N + i % TILE_N;
      if (m >= rows || n >= N) continue;
      float t0 = 0.f, t1 = 0.f;
      for (int s = 0; s < ksplit; ++s)
        t0 += __ldcg(&partial[((size_t)(s * nmat) * MT + m) * N + n]);
      if (nmat == 2)
        for (int s = 0; s < ksplit; ++s)
          t1 += __ldcg(&partial[((size_t)(s * nmat + 1) * MT + m) * N + n]);
      epi(m, n, t0, t1);
    }
    if (threadIdx.x == 0) tickets[strip] = 0;
  }
}

// rstd[m] = 1 / rms of row m < rows, row[m][k] = load(m, k); 0 for the others
template <int MT, typename Load>
__device__ __forceinline__ void rows_rstd(float* rstd, int rows, int K, float eps, float* buf,
                                          Load load) {
  __syncthreads();  // the last phase is done with rstd and buf
  for (int m = 0; m < MT; ++m) {
    const float v = m < rows ? block_rstd(K, eps, buf, [&](int k) { return load(m, k); }) : 0.f;
    if (threadIdx.x == 0) rstd[m] = v;
  }
  __syncthreads();
}

// Blocks the compiler must fit on an SM (65,536 registers over 256 threads a
// block): three for one or two rows a thread (80 registers, no spills). Left
// alone the compiler takes 128 registers, two blocks fit, and a decode row is
// a fifth slower (PERF.md); four blocks (64 registers) spill and are slower
// than three. Two for more rows a thread.
template <int MT>
constexpr int kMinBlocks = MT <= 2 ? 3 : 2;

// shared memory of one block: the gemv phases' buffer, or (ATT) the
// attention phase's, which the barrier after it frees
template <int MT, bool ATT>
constexpr size_t kSmemBytes = ATT && sizeof(q8a::Smem) > kStripSmemFloats<MT> * sizeof(float)
                                  ? sizeof(q8a::Smem)
                                  : kStripSmemFloats<MT> * sizeof(float);

template <int MT, int U, bool ATT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT>) mlp_block_kernel(const Args a) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes<MT, ATT>];
  float* sm = reinterpret_cast<float*>(smem);
  __shared__ float rstd[MT];
  __shared__ int last;
  cg::grid_group grid = cg::this_grid();
  if constexpr (ATT) {
    for (int item = blockIdx.x; item < q8a::items(a.q8); item += gridDim.x)
      q8a::att_item(a.q8, item, *reinterpret_cast<q8a::Smem*>(smem));
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
      gemv_phase<MT, U>(
          &a.wo, 1, D, D, a.G0, a.ks0, rows, a.partial, a.tickets, sm, &last,
          [&](int m, int k) {
            const size_t i = row0 + (size_t)m * D + k;
            return round_bf16(ATT ? __ldcg(&a.att32[i]) : load_act(a.att, i, a.dtype));
          },
          [&](int m, int n, float t, float) { a.r[(size_t)m * D + n] = load_x(m, n) + t; });
      grid.sync();
    }

    rows_rstd<MT>(rstd, rows, D, a.eps, sm, load_r);
    gemv_phase<MT, U>(
        a.w13, 2, D, HD, a.G1, a.ks1, rows, a.partial, a.tickets, sm, &last,
        [&](int m, int k) {
          return round_bf16(load_r(m, k) * rstd[m] * load_act(a.rms_ffn, k, a.dtype));
        },
        [&](int m, int n, float h1, float h3) {
          a.hs[(size_t)m * HD + n] = h1 * (1.0f / (1.0f + expf(-h1))) * h3;
        });
    grid.sync();

    gemv_phase<MT, U>(
        &a.w2, 1, HD, D, a.G2, a.ks2, rows, a.partial, a.tickets, sm, &last,
        [&](int m, int k) { return round_bf16(__ldcg(&a.hs[(size_t)m * HD + k])); },
        [&](int m, int n, float t, float) {
          const float v = a.residual ? t + load_r(m, n) : t;
          store_act(a.out, row0 + (size_t)m * D + n, a.dtype, v);
          if (has_qkv) a.o32[(size_t)m * D + n] = v;
        });

    if (has_qkv) {
      grid.sync();
      auto load_o = [&](int m, int k) { return __ldcg(&a.o32[(size_t)m * D + k]); };
      rows_rstd<MT>(rstd, rows, D, a.eps, sm, load_o);
      gemv_phase<MT, U>(
          &a.wqkv, 1, D, a.Dq, a.Gq, a.ksq, rows, a.partial, a.tickets, sm, &last,
          [&](int m, int k) {
            return round_bf16(load_o(m, k) * rstd[m] * load_act(a.rms_att, k, a.dtype));
          },
          [&](int m, int n, float t, float) {
            store_act(a.qkv, (size_t)(m0 + m) * a.Dq + n, a.dtype, t);
          });
    }
    if (m0 + MT < a.M) grid.sync();  // the next pass reuses the workspace
  }
}

template <int MT, int U>
cudaError_t occupancy(int* blocks_per_sm, bool att) {
  return att ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, mlp_block_kernel<MT, U, true>, kThreads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, mlp_block_kernel<MT, U, false>, kThreads, 0);
}

template <int MT, int U>
cudaError_t launch(Args& a, int grid, cudaStream_t st) {
  void* params[] = {&a};
  const void* fn = a.att32 ? reinterpret_cast<const void*>(&mlp_block_kernel<MT, U, true>)
                           : reinterpret_cast<const void*>(&mlp_block_kernel<MT, U, false>);
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, 0, st);
}

cudaError_t launch_mt(Args& a, int mt, int grid, cudaStream_t st) {
  switch (mt) {
    case 1: return launch<1, 16>(a, grid, st);
    case 2: return launch<2, 16>(a, grid, st);
    case 4: return launch<4, 16>(a, grid, st);
    default: return launch<8, 8>(a, grid, st);
  }
}

bool bad_matrix(int K, int N, int G, int ksplit) {
  return K <= 0 || N <= 0 || G <= 0 || G > kMaxG || K % G != 0 || N % 4 != 0 || ksplit < 1 ||
         ksplit > K / G;
}

}  // namespace

// The most blocks of the kernel for `mt` rows a thread (1, 2, 4 or 8), with
// the attention phase (att != 0) or without, that are resident together on
// the current device: *blocks_per_sm times *sms. A cooperative launch takes
// no more. Returns a cudaError_t.
extern "C" int mlp_block_occupancy(int mt, int att, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  switch (mt) {
    case 1: return occupancy<1, 16>(blocks_per_sm, att);
    case 2: return occupancy<2, 16>(blocks_per_sm, att);
    case 4: return occupancy<4, 16>(blocks_per_sm, att);
    case 8: return occupancy<8, 8>(blocks_per_sm, att);
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
              int G0, int G1, int G2, int Gq, int ks0, int ks1, int ks2, int ksq, int mt, int grid,
              int residual, int rms_stacked, float eps, size_t* need, int* strips) {
  const bool has_wo = att != nullptr || att32 != nullptr, has_qkv = qkv != nullptr;
  if (layer < 0 || layer >= L || M <= 0 || grid < 1) return cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (mt != 1 && mt != 2 && mt != 4 && mt != 8) return cudaErrorInvalidValue;
  if (bad_matrix(D, HD, G1, ks1) || bad_matrix(HD, D, G2, ks2)) return cudaErrorInvalidValue;
  if (has_wo && bad_matrix(D, D, G0, ks0)) return cudaErrorInvalidValue;
  if (has_qkv && (bad_matrix(D, Dq, Gq, ksq) || rms_att == nullptr)) return cudaErrorInvalidValue;
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
  *need = (size_t)mt * (3 * d + hd + part);
  *strips = (std::max(std::max(D, HD), has_qkv ? Dq : 0) + TILE_N - 1) / TILE_N;
  a.r = static_cast<float*>(ws);
  a.hs = a.r + mt * d;
  a.o32 = a.hs + mt * hd;
  a.partial = a.o32 + mt * d;
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
//     phase's mt * N * matrices * ksplit; tickets: n_tickets >= the widest
//     matrix's 128-column strips, zero on entry, left zero.
//   ks0, ks1, ks2, ksq: blocks over the contraction of wo, w1/w3, w2, wqkv.
//   mt in {1, 2, 4, 8}: rows a thread; grid: blocks, at most what
//     mlp_block_occupancy reports.
// All tensors contiguous; x, att, rms_*, out, qkv share `dtype`. Returns the
// launch's cudaError_t.
extern "C" int mlp_block(const void* att, const void* x, const void* wo_q, const void* wo_s,
                         const void* rms_ffn, const void* w1_q, const void* w1_s,
                         const void* w3_q, const void* w3_s, const void* w2_q,
                         const void* w2_s, const void* rms_att, const void* wqkv_q,
                         const void* wqkv_s, void* out, void* qkv, void* ws, void* tickets,
                         long long ws_floats, int n_tickets, int dtype, int layer, int L, int M,
                         int D, int HD, int Dq, int G0, int G1, int G2, int Gq, int ks0, int ks1,
                         int ks2, int ksq, int mt, int grid, int residual, int rms_stacked,
                         float eps, void* stream) {
  Args a{};
  size_t need = 0;
  int strips = 0;
  int err = make_args(a, att, nullptr, x, wo_q, wo_s, rms_ffn, w1_q, w1_s, w3_q, w3_s, w2_q, w2_s,
                      rms_att, wqkv_q, wqkv_s, out, qkv, ws, tickets, dtype, layer, L, M, D, HD,
                      Dq, G0, G1, G2, Gq, ks0, ks1, ks2, ksq, mt, grid, residual, rms_stacked, eps,
                      &need, &strips);
  if (err != cudaSuccess) return err;
  if ((size_t)ws_floats < need || n_tickets < strips) return cudaErrorInvalidValue;
  return launch_mt(a, mt, grid, static_cast<cudaStream_t>(stream));
}

// The whole decode layer over the int8 KV cache in one cooperative launch
// (K13): the attention phase on qkv3 (M, H + 2 KVH, hs), pre-RoPE, with
// cos_il / sin_il (M, hs) float32 and pos (M,) int32 on the device, appending
// this step's quantized K/V rows and scales to layer `layer` of the caches
// k8 / v8 (L, M, KVH, S, hs) int8 and ks / vs (L, M, KVH, S) float32 in place;
// then mlp_block's phases with att from it (x, weights, rms_*, out, qkv as
// there; rms_* layer-stacked; qkv null for the last layer).
//   ws: float32 workspace of ws_floats >= mlp_block's need + M * D + items *
//     16 * (hs + 2), items = M * KVH * n_rg * nsplit, n_rg = ceil(H / KVH /
//     16); tickets: n_tickets >= the strips + M * KVH * n_rg, zero on entry,
//     left zero. D = H * hs. Returns the launch's cudaError_t.
extern "C" int layer_block(const void* qkv3, const void* cos_il, const void* sin_il, void* k8,
                           void* ks, void* v8, void* vs, const void* pos, const void* x,
                           const void* wo_q, const void* wo_s, const void* rms_ffn,
                           const void* w1_q, const void* w1_s, const void* w3_q,
                           const void* w3_s, const void* w2_q, const void* w2_s,
                           const void* rms_att, const void* wqkv_q, const void* wqkv_s,
                           void* out, void* qkv, void* ws, void* tickets, long long ws_floats,
                           int n_tickets, int dtype, int layer, int L, int M, int D, int HD,
                           int Dq, int G0, int G1, int G2, int Gq, int ks0, int ks1, int ks2,
                           int ksq, int mt, int grid, float eps, int H, int KVH, int S, int hs,
                           int nsplit, float scale, void* stream) {
  if (H <= 0 || KVH <= 0 || H % KVH != 0 || H * hs != D) return cudaErrorInvalidValue;
  if (!qkv3 || !cos_il || !sin_il || !k8 || !ks || !v8 || !vs || !pos) return cudaErrorInvalidValue;
  Args a{};
  size_t need = 0;
  int strips = 0;
  // att32 is placed after the gemv workspace below; any non-null value marks the wo phase here
  int err = make_args(a, nullptr, static_cast<const float*>(ws), x, wo_q, wo_s, rms_ffn, w1_q,
                      w1_s, w3_q, w3_s, w2_q, w2_s, rms_att, wqkv_q, wqkv_s, out, qkv, ws,
                      tickets, dtype, layer, L, M, D, HD, Dq, G0, G1, G2, Gq, ks0, ks1, ks2, ksq,
                      mt, grid, 1, 1, eps, &need, &strips);
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
  p.scale = scale;
  p.n_rg = (q8a::rows_per_head(q8a::kLayer, 1, H, KVH) + q8a::kRB - 1) / q8a::kRB;
  a.att32 = att32;
  const long long att_floats = ws_floats - (long long)need - (long long)M * D;
  err = q8a::check(p, att_floats, n_tickets - strips);
  if (err != cudaSuccess) return err;
  return launch_mt(a, mt, grid, static_cast<cudaStream_t>(stream));
}
