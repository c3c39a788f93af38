// INT8 dequant-matmul: y (M, N) = x (M, K) @ dequant(q (K, N) int8,
// scale (K/G, N) f32), with an optional rmsnorm prologue on x and an
// optional residual epilogue on y.
//
// Replaces llama2_tpu/ops/pallas/quant_matmul.py::quant_matmul and
// ::quant_matmul_stacked (the stacked form is the same kernel behind a
// 64-bit offset of layer * K * N into the weight stack).
//
// Two arithmetic modes, as the Pallas kernel has them:
//   accurate: w = float(q) * scale[g], float32 FMA, float32 accumulation;
//   fast:     x rounded to bf16; the products x * float(q) of one quant group
//             are summed in float32 (a bf16 x times an int8 w is exact in
//             float32, so this is the tensor-core sum up to its order), the
//             group's partial is then multiplied by the f32 scale and added
//             to the float32 accumulator. A group is never split between
//             threads, so only the order of additions inside a group is
//             this kernel's own.
//
// Bound on this card: bytes for the decode rows (M <= 8: every weight byte
// is read once and used M times), operations for a prefill chunk.
//
// M <= 8, gemv_kernel (its inner loops are q8_gemv.cuh, shared with the FFN
// kernels of mlp_block.cu): a thread owns 4 consecutive columns (one 4-byte load
// per weight row; N is the contiguous axis of q and scale, so a warp reads
// one 128-byte line per row) and all MT rows; a warp owns one quant group at
// a time and the 8 warps of a block interleave over the block's groups, each
// issuing U row loads before it converts any, so about 8 * U rows of a
// column strip are in flight. Wider loads (8 or 16 bytes a thread) measured
// slower: fewer, fatter warps hide less latency (PERF.md). The contraction
// is split over gridDim.y blocks so that every projection gives about three
// blocks an SM (N = 4096 has only 32 strips of 128 columns). Blocks run in
// no order, so nothing is accumulated across them with float atomics: each
// block writes its partial sums to scratch, an integer ticket per column
// strip finds the block that finishes last, and that block adds the partials
// in split order. The result is the same from run to run.
//
// M > 8: 64 x 128 output tiles from shared-memory tiles of x (already normed)
// and of the weights. Accurate mode, tiled_fma_kernel: the weights
// dequantized to float32, 4 x 8 outputs a thread, float32 FMA. Fast mode,
// tiled_mma_kernel: x and the weights as bf16, the products on the tensor
// cores (mma.sync m16n8k16, float32 accumulators), which is exactly the
// mode's arithmetic. wgmma and TMA-fed pipelines are later work.
//
// The rmsnorm prologue: on the TPU one grid step norms the row for all the
// steps that follow it; here every block recomputes its rows' mean square
// (K floats from L2), eps after the mean, in float32, times rms_w, and only
// then rounds to bf16 in fast mode.
#include <stdint.h>

#include "q8_gemv.cuh"

namespace {

using namespace llama2;

struct Args {
  const void* x;       // (M, K) activations, dtype
  const int8_t* q;     // (K, N)
  const float* scale;  // (K / G, N)
  const void* rms_w;   // (K,) dtype, or null
  const void* res;     // (M, N) dtype, or null
  void* out;           // (M, N) dtype
  float* partial;      // (ksplit, M, N) scratch when ksplit > 1
  int* tickets;        // one per column strip; zero on entry and on exit
  int M, K, N, G, dtype, ksplit, kc;
  float eps;
};

// 1 / sqrt(mean(x[m]^2) + eps) of row m, by the whole block; `buf` is shared
// scratch of at least kWarps floats. Every thread returns the value.
__device__ float row_rstd(const Args& a, int m, float* buf) {
  return block_rstd(a.K, a.eps, buf,
                    [&](int k) { return load_act(a.x, (size_t)m * a.K + k, a.dtype); });
}

__device__ __forceinline__ void finish(const Args& a, int m, int n, float t) {
  const size_t i = (size_t)m * a.N + n;
  if (a.res != nullptr) t += load_act(a.res, i, a.dtype);
  store_act(a.out, i, a.dtype, t);
}

// MT rows a thread, U weight rows loaded ahead (q8_gemv.cuh)
template <int MT, int U, bool FAST>
__global__ void __launch_bounds__(kThreads) gemv_kernel(const Args a) {
  __shared__ float sm[kStripSmemFloats<MT>];
  __shared__ float rstd[MT];
  __shared__ int last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * TILE_N + lane * VEC;
  const bool col_ok = col < a.N;  // N % 4 == 0: a thread's columns are in or out whole
  const int KG = a.K / a.G;
  const int per = (KG + a.ksplit - 1) / a.ksplit;
  const int g0 = blockIdx.y * per;
  const int g1 = min(KG, g0 + per);
  const bool norm = a.rms_w != nullptr;

  if (norm) {
    for (int m = 0; m < MT; ++m) {
      const float r = m < a.M ? row_rstd(a, m, sm) : 0.f;
      if (threadIdx.x == 0) rstd[m] = r;
    }
    __syncthreads();
  }

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  float* xs = sm + warp * MT * kMaxG;
  for (int g = g0 + warp; g < g1; g += kWarps) {
    stage_group<MT, U>(xs, a.G, lane, [&](int m, int j) {
      if (m >= a.M) return 0.f;
      const int k = g * a.G + j;
      float v = load_act(a.x, (size_t)m * a.K + k, a.dtype);
      if (norm) v = v * rstd[m] * load_act(a.rms_w, k, a.dtype);
      return FAST ? round_bf16(v) : v;
    });
    if (col_ok) group_dot<MT, U, FAST>(a.q, a.scale, a.N, a.G, g, col, xs, acc);
  }

  // the warps' sums, added in warp order
  __syncthreads();
  put_warp_sums<MT>(sm, warp, lane, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < MT * TILE_N; i += kThreads) {
    const int m = i / TILE_N;
    const int j = i % TILE_N;
    const int n = blockIdx.x * TILE_N + strip_col(j);
    if (m >= a.M || n >= a.N) continue;
    const float t = sum_warps<MT>(sm, m, j);
    if (a.ksplit == 1)
      finish(a, m, n, t);
    else
      a.partial[((size_t)blockIdx.y * a.M + m) * a.N + n] = t;
  }
  if (a.ksplit == 1) return;

  // the block that draws the last ticket of its column strip adds the
  // splits' partial sums in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&a.tickets[blockIdx.x], 1) == a.ksplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < MT * TILE_N; i += kThreads) {
    const int m = i / TILE_N;
    const int n = blockIdx.x * TILE_N + i % TILE_N;
    if (m >= a.M || n >= a.N) continue;
    float t = 0.f;
    for (int sidx = 0; sidx < a.ksplit; ++sidx)
      t += __ldcg(&a.partial[((size_t)sidx * a.M + m) * a.N + n]);
    finish(a, m, n, t);
  }
  if (threadIdx.x == 0) a.tickets[blockIdx.x] = 0;
}

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int kMaxKC = 32;   // rows of K per shared-memory tile
constexpr int XS_LD = BM + 4;  // keeps float4 reads aligned

// The rows' 1 / rms of a 64-row tile, for the rmsnorm prologue.
__device__ void tile_rstd(const Args& a, int m0, float* rstd, float* red) {
  for (int mm = 0; mm < BM; ++mm) {
    const float r = m0 + mm < a.M ? row_rstd(a, m0 + mm, red) : 0.f;
    if (threadIdx.x == 0) rstd[mm] = r;
  }
  __syncthreads();
}

// Accurate mode for M > 8: float32 FMA. N % 4 == 0; kc divides G, kc <= kMaxKC.
__global__ void __launch_bounds__(kThreads) tiled_fma_kernel(const Args a) {
  __shared__ __align__(16) float xs[kMaxKC][XS_LD];  // [k][m]
  __shared__ __align__(16) float ws[kMaxKC][BN];     // [k][n]
  __shared__ float rstd[BM];
  __shared__ float red[kWarps];

  const int tx = threadIdx.x & 15;   // columns tx*4..+3 and 64+tx*4..+3
  const int ty = threadIdx.x >> 4;   // rows ty*4..+3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KG = a.K / a.G;
  const bool norm = a.rms_w != nullptr;
  if (norm) tile_rstd(a, m0, rstd, red);

  float acc[4][8], part[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = part[i][c] = 0.f;

  for (int g = 0; g < KG; ++g) {
    for (int c0 = 0; c0 < a.G; c0 += a.kc) {
      const int k0 = g * a.G + c0;
      __syncthreads();
      // x tile: consecutive threads along k
      for (int e = threadIdx.x; e < BM * a.kc; e += kThreads) {
        const int kk = e % a.kc;
        const int mm = e / a.kc;
        float v = 0.f;
        if (m0 + mm < a.M) {
          v = load_act(a.x, (size_t)(m0 + mm) * a.K + k0 + kk, a.dtype);
          if (norm) v = v * rstd[mm] * load_act(a.rms_w, k0 + kk, a.dtype);
        }
        xs[kk][mm] = v;
      }
      // weight tile, dequantized: 4 int8 a thread, 32 threads a row
      for (int e = threadIdx.x; e < a.kc * (BN / 4); e += kThreads) {
        const int kk = e / (BN / 4);
        const int cw = e % (BN / 4);
        const int n = n0 + cw * 4;
        float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < a.N) {
          const uint32_t word = load_word(a.q + (size_t)(k0 + kk) * a.N + n);
          const float4 s4 =
              __ldg(reinterpret_cast<const float4*>(a.scale + (size_t)g * a.N + n));
          w4 = make_float4(byte_f32(word, 0) * s4.x, byte_f32(word, 1) * s4.y,
                           byte_f32(word, 2) * s4.z, byte_f32(word, 3) * s4.w);
        }
        *reinterpret_cast<float4*>(&ws[kk][cw * 4]) = w4;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < a.kc; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) part[i][c] = fmaf(ar[i], br[c], part[i][c]);
      }
    }
    // a group is summed apart and then added to the accumulator: this keeps
    // the float32 rounding of a long K from walking as one sequential sum does
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[i][c] += part[i][c];
        part[i][c] = 0.f;
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + 64 * (c >> 2) + tx * 4 + (c & 3);
      if (n < a.N) finish(a, m, n, acc[i][c]);
    }
  }
}

// D (16 x 8, f32) += A (16 x 16, bf16, row-major) * B (16 x 8, bf16, "col").
// With g = lane / 4 and t = lane % 4, a lane holds
//   a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1], a[2] = A[g][2t+8, 2t+9],
//   a[3] = A[g+8][2t+8, 2t+9]; b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g];
//   d[0], d[1] = D[g][2t, 2t+1]; d[2], d[3] = D[g+8][2t, 2t+1]
// (two bf16 a register, the lower index in the lower half).
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices from shared memory, one fragment register each:
// lane l passes the address of row l % 8 of matrix l / 8 (16 bytes) and gets
// elements [l / 4][2 (l % 4), +1] of every matrix; with `trans`, elements
// [2 (l % 4), +1][l / 4], i.e. a pair down a column.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int MMA_KC = 64;         // rows of K per shared-memory tile
constexpr int XB_LD = MMA_KC + 8;  // bf16 x tile row: 36 words, conflict-free ldmatrix
constexpr int WB_LD = BN + 8;      // bf16 w tile row: 68 words, conflict-free ldmatrix

// Fast mode for M > 8: bf16 tensor-core products (mma.sync), float32 sums.
// x rounded to bf16 and the int8 weights converted to bf16 (exact) sit in
// shared memory; the 8 warps are 2 x 4 over the 64 x 128 tile, 32 x 32 each
// (2 x 4 mma tiles, fragments through ldmatrix). A group's products are summed
// in `part` by the tensor cores; at the group's end `part` times the f32 scale
// is added to `acc`. A group that is no multiple of 16 rows is padded with
// zero rows. The next tile's global loads are issued into registers before
// the current tile's products, so that memory latency and the tensor cores
// overlap; a thread fetches 16 k of one x row and 32 columns of one w row.
__global__ void __launch_bounds__(kThreads) tiled_mma_kernel(const Args a) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][XB_LD];      // [m][k]
  __shared__ __align__(16) __nv_bfloat16 ws[MMA_KC][WB_LD];  // [k][n]
  __shared__ float rstd[BM];
  __shared__ float red[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32;  // the warp's rows in the tile
  const int wn = (warp & 3) * 32;   // and columns
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KG = a.K / a.G;
  const int tiles_per_group = (a.G + MMA_KC - 1) / MMA_KC;
  const int n_tiles = KG * tiles_per_group;
  const bool norm = a.rms_w != nullptr;
  if (norm) tile_rstd(a, m0, rstd, red);

  // this thread's share of a tile's loads
  const int fr = threadIdx.x >> 2;         // x row, and w row (k)
  const int xk = (threadIdx.x & 3) * 16;   // first k of its 16 x elements
  const int wc = (threadIdx.x & 3) * 32;   // first column of its 32 weights
  uint32_t xq[8], wq[8];                   // packed bf16 x, raw int8 w

  auto fetch = [&](int tile) {
    const int g = tile / tiles_per_group;
    const int c0 = (tile % tiles_per_group) * MMA_KC;
    const int k0 = g * a.G + c0;
    const int rows = min(MMA_KC, a.G - c0);
    const bool row_ok = m0 + fr < a.M;
    const size_t xbase = (size_t)(m0 + fr) * a.K + k0 + xk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = xk + 2 * j + h;
        v[h] = 0.f;
        if (row_ok && kk < rows) {
          v[h] = load_act(a.x, xbase + 2 * j + h, a.dtype);
          if (norm) v[h] = v[h] * rstd[fr] * load_act(a.rms_w, k0 + kk, a.dtype);
        }
      }
      xq[j] = pack_bf16(v[0], v[1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + wc + 4 * j;
      wq[j] = (fr < rows && n < a.N) ? load_word(a.q + (size_t)(k0 + fr) * a.N + n) : 0u;
    }
  };
  auto stage = [&]() {
    uint4* xd = reinterpret_cast<uint4*>(&xs[fr][xk]);
    xd[0] = make_uint4(xq[0], xq[1], xq[2], xq[3]);
    xd[1] = make_uint4(xq[4], xq[5], xq[6], xq[7]);
    uint4* wd = reinterpret_cast<uint4*>(&ws[fr][wc]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w0 = wq[2 * j], w1 = wq[2 * j + 1];
      wd[j] = make_uint4(pack_bf16(byte_f32(w0, 0), byte_f32(w0, 1)),
                         pack_bf16(byte_f32(w0, 2), byte_f32(w0, 3)),
                         pack_bf16(byte_f32(w1, 0), byte_f32(w1, 1)),
                         pack_bf16(byte_f32(w1, 2), byte_f32(w1, 3)));
    }
  };

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = part[mi][ni][i] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  // ldmatrix rows of this lane: matrix lane / 8, row lane % 8
  const int lr = lane & 7;
  const int lm = lane >> 3;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) fetch(tile + 1);
    const int g = tile / tiles_per_group;
    const int c0 = (tile % tiles_per_group) * MMA_KC;
    const int steps = (min(MMA_KC, a.G - c0) + 15) / 16;  // rows past the group are 0
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // matrices: (rows, k), (rows + 8, k), (rows, k + 8), (rows + 8, k + 8)
        ldmatrix_x4(af[mi], &xs[wm + mi * 16 + (lm & 1) * 8 + lr][ks * 16 + (lm >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // matrices: (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
        uint32_t r[4];
        ldmatrix_x4_trans(r, &ws[ks * 16 + (lm & 1) * 8 + lr][wn + np * 16 + (lm >> 1) * 8]);
        bf[2 * np][0] = r[0]; bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2]; bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_m16n8k16_bf16(part[mi][ni], af[mi], bf[ni]);
    }
    if (tile % tiles_per_group == tiles_per_group - 1) {  // the group's last tile
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * (lane & 3);  // this lane's columns n, n + 1
        float2 s2 = make_float2(0.f, 0.f);
        if (n < a.N) s2 = __ldg(reinterpret_cast<const float2*>(a.scale + (size_t)g * a.N + n));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][0] = fmaf(part[mi][ni][0], s2.x, acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(part[mi][ni][1], s2.y, acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(part[mi][ni][2], s2.x, acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(part[mi][ni][3], s2.y, acc[mi][ni][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mi][ni][i] = 0.f;
        }
      }
    }
    __syncthreads();  // every warp is done with this tile
    if (tile + 1 < n_tiles) stage();
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm + mi * 16 + (lane >> 2) + 8 * (i >> 1);
        const int n = n0 + wn + ni * 8 + 2 * (lane & 3) + (i & 1);
        if (m < a.M && n < a.N) finish(a, m, n, acc[mi][ni][i]);
      }
}

template <int MT, int U>
cudaError_t launch_gemv(const Args& a, bool fast, cudaStream_t st) {
  const dim3 grid((a.N + TILE_N - 1) / TILE_N, a.ksplit);
  if (fast)
    gemv_kernel<MT, U, true><<<grid, kThreads, 0, st>>>(a);
  else
    gemv_kernel<MT, U, false><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run(Args a, int mode, int mt, cudaStream_t st) {
  if (a.M <= 0 || a.K <= 0 || a.N <= 0 || a.G <= 0 || a.K % a.G != 0 || a.N % 4 != 0)
    return cudaErrorInvalidValue;
  if ((a.dtype != kF32 && a.dtype != kBF16) || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  const bool fast = mode == 1;
  if (mt == 0) {  // tiled
    const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
    if (fast) {
      tiled_mma_kernel<<<grid, kThreads, 0, st>>>(a);
    } else {
      if (a.kc <= 0 || a.kc > kMaxKC || a.G % a.kc != 0) return cudaErrorInvalidValue;
      tiled_fma_kernel<<<grid, kThreads, 0, st>>>(a);
    }
    return cudaGetLastError();
  }
  if (a.M > mt || a.G > kMaxG || a.ksplit < 1 || a.ksplit > a.K / a.G)
    return cudaErrorInvalidValue;
  if (a.ksplit > 1 && (a.partial == nullptr || a.tickets == nullptr))
    return cudaErrorInvalidValue;
  switch (mt) {
    case 1: return launch_gemv<1, 16>(a, fast, st);
    case 2: return launch_gemv<2, 16>(a, fast, st);
    case 4: return launch_gemv<4, 16>(a, fast, st);
    case 8: return launch_gemv<8, 8>(a, fast, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K); q (K, N) int8; scale (K/G, N) f32; out (M, N). x, rms_w (K,),
// res (M, N) and out share `dtype`; rms_w and res may be null. mode: 0
// accurate, 1 fast. mt in {1, 2, 4, 8} picks the decode-row kernel (mt >= M
// rows a thread, ksplit blocks over K, with `partial` (ksplit, M, N) f32 and
// zeroed `tickets`, one per 128 columns); mt = 0 picks the tiled kernels (kc
// rows of K a tile in accurate mode). N % 4 == 0. All contiguous. Returns
// the launch's cudaError_t.
extern "C" int quant_matmul(const void* x, const void* q, const void* scale,
                            const void* rms_w, const void* res, void* out,
                            void* partial, void* tickets, int dtype, int mode,
                            int M, int K, int N, int G, int mt, int ksplit,
                            int kc, float eps, void* stream) {
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale),
         rms_w, res, out, static_cast<float*>(partial), static_cast<int*>(tickets),
         M, K, N, G, dtype, ksplit, kc, eps};
  return run(a, mode, mt, static_cast<cudaStream_t>(stream));
}

// The same on layer `layer` of q (L, K, N) and scale (L, K/G, N).
extern "C" int quant_matmul_stacked(const void* x, const void* q, const void* scale,
                                    const void* rms_w, const void* res, void* out,
                                    void* partial, void* tickets, int dtype,
                                    int mode, int layer, int L, int M, int K, int N,
                                    int G, int mt, int ksplit, int kc, float eps,
                                    void* stream) {
  if (layer < 0 || layer >= L || K <= 0 || N <= 0 || G <= 0 || K % G != 0)
    return cudaErrorInvalidValue;
  const size_t l = static_cast<size_t>(layer);
  Args a{x,
         static_cast<const int8_t*>(q) + l * (size_t)K * (size_t)N,
         static_cast<const float*>(scale) + l * (size_t)(K / G) * (size_t)N,
         rms_w, res, out, static_cast<float*>(partial), static_cast<int*>(tickets),
         M, K, N, G, dtype, ksplit, kc, eps};
  return run(a, mode, mt, static_cast<cudaStream_t>(stream));
}
