// INT8 dequant-matmul: y (M, N) = x (M, K) @ dequant(q (K, N) int8,
// scale (K/G, N) f32), with an optional rmsnorm prologue on x and an
// optional residual epilogue on y.
//
// Replaces llama2_tpu/ops/pallas/quant_matmul.py::quant_matmul and
// ::quant_matmul_stacked (the stacked form is the same kernel behind a
// 64-bit offset of layer * K * N into the weight stack).
//
// Two arithmetic modes, as the Pallas kernel has them:
//   accurate: y = x @ (float(q) * scale[g]) to float32 accuracy. The decode
//             rows take float32 FMA with float32 accumulation; the M > 8
//             tile sums each quant group's products as fast mode does, with
//             x cut into three bf16 planes whose sum is x (below);
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
// M > 8, both modes, tiled_wgmma_kernel (a prefill chunk: M = 201 on the main
// path). The mma.sync tile it replaces ran w13 (4096 x 22016) at M = 201 in
// 0.69 ms, 5% of the bf16 peak: 64 x 128 tiles cut M = 201 into 4 row tiles
// (every weight byte read and converted 4 times, the last tile 9/64 live), 4
// ldmatrix for every 8 products, one register-staged prefetch. Bound at that
// shape: bf16 operations, 36 GFLOP over 989 TFLOP/s = 0.037 ms, against 0.028
// for the weight bytes. Design: a block computes a 128 x 128 output tile, so
// M = 201 is 2 row tiles (side by side in the grid, sharing each weight tile
// in L2). Its two multiplying warpgroups take 64 rows each with
// wgmma.mma_async m64n128k16 (bf16 from shared memory, float32
// accumulators); its two converting warpgroups turn each raw int8 weight
// tile into bf16 once (a PRMT, two LOP3 and a bf16x2 subtraction for two
// values, exact) in the 128-byte swizzled K-major layout wgmma reads. Tiles
// of 64 K rows (x rows, raw weights, a group's scales) come by TMA into a
// 5-stage ring passed on by mbarriers (loaded, then converted); the last
// multiplying warp to finish a stage refills it, so loads run 4 tiles ahead
// and nobody waits to issue them. Register counts are moved to the
// multipliers (setmaxnreg). A quant group's products accumulate in `part`;
// at the group's end the warpgroup waits for them and adds part * scale[g]
// to `acc` in group order (a group that is no multiple of 16 rows is
// zero-padded). N = 4096 gives 64 tiles at M = 201, so K is split over
// blocks by whole groups until 132 blocks run; the splits' partials go to
// scratch and the block that draws the last ticket adds them in split order
// (no float atomics: equal bits on rerun). x rows are read as they are when
// bf16 with no prologue; otherwise a first launch (prep_x_kernel) norms and
// rounds them once into the workspace. What bounds it now (clock64 phase
// profiles on the card, PERF.md): the data, 24.5 KB a tile and block from
// L2 (x is read again for every column tile), then the conversion, not the
// multiplies.
//
// Accurate mode on the same tile (PLANES = 3). An int8 weight is exact in
// bf16, so y = sum_g scale[g] sum_{k in g} x_k q_k needs only x at float32
// accuracy: prep_x_kernel cuts each float32 x into three bf16 planes, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference is
// exact in float32; hi + mid + lo = x but for values near the float32
// underflow), and the multipliers run their wgmma over all three against the
// same converted weight tile into one `part`, promoted per group as in fast
// mode. Three x tiles a stage leave room for a 3-stage ring (5 stages with
// one plane). The float32 FMA tile this replaces ran w13 at M = 201 in 2.39
// ms, 15 TFLOP/s. A bf16 x with no prologue is one exact plane: accurate mode
// then runs the fast tile's arithmetic, which is the same function.
//
// The rmsnorm prologue: on the TPU one grid step norms the row for all the
// steps that follow it; here every block of the decode-row kernel
// recomputes its rows' mean square (K floats from L2), and prep_x_kernel
// computes it once a row with the same block reduction: eps after the mean,
// in float32, times rms_w, and only then rounded to bf16 (fast mode) or cut
// into planes (accurate).
#include <cuda.h>
#include <stdint.h>

#include "mma.cuh"
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
  int* tickets;        // one per column strip or output tile; zero on entry and on exit
  __nv_bfloat16* xt;   // the wgmma tile's prologue output, or null (x read as it is)
  int M, K, N, G, dtype, ksplit, planes;  // planes: the wgmma tile's bf16 planes of x
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

// ---- M > 8: the wgmma tile ----

using bf16 = __nv_bfloat16;

constexpr int WG_BM = 128;  // rows a block: two multiplying warpgroups of 64
constexpr int WG_BN = 128;  // columns a block
constexpr int WG_BK = 64;   // rows of K a tile: one 128-byte swizzle row of bf16
constexpr int WG_WARPS = 16;  // 8 multiplying (two warpgroups), 8 converting
constexpr int WG_THREADS = 32 * WG_WARPS;
constexpr int A_BYTES = WG_BM * WG_BK * 2;  // x tile (one plane), bf16
constexpr int B_BYTES = WG_BN * WG_BK * 2;  // weight tile, bf16
constexpr int W_BYTES = WG_BK * WG_BN;      // weight tile, raw int8

// The ring of a tile with PLANES x planes: its stages, and its dynamic
// shared memory (a stage's x tiles, bf16 and raw weight tiles, scales, two
// mbarriers and a counter; 1 KB of alignment slack)
template <int PLANES>
struct Ring {
  static constexpr int kStages = PLANES == 1 ? 5 : 3;
  static constexpr int kSmem =
      kStages * (PLANES * A_BYTES + B_BYTES + W_BYTES + WG_BN * 4 + 2 * 8 + 4) + 1024;
};

// A shared-memory matrix descriptor of wgmma for a K-major tile in the
// 128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes
// apart; the tile starts on a 1024-byte boundary, a k16 step 32 bytes in.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of element (row, k) of a K-major 128-byte-swizzled tile whose
// 16-byte chunk is k / 8: chunk c of row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ int sw128_off(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// d (64 x 128, f32; this thread's 64 values) (+)= A (64 x 16) B (16 x 128),
// both bf16 in shared memory, K-major; scale_d 0 ignores d's old values.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The prologue: x rows normed (float32, eps after the mean, times rms_w),
// cut into `planes` bf16 planes (one: bf16(x); three: hi, mid, lo, see the
// header), laid out by K tile: row m of plane p is row p * M + m, holding, for
// tile t = (group g, chunk c), the group's rows 64c..64c+63 at columns
// 64t.., zero past the group. One block a row. The rstd is the decode-row
// kernel's (block_rstd).
__global__ void __launch_bounds__(kThreads) prep_x_kernel(const Args a, bf16* xt, int tpg) {
  __shared__ float red[kWarps];
  const int m = blockIdx.x;
  const bool norm = a.rms_w != nullptr;
  const float rstd = norm ? row_rstd(a, m, red) : 0.f;
  const int width = a.K / a.G * tpg * WG_BK;
  const size_t plane = (size_t)a.M * width;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const int t = i / WG_BK;
    const int kk = WG_BK * (t % tpg) + i % WG_BK;  // row within the group
    float v = 0.f;
    if (kk < a.G) {
      const int k = (t / tpg) * a.G + kk;
      v = load_act(a.x, (size_t)m * a.K + k, a.dtype);
      if (norm) v = v * rstd * load_act(a.rms_w, k, a.dtype);
    }
    bf16* dst = xt + (size_t)m * width + i;
    const bf16 hi = __float2bfloat16_rn(v);
    dst[0] = hi;
    if (a.planes == 3) {
      const float r = v - __bfloat162float(hi);
      const bf16 mid = __float2bfloat16_rn(r);
      dst[plane] = mid;
      dst[2 * plane] = __float2bfloat16_rn(r - __bfloat162float(mid));
    }
  }
}

// Eight int8 rows of one weight column, byte c of words w[0..7], as 8 bf16
// (the lower row in the lower half), exactly (int8_pair_bf16).
__device__ __forceinline__ uint4 column_bf16(const uint32_t (&w)[8], int c) {
  const uint32_t sel = 0x0400u + static_cast<uint32_t>(c) * 0x0101u;  // bytes c and 4 + c
  uint32_t r[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) r[p] = int8_pair_bf16(w[2 * p], w[2 * p + 1], sel);
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// mbarrier helpers: arrivals, the asynchronous arrival of this thread's
// cp.async copies, the transaction count of a TMA copy, and a wait on the
// completion of the phase with parity `parity`
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D box of a tensor map at (col, row) into shared memory by the tensor
// memory accelerator, its bytes counted on `bar`; parts past the tensor arrive
// as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int col, int row,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// The tensor maps of one launch: x's bf16 rows, its planes one above the
// other (128 x 64 boxes, 128-byte swizzle), the int8 weights (64 x 128 boxes) and the scales (1 x 128);
// the weights' map is unused (cp.async instead) where N % 16 != 0.
struct Maps {
  CUtensorMap x, q, scale;
};

// M > 8 (see the header): a block computes a 128 x 128 output tile over the
// quant groups of its K split. Warpgroups 0 and 1 take 64 rows each and
// multiply (wgmma, every x plane against the same weight tile) and promote;
// warpgroups 2 and 3 convert the raw int8 weight tiles to bf16. Per stage
// PLANES x tiles, the raw weight tile and,
// with a group's last tile, its scales come by TMA, issued by one lane (the
// weights by cp.async from a warp where N % 16 != 0): for the first stages
// by thread 0, then for tile i + WG_STAGES by the multiplying warp that is
// the last to finish tile i (a counter a stage finds it), so no warp waits
// to refill a stage. Stage s passes to the converters through `loaded[s]`
// (the copies landed) and to the multipliers through `ready[s]`
// (converted). tpg: tiles a group, cdiv(G, 64).
template <int PLANES>
__global__ void __launch_bounds__(WG_THREADS, 1)
    tiled_wgmma_kernel(const Args a, const __grid_constant__ Maps maps, int tpg) {
  constexpr int WG_STAGES = Ring<PLANES>::kStages;
  constexpr int X_BYTES = PLANES * A_BYTES;  // a stage's x tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sA = base;                          // [stage][plane] x tiles, swizzled
  unsigned char* sB = sA + WG_STAGES * X_BYTES;      // [stage] weight tiles, bf16, swizzled
  unsigned char* sW = sB + WG_STAGES * B_BYTES;      // [stage] weight tiles, raw int8
  float* sS = reinterpret_cast<float*>(sW + WG_STAGES * W_BYTES);  // [stage][128] scales
  uint64_t* loaded = reinterpret_cast<uint64_t*>(sS + WG_STAGES * WG_BN);
  uint64_t* ready = loaded + WG_STAGES;
  int* done = reinterpret_cast<int*>(ready + WG_STAGES);  // [stage] warps done with it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int m0 = blockIdx.x * WG_BM;
  const int n0 = blockIdx.y * WG_BN;
  const int KG = a.K / a.G;
  const int per = (KG + a.ksplit - 1) / a.ksplit;  // groups a split
  const int g_begin = blockIdx.z * per;
  const int t_begin = g_begin * tpg;
  const int n_tiles = (min(KG, g_begin + per) - g_begin) * tpg;
  const bool wide = a.N % 16 == 0;  // the weights by TMA

  // tile i into stage i % WG_STAGES, by one warp: lane 0 issues the TMA
  // copies; where N % 16 != 0 the warp copies the weights (4 bytes a lane)
  auto issue = [&](int i) {
    const int s = i % WG_STAGES, t = t_begin + i;
    const int g = t / tpg, c = t % tpg;
    if (lane == 0) {
      const bool last = c == tpg - 1;  // with a group's last tile, its scales
      mbar_arrive_tx(&loaded[s], X_BYTES + (wide ? W_BYTES : 0) + (last ? WG_BN * 4 : 0));
      // plane p's rows start at p * M: a tile's rows past M are the next
      // plane's (or zeros past the last) and reach only rows never stored
      for (int p = 0; p < PLANES; ++p)
        tma_box(sA + s * X_BYTES + p * A_BYTES, &maps.x, t * WG_BK, p * a.M + m0, &loaded[s]);
      if (wide) tma_box(sW + s * W_BYTES, &maps.q, n0, g * a.G + WG_BK * c, &loaded[s]);
      if (last) tma_box(sS + s * WG_BN, &maps.scale, n0, g, &loaded[s]);
    }
    if (!wide) {  // columns past N arrive as zeros
      const int rows = min(WG_BK, a.G - WG_BK * c);
      const size_t k0 = (size_t)g * a.G + WG_BK * c;
      unsigned char* dW = sW + s * W_BYTES;
      for (int e = lane; e < rows * 32; e += 32) {
        const int kk = e >> 5, n = n0 + (e & 31) * 4;
        const bool ok = n < a.N;
        cp_async4(dW + e * 4, ok ? a.q + (k0 + kk) * a.N + n : a.q, ok ? 4 : 0);
      }
      mbar_arrive_cp_async(&loaded[s]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      // the issuing lane's arrival (with the bytes), and where N % 16 != 0
      // the issuing warp's cp.async copies
      mbar_init(&loaded[s], wide ? 1 : 1 + 32);
      mbar_init(&ready[s], 256);  // the converting warps
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < min(n_tiles, WG_STAGES); ++i) issue(i);

  if (wg >= 2) {  // ---- the converting warps
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    // warps 8..15: weight tile j to bf16, K-major; warp 8 + ko converts rows
    // 8ko..8ko+7, lane l columns 4l..4l+3, one column (16 bytes) a store,
    // taken in a rotated order so that the 8 lanes of a store phase hit 8
    // distinct chunks. Rows past the group (another group's, or stale) are
    // stored as zeros.
    const int ko = warp - 8;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % WG_STAGES;
      const int rows = min(WG_BK, a.G - WG_BK * ((t_begin + j) % tpg));
      mbar_wait(&loaded[s], (j / WG_STAGES) & 1);
      const unsigned char* src = sW + s * W_BYTES + ko * 8 * 128 + lane * 4;
      uint32_t w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        w[r] = ko * 8 + r < rows ? *reinterpret_cast<const uint32_t*>(src + r * 128) : 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cc = (q + (lane >> 1)) & 3;
        const int n = 4 * lane + cc;
        *reinterpret_cast<uint4*>(sB + s * B_BYTES + sw128_off(n, ko)) = column_bf16(w, cc);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&ready[s]);
    }
    return;
  }

  // ---- the multipliers: warpgroup wg, rows m0 + 64 wg ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % WG_STAGES;
    const int c = (t_begin + i) % tpg;
    mbar_wait(&ready[s], (i / WG_STAGES) & 1);
    // every warpgroup issues all 4 k16 steps of every plane with no branch
    // around them (ptxas serializes wgmma in a divergent path); rows past
    // the group are zeros
    const uint32_t db = smem_u32(sB + s * B_BYTES);
    fence_operands(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const uint32_t da = smem_u32(sA + s * X_BYTES + p * A_BYTES + wg * (A_BYTES / 2));
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks)
        wgmma_m64n128k16(part, sw128_desc(da + 32 * ks), sw128_desc(db + 32 * ks),
                         (p > 0 || ks > 0 || c > 0) ? 1 : 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    const bool last = c == tpg - 1;
    float2 s2[16];  // at the group's end its scales, read while the products run
    if (last) {
      const float* sc = sS + s * WG_BN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 16; ++j) s2[j] = *reinterpret_cast<const float2*>(sc + 8 * j);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(part);
    if (last) {  // the group's end: acc += part * scale, in group order
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j] = fmaf(part[4 * j], s2[j].x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(part[4 * j + 1], s2[j].y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(part[4 * j + 2], s2[j].x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(part[4 * j + 3], s2[j].y, acc[4 * j + 3]);
      }
    }
    // the last of the 8 multiplying warps to finish tile i refills its stage
    __syncwarp();
    int before = 0;
    if (lane == 0) {
      __threadfence_block();
      before = atomicAdd(&done[s], 1);
    }
    if (__shfl_sync(0xffffffffu, before, 0) == 7) {
      __threadfence_block();
      if (lane == 0) done[s] = 0;
      if (i + WG_STAGES < n_tiles) issue(i + WG_STAGES);
    }
  }

  // acc[4j + i] is row 16 (warp % 4) + lane / 4 + 8 (i / 2) of the
  // warpgroup's 64, column 8j + 2 (lane % 4) + i % 2
  const bool live = m0 + 64 * wg < a.M;  // this warpgroup has rows to store
  const int mr = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int nc = n0 + 2 * (lane & 3);
  if (a.ksplit == 1) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mr + 8 * (i >> 1), n = nc + 8 * j + (i & 1);
        if (m < a.M && n < a.N) finish(a, m, n, acc[4 * j + i]);
      }
    return;
  }
  // split K: the partial sums to scratch; the block that draws the last
  // ticket of its output tile adds the splits in split order (the two
  // multiplying warpgroups meet at named barrier 1)
  if (live) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int m = mr + 8 * (i >> 1), n = nc + 8 * j;
        if (m < a.M && n < a.N)
          *reinterpret_cast<float2*>(&a.partial[((size_t)blockIdx.z * a.M + m) * a.N + n]) =
              make_float2(acc[4 * j + i], acc[4 * j + i + 1]);
      }
  }
  __shared__ int last;
  const int ticket = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (tid == 0) last = atomicAdd(&a.tickets[ticket], 1) == a.ksplit - 1;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (!last) return;
  __threadfence();
  for (int e = tid; e < WG_BM * WG_BN; e += 256) {
    const int m = m0 + e / WG_BN, n = n0 + e % WG_BN;
    if (m >= a.M || n >= a.N) continue;
    float t = 0.f;
    for (int sidx = 0; sidx < a.ksplit; ++sidx)
      t += __ldcg(&a.partial[((size_t)sidx * a.M + m) * a.N + n]);
    finish(a, m, n, t);
  }
  if (tid == 0) a.tickets[ticket] = 0;
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

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <int PLANES>
cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  const int KG = a.K / a.G;
  const int tpg = (a.G + WG_BK - 1) / WG_BK;
  const int per = a.ksplit >= 1 ? (KG + a.ksplit - 1) / a.ksplit : 0;
  if (a.ksplit < 1 || (a.ksplit - 1) * per >= KG) return cudaErrorInvalidValue;
  if (a.ksplit > 1 && (a.partial == nullptr || a.tickets == nullptr)) return cudaErrorInvalidValue;
  const bf16* xa = a.xt;
  int xa_ld = KG * tpg * WG_BK;
  if (a.xt != nullptr) {
    prep_x_kernel<<<a.M, kThreads, 0, st>>>(a, a.xt, tpg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  } else {  // bf16 rows read as they are: tile t is columns 64t..64t+63
    if (PLANES != 1 || a.dtype != kBF16 || a.rms_w != nullptr || a.G % WG_BK != 0)
      return cudaErrorInvalidValue;
    xa = static_cast<const bf16*>(a.x);
    xa_ld = a.K;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  Maps maps;
  const auto map2d = [&](CUtensorMap* m, CUtensorMapDataType type, const void* p, int esize,
                         int cols, int rows, int box_cols, int box_rows, CUtensorMapSwizzle sw) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(m, type, 2, const_cast<void*>(p), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (!map2d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xa, 2, xa_ld, PLANES * a.M, WG_BK, WG_BM,
             CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map2d(&maps.scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.scale, 4, a.N, KG, WG_BN, 1,
             CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (a.N % 16 == 0 && !map2d(&maps.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q, 1, a.N, a.K, WG_BN,
                               WG_BK, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  constexpr int smem = Ring<PLANES>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(tiled_wgmma_kernel<PLANES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + WG_BM - 1) / WG_BM, (a.N + WG_BN - 1) / WG_BN, a.ksplit);
  tiled_wgmma_kernel<PLANES><<<grid, WG_THREADS, smem, st>>>(a, maps, tpg);
  return cudaGetLastError();
}

cudaError_t run(Args a, int mode, int mt, cudaStream_t st) {
  if (a.M <= 0 || a.K <= 0 || a.N <= 0 || a.G <= 0 || a.K % a.G != 0 || a.N % 4 != 0)
    return cudaErrorInvalidValue;
  if ((a.dtype != kF32 && a.dtype != kBF16) || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  const bool fast = mode == 1;
  if (mt == 0) {  // the wgmma tile: one plane in fast mode and for an exact
                  // bf16 x (no prologue), three in accurate mode otherwise
    const bool exact = a.dtype == kBF16 && a.rms_w == nullptr;
    if (a.planes == 1 && (fast || exact)) return launch_wgmma<1>(a, st);
    if (a.planes == 3 && !fast) return launch_wgmma<3>(a, st);
    return cudaErrorInvalidValue;
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
// zeroed `tickets`, one per 128 columns); mt = 0 picks the wgmma tile:
// ksplit blocks over K (with `partial` and zeroed `tickets`, one per 128 x
// 128 output tile), x cut into `planes` bf16 planes (3 in accurate mode; 1
// in fast mode, or in accurate mode for bf16 x with no rms_w), its prologue
// writing them to `xt` (planes * M, K/G * cdiv(G, 64) * 64) when xt is not
// null, and x read as it is otherwise (one plane, bf16, no rms_w, G % 64 ==
// 0, 16-byte aligned). N % 4 == 0. All contiguous. Returns the launch's
// cudaError_t.
extern "C" int quant_matmul(const void* x, const void* q, const void* scale,
                            const void* rms_w, const void* res, void* out,
                            void* partial, void* tickets, void* xt, int dtype, int mode,
                            int M, int K, int N, int G, int mt, int ksplit,
                            int planes, float eps, void* stream) {
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(scale),
         rms_w, res, out, static_cast<float*>(partial), static_cast<int*>(tickets),
         static_cast<__nv_bfloat16*>(xt), M, K, N, G, dtype, ksplit, planes, eps};
  return run(a, mode, mt, static_cast<cudaStream_t>(stream));
}

// The same on layer `layer` of q (L, K, N) and scale (L, K/G, N).
extern "C" int quant_matmul_stacked(const void* x, const void* q, const void* scale,
                                    const void* rms_w, const void* res, void* out,
                                    void* partial, void* tickets, void* xt, int dtype,
                                    int mode, int layer, int L, int M, int K, int N,
                                    int G, int mt, int ksplit, int planes, float eps,
                                    void* stream) {
  if (layer < 0 || layer >= L || K <= 0 || N <= 0 || G <= 0 || K % G != 0)
    return cudaErrorInvalidValue;
  const size_t l = static_cast<size_t>(layer);
  Args a{x,
         static_cast<const int8_t*>(q) + l * (size_t)K * (size_t)N,
         static_cast<const float*>(scale) + l * (size_t)(K / G) * (size_t)N,
         rms_w, res, out, static_cast<float*>(partial), static_cast<int*>(tickets),
         static_cast<__nv_bfloat16*>(xt), M, K, N, G, dtype, ksplit, planes, eps};
  return run(a, mode, mt, static_cast<cudaStream_t>(stream));
}
