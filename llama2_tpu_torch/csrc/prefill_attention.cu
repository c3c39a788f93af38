// Causal flash attention of a T-token prefill segment against the KV cache.
//
// Replaces llama2_tpu/ops/pallas/prefill_attention.py::flash_prefill_attention.
//
// Computes, for a segment of T tokens starting at position pos0 whose K/V
// rows are already in the cache:
//   out[b, t, h] = softmax(scale * q[b, t, h] . K[0..pos0+t]) V[0..pos0+t]
// for the K/V head kvh = h / (H / KVH) of (b, ...). Rows are token-major with
// the G = H / KVH heads of one K/V group adjacent (row r is token r / G, head
// kvh * G + r % G: the JAX kernel's layout), so every row of a block shares
// the same K/V rows. A block walks key tiles only up to its last query
// position (keys past it are never read).
//
// Three variants, picked by the wrapper from the dtype and head size before
// the launch (ops/cuda/prefill_attention.py::plan), each counted apart:
//
// mma (bf16, hs % 16 == 0), prefill_mma_kernel. At the main path's shape (T =
// 201, H = KVH = 32, hs = 128) the segment is 0.33 GFLOP; the float32 FMA
// version ran it at 2.2 TFLOP/s in 128 blocks, fewer than the 132 SMs. Here
// a warp owns 16 query rows and a block 16, 32 or 64 (the most that still
// launches 132 blocks: 32 rows, 224 blocks at the main path's shape). Q.K^T
// and P.V run on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators) from shared memory through ldmatrix (V through ldmatrix.trans);
// K/V tiles of 64 keys (32 at hs > 128) are double-buffered by cp.async, so
// the next tile's load overlaps this tile's products. The online softmax runs
// on the score fragments in float32. Numerics: q.k is exact bf16 products
// summed in float32, then times the float32 scale (q is not scaled, and so
// not rounded, before the product). P enters the value product as a bf16 pair
// hi + lo (hi = bf16(p), lo = bf16(p - hi)): one bf16 P is off by up to 2^-9
// of p, which at a short segment (two keys of |v| ~ 3, an output near 0)
// exceeds the card rule of 1e-3 + 2^-7 |x| against the float32 plain version;
// the pair leaves 2^-17. The row sums l are of the float32 p. Keys past the
// tile's last position are zero-filled, so a NaN or stale row there never
// meets a zero weight; only a tile that reaches past the block's first
// position is masked. Heavy (late) q tiles are launched first.
//
// tf32 (float32, hs % 8 == 0), prefill_tf32_kernel: the mma variant's layout
// (token-major rows of a K/V group, 16-row groups, tiles sized to launch 132
// blocks, K/V tiles double-buffered by cp.async, the online softmax on the
// score fragments, heavy tiles first, only the boundary tile masked) at
// float32 accuracy on the tensor cores. The JAX kernel reaches
// Precision.HIGHEST on the TPU as several bf16 passes of the MXU; here both
// products are three TF32 passes (mma.sync m16n8k8, float32 accumulators):
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi with a = a_hi + a_lo cut by
// cvt.rna (mma.cuh, split_tf32), to about 2^-21 |a b|. q is scaled in
// float32 and split once a block, as the plain version scales it; K and V
// are split where they are loaded; P enters P.V as a pair too (one TF32 P is
// off by 2^-11 of p, past the float32 bound of 2e-5 at short segments).
// ldmatrix moves only b16, so fragments come from 32-bit shared loads of
// tiles whose rows are padded by 4 floats: the row stride is 4 banks off a
// multiple of 32, so the (key, d) reads of K (bank 4g + t) and the (2t, g)
// reads of V (bank 8t + g) hit 32 distinct banks. The score fragment of
// keys 8j..8j+7 is P.V's A fragment of k-step j once its two key columns are
// read as columns t and t + 4, so V's rows are read in that order too. Three
// passes a product make each warp a long chain of dependent products: at the
// main path's chunk (224 blocks of 32 rows) one warp a row group left under
// one warp a scheduler. So a block has 4 warps: each 16-row group is taken
// by 4 / (row groups) warps, each on its own slice of every K/V tile (8 keys
// at least), whose states (o, m, l) merge in shared memory in slice order
// at the end; the three passes of the scores accumulate apart (three
// independent chains of products). Tiles of 64 keys at hs <= 64; at hs <=
// 128 32 keys, or 16 for 64-row blocks; 16 at hs > 128: two blocks fit an SM
// at hs <= 128 (q's hi and lo tiles and two K/V tiles each). A segment whose
// row tiles launch fewer than 132 blocks (a verify window: 32 at the 7B
// layout, each walking the whole cache) cuts each row tile's K/V tiles into
// runs over up to 16 blocks, the count from the shapes (the wrapper's plan):
// each run's (o, m, l) goes to the workspace, and the block that draws the
// row tile's last ticket merges them in run order, as K2/K4 merge their
// splits (no float atomics: equal bits on rerun). The split and the unsplit
// launch are two instances of the kernel (SPLIT): taken as a runtime value,
// the split's code cost the unsplit path 3-12% on the H100 (T = 2048 to 128).
//
// fma (hs not a multiple of 8 in float32, or of 16 in bf16), prefill_kernel:
// float32 FMA throughout, q scaled in float32 before the dot. A block holds up
// to 64 query rows in shared memory and stages each 32-key K/V tile as
// float32 for all 8 warps. Each warp owns 8 rows: in the score phase lane j
// computes key j's scores against them; the online softmax runs per row with
// warp reductions; in the value phase lane j accumulates head elements j,
// j+32, ... A ragged last q tile masks rows past T rather than shrinking the
// tile. Bound on this card: float32 operations at long segments, bytes at
// short ones.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using llama2::from_f32;
using llama2::to_f32;
using llama2::warp_max;
using llama2::warp_sum;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                      // keys per tile: one per lane

size_t smem_bytes(int hs) {
  // q rows, K tile (rows padded by one float: conflict-free column reads),
  // V tile, probabilities
  return sizeof(float) *
         ((size_t)kRows * hs + (size_t)kKeys * (hs + 1) + (size_t)kKeys * hs +
          (size_t)kRows * kKeys);
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kWarps * 32)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
               const T* __restrict__ v_cache, T* __restrict__ out, int T_,
               int H, int KVH, int S, int hs, int pos0, int block_q,
               float scale) {
  extern __shared__ float smem[];
  float* sq = smem;                    // [kRows][hs]
  float* sk = sq + kRows * hs;         // [kKeys][hs + 1]
  float* sv = sk + kKeys * (hs + 1);   // [kKeys][hs]
  float* sp = sv + kKeys * hs;         // [kRows][kKeys]

  const int kvh = blockIdx.x;
  const int tq = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int R = block_q * G;  // live rows of this block (<= kRows)
  const int t0 = tq * block_q;
  const int n_tok = min(block_q, T_ - t0);
  const int hi = pos0 + t0 + n_tok - 1;  // last query position in the tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kRowsPerWarp;

  for (int idx = threadIdx.x; idx < kRows * hs; idx += blockDim.x) {
    const int r = idx / hs, d = idx % hs;
    const int tok = t0 + r / G;
    float val = 0.f;
    if (r < R && tok < T_) {
      const int head = kvh * G + r % G;
      val = to_f32(q[(((size_t)b * T_ + tok) * H + head) * hs + d]) * scale;
    }
    sq[idx] = val;
  }

  // a dead row (past R or T) attends keys 0..pos0: finite, never stored
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const int tok = t0 + row / G;
    qpos[r] = (row < R && tok < T_) ? pos0 + tok : pos0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[r][i] = 0.f;
  }

  const size_t plane = ((size_t)b * KVH + kvh) * (size_t)S * hs;
  const int n_tiles = hi / kKeys + 1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKeys;
    __syncthreads();  // sq is written / the previous tile is consumed
    for (int idx = threadIdx.x; idx < kKeys * hs; idx += blockDim.x) {
      const int j = idx / hs, d = idx % hs;
      const int key = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (key <= hi) {
        kval = to_f32(k_cache[plane + (size_t)key * hs + d]);
        vval = to_f32(v_cache[plane + (size_t)key * hs + d]);
      }
      sk[j * (hs + 1) + d] = kval;
      sv[j * hs + d] = vval;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = sk + lane * (hs + 1);
    for (int d = 0; d < hs; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(sq[(row0 + r) * hs + d], kd, s[r]);
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = key <= qpos[r] ? s[r] : -INFINITY;
      // finite: tile 0 holds key 0, which every row sees
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float pr = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[r][i] *= alpha;
      sp[(row0 + r) * kKeys + lane] = pr;
    }
    __syncwarp();

    for (int j = 0; j < kKeys; ++j) {
      float vj[NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < hs ? sv[j * hs + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = sp[(row0 + r) * kKeys + j];
#pragma unroll
        for (int i = 0; i < NPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
    __syncwarp();  // sp is read before the next tile overwrites it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const int tok = t0 + row / G;
    if (row < R && tok < T_) {
      const int head = kvh * G + row % G;
      T* o = out + (((size_t)b * T_ + tok) * H + head) * hs;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hs) o[d] = from_f32<T>(acc[r][i] / l[r]);
      }
    }
  }
}

// ---- the mma variant: bf16, hs % 16 == 0 ----

using bf16 = __nv_bfloat16;
using llama2::cp_async16;
using llama2::cp_async_commit;
using llama2::cp_async_wait;
using llama2::ldmatrix_x4;
using llama2::ldmatrix_x4_trans;
using llama2::mma_m16n8k16_bf16;
using llama2::pack_bf16;

// keys a K/V tile, and the shared row of one q / K / V row in bf16 (16 bytes
// of pad: 8 consecutive rows of an ldmatrix fall in distinct banks)
template <int HS>
struct MmaTile {
  static constexpr int kKeys = HS <= 128 ? 64 : 32;
  static constexpr int kLd = HS + 8;
};

template <int HS, int NW>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)MmaTile<HS>::kLd * (NW * 16 + 4 * MmaTile<HS>::kKeys);
}

// p as a bf16 pair: hi = bf16(p), lo = bf16(p - hi), packed two columns a
// register as the A fragment wants them
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// HS: the head size rounded up to 64, 128 or 256 (columns past hs are zero);
// NW warps of 16 query rows each.
template <int HS, int NW>
__global__ void __launch_bounds__(NW * 32)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
                   const bf16* __restrict__ v_cache, bf16* __restrict__ out, int T_, int H,
                   int KVH, int S, int hs, int pos0, float scale) {
  constexpr int BK = MmaTile<HS>::kKeys;
  constexpr int LD = MmaTile<HS>::kLd;
  constexpr int BQ = NW * 16;
  constexpr int CH = HS / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sk = sq + BQ * LD;                       // [2][BK][LD]
  bf16* sv = sk + 2 * BK * LD;                   // [2][BK][LD]

  const int kvh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = T_ * G;  // query rows of this (b, kv head)
  const int r0 = tile * BQ;
  const int lo = pos0 + r0 / G;                          // the tile's first query position
  const int hi = pos0 + (min(r0 + BQ, rows) - 1) / G;    // and its last
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lr = lane & 7;   // ldmatrix: row lr of matrix lm
  const int lm = lane >> 3;
  const size_t plane = ((size_t)b * KVH + kvh) * (size_t)S;  // key 0's row

  for (int i = threadIdx.x; i < BQ * CH; i += NW * 32) {
    const int r = i / CH, c = i % CH;
    const int row = r0 + r;
    const bool ok = row < rows && c * 8 < hs;
    const bf16* src =
        ok ? q + (((size_t)b * T_ + row / G) * H + kvh * G + row % G) * hs + c * 8 : q;
    cp_async16(sq + r * LD + c * 8, src, ok ? 16 : 0);
  }
  auto load_kv = [&](int t, int buf) {
    for (int i = threadIdx.x; i < BK * CH; i += NW * 32) {
      const int j = i / CH, c = i % CH;
      const int key = t * BK + j;
      const bool ok = key <= hi && c * 8 < hs;
      const size_t off = ok ? (plane + key) * hs + c * 8 : 0;
      cp_async16(sk + (buf * BK + j) * LD + c * 8, k_cache + off, ok ? 16 : 0);
      cp_async16(sv + (buf * BK + j) * LD + c * 8, v_cache + off, ok ? 16 : 0);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this lane's two rows: warp * 16 + lane / 4, and 8 below; a dead row (past
  // T) attends keys 0..pos0: finite, never stored
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h;
    qpos[h] = row < rows ? pos0 + row / G : pos0;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HS / 8][4];
#pragma unroll
  for (int j = 0; j < HS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;

  const bf16* qw = sq + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
  const int n_tiles = hi / BK + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q) landed
    __syncthreads();

    // scores of this warp's 16 rows against the tile's BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    const bf16* kt = sk + (buf * BK + (lm >> 1) * 8 + lr) * LD + (lm & 1) * 8;
#pragma unroll
    for (int kd = 0; kd < HS / 16; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, qw + kd * 16);  // (rows, d), (rows + 8, d), (rows, d + 8), (rows + 8, d + 8)
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t r[4];  // (keys, d), (keys, d + 8), (keys + 8, d), (keys + 8, d + 8)
        ldmatrix_x4(r, kt + nb * 16 * LD + kd * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_m16n8k16_bf16(s[2 * nb], a, b0);
        mma_m16n8k16_bf16(s[2 * nb + 1], a, b1);
      }
    }

    // online softmax in float32 on the score fragments: s[j][i] is row
    // (i < 2 ? 0 : 1), key t * BK + 8j + 2 (lane % 4) + (i & 1)
    const bool diag = t * BK + BK - 1 > lo;  // some key here is past some row's position
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = t * BK + 8 * j + 2 * (lane & 3) + (i & 1);
        float v = s[j][i] * scale;
        if (diag && key > qpos[i >> 1]) v = -INFINITY;
        s[j][i] = v;
        mx[i >> 1] = fmaxf(mx[i >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 lanes of a row; finite: tile 0 holds key 0, which every row sees
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - m[i >> 1]);
        l[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int j = 0; j < HS / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += P V, P as the pair hi + lo; the score fragments of keys 16kk..+7
    // and +8..+15 are the A fragment of one k16 step
    const bf16* vt = sv + (buf * BK + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int db = 0; db < HS / 16; ++db) {
        uint32_t r[4];  // (keys, d), (keys + 8, d), (keys, d + 8), (keys + 8, d + 8), transposed
        ldmatrix_x4_trans(r, vt + kk * 16 * LD + db * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_m16n8k16_bf16(o[2 * db], ph, b0);
        mma_m16n8k16_bf16(o[2 * db], pl, b0);
        mma_m16n8k16_bf16(o[2 * db + 1], ph, b1);
        mma_m16n8k16_bf16(o[2 * db + 1], pl, b1);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= rows) continue;
    bf16* orow = out + (((size_t)b * T_ + row / G) * H + kvh * G + row % G) * hs;
#pragma unroll
    for (int j = 0; j < HS / 8; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d < hs)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[j][2 * h] / l[h], o[j][2 * h + 1] / l[h]);
    }
  }
}

template <int HS, int NW>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc, void* out, int B, int T_,
                       int H, int KVH, int S, int hs, int pos0, float scale, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<HS, NW>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mma_kernel<HS, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = T_ * (H / KVH);
  dim3 grid(KVH, (rows + NW * 16 - 1) / (NW * 16), B);
  prefill_mma_kernel<HS, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<bf16*>(out), T_, H, KVH, S, hs, pos0, scale);
  return cudaGetLastError();
}

template <int HS>
cudaError_t dispatch_mma(int warps, const void* q, const void* kc, const void* vc, void* out,
                         int B, int T_, int H, int KVH, int S, int hs, int pos0, float scale,
                         cudaStream_t st) {
  switch (warps) {
    case 1: return launch_mma<HS, 1>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
    case 2: return launch_mma<HS, 2>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
    case 4: return launch_mma<HS, 4>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the tf32 variant: float32, hs % 8 == 0 ----

using llama2::mma_m16n8k8_tf32;
using llama2::split_tf32;

// keys a K/V tile of a block of NW row groups (two blocks of 32 or 64 rows
// fit an SM at hs <= 128), and the shared row of one q / K / V row in
// float32 (4 floats of pad: see the header)
template <int HS, int NW>
struct Tf32Tile {
  static constexpr int kKeys = HS <= 64 ? 64 : HS <= 128 && NW < 4 ? 32 : 16;
  static constexpr int kLd = HS + 4;
};

// A block of NW row groups has 4 warps: each row group's 16 rows are taken
// by KS = 4 / NW warps, each on its own slice of every K/V tile (8 keys at
// least), merged at the end.
template <int HS, int NW>
__host__ __device__ constexpr int tf32_slices() {
  return (4 / NW) * 8 <= Tf32Tile<HS, NW>::kKeys ? 4 / NW : Tf32Tile<HS, NW>::kKeys / 8;
}

template <int HS, int NW>
constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * (size_t)Tf32Tile<HS, NW>::kLd * (2 * NW * 16 + 4 * Tf32Tile<HS, NW>::kKeys);
}

// HS: the head size rounded up to 64, 128 or 256 (columns past hs are zero);
// NW row groups of 16 query rows, each taken by KS warps. With SPLIT (and
// splits > 1) the tiles of a row tile's keys are cut into `splits` runs, one
// a block (blockIdx.x = kv head * splits + split): each writes its rows' (o, m, l)
// to ws, and the block that draws the last ticket of its row tile merges
// them in split order.
template <int HS, int NW, bool SPLIT>
__global__ void __launch_bounds__(NW * tf32_slices<HS, NW>() * 32)
prefill_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k_cache,
                    const float* __restrict__ v_cache, float* __restrict__ out, int T_, int H,
                    int KVH, int S, int hs, int pos0, float scale, int splits,
                    float* __restrict__ ws, int* __restrict__ tickets) {
  if (!SPLIT) splits = 1;  // the unsplit instance carries none of the split's code
  constexpr int KS = tf32_slices<HS, NW>();
  constexpr int BK = Tf32Tile<HS, NW>::kKeys;
  constexpr int KB = BK / KS;  // keys a warp takes of a tile
  constexpr int LD = Tf32Tile<HS, NW>::kLd;
  constexpr int BQ = NW * 16;
  constexpr int CH = HS / 4;  // 16-byte chunks a row
  constexpr int NT = NW * KS * 32;
  constexpr int E = HS / 2 + 4;  // a lane's merged state: o, m[2], l[2]
  static_assert((KS - 1) * NW * 32 * E <= 4 * BK * LD, "the merge fits the K/V tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [BQ][LD]: q, then tf32(q * scale)
  float* sql = sq + BQ * LD;                       // [BQ][LD]: the low part
  float* sk = sql + BQ * LD;                       // [2][BK][LD]
  float* sv = sk + 2 * BK * LD;                    // [2][BK][LD]

  const int kvh = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int tile = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int rows = T_ * G;  // query rows of this (b, kv head)
  const int r0 = tile * BQ;
  const int lo = pos0 + r0 / G;                        // the tile's first query position
  const int hi = pos0 + (min(r0 + BQ, rows) - 1) / G;  // and its last
  const int n_all = hi / BK + 1;                       // the K/V tiles of keys 0..hi
  const int per = (n_all + splits - 1) / splits;
  const int t_begin = min(n_all, split * per);         // this block's run (may be empty)
  const int t_end = min(n_all, t_begin + per);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % NW;  // row group
  const int kh = warp / NW;  // key slice: keys kh * KB .. of every tile
  const int g = lane >> 2;   // fragment row / column g, and t
  const int t4 = lane & 3;
  const size_t plane = ((size_t)b * KVH + kvh) * (size_t)S;  // key 0's row

  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int row = r0 + r;
    const bool ok = row < rows && c * 4 < hs;
    const float* src =
        ok ? q + (((size_t)b * T_ + row / G) * H + kvh * G + row % G) * hs + c * 4 : q;
    cp_async16(sq + r * LD + c * 4, src, ok ? 16 : 0);
  }
  cp_async_commit();
  auto load_kv = [&](int t, int buf) {
    for (int i = threadIdx.x; i < BK * CH; i += NT) {
      const int j = i / CH, c = i % CH;
      const int key = t * BK + j;
      const bool ok = key <= hi && c * 4 < hs;
      const size_t off = ok ? (plane + key) * hs + c * 4 : 0;
      cp_async16(sk + (buf * BK + j) * LD + c * 4, k_cache + off, ok ? 16 : 0);
      cp_async16(sv + (buf * BK + j) * LD + c * 4, v_cache + off, ok ? 16 : 0);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();
  // q scaled in float32 and split once, for every tile
  cp_async_wait<1>();
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * HS; i += NT) {
    const int e = (i / HS) * LD + i % HS;
    uint32_t h, l;
    split_tf32(sq[e] * scale, h, l);
    sq[e] = __uint_as_float(h);
    sql[e] = __uint_as_float(l);
  }

  // this lane's two rows: rw * 16 + g, and 8 below; a dead row (past T)
  // attends keys 0..pos0: finite, never stored
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rw * 16 + g + 8 * h;
    qpos[h] = row < rows ? pos0 + row / G : pos0;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HS / 8][4];
#pragma unroll
  for (int j = 0; j < HS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;

  const float* qh = sq + (rw * 16 + g) * LD + t4;
  const float* ql = sql + (rw * 16 + g) * LD + t4;
  // a row group wholly past T (the last tile's, at T = 201) only loads and
  // waits, leaving the SM's issue slots to the warps with rows
  const bool live = r0 + rw * 16 < rows;
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t landed
    __syncthreads();
    if (!live) {
      __syncthreads();
      continue;
    }

    // scores of this warp's 16 rows against its KB keys of the tile: the
    // three passes in s, c and e (independent chains of products)
    float s[KB / 8][4], c[KB / 8][4], e[KB / 8][4];
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = c[j][i] = e[j][i] = 0.f;
    const float* kt = sk + (buf * BK + kh * KB + g) * LD + t4;
#pragma unroll
    for (int kd = 0; kd < HS / 8; ++kd) {
      const int d = kd * 8;
      const uint32_t ah[4] = {__float_as_uint(qh[d]), __float_as_uint(qh[8 * LD + d]),
                              __float_as_uint(qh[d + 4]), __float_as_uint(qh[8 * LD + d + 4])};
      const uint32_t al[4] = {__float_as_uint(ql[d]), __float_as_uint(ql[8 * LD + d]),
                              __float_as_uint(ql[d + 4]), __float_as_uint(ql[8 * LD + d + 4])};
#pragma unroll
      for (int nb = 0; nb < KB / 8; ++nb) {
        uint32_t bh[2], bl[2];  // K[8nb + g][d + t], [d + t + 4]
        split_tf32(kt[nb * 8 * LD + d], bh[0], bl[0]);
        split_tf32(kt[nb * 8 * LD + d + 4], bh[1], bl[1]);
        mma_m16n8k8_tf32(c[nb], al, bh);
        mma_m16n8k8_tf32(e[nb], ah, bl);
        mma_m16n8k8_tf32(s[nb], ah, bh);
      }
    }

    // online softmax in float32 on the score fragments: s[j][i] is row
    // (i < 2 ? 0 : 1), key t * BK + kh * KB + 8j + 2 t4 + (i & 1)
    const bool diag = t * BK + BK - 1 > lo;  // some key here is past some row's position
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = t * BK + kh * KB + 8 * j + 2 * t4 + (i & 1);
        s[j][i] += c[j][i] + e[j][i];
        if (diag && key > qpos[i >> 1]) s[j][i] = -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 lanes of a row; a slice may not have met a visible key yet
      // (-inf: then nothing is added and nothing rescaled)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float base = mx[h] == -INFINITY ? 0.f : mx[h];
      alpha[h] = expf(m[h] - base);
      m[h] = mx[h];
      mx[h] = base;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - mx[i >> 1]);
        l[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int j = 0; j < HS / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += P V, P as the pair hi + lo: k-step kk takes keys 8kk + 2 t4 as
    // column t4 and 8kk + 2 t4 + 1 as column t4 + 4, of P and of V alike
    const float* vt = sv + (buf * BK + kh * KB + 2 * t4) * LD + g;
#pragma unroll
    for (int kk = 0; kk < KB / 8; ++kk) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kk][0], ph[0], pl[0]);
      split_tf32(s[kk][2], ph[1], pl[1]);
      split_tf32(s[kk][1], ph[2], pl[2]);
      split_tf32(s[kk][3], ph[3], pl[3]);
#pragma unroll
      for (int db = 0; db < HS / 8; ++db) {
        uint32_t bh[2], bl[2];  // V[8kk + 2 t4][8db + g], V[8kk + 2 t4 + 1][8db + g]
        split_tf32(vt[kk * 8 * LD + db * 8], bh[0], bl[0]);
        split_tf32(vt[(kk * 8 + 1) * LD + db * 8], bh[1], bl[1]);
        mma_m16n8k8_tf32(o[db], pl, bh);
        mma_m16n8k8_tf32(o[db], ph, bl);
        mma_m16n8k8_tf32(o[db], ph, bh);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (KS > 1) {
    // the slices' states (o, m, l) through shared memory, lane by lane in
    // fragment order, merged into slice 0's in slice order
    float* part = sk;  // [(KS - 1) * NW][E][32]
    if (kh > 0 && live) {
      float* p = part + ((kh - 1) * NW + rw) * E * 32 + lane;
#pragma unroll
      for (int j = 0; j < HS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[(4 * j + i) * 32] = o[j][i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[(HS / 2 + h) * 32] = m[h];
        p[(HS / 2 + 2 + h) * 32] = l[h];
      }
    }
    __syncthreads();
    if (kh == 0 && live) {
#pragma unroll
      for (int k = 1; k < KS; ++k) {
        const float* p = part + ((k - 1) * NW + rw) * E * 32 + lane;
        float a[2], w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // -inf: a slice (or a split's run) that met no visible key
          const float mk = p[(HS / 2 + h) * 32];
          const float mn = fmaxf(m[h], mk);
          const float base = mn == -INFINITY ? 0.f : mn;
          a[h] = expf(m[h] - base);
          w[h] = expf(mk - base);
          l[h] = l[h] * a[h] + p[(HS / 2 + 2 + h) * 32] * w[h];
          m[h] = mn;
        }
#pragma unroll
        for (int j = 0; j < HS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[j][i] = o[j][i] * a[i >> 1] + p[(4 * j + i) * 32] * w[i >> 1];
      }
    }
  }

  // slice 0 of each row group with rows holds the block's state: out
  // directly, or this split's run to ws (rows of o[HS], m, l)
  const size_t tile_at = ((size_t)b * KVH + kvh) * gridDim.y + tile;  // the row tile's ticket
  if (kh == 0 && live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw * 16 + g + 8 * h;
      const int row = r0 + r;
      if (splits == 1) {
        if (row >= rows) continue;
        float* orow = out + (((size_t)b * T_ + row / G) * H + kvh * G + row % G) * hs;
#pragma unroll
        for (int j = 0; j < HS / 8; ++j) {
          const int d = 8 * j + 2 * t4;
          if (d < hs)
            *reinterpret_cast<float2*>(orow + d) =
                make_float2(o[j][2 * h] / l[h], o[j][2 * h + 1] / l[h]);
        }
      } else {
        float* dst = ws + ((tile_at * splits + split) * BQ + r) * (HS + 2);
#pragma unroll
        for (int j = 0; j < HS / 8; ++j) {
          const int d = 8 * j + 2 * t4;
          if (d < hs) *reinterpret_cast<float2*>(dst + d) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
        }
        if (t4 == 0) {
          dst[HS] = m[h];
          dst[HS + 1] = l[h];
        }
      }
    }
  }
  if (splits == 1) return;

  // the block that draws the row tile's last ticket merges the runs in split
  // order (no float atomics: equal bits on rerun) and zeroes the ticket
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[tile_at], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* runs = ws + tile_at * splits * BQ * (HS + 2);
  for (int i = threadIdx.x; i < BQ * hs; i += NT) {
    const int r = i / hs, d = i % hs;
    const int row = r0 + r;
    if (row >= rows) continue;
    float mt = -INFINITY;
    for (int k = 0; k < splits; ++k) mt = fmaxf(mt, __ldcg(runs + ((size_t)k * BQ + r) * (HS + 2) + HS));
    // finite: split 0's run holds key 0, which every row sees
    float lt = 0.f, ot = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* p = runs + ((size_t)k * BQ + r) * (HS + 2);
      const float w = expf(__ldcg(p + HS) - mt);
      lt += __ldcg(p + HS + 1) * w;
      ot += __ldcg(p + d) * w;
    }
    out[(((size_t)b * T_ + row / G) * H + kvh * G + row % G) * hs + d] = ot / lt;
  }
  if (threadIdx.x == 0) tickets[tile_at] = 0;
}

// the key splits' scratch: the runs' rows and one ticket a row tile
struct Splits {
  int n;
  float* ws;     // (B, KVH, row tiles, n, 16 NW, HS + 2) f32 when n > 1
  int* tickets;  // B * KVH * row tiles, zero on entry and on exit
};

template <int HS, int NW>
cudaError_t launch_tf32(const void* q, const void* kc, const void* vc, void* out, int B, int T_,
                        int H, int KVH, int S, int hs, int pos0, float scale, Splits sp,
                        cudaStream_t st) {
  if (sp.n < 1 || (sp.n > 1 && (sp.ws == nullptr || sp.tickets == nullptr)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = tf32_smem_bytes<HS, NW>();
  const auto kernel = sp.n > 1 ? prefill_tf32_kernel<HS, NW, true> : prefill_tf32_kernel<HS, NW, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = T_ * (H / KVH);
  dim3 grid(KVH * sp.n, (rows + NW * 16 - 1) / (NW * 16), B);
  kernel<<<grid, NW * tf32_slices<HS, NW>() * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc), static_cast<const float*>(vc),
      static_cast<float*>(out), T_, H, KVH, S, hs, pos0, scale, sp.n, sp.ws, sp.tickets);
  return cudaGetLastError();
}

template <int HS>
cudaError_t dispatch_tf32(int warps, const void* q, const void* kc, const void* vc, void* out,
                          int B, int T_, int H, int KVH, int S, int hs, int pos0, float scale,
                          Splits sp, cudaStream_t st) {
  switch (warps) {
    case 1: return launch_tf32<HS, 1>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, sp, st);
    case 2: return launch_tf32<HS, 2>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, sp, st);
    case 4: return launch_tf32<HS, 4>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, sp, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the fma variant ----

template <typename T, int NPL>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out,
                   int B, int T_, int H, int KVH, int S, int hs, int pos0,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const int block_q = kRows / G;
  const size_t smem = smem_bytes(hs);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KVH, (T_ + block_q - 1) / block_q, B);
  prefill_kernel<T, NPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), T_, H, KVH, S, hs, pos0,
      block_q, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kc, const void* vc, void* out,
                     int B, int T_, int H, int KVH, int S, int hs, int pos0,
                     float scale, cudaStream_t st) {
  if (hs <= 32) return launch<T, 1>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
  if (hs <= 64) return launch<T, 2>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
  if (hs <= 128) return launch<T, 4>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
  if (hs <= 256) return launch<T, 8>(q, kc, vc, out, B, T_, H, KVH, S, hs, pos0, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, T, H, hs); caches (B, KVH, S, hs) holding the segment's own rows at
// pos0..pos0+T-1; out (B, T, H, hs). All contiguous, one dtype; G = H / KVH
// must be at most 64 and pos0 + T at most S. warps: 0 launches the fma
// variant (f32 or bf16, hs <= 256); 1, 2 or 4 a tensor-core variant with that
// many row groups a block: mma for bf16 (hs % 16 == 0), tf32 for f32 (hs % 8
// == 0), hs <= 256, 16-byte aligned rows. splits > 1 (tf32 only) cuts each
// row tile's keys over that many blocks, with `ws` (B, KVH, row tiles,
// splits, 16 warps, HS + 2) f32, HS the head size rounded up to 64, 128 or
// 256, and zeroed `tickets`, one a row tile. Returns the launch's cudaError_t.
extern "C" int flash_prefill_attention(const void* q, const void* k_cache,
                                       const void* v_cache, void* out,
                                       int dtype, int B, int T, int H, int KVH,
                                       int S, int hs, int pos0, float scale,
                                       int warps, int splits, void* ws, void* tickets,
                                       void* stream) {
  if (B <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > kRows ||
      pos0 < 0 || pos0 + T > S)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Splits sp{splits, static_cast<float*>(ws), static_cast<int*>(tickets)};
  if (warps != 0) {
    if (hs <= 0 || hs > 256) return cudaErrorInvalidValue;
    if (dtype == llama2::kBF16 && hs % 16 == 0 && splits == 1) {
      if (hs <= 64)
        return dispatch_mma<64>(warps, q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
      if (hs <= 128)
        return dispatch_mma<128>(warps, q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
      return dispatch_mma<256>(warps, q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
    }
    if (dtype == llama2::kF32 && hs % 8 == 0) {
      if (hs <= 64)
        return dispatch_tf32<64>(warps, q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, sp, st);
      if (hs <= 128)
        return dispatch_tf32<128>(warps, q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, sp, st);
      return dispatch_tf32<256>(warps, q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, sp, st);
    }
    return cudaErrorInvalidValue;
  }
  if (splits != 1) return cudaErrorInvalidValue;
  if (dtype == llama2::kF32)
    return dispatch<float>(q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
  if (dtype == llama2::kBF16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
  return cudaErrorInvalidValue;
}
