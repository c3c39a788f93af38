// Causal flash attention of a T-token prefill segment against the KV cache.
//
// Replaces llama2_tpu/ops/pallas/prefill_attention.py::flash_prefill_attention.
//
// Computes, for a segment of T tokens starting at position pos0 whose K/V
// rows are already in the cache:
//   out[b, t, h] = softmax(q[b, t, h] * scale . K[0..pos0+t]) V[0..pos0+t]
// for the K/V head kvh = h / (H / KVH) of (b, ...).
//
// Bound on this card: at prompt lengths the work is small either way. It
// reads q, writes out, and reads K/V rows 0..pos0+T-1 of each (b, kv head)
// once per query tile; it does 4 * hs FLOPs per (query, head, visible key)
// pair. With float32 FMA (no tensor cores) it is bound by operations at long
// segments and by bytes at short ones.
//
// Design: grid (KVH, q tiles, B). A block holds up to 64 query rows in
// shared memory, token-major with the G = H / KVH heads of one group
// adjacent, so row r is token r / G of the tile (the JAX kernel's layout) and
// every row of the block shares the same K/V rows. It walks 32-key tiles only
// up to the tile's last query position (keys past it are never read), staging
// each K/V tile in shared memory as float32 for all 8 warps. Each warp owns 8
// rows: in the score phase lane j computes key j's scores against them; the
// online softmax runs per row with warp reductions; in the value phase lane
// j accumulates head elements j, j+32, ... . A ragged last q tile masks rows
// past T rather than shrinking the tile. Arithmetic is float32 FMA for f32
// and bf16 inputs (no TF32), q scaled in float32 before the dot, matching the
// JAX kernel's Precision.HIGHEST dots.
#include <math.h>

#include "common.cuh"

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
// must be at most 64 and pos0 + T at most S. Returns the launch's cudaError_t.
extern "C" int flash_prefill_attention(const void* q, const void* k_cache,
                                       const void* v_cache, void* out,
                                       int dtype, int B, int T, int H, int KVH,
                                       int S, int hs, int pos0, float scale,
                                       void* stream) {
  if (B <= 0 || T <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > kRows ||
      pos0 < 0 || pos0 + T > S)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32)
    return dispatch<float>(q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
  if (dtype == llama2::kBF16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, out, B, T, H, KVH, S, hs, pos0, scale, st);
  return cudaErrorInvalidValue;
}
