// Flash decode attention over the layer-stacked KV cache, with this step's
// K/V rows appended in place.
//
// Replaces llama2_tpu/ops/pallas/attention.py::flash_decode_attention_stacked.
//
// Computes, for each batch row b and query head h (one query token):
//   k_cache[layer, b, kvh, pos_b] = k_new[b, kvh];  v likewise
//   out[b, h] = softmax(q[b, h] * scale . K[0..pos_b]) V[0..pos_b]
// with kvh = h / (H / KVH). Only keys 0..pos_b are read.
//
// Bound on this card: bytes. Each (b, kv head) reads its (pos_b + 1) K and V
// rows once per query head of its group, two FMAs per element read. One
// block per (b, query head) streams those rows; 8 warps interleave chunks of
// KC keys, and each warp issues a whole chunk's K and V loads before it
// reduces, so about 8 * KC rows per block are in flight to cover memory
// latency. Each warp keeps its own online-softmax state; the warps merge
// through shared memory at the end. At batch 1 the grid is only B * H blocks
// (32 at Llama-2-7B widths on 132 SMs); splitting the key range across more
// blocks is later work.
//
// The append: the row at pos_b is taken from k_new/v_new, never from the
// cache, so no block depends on the write; the first query head of each
// group writes the row back. Arithmetic is float32 FMA for f32 and bf16
// inputs (no TF32), matching the JAX kernel's Precision.HIGHEST dots.
#include <math.h>

#include "common.cuh"

namespace {

using llama2::from_f32;
using llama2::to_f32;
using llama2::warp_sum;

constexpr int kWarps = 8;

// NPL: head elements per lane (hs <= 32 * NPL); KC: keys per warp chunk
template <typename T, int NPL, int KC>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, T* k_cache, T* v_cache,
              const T* __restrict__ k_new, const T* __restrict__ v_new,
              const int* __restrict__ pos, T* __restrict__ out, int layer,
              int B, int H, int KVH, int S, int hs, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int kvh = h / G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = pos[b];

  const size_t plane = (((size_t)layer * B + b) * KVH + kvh) * (size_t)S * hs;
  const T* kp = k_cache + plane;
  const T* vp = v_cache + plane;
  const T* kn = k_new + ((size_t)b * KVH + kvh) * hs;
  const T* vn = v_new + ((size_t)b * KVH + kvh) * hs;

  // q pre-scaled in f32, as the JAX kernel does before its dot
  float qr[NPL];
  const T* qh = q + ((size_t)b * H + h) * hs;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hs ? to_f32(qh[d]) * scale : 0.f;
  }

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
      const T* kr = t == p ? kn : kp + (size_t)t * hs;
      const T* vr = t == p ? vn : vp + (size_t)t * hs;
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

  if (h % G == 0) {
    T* kw = k_cache + plane + (size_t)p * hs;
    T* vw = v_cache + plane + (size_t)p * hs;
    for (int d = threadIdx.x; d < hs; d += blockDim.x) {
      kw[d] = kn[d];
      vw[d] = vn[d];
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
  T* oh = out + ((size_t)b * H + h) * hs;
  for (int d = threadIdx.x; d < hs; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(sm_acc[w][d], wscale[w], o);
    oh[d] = from_f32<T>(o / L);
  }
}

template <typename T, int NPL>
cudaError_t launch(const void* q, void* kc, void* vc, const void* kn,
                   const void* vn, const void* pos, void* out, int layer, int B,
                   int H, int KVH, int S, int hs, float scale,
                   cudaStream_t stream) {
  constexpr int KC = NPL >= 8 ? 4 : 8;  // keeps the chunk within registers
  dim3 grid(H, B);
  decode_kernel<T, NPL, KC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<const int*>(pos), static_cast<T*>(out), layer, B, H, KVH, S,
      hs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, void* kc, void* vc, const void* kn,
                     const void* vn, const void* pos, void* out, int layer,
                     int B, int H, int KVH, int S, int hs, float scale,
                     cudaStream_t st) {
  if (hs <= 32) return launch<T, 1>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 64) return launch<T, 2>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 128) return launch<T, 4>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (hs <= 256) return launch<T, 8>(q, kc, vc, kn, vn, pos, out, layer, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, hs); caches (L, B, KVH, S, hs), updated in place; k_new/v_new
// (B, KVH, 1, hs); pos (B,) int32 on the device; out (B, H, hs). All
// contiguous, one dtype. Returns the launch's cudaError_t.
extern "C" int flash_decode_attention_stacked(
    const void* q, void* k_cache, void* v_cache, const void* k_new,
    const void* v_new, const void* pos, void* out, int dtype, int layer, int B,
    int H, int KVH, int S, int hs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == llama2::kF32)
    return dispatch<float>(q, k_cache, v_cache, k_new, v_new, pos, out, layer, B, H, KVH, S, hs, scale, st);
  if (dtype == llama2::kBF16)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, k_new, v_new, pos, out, layer, B, H, KVH, S, hs, scale, st);
  return cudaErrorInvalidValue;
}
