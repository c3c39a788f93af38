// Tensor-core and asynchronous-copy helpers shared by the prefill kernels
// and the FFN megakernels: the bf16 mma.sync product and its ldmatrix operand
// loads, the TF32 product and the hi + lo split of a float32 operand (K1's
// prefill_attention.cu), cp.async into shared memory (K1, and the M > 8 tile
// of quant_matmul.cu), and the exact int8 -> bf16 pair conversion (the M > 8
// tile, and mlp_block.cu's tensor-core phases).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace llama2 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// D (16 x 8, f32) += A (16 x 8, tf32, row-major) * B (8 x 8, tf32, "col").
// With g = lane / 4 and t = lane % 4, a lane holds
//   a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4];
//   b[0] = B[t][g], b[1] = B[t+4][g]; d as for m16n8k16.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tf32(x): x rounded to 10 explicit mantissa bits, to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds a finite x: half a unit added to the
// magnitude's bits (a carry moves to the next binade), the low 13 bits
// cleared. Two integer operations, on the full-rate pipe.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as a TF32 pair: hi = tf32(x), lo = tf32(x - hi). x - hi is exact in
// float32, so hi + lo is x to 2^-22 |x|, and hi_a hi_b + hi_a lo_b + lo_a
// hi_b is a b to about 2^-21 |a b|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Four 8 x 8 b16 matrices from shared memory, one fragment register each:
// lane l passes the address of row l % 8 of matrix l / 8 (16 bytes) and gets
// elements [l / 4][2 (l % 4), +1] of every matrix; with `trans`, elements
// [2 (l % 4), +1][l / 4], i.e. a pair down a column.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte `sel & 3` of lo and byte `sel & 3` of hi (sel = 0x0400 + c * 0x0101
// for byte c), read as int8, as one bf16 pair (lo's in the lower half),
// exactly: with the bf16 bits 0x4300 | (b & 0x7f) = 128 + (b & 127) and
// 0x4300 | (b & 0x80) = 128 or 256 (b >= 0 or < 0), the bf16 difference of
// the two is b. A PRMT, two LOP3 and one bf16x2 subtraction.
__device__ __forceinline__ uint32_t int8_pair_bf16(uint32_t lo, uint32_t hi, uint32_t sel) {
  const uint32_t pair = __byte_perm(lo, hi, sel);  // byte c of each in bytes 0 and 2
  const uint32_t m = (pair & 0x007f007fu) | 0x43004300u;
  const uint32_t sub = (pair & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                   *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Asynchronous copies of 16, 8 or 4 bytes from global to shared memory. With
// src_bytes 0 the destination is zero-filled and nothing is read (the source
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace llama2
