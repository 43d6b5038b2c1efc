// Tensor-core building blocks shared by the bf16 paths of
// flash_attention.cu, moe_gmm.cu and ssd_scan.cu (sm_80 instructions, all
// on sm_90a):
// 16-byte asynchronous copies global -> shared (`cp.async`, zero-filling
// past a given byte count), `ldmatrix` loads of 8x8 bf16 tiles from shared
// memory into mma fragments (plain and transposed), and the warp-wide
// `mma.sync` m16n8k16 product of bf16 operands into f32 accumulators.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 (row g, cols 2t,
//     2t+1), a1 (row g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row
//     g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k by n), 2 registers: b0 (k 2t, 2t+1; col g), b1 (k 2t+8,
//     2t+9; col g);
//   C/D (16 x 8, f32), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3
//     (row g+8, cols 2t, 2t+1).
// An `ldmatrix.x4` takes one row address from each lane (lanes 8i..8i+7
// give the eight rows of matrix i) and leaves matrix i in register i, each
// lane holding row g, elements 2t and 2t+1; `.trans` hands out the
// transposed matrix instead, so a k-major (row-major k x n) tile in shared
// memory gives B fragments directly.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global `src` to shared `dst`; only the first
// `src_bytes` (0..16) are read, the rest of the 16 are zero-filled.  Both
// addresses must be 16-byte aligned (pass any valid `src` with 0 bytes).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a . b for one 16 x 8 tile, depth 16: bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (max relative error 2^-22), flushing
// denormal results to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (nearest even) in one register, `lo` in the
// low half: the element order of every fragment above.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 values of one register, as floats (low half first).
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two floats split into a bf16 pair each, v = hi + lo to about 2^-16 of
// |v|: hi = bf16(v), lo = bf16(v - hi) (the difference is exact in f32).
// Two mma.sync products, by hi and by lo, then carry an f32 operand
// through the tensor cores to about 2^-16, where one bf16 rounding gives
// 2^-9.
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(v0, v1);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(v0 - h.x, v1 - h.y);
}

}  // namespace tc
