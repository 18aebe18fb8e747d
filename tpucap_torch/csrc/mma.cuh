// Warp-level tensor-core and asynchronous-copy primitives for sm_90a, the
// building blocks of the bf16 routes of kernels K2 (lstm_step.cu) and K5
// (flash_attention.cu): 16-byte cp.async with zero fill, ldmatrix (plain
// and transposed) and mma.sync m16n8k16 with bf16 operands and f32
// accumulators.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// lane = 4 g + t:
//   A, 16 x 16 row-major: a[0] = (row g, cols 2t, 2t+1), a[1] = (g+8, 2t..),
//                         a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..)
//   B, 16 x 8:            b[0] = (rows k = 2t, 2t+1; col n = g), b[1] = (k 2t+8..; g)
//   C, 16 x 8 f32:        c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (g+8, ..)
// Each 32-bit register holds two bf16, the lower index in the low half.
//
// Shared tiles are rows of 64 bf16 (128 bytes, eight 16-byte chunks).
// Chunk c of row r is stored at chunk c ^ (r % 8), so the eight rows that
// one ldmatrix phase reads fall on eight different sets of banks.
#pragma once

#include "common.cuh"

namespace tpucap {
namespace mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ unsigned swz(int row, int chunk) {
  return static_cast<unsigned>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// One 16-byte asynchronous copy from global to shared memory; with
// valid == false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void copy16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace mma
}  // namespace tpucap
