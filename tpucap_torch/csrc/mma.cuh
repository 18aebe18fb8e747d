// Tensor-core and asynchronous-copy primitives for sm_90a, the building
// blocks of the bf16 routes of the port's kernels:
// 16-byte cp.async with zero fill (K2, K4, K5, K5b), ldmatrix (K2-K5b;
// transposed, K2 only), mma.sync m16n8k16 with
// bf16 operands and f32 accumulators (K2 only), and warpgroup wgmma
// m64nNk16 with A from registers and B from shared memory: N = 32 (K3's
// merge head), 64 (K4, K5, K5b), 128 (K3's projection, K4), 8 (K5b's
// ragged last tile); B K-major everywhere, and MN-major where K5 and K5b
// multiply by a tile stored by rows of the contraction (P V, dS K, P^T dO,
// dS^T Q). lstm_step.cu, decoder_step.cu, bottleneck.cu,
// flash_attention.cu and flash_attention_bwd.cu.
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

// -- wgmma (sm_90a): a warpgroup's 64 x N product --------------------------
//
// d (64 x N, f32) += a b with A from registers (each warp of the warpgroup
// its 16 rows, in mma.sync's A layout, e.g. from ldmatrix_x4) and B read by
// the tensor cores from shared memory, a tile of 128-byte rows (64 bf16)
// stored with swz above from a 1024-byte aligned base, so that the layout
// is wgmma's 128-byte swizzle; 8-row groups 1024 bytes apart.
//   kTrans 0, K-major (mma.sync's .col operand): B[k][n] at row n, column
//     k; N rows of 64 k. Step kk (16 deep) is smem_desc(base + 32 kk).
//   kTrans 1, MN-major: B[k][n] at row k, column n, N = 64; step kk is 16
//     rows, smem_desc(base + 2048 kk).
// Each warp's accumulators are in mma.sync's C layout, n8 tile j in d[j].
// Data that cp.async wrote must be made visible to the tensor cores
// (fence.proxy.async) before the barrier that publishes it; TMA's writes
// are visible once their mbarrier phase completes.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int N, int kTrans = 0>
struct Wgmma;
template <int kTrans>
struct Wgmma<8, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[1][4], const unsigned (&a)[4], uint64_t b,
                                             bool acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)),
          "n"(kTrans));
  }
};
template <int kTrans>
struct Wgmma<32, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[4][4], const unsigned (&a)[4],
                                             uint64_t b, bool acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)), "n"(kTrans));
  }
};
template <int kTrans>
struct Wgmma<64, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[8][4], const unsigned (&a)[4],
                                             uint64_t b, bool acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)), "n"(kTrans));
  }
};
template <int kTrans>
struct Wgmma<128, kTrans> {
  __device__ __forceinline__ static void run(float (&d)[16][4], const unsigned (&a)[4],
                                             uint64_t b, bool acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)), "n"(kTrans));
  }
};

// Keeps the compiler from moving writes of d or a below the wgmma fence,
// or reads of d (and reuse of a's registers) above the wait: the wgmmas
// read a and write d after their asm has returned.
template <int NT, int NA>
__device__ __forceinline__ void pin(float (&d)[NT][4], unsigned (&a)[NA][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Commits the warpgroup's wgmmas so far and waits until at most kPending
// groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace mma
}  // namespace tpucap
