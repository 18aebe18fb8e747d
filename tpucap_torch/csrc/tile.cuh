// One warp's 16 x 16 output tile with an f32 accumulator, the building
// block of kernels K4 (bottleneck.cu) and K5 (flash_attention.cu).
//
//   acc += A (16 x 16, row-major, leading dimension lda)
//        @ B (16 x 16; element (k, n) at b[n * ldb + k] when kBCol,
//             at b[k * ldb + n] otherwise)
//
// bf16 operands go through the tensor cores (nvcuda::wmma, f32 accumulate);
// f32 operands through f32 FMAs, with no TF32, so an f32 flow keeps f32
// products. For wmma every pointer must be 32-byte aligned and every
// leading dimension a multiple of 8 elements (16 for the f32 accumulator's
// load/store, which wants a multiple of 4 floats).
//
// Lane ownership of the f32 tile: lane l holds rows l / 16 + 2 i, i < 8,
// of column l % 16.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace tpucap {

template <typename T, bool kBCol>
struct Tile;

template <bool kBCol>
struct Tile<__nv_bfloat16, kBCol> {
  using LayoutB =
      std::conditional_t<kBCol, nvcuda::wmma::col_major, nvcuda::wmma::row_major>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc;

  __device__ void zero() { nvcuda::wmma::fill_fragment(acc, 0.0f); }
  __device__ void load(const float* p, int ld) {
    nvcuda::wmma::load_matrix_sync(acc, p, ld, nvcuda::wmma::mem_row_major);
  }
  __device__ void store(float* p, int ld) const {
    nvcuda::wmma::store_matrix_sync(p, acc, ld, nvcuda::wmma::mem_row_major);
  }
  __device__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b,
                      int ldb) {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           nvcuda::wmma::row_major>
        fa;
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           LayoutB>
        fb;
    nvcuda::wmma::load_matrix_sync(fa, a, lda);
    nvcuda::wmma::load_matrix_sync(fb, b, ldb);
    nvcuda::wmma::mma_sync(acc, fa, fb, acc);
  }
};

template <bool kBCol>
struct Tile<float, kBCol> {
  float acc[8];

  __device__ static int col() { return threadIdx.x % 16; }
  __device__ static int row(int i) { return (threadIdx.x % 32) / 16 + 2 * i; }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  }
  __device__ void load(const float* p, int ld) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = p[row(i) * ld + col()];
  }
  __device__ void store(float* p, int ld) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[row(i) * ld + col()] = acc[i];
  }
  __device__ void mma(const float* a, int lda, const float* b, int ldb) {
    float bk[16];  // this lane's column of B
#pragma unroll
    for (int k = 0; k < 16; ++k)
      bk[k] = kBCol ? b[col() * ldb + k] : b[k * ldb + col()];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* ar = a + row(i) * lda;
      float s = acc[i];
#pragma unroll
      for (int k = 0; k < 16; ++k) s = fmaf(ar[k], bk[k], s);
      acc[i] = s;
    }
  }
};

// x rounded to T and back (identity for f32): the TPU kernels' downcasts.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

}  // namespace tpucap
