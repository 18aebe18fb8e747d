// Tensor Memory Accelerator (TMA) loads for sm_90a: one thread asks for a
// whole tile of a bf16 tensor to be copied into shared memory with the
// 128-byte swizzle (the layout of mma.cuh's swz, and of wgmma's B operand,
// when the destination is 1024-byte aligned), zero-filling whatever of the
// box lies outside the tensor; completion is counted in bytes on an
// mbarrier in shared memory. Used by kernels K3's merge head and
// projection (decoder_step.cu) and K4 (bottleneck.cu).
//
// The tensor map is encoded on the host with the driver's
// cuTensorMapEncodeTiled, found through the runtime, so nothing links
// against libcuda; it reaches the kernel as a __grid_constant__ parameter.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace tpucap {
namespace tma {

// A tiled map of a bf16 tensor: dims[0] is the contiguous one, with 64
// elements (128 bytes) in the box; strides in bytes for dims 1.. (multiples
// of 16); box sizes at most 256. Returns a cudaError_t as int.
inline int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn) {
      fn = nullptr;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorSymbolNotFound);
    }
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A row-major (rows, cols) bf16 matrix with row stride ld elements, read in
// boxes of box_rows rows x 64 columns.
inline int encode_2d(CUtensorMap* map, const void* base, int rows, int cols, int64_t ld,
                     int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return encode(map, base, 2, dims, strides, box);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialised mbarriers visible to the async proxy; then a barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, announcing `bytes` more to come by TMA.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void load_2d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                        int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                        int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace tma
}  // namespace tpucap
