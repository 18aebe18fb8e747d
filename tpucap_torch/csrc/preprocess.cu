// Kernel K1: uint8 RGB batch -> resized, mode-normalized float batch.
//
// Replaces tpucap/ops/preprocess.py:normalize_images (Pallas kernel
// _normalize_kernel) together with the XLA gather of resize_nearest, i.e.
// fused_preprocess: out[b, y, x, ch] = scale[ch] * in[b, rows[y], cols[x],
// flip ? 2 - ch : ch] + bias[ch], computed in f32 and stored in the output
// dtype, NHWC (so the result is already channels_last for the conv stem).
//
// Bound on an H100: bytes. Each uint8 input is read once and each output
// written once (about 115 MB at (256, 224, 224, 3) u8 -> bf16); the work is
// one fused multiply-add per element. Design: one pass and no
// intermediate; one thread per output pixel, so a warp stores 96
// contiguous elements; the row and column maps (PIL nearest indices) are
// small int32 tables the block reads from L1/L2. The TPU kernel's widening
// through int32 works around a Mosaic limit and is not needed here.
#include "common.cuh"

namespace {

template <typename TOut>
__global__ void preprocess_u8_kernel(const uint8_t* __restrict__ src,
                                     const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ cols,
                                     TOut* __restrict__ out, int H, int W,
                                     int S_h, int S_w, float s0, float s1,
                                     float s2, float b0, float b1, float b2,
                                     int flip) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= S_w) return;
  const int y = blockIdx.y;
  const int64_t b = blockIdx.z;
  const uint8_t* p =
      src + ((b * H + rows[y]) * static_cast<int64_t>(W) + cols[x]) * 3;
  const float v0 = static_cast<float>(p[flip ? 2 : 0]);
  const float v1 = static_cast<float>(p[1]);
  const float v2 = static_cast<float>(p[flip ? 0 : 2]);
  TOut* o = out + ((b * S_h + y) * static_cast<int64_t>(S_w) + x) * 3;
  o[0] = tpucap::from_f32<TOut>(__fmaf_rn(v0, s0, b0));
  o[1] = tpucap::from_f32<TOut>(__fmaf_rn(v1, s1, b1));
  o[2] = tpucap::from_f32<TOut>(__fmaf_rn(v2, s2, b2));
}

template <typename TOut>
void launch(const uint8_t* src, const int32_t* rows, const int32_t* cols,
            void* out, int B, int H, int W, int S_h, int S_w, const float* s,
            const float* bias, int flip, cudaStream_t stream) {
  constexpr int kThreads = 128;
  dim3 grid((S_w + kThreads - 1) / kThreads, S_h, B);
  preprocess_u8_kernel<TOut><<<grid, kThreads, 0, stream>>>(
      src, rows, cols, static_cast<TOut*>(out), H, W, S_h, S_w, s[0], s[1],
      s[2], bias[0], bias[1], bias[2], flip);
}

}  // namespace

extern "C" int tpucap_preprocess_u8(const void* src, const void* rows,
                                    const void* cols, void* out, int B, int H,
                                    int W, int S_h, int S_w,
                                    const float* scale, const float* bias,
                                    int flip, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint8_t*>(src);
  auto r = static_cast<const int32_t*>(rows);
  auto c = static_cast<const int32_t*>(cols);
  switch (out_dtype) {
    case tpucap::kF32:
      launch<float>(in, r, c, out, B, H, W, S_h, S_w, scale, bias, flip, s);
      break;
    case tpucap::kBF16:
      launch<__nv_bfloat16>(in, r, c, out, B, H, W, S_h, S_w, scale, bias,
                            flip, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
