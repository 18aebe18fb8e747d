// Kernel K1: uint8 RGB batch -> resized, mode-normalized float batch.
//
// Replaces tpucap/ops/preprocess.py:normalize_images (Pallas kernel
// _normalize_kernel) together with the XLA gather of resize_nearest, i.e.
// fused_preprocess: out[b, y, x, ch] = scale[ch] * in[b, rows[y], cols[x],
// flip ? 2 - ch : ch] + bias[ch], computed in f32 (one fused multiply-add)
// and stored in the output dtype, NHWC (so the result is already
// channels_last for the conv stem).
//
// Bound on an H100: bytes. Each uint8 input is read once and each output
// written once (about 115 MB at (256, 224, 224, 3) u8 -> bf16, 34.5 us at
// 3.35 TB/s); the work is one multiply-add per element. So the design is
// about keeping bytes in flight with few instructions per byte, and about
// whole sectors per memory instruction. The TPU kernel's widening through
// int32 works around a Mosaic limit and is not needed here; a byte becomes
// a float exactly through its bits (byte_to_f32).
//
// Same size (the main path: 224 in, 224 out; rows and cols are then the
// identity, so output element e reads input element e of its pixel):
// preprocess_u8_same_kernel. A lane takes 8 whole pixels (24 bytes in, 24
// outputs), so every element's channel, and the flip, are known at compile
// time and no table is read. A warp's 256 pixels pass through shared
// memory: 16-byte loads of its 768 contiguous bytes, and its outputs written
// back with 16-byte stores that are contiguous across the warp (three a
// lane in bf16, six in f32). Each lane storing its own 48 bytes directly
// was 12 % slower, 16 pixels a lane 1.9x slower (PERF.md, K1's versions).
// The last, partial warp takes its lanes' pixels directly, and pixels past
// a multiple of 8 one element at a time.
//
// Any other size: preprocess_u8_gather_kernel. A block makes R output rows
// of one image. It stages their R source rows (W x 3 bytes each) and the
// column map in shared memory, the rows with 16-byte loads (byte loads for
// a row's unaligned head and tail: rows of W x 3 bytes need not start on 16
// bytes). Then the block's lanes take consecutive outputs of its rows (the
// rows are contiguous in the output, whatever S_w), so a warp's reads of
// the staged rows fall on consecutive words and each store writes 32
// consecutive outputs; a thread steps through the rows without dividing.
// Each thread walking 8 outputs of its own 16-byte chunk read shared memory
// 32 bytes a lane apart (8-way bank conflicts) and lost to the earlier
// one-thread-a-pixel kernel it replaced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // output rows per gather block, fewer if shared memory is short

struct Affine {
  float s0, s1, s2, b0, b1, b2;
};

// Byte `k` (0..3) of w as a float, exactly: 2^23 + byte through the bits,
// less 2^23.
__device__ __forceinline__ float byte_to_f32(unsigned w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + k)) - 8388608.0f;
}

template <int kCh>
__device__ __forceinline__ float affine(float x, const Affine& a) {
  if constexpr (kCh == 0) return __fmaf_rn(x, a.s0, a.b0);
  if constexpr (kCh == 1) return __fmaf_rn(x, a.s1, a.b1);
  return __fmaf_rn(x, a.s2, a.b2);
}

__device__ __forceinline__ float affine(float x, int ch, const Affine& a) {
  const float s = ch == 0 ? a.s0 : (ch == 1 ? a.s1 : a.s2);
  const float b = ch == 0 ? a.b0 : (ch == 1 ? a.b1 : a.b2);
  return __fmaf_rn(x, s, b);
}

// n consecutive values (n a multiple of 16 bytes' worth) to 16-byte aligned
// dst, in the output dtype.
template <int N>
__device__ __forceinline__ void store(float* dst, const float (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
}
template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    unsigned p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(y[i + 2 * j], y[i + 2 * j + 1]);
      p[j] = *reinterpret_cast<const unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// 8 pixels from 24 bytes (6 words) to 24 outputs, channels flipped or not.
template <bool kFlip>
__device__ __forceinline__ void pixels8(const unsigned (&w)[6], const Affine& a, float (&y)[24]) {
#pragma unroll
  for (int px = 0; px < 8; ++px) {
    const int e = 3 * px;
    const float c0 = byte_to_f32(w[e / 4], e % 4);
    const float c1 = byte_to_f32(w[(e + 1) / 4], (e + 1) % 4);
    const float c2 = byte_to_f32(w[(e + 2) / 4], (e + 2) % 4);
    y[e] = affine<0>(kFlip ? c2 : c0, a);
    y[e + 1] = affine<1>(c1, a);
    y[e + 2] = affine<2>(kFlip ? c0 : c2, a);
  }
}

template <typename TOut, bool kFlip>
__global__ void __launch_bounds__(kThreads)
    preprocess_u8_same_kernel(const uint8_t* __restrict__ src, TOut* __restrict__ out,
                              int64_t pixels, Affine a) {
  constexpr int kOut = 24 * sizeof(TOut);  // a lane's 8 pixels, in bytes out
  __shared__ __align__(16) unsigned char in_s[kThreads / 32][32 * 24];
  __shared__ __align__(16) unsigned char out_s[kThreads / 32][32 * kOut];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 8;
  const int64_t wp0 = p0 - 8 * lane;  // the warp's first pixel
  float y[24];
  if (wp0 + 256 <= pixels && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    // The warp's 768 bytes in and 32 kOut bytes out pass through shared
    // memory, so that every global load and store is 16 bytes a lane,
    // contiguous across the warp.
    const uint4* gs = reinterpret_cast<const uint4*>(src + 3 * wp0);
    uint4* si = reinterpret_cast<uint4*>(in_s[warp]);
    si[lane] = gs[lane];
    if (lane < 16) si[32 + lane] = gs[32 + lane];
    __syncwarp();
    const uint2* s = reinterpret_cast<const uint2*>(in_s[warp] + 24 * lane);
    const uint2 q0 = s[0], q1 = s[1], q2 = s[2];
    const unsigned w[6] = {q0.x, q0.y, q1.x, q1.y, q2.x, q2.y};
    pixels8<kFlip>(w, a, y);
    store(reinterpret_cast<TOut*>(out_s[warp] + kOut * lane), y);
    __syncwarp();
    const uint4* so = reinterpret_cast<const uint4*>(out_s[warp]);
    uint4* go = reinterpret_cast<uint4*>(out + 3 * wp0);
#pragma unroll
    for (int i = 0; i < kOut / 16; ++i) go[32 * i + lane] = so[32 * i + lane];
    return;
  }
  // The last warp (or a source aligned to 8 bytes only): each lane its own
  // 8 pixels, 8-byte loads, 16-byte stores.
  if (p0 >= pixels) return;
  if (p0 + 8 <= pixels) {
    const uint2* s = reinterpret_cast<const uint2*>(src + 3 * p0);
    const uint2 q0 = s[0], q1 = s[1], q2 = s[2];
    const unsigned w[6] = {q0.x, q0.y, q1.x, q1.y, q2.x, q2.y};
    pixels8<kFlip>(w, a, y);
    store(out + 3 * p0, y);
    return;
  }
  for (int64_t e = 3 * p0; e < 3 * pixels; ++e) {
    const int ch = static_cast<int>(e - 3 * p0) % 3;
    const float x = static_cast<float>(src[kFlip ? e + 2 - 2 * ch : e]);
    out[e] = tpucap::from_f32<TOut>(affine(x, ch, a));
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    preprocess_u8_gather_kernel(const uint8_t* __restrict__ src, const int32_t* __restrict__ rows,
                                const int32_t* __restrict__ cols, TOut* __restrict__ out, int H,
                                int W, int S_h, int S_w, int R, int pitch, Affine a, int flip) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* col3 = reinterpret_cast<int*>(smem);  // 3 cols[x]
  int* row_at = col3 + S_w;                   // where staged row r's first byte is
  unsigned char* stage = smem + ((4 * (S_w + R) + 15) & ~15);
  const int tid = threadIdx.x;
  const int b = blockIdx.y, y0 = blockIdx.x * R;
  const int nrows = min(R, S_h - y0);
  const int W3 = 3 * W;

  for (int x = tid; x < S_w; x += kThreads) col3[x] = 3 * cols[x];
  // Source row r sits at stage + r pitch as the 16-byte aligned window
  // around its W3 bytes: chunk c of the window is global bytes lo + 16 c.
  const int nchunk = pitch / 16;
  for (int i = tid; i < nrows * nchunk; i += kThreads) {
    const int r = i / nchunk, c = i - r * nchunk;
    const uint8_t* row = src + (static_cast<int64_t>(b) * H + rows[y0 + r]) * W3;
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    const int off = 16 * c - head;  // the chunk's first byte, relative to the row
    unsigned char* dst = stage + r * pitch + 16 * c;
    if (off >= 0 && off + 16 <= W3) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(row + off);
    } else {
      for (int k = max(0, -off); k < 16 && off + k < W3; ++k) dst[k] = row[off + k];
    }
    if (c == 0) row_at[r] = r * pitch + head;
  }
  __syncthreads();

  // Lanes on consecutive outputs of the block's rows: the shared-memory
  // reads of a warp fall on consecutive words (no bank conflicts), and each
  // store instruction writes 32 consecutive outputs. Output i of the block
  // is (row r, position j of L); a thread steps by kThreads, i.e. by
  // (dr, dj), without dividing.
  const int L = 3 * S_w;
  const int n = nrows * L;
  TOut* o = out + (static_cast<int64_t>(b) * S_h + y0) * L;
  const int dr = kThreads / L, dj = kThreads - dr * L;
  int r = tid / L, j = tid - r * L;
  for (int i = tid; i < n; i += kThreads) {
    const int x = j / 3, ch = j - 3 * x;
    const int from = row_at[r] + col3[x] + (flip ? 2 - ch : ch);
    o[i] = tpucap::from_f32<TOut>(affine(static_cast<float>(stage[from]), ch, a));
    r += dr;
    j += dj;
    if (j >= L) {
      j -= L;
      ++r;
    }
  }
}

template <typename TOut>
int launch(const uint8_t* src, const int32_t* rows, const int32_t* cols, void* out, int B, int H,
           int W, int S_h, int S_w, const Affine& a, int flip, cudaStream_t stream) {
  TOut* o = static_cast<TOut*>(out);
  if (S_h == H && S_w == W && reinterpret_cast<uintptr_t>(src) % 8 == 0) {
    const int64_t pixels = static_cast<int64_t>(B) * H * W;
    const int64_t blocks = (pixels + 8 * kThreads - 1) / (8 * kThreads);
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    if (flip)
      preprocess_u8_same_kernel<TOut, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(src, o, pixels, a);
    else
      preprocess_u8_same_kernel<TOut, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(src, o, pixels, a);
    return static_cast<int>(cudaGetLastError());
  }
  // Gather: R rows a block, as many as fit in 48 KB (at least one, up to
  // the card's 227 KB for very wide images).
  const int pitch = 16 * ((3 * W + 15) / 16 + 1);
  const int table = (4 * (S_w + kRows) + 15) & ~15;
  int R = (48 * 1024 - table) / pitch;
  R = R < 1 ? 1 : (R > kRows ? kRows : R);
  const size_t smem = static_cast<size_t>((4 * (S_w + R) + 15) & ~15) + static_cast<size_t>(R) * pitch;
  if (smem > 227 * 1024 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(preprocess_u8_gather_kernel<TOut>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S_h + R - 1) / R, B);
  preprocess_u8_gather_kernel<TOut><<<grid, kThreads, smem, stream>>>(src, rows, cols, o, H, W, S_h,
                                                                       S_w, R, pitch, a, flip);
  return static_cast<int>(cudaGetLastError());
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
  const Affine a{scale[0], scale[1], scale[2], bias[0], bias[1], bias[2]};
  if (B < 1 || S_h < 1 || S_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (out_dtype) {
    case tpucap::kF32:
      return launch<float>(in, r, c, out, B, H, W, S_h, S_w, a, flip, s);
    case tpucap::kBF16:
      return launch<__nv_bfloat16>(in, r, c, out, B, H, W, S_h, S_w, a, flip, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
