// Kernel K4: ResNet-50's identity bottleneck block in one launch,
//   out = relu(x + c3(relu(c2(relu(c1(x))))))
// for BN-folded 1x1 (C -> M), 3x3 (M -> M, SAME) and 1x1 (M -> C) convs
// with biases, stride 1, no conv shortcut.
//
// Replaces tpucap/ops/pallas/bottleneck.py:fused_identity_block (Pallas
// kernel _block_kernel), and keeps its numerics: each conv accumulates in
// f32 and is rounded to the activation dtype before its bias is added in
// that dtype; the 3x3's nine taps share one f32 accumulator; the output is
// relu((y3 + b3) + x), each add rounded to the activation dtype. y1 outside
// the image is 0 (the TPU kernel zeroes the halo of y1, not of x).
//
// Bound on an H100 (batch 256, bf16): x read once and out written once are
// 0.82 GB at 56x56 (0.245 ms) and 0.41 GB at 28x28 (0.123 ms), so the early
// stages are bound by bytes; at 14x14 and 7x7 the 111.8 GFLOP of each block
// take 0.113 ms at 989 TFLOP/s, so they are bound by operations.
//
// Design. The TPU kernel holds whole images and their halo in 12 MiB of
// VMEM. A Hopper block has at most 227 KB of shared memory, so one block
// owns one (image, TH x TW output tile) and keeps only that tile's
// intermediates on chip:
//   1. y1 on the (TH+2) x (TW+2) halo, x staged through shared memory in
//      64-channel chunks; y1 kept in shared memory in the activation dtype
//      (zero outside the image);
//   2. the 3x3 as nine shifted products read straight from y1 in shared
//      memory. Rows are computed on the halo's width (TW+2), so tap
//      (dy, dx) is the same matrix shifted by dy*(TW+2)+dx rows; the two
//      extra columns per row are computed and never stored. y2 stays in
//      shared memory;
//   3. conv3 in 64-channel passes over C, with b3, the residual x (staged
//      beside the weights) and relu in the epilogue, out written once.
// Weights go through shared memory too, one 64 x 64 chunk at a time, read
// as they lie on the card (OIHW in channels_last memory, i.e. (out, kh,
// kw, in) bytes). Every copy into shared memory is a 16-byte cp.async,
// all of a chunk's in flight at once, zero-filled outside the image.
// Every product is a warp-level 16x16 tile (tile.cuh): bf16 tensor cores
// (wmma) with f32 accumulators for bf16, f32 FMAs for f32. This is the
// simple version: nothing is double-buffered, and a TMA/wgmma pipeline is
// later work.
#include "tile.cuh"

namespace {

using tpucap::round_to;
using tpucap::Tile;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNC = 64;        // output channels per pass
constexpr int kKC = 64;        // reduction depth per staged chunk
constexpr int kLdC = kKC + 8;  // row stride of the staged x and weight chunks
constexpr int kMaxTiles = 4;   // 16x16 tiles per warp per pass
constexpr int kMaxRows = kWarps * kMaxTiles * 16 / (kNC / 16);  // 128
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may have

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

struct Geometry {
  int TH, TW;  // output tile
  int P1;      // halo pixels (TH+2)*(TW+2)
  int R1;      // stage-1 rows (halo, padded to 16)
  int R2;      // stage-2/3 rows: TH rows of TW+2 columns, padded to 16
  int Y1R;     // y1 rows: the 3x3's shifted reads run past the halo
  __host__ __device__ Geometry(int th, int tw) : TH(th), TW(tw) {
    P1 = (TH + 2) * (TW + 2);
    R1 = round16(P1);
    R2 = round16(TH * (TW + 2));
    const int need = R2 + 2 * (TW + 2) + 2;
    Y1R = round16(R1 > need ? R1 : need);
  }
  // y1 and y2 rows are M + 16 elements apart: 32-byte aligned at any row
  // (the 3x3's shifted reads start anywhere) and 8 banks apart, so a
  // fragment's 16 rows are read in 4 wavefronts, not 16.
  __host__ __device__ size_t smem(int M, size_t es) const {
    return (static_cast<size_t>(Y1R + R2) * (M + 16) +
            static_cast<size_t>(R1 + kNC) * kLdC) * es;
  }
};

// One 16-byte asynchronous copy from global to shared memory; with
// valid == false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Waits for this thread's copies, then for every thread's.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Rows n0 .. n0+kNC of a weight matrix (row stride ldw, elements), columns
// k0 .. k0+kKC, into ws[kNC][kLdC], each row a contiguous 128 (bf16) or
// 256 (f32) bytes.
template <typename T>
__device__ void stage_weights(T* ws, const T* w, int64_t ldw, int n0, int64_t k0) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < kNC * (kKC / kVec); i += kThreads) {
    const int n = i / (kKC / kVec), k = (i % (kKC / kVec)) * kVec;
    copy16(ws + n * kLdC + k, w + (n0 + n) * ldw + k0 + k, true);
  }
}

// x at rows of a pixel grid (row r -> pixel (oy + r / rw, ox + r % rw),
// rows >= valid_rows and pixels outside the image zero), channels
// c0 .. c0+kKC, into dst[R][kLdC].
template <typename T>
__device__ void stage_pixels(T* dst, const T* xb, int R, int valid_rows, int rw,
                             int oy, int ox, int H, int W, int C, int c0) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < R * (kKC / kVec); i += kThreads) {
    const int r = i / (kKC / kVec), k = (i % (kKC / kVec)) * kVec;
    const int gy = oy + r / rw, gx = ox + r % rw;
    const bool in = r < valid_rows && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = in ? xb + (static_cast<int64_t>(gy) * W + gx) * C + c0 + k : xb;
    copy16(dst + r * kLdC + k, src, in);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    identity_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                          const T* __restrict__ b1, const T* __restrict__ w2,
                          const T* __restrict__ b2, const T* __restrict__ w3,
                          const T* __restrict__ b3, T* __restrict__ out, int H,
                          int W, int C, int M, int TH, int TW) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g(TH, TW);
  const int HW2 = TW + 2;
  const int ldy = M + 16;
  T* y1 = reinterpret_cast<T*>(smem);  // Y1R x ldy
  T* y2 = y1 + g.Y1R * ldy;            // R2 x ldy
  T* xs = y2 + g.R2 * ldy;             // R1 x kLdC: a chunk of x (stage 1)
  T* ws = xs + g.R1 * kLdC;            // kNC x kLdC: a chunk of weights
  // After a pass's last product, ws is free: each warp's 16x16 epilogue
  // tile goes there (8 x 1 KB <= kNC * kLdC * sizeof(T)).
  float* ebuf = reinterpret_cast<float*>(ws);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* eb = ebuf + warp * 256;
  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int64_t img = static_cast<int64_t>(blockIdx.y) * H * W * C;
  const T* xb = x + img;
  T* ob = out + img;
  const T zero = tpucap::from_f32<T>(0.0f);

  // y1 rows past the halo feed only the discarded columns of stage 2.
  for (int i = tid; i < (g.Y1R - g.R1) * ldy; i += kThreads) y1[g.R1 * ldy + i] = zero;

  // -- stage 1: y1 = relu(round(x @ w1) + b1) on the halo -----------------
  const int tiles1 = (g.R1 / 16) * (kNC / 16);
  for (int n0 = 0; n0 < M; n0 += kNC) {
    Tile<T, true> t[kMaxTiles];
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) t[j].zero();
    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();  // every warp is done with the previous chunk
      stage_pixels(xs, xb, g.R1, g.P1, HW2, ty0 - 1, tx0 - 1, H, W, C, k0);
      stage_weights(ws, w1, C, n0, k0);
      copies_done();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16)
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          const int tt = warp + kWarps * j;
          if (tt >= tiles1) continue;
          const int rt = tt / (kNC / 16), ct = tt % (kNC / 16);
          t[j].mma(xs + rt * 16 * kLdC + kk, kLdC, ws + ct * 16 * kLdC + kk, kLdC);
        }
    }
    __syncthreads();  // ws becomes the epilogue buffer
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int tt = warp + kWarps * j;
      if (tt >= tiles1) continue;
      const int rt = tt / (kNC / 16), ct = tt % (kNC / 16);
      const int n = n0 + ct * 16 + lane % 16;  // this lane's column
      const float bias = tpucap::to_f32(b1[n]);
      t[j].store(eb, 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16;
        const int gy = ty0 - 1 + r / HW2, gx = tx0 - 1 + r % HW2;
        float v = 0.0f;
        if (r < g.P1 && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = fmaxf(round_to<T>(round_to<T>(eb[e]) + bias), 0.0f);
        y1[r * ldy + n] = tpucap::from_f32<T>(v);
      }
      __syncwarp();
    }
  }

  // -- stage 2: y2 = relu(round(sum over 9 taps of y1 shifted @ w2) + b2) --
  const int tiles2 = (g.R2 / 16) * (kNC / 16);
  for (int n0 = 0; n0 < M; n0 += kNC) {
    Tile<T, true> t[kMaxTiles];
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) t[j].zero();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HW2 + tap % 3;
      for (int k0 = 0; k0 < M; k0 += kKC) {
        __syncthreads();  // y1 complete; every warp is done with ws
        stage_weights(ws, w2, 9 * static_cast<int64_t>(M), n0, tap * static_cast<int64_t>(M) + k0);
        copies_done();
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16)
#pragma unroll
          for (int j = 0; j < kMaxTiles; ++j) {
            const int tt = warp + kWarps * j;
            if (tt >= tiles2) continue;
            const int rt = tt / (kNC / 16), ct = tt % (kNC / 16);
            t[j].mma(y1 + (rt * 16 + shift) * ldy + k0 + kk, ldy, ws + ct * 16 * kLdC + kk, kLdC);
          }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int tt = warp + kWarps * j;
      if (tt >= tiles2) continue;
      const int rt = tt / (kNC / 16), ct = tt % (kNC / 16);
      const int n = n0 + ct * 16 + lane % 16;
      const float bias = tpucap::to_f32(b2[n]);
      t[j].store(eb, 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16;
        const float v = round_to<T>(round_to<T>(eb[e]) + bias);
        y2[r * ldy + n] = tpucap::from_f32<T>(fmaxf(v, 0.0f));
      }
      __syncwarp();
    }
  }

  // -- stage 3: out = relu(round(round(y2 @ w3) + b3) + x) ----------------
  for (int n0 = 0; n0 < C; n0 += kNC) {
    Tile<T, true> t[kMaxTiles];
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) t[j].zero();
    for (int k0 = 0; k0 < M; k0 += kKC) {
      __syncthreads();  // y2 complete; every warp is done with ws and xs
      stage_weights(ws, w3, M, n0, k0);
      // The residual for this pass's channels, into xs (free after stage 1).
      if (k0 == 0) stage_pixels(xs, xb, g.R2, TH * HW2, HW2, ty0, tx0, H, W, C, n0);
      copies_done();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16)
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          const int tt = warp + kWarps * j;
          if (tt >= tiles2) continue;
          const int rt = tt / (kNC / 16), ct = tt % (kNC / 16);
          t[j].mma(y2 + rt * 16 * ldy + k0 + kk, ldy, ws + ct * 16 * kLdC + kk, kLdC);
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int tt = warp + kWarps * j;
      if (tt >= tiles2) continue;
      const int rt = tt / (kNC / 16), ct = tt % (kNC / 16);
      const int c = ct * 16 + lane % 16, n = n0 + c;
      const float bias = tpucap::to_f32(b3[n]);
      t[j].store(eb, 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16;
        const int py = r / HW2, px = r % HW2;
        const int gy = ty0 + py, gx = tx0 + px;
        if (py >= TH || px >= TW || gy >= H || gx >= W) continue;
        float v = round_to<T>(round_to<T>(eb[e]) + bias);
        v = round_to<T>(v + tpucap::to_f32(xs[r * kLdC + c]));
        ob[(static_cast<int64_t>(gy) * W + gx) * C + n] = tpucap::from_f32<T>(fmaxf(v, 0.0f));
      }
      __syncwarp();
    }
  }
}

// Output tile: the widest TW <= 8 that divides W (56 -> 8, 28/14/7 -> 7),
// TH likewise, then TH shrinks until the rows and shared memory fit (bf16
// fits every stage at 8x8 or 7x7; f32 at 7x7 with M = 512 needs TH = 1).
template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int B,
           int H, int W, int C, int M, cudaStream_t stream) {
  if (C % kNC || M % kNC || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int TW = W < 8 ? W : 8, TH = H < 8 ? H : 8;
  while (W % TW) --TW;
  while (H % TH) --TH;
  auto fits = [&](int th) {
    const Geometry g(th, TW);
    return g.R1 <= kMaxRows && g.R2 <= kMaxRows && g.smem(M, sizeof(T)) <= kMaxSmem;
  };
  while (TH > 1 && !fits(TH)) --TH;
  if (!fits(TH)) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // once per dtype, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        identity_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const size_t smem = Geometry(TH, TW).smem(M, sizeof(T));
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  identity_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(out), H, W, C, M, TH, TW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, H, W, C); w1 (M, C); w2 (M, 3, 3, M); w3 (C, M); b1, b2 (M,);
// b3 (C,); all contiguous, one dtype. C and M multiples of 64.
extern "C" int tpucap_identity_block(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* out, int B, int H,
                                     int W, int C, int M, int dtype,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpucap::kF32:
      return launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, s);
    case tpucap::kBF16:
      return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C,
                                   M, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
