// Kernel K4: ResNet-50's identity bottleneck block in one launch,
//   out = relu(x + c3(relu(c2(relu(c1(x))))))
// for BN-folded 1x1 (C -> M), 3x3 (M -> M, SAME) and 1x1 (M -> C) convs
// with biases, stride 1, no conv shortcut.
//
// Replaces tpucap/ops/pallas/bottleneck.py:fused_identity_block (Pallas
// kernel _block_kernel, :47-88), and keeps its numerics: each conv
// accumulates in f32 and is rounded to the activation dtype before its bias
// is added in that dtype; the 3x3's nine taps share one f32 accumulator;
// the output is relu((y3 + b3) + x), each add rounded to the activation
// dtype. y1 outside the image is 0 (the TPU kernel zeroes the halo of y1,
// not of x).
//
// Bound on an H100 (batch 256, bf16): x read once and out written once are
// 0.82 GB at 56x56 (0.245 ms) and 0.41 GB at 28x28 (0.123 ms), so the early
// stages are bound by bytes; at 14x14 and 7x7 the 111.8 GFLOP of each block
// take 0.113 ms at 989 TFLOP/s, so they are bound by operations.
//
// Tiling (both routes). The TPU kernel holds whole images and their halo in
// 12 MiB of VMEM. A Hopper block has at most 227 KB of shared memory, so one
// block owns one (image, TH x TW output tile) and keeps only that tile's
// intermediates on chip:
//   1. y1 on the (TH+2) x (TW+2) halo, from x staged through shared memory
//      in 64-channel chunks; y1 kept in shared memory (zero outside the
//      image);
//   2. the 3x3 as nine shifted products read straight from y1. Rows are
//      computed on the halo's width (TW+2), so tap (dy, dx) is the same
//      matrix shifted by dy*(TW+2)+dx rows; the two extra columns per row
//      are computed and never stored. y2 stays in shared memory;
//   3. conv3 over C in passes, with b3, the residual x and relu in the
//      epilogue, out written once.
// Weights are read as they lie on the card (OIHW in channels_last memory,
// i.e. (out, kh, kw, in) bytes): N rows with K contiguous, mma's .col B
// operand as it is. Every copy into shared memory is a 16-byte cp.async,
// zero-filled outside the image.
//
// bf16 route (identity_block_kernel_mma; mma.cuh, tma.cuh): one stream of
// 64-deep chunks runs through all three stages (stage 1: a chunk of w1 and
// of x on the halo; stages 2-3: a chunk of w2 or w3), each chunk one or two
// TMA requests by one thread into a 3-stage ring on mbarriers (x's box
// reaches past the image edge, where the TMA unit fills zeros), one block
// barrier a chunk, so chunk q+2 is in flight while chunk q is multiplied.
// Passes are 128 output channels wide (64 when M = 64). Two warpgroups
// split a pass's rows when it has more than 64 (each 64 x N), else its
// columns (64 each); per 16-deep step one wgmma (m64n64k16 or m64n128k16,
// f32 accumulators) with A from ldmatrix fragments and B, the weights, read
// by the tensor cores from the ring. The 3x3's shifted A reads start at
// any row, which a wgmma descriptor cannot, but ldmatrix takes one row
// address a lane; y1 and y2 rows are M + 8 elements apart (16 bytes past a
// multiple of 128), so eight consecutive rows fall on distinct banks
// whatever the shift. Epilogues work on the accumulator registers: y1 and
// y2 as bf16x2 stores into shared memory; out after a 4 x 4 transpose
// within each quad of lanes, so each lane owns 8 consecutive channels,
// adds the residual from one 16-byte load of x (in L2 since stage 1) and
// stores 16 bytes. Shared memory: y1 | (x ring in stage 1, y2 after) |
// weight ring, 107-111 KB (2 blocks an SM) at conv2-3, 135 and 212 KB at
// conv4-5. Tiles are 8 or 7 on a side (a divisor of the image side from 8
// down to 5, else 8 with a ragged last tile). C must be a multiple of 128.
// What the versions taught (PERF.md, K4's versions): each chunk's time was
// set by the serial work of every warp, not by the tensor cores or by L2,
// the loads landing in time: per-thread cp.async issue (gone with TMA),
// then integer division of the chunk index in every thread (gone: nested
// loops walk the stream, a cursor the loads). Leaving the wgmmas in flight
// across chunks (the compiler then fences their registers), and a ring
// depth chosen at run time, were slower.
//
// f32 route (identity_block_kernel): 64-wide passes of warp-level 16x16
// tiles (tile.cuh, f32 FMAs, no TF32), one 64 x 64 weight chunk at a time,
// all of a chunk's copies in flight and then a barrier.
#include "mma.cuh"
#include "tma.cuh"
#include "tile.cuh"

namespace {

using tpucap::round_to;
using tpucap::Tile;
using tpucap::mma::copy16;
using tpucap::mma::smem_addr;

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
    copy16(smem_addr(ws + n * kLdC + k), w + (n0 + n) * ldw + k0 + k, true);
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
    copy16(smem_addr(dst + r * kLdC + k), src, in);
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

// -- bf16: wgmma with a copy ring ---------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kRing = 3;               // stages of the copy ring
constexpr int kWSlot = 128 * 128;      // a weight chunk: 128 rows of 64 bf16
constexpr int kNC3 = 128;              // stage 3's pass width

// From a 1024-byte aligned base: y1 | union(x ring, y2) | weight ring |
// an mbarrier per ring stage, in bytes. The rings' slots start on 1024
// bytes (the 128-byte swizzle of TMA and wgmma); rows of y1 and y2 are
// 2 (M + 8) bytes apart.
__host__ __device__ inline int align1k(int n) { return (n + 1023) / 1024 * 1024; }
__host__ __device__ inline int x_slot(const Geometry& g) { return align1k(g.R1 * 128); }
__host__ __device__ inline int union_offset(const Geometry& g, int M) {
  return align1k(g.Y1R * 2 * (M + 8));
}
__host__ __device__ inline int ring_offset(const Geometry& g, int M) {
  const int y2 = g.R2 * 2 * (M + 8), xr = kRing * x_slot(g);
  return align1k(union_offset(g, M) + (y2 > xr ? y2 : xr));
}
__host__ __device__ inline size_t smem_mma(const Geometry& g, int M) {
  return 1024 + static_cast<size_t>(ring_offset(g, M)) + kRing * kWSlot + 8 * kRing;
}

__device__ __forceinline__ float rnd(float v) { return round_to<bf16>(v); }

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// One 64-deep chunk into the warpgroup's 64 x N accumulators: A rows from
// ldmatrix (row `row` of this warp's 16, 16-byte chunk c at a0 + swz(row,
// c) when kSwz, else a0 + row * lda + 16 c), B = N weight rows from w_t.
template <int N, bool kSwz>
__device__ __forceinline__ void wg_chunk(float (&d)[N / 8][4], unsigned a0, int lda, int c0,
                                         int row, unsigned w_t) {
  using namespace tpucap::mma;
  unsigned a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = c0 + 2 * kk + ((threadIdx.x % 32) >> 4);
    ldmatrix_x4(a[kk], kSwz ? a0 + swz(row, c) : a0 + row * lda + 16 * c);
  }
  pin(d, a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<N>::run(d, a[kk], smem_desc(w_t + 32 * kk), true);
  wgmma_commit_wait<0>();
  pin(d, a);
}

// kNC1: the width of stage 1's and stage 2's passes (64 or 128).
template <int kNC1>
__global__ void __launch_bounds__(kThreads, 2)
    identity_block_kernel_mma(const bf16* __restrict__ x, const __grid_constant__ CUtensorMap xm,
                              const __grid_constant__ CUtensorMap w1, const bf16* __restrict__ b1,
                              const __grid_constant__ CUtensorMap w2, const bf16* __restrict__ b2,
                              const __grid_constant__ CUtensorMap w3, const bf16* __restrict__ b3,
                              bf16* __restrict__ out, int H, int W, int C, int M, int TH,
                              int TW) {
  using namespace tpucap::mma;
  using namespace tpucap::tma;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g(TH, TW);
  const int HW2 = TW + 2;
  const int ldy = 2 * (M + 8);
  const unsigned y1_s = (smem_addr(smem) + 1023) & ~1023u;
  const unsigned u_s = y1_s + union_offset(g, M);  // x ring (stage 1), then y2
  const unsigned w_s = y1_s + ring_offset(g, M);
  const unsigned bar = w_s + kRing * kWSlot;
  const int xs = x_slot(g);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4;
  const int qg = lane / 4, qt = lane % 4;
  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int64_t img = static_cast<int64_t>(blockIdx.y) * H * W * C;
  const bf16* xb = x + img;
  bf16* ob = out + img;

  // y1 rows past the halo feed only the discarded columns of stage 2.
  for (int i = tid; i < (g.Y1R - g.R1) * ldy / 16; i += kThreads)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(y1_s + g.R1 * ldy + 16 * i),
                 "r"(0)
                 : "memory");

  // The chunk stream: stage 1 (M / kNC1 passes of C / 64 chunks), stage 2
  // (M / kNC1 passes of 9 taps x M / 64 chunks), stage 3 (C / 128 passes of
  // M / 64 chunks).
  const int kc1 = C / 64, kc2 = M / 64;
  const int Q1 = (M / kNC1) * kc1, Q2 = (M / kNC1) * 9 * kc2, Q3 = (C / kNC3) * kc2;
  const int Q = Q1 + Q2 + Q3;
  struct Chunk {
    int stage, n0, col, tap, last;  // col: first weight column (k)
  };
  // The next chunk by TMA, thread 0 only, in stream order (the first
  // kRing - 1 before the loop, then chunk q + kRing - 1 at chunk q): rows
  // n0 .. of the weight matrix, columns col .. col + 64; in stage 1 also
  // x's channels col .. col + 64 on the (TH+2) x (TW+2) halo (P1 rows in
  // halo order, zero outside the image: the box's out-of-bounds part). A
  // cursor walks the stream, so no chunk index is divided.
  int ls = 1, ln0 = 0, ltap = 0, lk = 0, lq = 0;
  auto load_next = [&]() {
    const int col = ls == 2 ? ltap * M + 64 * lk : 64 * lk;
    const unsigned b = bar + 8 * (lq % kRing), w_t = w_s + (lq % kRing) * kWSlot;
    const int nc = ls == 3 ? kNC3 : kNC1;
    mbar_expect(b, nc * 128 + (ls == 1 ? g.P1 * 128 : 0));
    load_2d(w_t, ls == 1 ? &w1 : ls == 2 ? &w2 : &w3, b, col, ln0);
    if (ls == 1) load_4d(u_s + (lq % kRing) * xs, &xm, b, col, tx0 - 1, ty0 - 1, blockIdx.y);
    ++lq;
    if (++lk < (ls == 1 ? kc1 : kc2)) return;
    lk = 0;
    if (ls == 2 && ++ltap < 9) return;
    ltap = 0;
    ln0 += nc;
    if (ln0 < (ls == 3 ? C : M)) return;
    ln0 = 0;
    ++ls;
  };

  float d[16][4];  // this warp's 16 rows x the warpgroup's N columns
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;
  auto& d64 = reinterpret_cast<float(&)[8][4]>(d);

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(bar + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kRing - 1 && s < Q; ++s) load_next();
  // Chunk q, described by c: the chunk stream walked by nested loops, so
  // that no thread divides a chunk index.
  auto step = [&](int q, const Chunk& c) {
    mbar_wait(bar + 8 * (q % kRing), (q / kRing) & 1);  // chunk q has landed
    __syncthreads();  // every warp is done with slot q - 1; y1, y2 complete
    if (tid == 0 && q + kRing - 1 < Q) load_next();
    // The warpgroups split the pass's rows when there are more than 64,
    // else its columns (one idles on a 64-wide pass of 64 rows).
    const int R = c.stage == 1 ? g.R1 : g.R2, nc = c.stage == 3 ? kNC3 : kNC1;
    const bool split_rows = R > 64, wide = split_rows && nc == 128;
    const int rb = split_rows ? 64 * wg : 0, cb = split_rows ? 0 : 64 * wg;
    if (!split_rows && nc == 64 && wg == 1) return;
    int row = rb + 16 * wl + (lane & 15);
    row = row < R ? row : R - 1;  // rows past R are computed and never stored
    const unsigned w_t = w_s + (q % kRing) * kWSlot + cb * 128;
    unsigned a0 = u_s + (q % kRing) * xs;  // stage 1: the x ring
    int c0 = 0;
    if (c.stage == 2) {
      a0 = y1_s + ((c.tap / 3) * HW2 + c.tap % 3) * ldy;
      c0 = (c.col - c.tap * M) / 8;
    } else if (c.stage == 3) {
      a0 = u_s;  // y2
      c0 = c.col / 8;
    }
    if (wide) {
      if (c.stage == 1) wg_chunk<128, true>(d, a0, 0, c0, row, w_t);
      else wg_chunk<128, false>(d, a0, ldy, c0, row, w_t);
    } else {
      if (c.stage == 1) wg_chunk<64, true>(d64, a0, 0, c0, row, w_t);
      else wg_chunk<64, false>(d64, a0, ldy, c0, row, w_t);
    }
    if (!c.last) return;

    const int nt = wide ? 16 : 8;  // n8 tiles of this warpgroup
    const int n_base = c.n0 + cb;
    if (c.stage != 3) {
      // y1 = relu(round(round(acc) + b1)) (0 outside the image), or y2.
      const bf16* bias = c.stage == 1 ? b1 : b2;
      const unsigned dst = c.stage == 1 ? y1_s : u_s;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j >= nt) break;
        const int n = n_base + 8 * j + 2 * qt;
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rb + 16 * wl + qg + 8 * h;
          float v0 = fmaxf(rnd(rnd(d[j][2 * h]) + bb.x), 0.0f);
          float v1 = fmaxf(rnd(rnd(d[j][2 * h + 1]) + bb.y), 0.0f);
          d[j][2 * h] = 0.0f;
          d[j][2 * h + 1] = 0.0f;
          if (r >= R) continue;
          if (c.stage == 1) {
            const int gy = ty0 - 1 + r / HW2, gx = tx0 - 1 + r % HW2;
            if (!(r < g.P1 && gy >= 0 && gy < H && gx >= 0 && gx < W)) v0 = v1 = 0.0f;
          }
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + r * ldy + 2 * n),
                       "r"(pack_bf16(v0, v1))
                       : "memory");
        }
      }
      return;
    }

    // out = relu(round(round(round(acc) + b3) + x)), 16 bytes a lane.
#pragma unroll
    for (int jg = 0; jg < 4; ++jg) {
      if (4 * jg >= nt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned pv[4];  // n8 tile 4 jg + j: channels 8 j + 2 qt, + 1 of this group
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n_base + 32 * jg + 8 * j + 2 * qt;
          const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b3 + n));
          pv[j] = pack_bf16(rnd(rnd(d[4 * jg + j][2 * h]) + bb.x),
                            rnd(rnd(d[4 * jg + j][2 * h + 1]) + bb.y));
          d[4 * jg + j][2 * h] = 0.0f;
          d[4 * jg + j][2 * h + 1] = 0.0f;
        }
        // Within the quad, lane qt gathers tile qt's pairs from lanes 0-3:
        // channels 8 qt + 2 s, + 1 into mine[s].
        unsigned mine[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int send_j = (qt + rr) & 3, s = (qt - rr) & 3;
          unsigned send = pv[0];
#pragma unroll
          for (int j = 1; j < 4; ++j)
            if (send_j == j) send = pv[j];
          const unsigned recv = __shfl_sync(0xffffffffu, send, (lane & ~3) | s);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (s == j) mine[j] = recv;
        }
        const int r = rb + 16 * wl + qg + 8 * h;
        const int py = r / HW2, px = r % HW2, gy = ty0 + py, gx = tx0 + px;
        if (r >= R || py >= TH || px >= TW || gy >= H || gx >= W) continue;
        const int64_t off = (static_cast<int64_t>(gy) * W + gx) * C + n_base + 32 * jg + 8 * qt;
        const uint4 res = *reinterpret_cast<const uint4*>(xb + off);
        const unsigned rv[4] = {res.x, res.y, res.z, res.w};
        unsigned o[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float2 a = unpack(mine[s]), b = unpack(rv[s]);
          o[s] = pack_bf16(fmaxf(rnd(a.x + b.x), 0.0f), fmaxf(rnd(a.y + b.y), 0.0f));
        }
        *reinterpret_cast<uint4*>(ob + off) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  };
  int q = 0;
  for (int n0 = 0; n0 < M; n0 += kNC1)
    for (int k = 0; k < kc1; ++k, ++q) step(q, Chunk{1, n0, 64 * k, 0, k == kc1 - 1});
  for (int n0 = 0; n0 < M; n0 += kNC1)
    for (int tap = 0; tap < 9; ++tap)
      for (int k = 0; k < kc2; ++k, ++q)
        step(q, Chunk{2, n0, tap * M + 64 * k, tap, tap == 8 && k == kc2 - 1});
  for (int n0 = 0; n0 < C; n0 += kNC3)
    for (int k = 0; k < kc2; ++k, ++q) step(q, Chunk{3, n0, 64 * k, 0, k == kc2 - 1});
}

// A tile side: the largest divisor of n from 8 down to 5, else 8 (or n
// when smaller), the last tile then ragged.
int tile_side(int n) {
  for (int t = 8; t >= 5; --t)
    if (n % t == 0) return t;
  return n < 8 ? n : 8;
}

template <int kNC1>
int launch_mma_nc(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* w3, const void* b3, void* out, int B, int H,
                  int W, int C, int M, cudaStream_t stream) {
  const int TW = tile_side(W);
  int TH = tile_side(H);
  auto fits = [&](int th) {
    const Geometry g(th, TW);
    return g.R1 <= kMaxRows && g.R2 <= kMaxRows && smem_mma(g, M) <= kMaxSmem;
  };
  while (TH > 1 && !fits(TH)) --TH;
  if (!fits(TH)) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // once per instantiation, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        identity_block_kernel_mma<kNC1>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  // x as (B, H, W, C) read in (TH+2) x (TW+2) x 64 boxes; the weights as
  // (rows, K) matrices read in (pass width) x 64 boxes.
  CUtensorMap xm, w1m, w2m, w3m;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(TW + 2), static_cast<cuuint32_t>(TH + 2), 1};
  int err = tpucap::tma::encode(&xm, x, 4, dims, strides, box);
  if (!err) err = tpucap::tma::encode_2d(&w1m, w1, M, C, C, kNC1);
  if (!err) err = tpucap::tma::encode_2d(&w2m, w2, M, 9 * M, 9 * M, kNC1);
  if (!err) err = tpucap::tma::encode_2d(&w3m, w3, C, M, M, kNC3);
  if (err) return err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  identity_block_kernel_mma<kNC1><<<grid, kThreads, smem_mma(Geometry(TH, TW), M), stream>>>(
      static_cast<const bf16*>(x), xm, w1m, static_cast<const bf16*>(b1), w2m,
      static_cast<const bf16*>(b2), w3m, static_cast<const bf16*>(b3), static_cast<bf16*>(out),
      H, W, C, M, TH, TW);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* out, int B, int H, int W, int C, int M,
               cudaStream_t stream) {
  if (C % kNC3 || M % 64 || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return M % 128 ? launch_mma_nc<64>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, stream)
                 : launch_mma_nc<128>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, stream);
}

}  // namespace

// x, out (B, H, W, C); w1 (M, C); w2 (M, 3, 3, M); w3 (C, M); b1, b2 (M,);
// b3 (C,); all contiguous, one dtype, 16-byte aligned. C and M multiples of
// 64 (f32) or C of 128 and M of 64 (bf16).
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
      return launch_mma(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, M, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
