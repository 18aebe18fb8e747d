// Kernel K2: one Keras LSTM cell step for a batch.
//
// Replaces tpucap/ops/pallas/lstm_step.py:fused_lstm_step (Pallas kernel
// _lstm_kernel), which is also the first stage of
// tpucap/ops/pallas/decoder_step.py:_kernel:
//   z = x @ W + h @ U + b            (f32 accumulation)
//   i, f, g, o = split(z, 4)         (Keras gate order)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// Outputs h' and c' in the dtype of h and c, and h' in f32 (the merge
// step's next stage reads the unrounded h', as the TPU kernel does).
//
// Bound on an H100: at the decode shape (768 x 512 x 1024, bf16) about
// 0.8 GFLOP and 3.7 MB, about a microsecond either way, so launch latency
// and the latency of each block's loads are what the kernel can spend
// time on. Each block owns a tile of rows and a tile of units j and
// accumulates all four gate columns j, U+j, 2U+j, 3U+j, so the gate
// epilogue needs nothing from another block and z never leaves registers.
// [x h] and [W; U] are walked as one K = E + U reduction.
//
// bf16 route (lstm_cell_kernel_mma): tensor-core mma.sync (m16n8k16, f32
// accumulate, exact bf16 products) on ldmatrix fragments. A block owns 32
// rows x 16 units (64 weight columns, gate-major: i of its units, then f,
// g, o); 64-deep stages of [x h] and of those columns arrive by 16-byte
// cp.async in a 3-stage ring, one barrier per stage. With one warp per
// 16 x 64 output tile (768 warps at the decode shape, under six an SM)
// one warp's serial chain of waits, ldmatrix and address arithmetic set
// most of the time (it stayed with the loads and MMAs taken out), so each
// stage's 64-deep reduction is split across four warps, 16 deep each, per
// 16-row group: 8 warps a block, 384 blocks, three an SM. A warp's 16 x 8
// accumulator tiles (eight) are i, f, g and o of units 0-7 and 8-15; the four
// partial sums of a row group meet in shared memory (over the ring, free
// by then), and each thread finishes the gates of one row and two units,
// with bf16x2 and float2 stores; c and the bias are loaded before the
// reduction. What bounds it now is the rate at which the stages arrive
// from L2 (PERF.md, K2's versions): larger tiles that halve the L2
// traffic, or a deeper ring, did not move it. E and U must be multiples
// of 8 (16-byte rows); any B.
//
// f32 route (lstm_cell_kernel_f32): f32 FMAs through 32-deep shared tiles,
// no TF32, so an f32 flow keeps f32 products.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -- bf16: tensor cores -------------------------------------------------------

constexpr int kGroups = 2;               // 16-row groups per block
constexpr int kSlices = 4;               // warps splitting a stage's depth
constexpr int kWarps = kGroups * kSlices;
constexpr int kMinBlocks = 3;            // per SM: at most 80 registers a thread
constexpr int kBM = 16 * kGroups;        // rows per block
constexpr int kBU = 16;                  // units per block (x 4 gates = 64 columns)
constexpr int kKC = 16 * kSlices;        // reduction depth per stage
constexpr int kStages = 3;
constexpr int kABytes = kBM * 128;       // a stage of [x h]: kBM rows of 64 bf16
constexpr int kWBytes = kKC * 128;       // a stage of weights: 64 rows of 64 bf16
constexpr int kLdR = 72;                 // row stride (floats) of a partial sum
constexpr size_t kSmemMma = kStages * (kABytes + kWBytes);
static_assert(kGroups * kSlices * 16 * kLdR * sizeof(float) <= kSmemMma,
              "the partial sums reuse the ring");
static_assert(kBM * kBU / 2 == 32 * kWarps, "one thread per row and unit pair");

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
    lstm_cell_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ h,
                         const bf16* __restrict__ c, const bf16* __restrict__ wk,
                         const bf16* __restrict__ wr, const bf16* __restrict__ bias,
                         bf16* __restrict__ h_out, bf16* __restrict__ c_out,
                         float* __restrict__ h32_out, int B, int E, int U) {
  using namespace tpucap::mma;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned a_s = smem_addr(smem);
  const unsigned w_s = a_s + kStages * kABytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / kSlices, slice = warp % kSlices;
  const int m0 = blockIdx.y * kBM, u0 = blockIdx.x * kBU;
  const int K = E + U;
  const int nk = (K + kKC - 1) / kKC;
  const int64_t G = 4 * static_cast<int64_t>(U);

  // This thread's share of the epilogue: row m0 + er, units eu, eu + 1.
  const int er = tid / (kBU / 2), eu = u0 + 2 * (tid % (kBU / 2));
  const bool mine = m0 + er < B && eu < U;
  float2 cc = make_float2(0.0f, 0.0f), bz[4];
  if (mine) {
    cc = bf2(c + static_cast<int64_t>(m0 + er) * U + eu);
#pragma unroll
    for (int q = 0; q < 4; ++q) bz[q] = bf2(bias + q * U + eu);
  }

  // Stage kc: [x h] rows m0.. and weight rows kc*64.., zero past B, K, U.
  // E is a multiple of 8, so no 16-byte chunk straddles x and h.
  auto load_stage = [&](int kc) {
    const int k0 = kc * kKC;
    const unsigned a_t = a_s + (kc % kStages) * kABytes;
    const unsigned w_t = w_s + (kc % kStages) * kWBytes;
#pragma unroll
    for (int i = tid; i < kBM * 8; i += 32 * kWarps) {
      const int r = i / 8, ch = i % 8, gm = m0 + r, gk = k0 + 8 * ch;
      const bool ok = gm < B && gk < K;
      const bf16* src = x;
      if (ok) src = gk < E ? x + static_cast<int64_t>(gm) * E + gk
                           : h + static_cast<int64_t>(gm) * U + (gk - E);
      copy16(a_t + swz(r, ch), src, ok);
    }
    // Chunk ch of a weight row: gate ch / 2, units u0 + 8 (ch % 2) .. + 7.
#pragma unroll
    for (int i = tid; i < kKC * 8; i += 32 * kWarps) {
      const int r = i / 8, ch = i % 8, gk = k0 + r, gu = u0 + 8 * (ch % 2);
      const bool ok = gk < K && gu < U;
      const bf16* src = wk;
      if (ok) {
        const int64_t n = static_cast<int64_t>(ch / 2) * U + gu;
        src = gk < E ? wk + gk * G + n : wr + (gk - E) * G + n;
      }
      copy16(w_t + swz(r, ch), src, ok);
    }
  };

  float acc[8][4];  // n-tile 2 q + s: gate q, units 8 s .. 8 s + 7
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    wait_pending<kStages - 2>();  // stage kc has landed (this thread's part)
    __syncthreads();              // ... every thread's; stage kc - 1 is free
    if (kc + kStages - 1 < nk) load_stage(kc + kStages - 1);
    commit();
    // This warp's 16-deep slice of the stage.
    const unsigned a_t = a_s + (kc % kStages) * kABytes;
    const unsigned w_t = w_s + (kc % kStages) * kWBytes;
    unsigned a[4];
    ldmatrix_x4(a, a_t + swz(16 * grp + (lane & 15), 2 * slice + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned b[4];
      ldmatrix_x4_trans(b, w_t + swz(16 * slice + (lane & 15), 2 * j + (lane >> 4)));
      mma_bf16(acc[2 * j], a, b[0], b[1]);
      mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }

  // The partial sums, [group][slice][16 rows][64 columns], over the ring.
  wait_pending<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  {
    const int g = lane / 4, t = lane % 4;
    float* dst = red + (grp * kSlices + slice) * 16 * kLdR + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(dst + (g + 8 * hh) * kLdR + 8 * n) =
            make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
  __syncthreads();
  if (!mine) return;

  float2 z[4];  // gates i, f, g, o of units eu, eu + 1
#pragma unroll
  for (int q = 0; q < 4; ++q) z[q] = make_float2(0.0f, 0.0f);
  const float* src = red + ((er / 16) * kSlices * 16 + er % 16) * kLdR + (eu - u0);
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(src + s * 16 * kLdR + q * kBU);
      z[q].x += v.x;
      z[q].y += v.y;
    }
  float hn[2], cn[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const auto pick = [e](float2 v) { return e ? v.y : v.x; };
    const float ig = tpucap::sigmoid_f32(pick(z[0]) + pick(bz[0]));
    const float fg = tpucap::sigmoid_f32(pick(z[1]) + pick(bz[1]));
    const float gg = tanhf(pick(z[2]) + pick(bz[2]));
    const float og = tpucap::sigmoid_f32(pick(z[3]) + pick(bz[3]));
    cn[e] = fg * pick(cc) + ig * gg;
    hn[e] = og * tanhf(cn[e]);
  }
  const int64_t idx = static_cast<int64_t>(m0 + er) * U + eu;
  *reinterpret_cast<__nv_bfloat162*>(c_out + idx) = __floats2bfloat162_rn(cn[0], cn[1]);
  *reinterpret_cast<__nv_bfloat162*>(h_out + idx) = __floats2bfloat162_rn(hn[0], hn[1]);
  *reinterpret_cast<float2*>(h32_out + idx) = make_float2(hn[0], hn[1]);
}

int launch_mma(const void* x, const void* h, const void* c, const void* wk,
               const void* wr, const void* b, void* h_out, void* c_out, float* h32_out,
               int B, int E, int U, cudaStream_t stream) {
  if (B < 1 || E % 8 || U % 8 || (B + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // once, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMma));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((U + kBU - 1) / kBU, (B + kBM - 1) / kBM);
  lstm_cell_kernel_mma<<<grid, 32 * kWarps, kSmemMma, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(h),
      static_cast<const bf16*>(c), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wr), static_cast<const bf16*>(b),
      static_cast<bf16*>(h_out), static_cast<bf16*>(c_out), h32_out, B, E, U);
  return static_cast<int>(cudaGetLastError());
}

// -- f32: FMAs ----------------------------------------------------------------

constexpr int kTM = 32;  // rows per block
constexpr int kTU = 32;  // units per block (x 4 gates)
constexpr int kTK = 32;  // reduction depth per shared tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTM / (kThreads / kTU);  // 4

__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel_f32(const float* __restrict__ x, const float* __restrict__ h,
                         const float* __restrict__ c, const float* __restrict__ wk,
                         const float* __restrict__ wr, const float* __restrict__ bias,
                         float* __restrict__ h_out, float* __restrict__ c_out,
                         float* __restrict__ h32_out, int B, int E, int U) {
  __shared__ float as[kTK][kTM + 1];
  __shared__ float ws[kTK][4 * kTU];

  const int tid = threadIdx.x;
  const int lane_u = tid % kTU;
  const int row0 = (tid / kTU) * kRowsPerThread;
  const int m0 = blockIdx.y * kTM;
  const int u0 = blockIdx.x * kTU;
  const int K = E + U;
  const int64_t G = 4 * static_cast<int64_t>(U);

  float acc[kRowsPerThread][4];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int i = tid; i < kTM * kTK; i += kThreads) {
      const int m = i / kTK, kk = i % kTK;
      const int gm = m0 + m, gk = k0 + kk;
      float v = 0.0f;
      if (gm < B && gk < K) {
        v = gk < E ? x[static_cast<int64_t>(gm) * E + gk]
                   : h[static_cast<int64_t>(gm) * U + gk - E];
      }
      as[kk][m] = v;
    }
    for (int i = tid; i < kTK * 4 * kTU; i += kThreads) {
      const int kk = i / (4 * kTU), col = i % (4 * kTU);
      const int g = col / kTU, gu = u0 + col % kTU, gk = k0 + kk;
      float v = 0.0f;
      if (gk < K && gu < U) {
        const int64_t n = static_cast<int64_t>(g) * U + gu;
        v = gk < E ? wk[gk * G + n] : wr[(gk - E) * G + n];
      }
      ws[kk][col] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = ws[kk][g * kTU + lane_u];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float a = as[kk][row0 + r];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(a, w[g], acc[r][g]);
      }
    }
    __syncthreads();
  }

  const int gu = u0 + lane_u;
  if (gu >= U) return;
  const float bi = bias[gu];
  const float bf = bias[U + gu];
  const float bg = bias[2 * U + gu];
  const float bo = bias[3 * U + gu];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gm = m0 + row0 + r;
    if (gm >= B) break;
    const int64_t idx = static_cast<int64_t>(gm) * U + gu;
    const float ig = tpucap::sigmoid_f32(acc[r][0] + bi);
    const float fg = tpucap::sigmoid_f32(acc[r][1] + bf);
    const float gg = tanhf(acc[r][2] + bg);
    const float og = tpucap::sigmoid_f32(acc[r][3] + bo);
    const float c_new = fg * c[idx] + ig * gg;
    const float h_new = og * tanhf(c_new);
    c_out[idx] = c_new;
    h_out[idx] = h_new;
    h32_out[idx] = h_new;
  }
}

int launch_f32(const void* x, const void* h, const void* c, const void* wk,
               const void* wr, const void* b, void* h_out, void* c_out, float* h32_out,
               int B, int E, int U, cudaStream_t stream) {
  const dim3 grid((U + kTU - 1) / kTU, (B + kTM - 1) / kTM);
  lstm_cell_kernel_f32<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wk),
      static_cast<const float*>(wr), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), h32_out, B, E, U);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, E), h and c (B, U), wk (E, 4U), wr (U, 4U), bias (4U), all of one
// dtype, contiguous, 16-byte aligned; E and U multiples of 8.
extern "C" int tpucap_lstm_cell(const void* x, const void* h, const void* c,
                                const void* wk, const void* wr,
                                const void* bias, void* h_out, void* c_out,
                                void* h32_out, int B, int E, int U, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto h32 = static_cast<float*>(h32_out);
  switch (dtype) {
    case tpucap::kF32:
      return launch_f32(x, h, c, wk, wr, bias, h_out, c_out, h32, B, E, U, s);
    case tpucap::kBF16:
      return launch_mma(x, h, c, wk, wr, bias, h_out, c_out, h32, B, E, U, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
