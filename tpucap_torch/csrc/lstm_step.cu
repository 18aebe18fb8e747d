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
// 0.8 GFLOP and 4 MB, i.e. about a microsecond either way, so launch and
// latency dominate. Design: each block owns a tile of rows and a tile of
// units j and accumulates all four gate columns j, U+j, 2U+j, 3U+j, so the
// gate epilogue needs nothing from another block and z never leaves
// registers. [x h] and [W; U] are walked as one K = E + U reduction
// through shared-memory tiles; products are f32 FMAs on upcast inputs
// (exact for bf16 operands).
#include "common.cuh"

namespace {

constexpr int kTM = 32;  // rows per block
constexpr int kTU = 32;  // units per block (x 4 gates)
constexpr int kTK = 32;  // reduction depth per shared tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTM / (kThreads / kTU);  // 4

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                     const T* __restrict__ c, const T* __restrict__ wk,
                     const T* __restrict__ wr, const T* __restrict__ bias,
                     T* __restrict__ h_out, T* __restrict__ c_out,
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
        v = gk < E ? tpucap::to_f32(x[static_cast<int64_t>(gm) * E + gk])
                   : tpucap::to_f32(h[static_cast<int64_t>(gm) * U + gk - E]);
      }
      as[kk][m] = v;
    }
    for (int i = tid; i < kTK * 4 * kTU; i += kThreads) {
      const int kk = i / (4 * kTU), col = i % (4 * kTU);
      const int g = col / kTU, gu = u0 + col % kTU, gk = k0 + kk;
      float v = 0.0f;
      if (gk < K && gu < U) {
        const int64_t n = static_cast<int64_t>(g) * U + gu;
        v = gk < E ? tpucap::to_f32(wk[gk * G + n])
                   : tpucap::to_f32(wr[(gk - E) * G + n]);
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
  const float bi = tpucap::to_f32(bias[gu]);
  const float bf = tpucap::to_f32(bias[U + gu]);
  const float bg = tpucap::to_f32(bias[2 * U + gu]);
  const float bo = tpucap::to_f32(bias[3 * U + gu]);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gm = m0 + row0 + r;
    if (gm >= B) break;
    const int64_t idx = static_cast<int64_t>(gm) * U + gu;
    const float ig = tpucap::sigmoid_f32(acc[r][0] + bi);
    const float fg = tpucap::sigmoid_f32(acc[r][1] + bf);
    const float gg = tanhf(acc[r][2] + bg);
    const float og = tpucap::sigmoid_f32(acc[r][3] + bo);
    const float c_new = fg * tpucap::to_f32(c[idx]) + ig * gg;
    const float h_new = og * tanhf(c_new);
    c_out[idx] = tpucap::from_f32<T>(c_new);
    h_out[idx] = tpucap::from_f32<T>(h_new);
    h32_out[idx] = h_new;
  }
}

template <typename T>
void launch(const void* x, const void* h, const void* c, const void* wk,
            const void* wr, const void* b, void* h_out, void* c_out,
            float* h32_out, int B, int E, int U, cudaStream_t stream) {
  dim3 grid((U + kTU - 1) / kTU, (B + kTM - 1) / kTM);
  lstm_cell_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(wk),
      static_cast<const T*>(wr), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), h32_out, B, E, U);
}

}  // namespace

extern "C" int tpucap_lstm_cell(const void* x, const void* h, const void* c,
                                const void* wk, const void* wr,
                                const void* bias, void* h_out, void* c_out,
                                void* h32_out, int B, int E, int U, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto h32 = static_cast<float*>(h32_out);
  switch (dtype) {
    case tpucap::kF32:
      launch<float>(x, h, c, wk, wr, bias, h_out, c_out, h32, B, E, U, s);
      break;
    case tpucap::kBF16:
      launch<__nv_bfloat16>(x, h, c, wk, wr, bias, h_out, c_out, h32, B, E,
                            U, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
