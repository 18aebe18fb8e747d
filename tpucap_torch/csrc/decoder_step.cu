// Kernel K3: the merge head and the vocab projection of the fused
// merge-decoder step.
//
// Replaces tpucap/ops/pallas/decoder_step.py:fused_merge_step (Pallas
// kernel _kernel). On the TPU one call runs the LSTM cell, the merge head
// and the vocab tiles in a sequential grid, keeping h' and `merged` in VMEM
// scratch from grid step 0. Hopper blocks run in parallel and nothing
// carries between them, so the step is three launches on one stream:
//   1. K2 (lstm_step.cu), which also writes h' in f32;
//   2. merge head:  merged = relu((fe + h') @ W_p + b_p), f32, into a (B, U)
//      f32 scratch the wrapper allocates;
//   3. projection:  logits = merged @ W_o + b_o, f32.
// Stages 2 and 3 are one templated "linear + bias (+ relu)" kernel. Both
// keep the TPU kernel's numerics: fe + h' and merged stay f32, weights are
// upcast to f32, products and sums are f32 FMAs.
//
// Bound on an H100: the projection at (768 x 256) @ (256 x 7579) moves
// 28 MB (W_o in bf16, merged in f32, mostly the 23 MB of f32 logits
// written): about 8.3 us at 3.35 TB/s. Its 3.0 GFLOP take about 3 us on
// bf16 tensor cores, and still about 9 us with merged split into three
// bf16 terms (hi + mid + lo, f32 accumulation), which keeps f32 accuracy
// against the bf16 W_o. So it is bound by the logits write. The merge head
// (0.1 GFLOP, 2.1 MB) is bound by bytes too, at about 0.6 us. Design, for
// now: a classic SIMT tiled GEMM on f32 FMAs, far from that bound: 256
// threads, a 16 x 16 thread grid, each thread owning a (BM/16) x (BN/16)
// register tile with strided rows/columns so shared reads are broadcast or
// conflict-free; bias and relu in the epilogue; ragged edges masked. The
// bf16-split tensor-core version (wgmma, TMA) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int BM, int BN, int BK, typename TA, typename TW, bool kHasA2,
          bool kRelu>
__global__ void __launch_bounds__(kThreads)
    linear_kernel(const TA* __restrict__ A, const float* __restrict__ A2,
                  const TW* __restrict__ W, const TW* __restrict__ bias,
                  float* __restrict__ C, int M, int N, int K) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ float as[BK][BM + 4];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, kk = i % BK;
      const int gm = m0 + m, gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K) {
        const int64_t off = static_cast<int64_t>(gm) * K + gk;
        v = tpucap::to_f32(A[off]);
        if constexpr (kHasA2) v += A2[off];
      }
      as[kk][m] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN, n = i % BN;
      const int gk = k0 + kk, gn = n0 + n;
      ws[kk][n] = (gk < K && gn < N)
                      ? tpucap::to_f32(W[static_cast<int64_t>(gk) * N + gn])
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float b = tpucap::to_f32(bias[gn]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
      float v = acc[i][j] + b;
      if constexpr (kRelu) v = fmaxf(v, 0.0f);
      C[static_cast<int64_t>(gm) * N + gn] = v;
    }
  }
}

template <int BM, int BN, int BK, typename TA, typename TW, bool kHasA2,
          bool kRelu>
void launch(const void* A, const float* A2, const void* W, const void* bias,
            float* C, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_kernel<BM, BN, BK, TA, TW, kHasA2, kRelu>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const TA*>(A), A2, static_cast<const TW*>(W),
          static_cast<const TW*>(bias), C, M, N, K);
}

}  // namespace

// merged (M, N) f32 = relu((fe (M, K) in dtype + h32 (M, K) f32)
//                          @ wp (K, N) in dtype + bp (N,) in dtype).
// N = K = hidden width, small: 64 x 64 tiles keep enough blocks in flight.
extern "C" int tpucap_merge_head(const void* fe, const void* h32,
                                 const void* wp, const void* bp, void* out,
                                 int M, int N, int K, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a2 = static_cast<const float*>(h32);
  auto c = static_cast<float*>(out);
  switch (dtype) {
    case tpucap::kF32:
      launch<64, 64, 16, float, float, true, true>(fe, a2, wp, bp, c, M, N,
                                                   K, s);
      break;
    case tpucap::kBF16:
      launch<64, 64, 16, __nv_bfloat16, __nv_bfloat16, true, true>(
          fe, a2, wp, bp, c, M, N, K, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits (M, N) f32 = merged (M, K) f32 @ wo (K, N) in dtype + bo (N,).
extern "C" int tpucap_vocab_proj(const void* merged, const void* wo,
                                 const void* bo, void* out, int M, int N,
                                 int K, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(out);
  switch (dtype) {
    case tpucap::kF32:
      launch<128, 128, 8, float, float, false, false>(merged, nullptr, wo,
                                                      bo, c, M, N, K, s);
      break;
    case tpucap::kBF16:
      launch<128, 128, 8, float, __nv_bfloat16, false, false>(
          merged, nullptr, wo, bo, c, M, N, K, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
