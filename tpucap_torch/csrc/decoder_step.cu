// Kernel K3: the merge head and the vocab projection of the fused
// merge-decoder step.
//
// Replaces tpucap/ops/pallas/decoder_step.py:fused_merge_step (Pallas
// kernel _kernel; its projection tiles at :73-80). On the TPU one call runs
// the LSTM cell, the merge head and the vocab tiles in a sequential grid,
// keeping h' and `merged` in VMEM scratch from grid step 0. Hopper blocks
// run in parallel and nothing carries between them, so the step is three
// launches on one stream:
//   1. K2 (lstm_step.cu), which also writes h' in f32;
//   2. merge head:  merged = relu((fe + h') @ W_p + b_p), f32, into a (B, U)
//      f32 scratch the wrapper allocates;
//   3. projection:  logits = merged @ W_o + b_o, f32.
// Both keep the TPU kernel's numerics: fe + h' and merged stay f32, the
// products of merged with the weights are exact and summed in f32.
//
// Bound on an H100: the projection at (768 x 256) @ (256 x 7579) moves
// 28 MB (W_o in bf16, merged in f32, mostly the 23 MB of f32 logits
// written): about 8.3 us at 3.35 TB/s. Its 3.0 GFLOP take about 3 us on
// bf16 tensor cores, and about 9 us with merged split into three bf16
// terms. The merge head (0.1 GFLOP, 2.1 MB) is bound by bytes, at about
// 0.6 us.
//
// bf16 projection (vocab_proj_kernel): tensor cores on an exact split.
// Each f32 value m of `merged` is split, in the kernel, into three bf16
// terms hi = bf16(m), mid = bf16(m - hi), lo = bf16(m - hi - mid), whose
// sum is m exactly (for |m| above about 1e-33); every bf16 x bf16 product
// is exact in f32, so hi W + mid W + lo W, summed in one f32 accumulator,
// differs from the f32 product only in summation order. (Two terms would
// leave about 2^-17 of each product: a change of numerics, not of speed.)
// A persistent block owns 64 rows of merged, splits them once into shared
// memory (3 x 64 x U bf16, 96 KB at U = 256), then walks every G-th
// 256-column tile of the vocabulary. W_o is read K-major, as the (V, U)
// copy W_o^T that the fused step makes once per decode (V = 7579 is odd,
// so rows of W_o itself are not 16-byte aligned): each 64-deep slab of a
// tile is one TMA request (zero past V, 128-byte swizzle) into a 3-stage
// ring on mbarriers, running on across tiles. Two warpgroups each own 128
// columns: per 16-deep step, three wgmma.m64n128k16 (one per term) with the
// terms' fragments from ldmatrix and W_o^T read by the tensor cores from
// the ring. Logits rows are only 4-byte aligned (V odd), so each warp
// stages its 16 x 32 pieces in shared memory and writes whole rows of 32
// consecutive floats per store; bias added, ragged rows and columns
// masked. U must be a multiple of 64, at most 256; other widths take the
// SIMT kernel below. What the versions taught (PERF.md, K3's versions):
// with per-thread cp.async and mma.sync each warp's serial instruction
// stream set the time, not the tensor cores or L2; the staged stores,
// wgmma and TMA each cut it. Leaving a slab's wgmmas in flight under the
// next slab (A's fragments double-buffered) was slower: the compiler
// fences registers that an in-flight wgmma uses.
//
// bf16 merge head (merge_head_kernel): the same exact split, of a = fe + h'
// (summed in f32, as the reference does), on wgmma.m64n32k16. At M = 768,
// U = 256 the work is tiny (0.3 GFLOP with the split, 2.1 MB), so the time
// is latency: launch, one round trip to memory, and each warp's serial
// stream. One warpgroup a block owns 64 rows x 32 columns, so 96 blocks
// fill most of the card (the SIMT kernel's 64 x 64 tiles made 48). Thread 0
// asks for the block's 32 columns of W_p (16 KB at U = 256) in one TMA
// request per 64-deep slab, all on one mbarrier, while each warp loads its
// own 16 rows of fe and h' straight into registers in mma's A layout (no
// shared memory, no barrier for A; the next slab's loads in flight under
// this slab's split and wgmmas) and splits them there into the three terms'
// fragments. W_p is read K-major, as the (U, U) copy W_p^T that the fused
// step makes once per decode beside W_o^T: the proven 128-byte-swizzled
// K-major tile of the projection, where reading W_p as stored would take
// wgmma's transposed (MN-major) B layout, which at 32 columns needs another
// swizzle. No thread divides in the loop; bias and relu come from the
// accumulators. U must be a multiple of 64, at most 256; other widths take
// the SIMT kernel below.
//
// f32 (both stages), and bf16 at other widths (linear_kernel): a classic
// SIMT tiled GEMM on f32 FMAs with weights upcast to f32: 256 threads, a
// 16 x 16 thread grid, each thread owning a (BM/16) x (BN/16) register tile
// with strided rows/columns so shared reads are broadcast or conflict-free;
// bias and relu in the epilogue; ragged edges masked.
#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

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

// -- bf16 projection: tensor cores on the three-term split ------------------

using bf16 = __nv_bfloat16;

constexpr int kVpWarps = 8;                 // warpgroup g: columns 128 g .. of a tile
constexpr int kVpBM = 64;                   // rows of merged per block
constexpr int kVpBN = 256;                  // vocab columns per tile
constexpr int kVpKC = 64;                   // depth of a ring stage
constexpr int kVpMaxK = 256;
constexpr int kVpStages = 3;
constexpr int kVpStageBytes = kVpBN * 128;  // 256 rows of 64 bf16
constexpr int kVpSmemA = 3 * kVpBM * kVpMaxK * 2;
constexpr int kStgLd = 33;                  // row stride (floats) of a warp's staging tile
constexpr int kVpStg = kVpWarps * 16 * kStgLd * 4;
constexpr size_t kVpSmem = 1024 + kVpSmemA + kVpStages * kVpStageBytes + kVpStg + 8 * kVpStages;

__global__ void __launch_bounds__(32 * kVpWarps, 1)
    vocab_proj_kernel(const float* __restrict__ merged, const __grid_constant__ CUtensorMap wo_t,
                      const bf16* __restrict__ bias, float* __restrict__ out, int M,
                      int N, int K) {
  using namespace tpucap::mma;
  using namespace tpucap::tma;
  extern __shared__ __align__(128) unsigned char smem[];
  // The ring's wgmma swizzle needs 1024-byte aligned tiles.
  const unsigned raw = smem_addr(smem), a_s = (raw + 1023) & ~1023u;
  const unsigned w_s = a_s + kVpSmemA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4;
  float* stg = reinterpret_cast<float*>(smem + (w_s - raw) + kVpStages * kVpStageBytes) +
               warp * 16 * kStgLd;
  const unsigned bar = w_s + kVpStages * kVpStageBytes + kVpStg;  // an mbarrier a stage
  const int m0 = blockIdx.y * kVpBM;
  const int kchunks = K / 8;  // 16-byte chunks of a row
  // Chunk c of row r of split term t, swizzled within the row's 8-chunk groups.
  auto a_addr = [&](int t, int r, int c) {
    return a_s + static_cast<unsigned>((t * kVpBM + r) * 2 * K) +
           static_cast<unsigned>(((c & ~7) | ((c ^ r) & 7)) << 4);
  };

  // This block's tiles: blockIdx.x, + gridDim.x, ...; a ring stage per
  // (tile, 64-deep slab).
  const int tiles = (N + kVpBN - 1) / kVpBN;
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int nk = K / kVpKC;
  const int Q = my_tiles * nk;
  // Stage q: rows n0 .. n0 + 256 of W_o^T (zero past N), columns k0 ..
  // k0 + 64, one TMA request by thread 0.
  auto load_stage = [&](int q) {
    const int n0 = (blockIdx.x + (q / nk) * gridDim.x) * kVpBN, k0 = (q % nk) * kVpKC;
    const unsigned b = bar + 8 * (q % kVpStages);
    mbar_expect(b, kVpStageBytes);
    load_2d(w_s + (q % kVpStages) * kVpStageBytes, &wo_t, b, k0, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < kVpStages; ++s) mbar_init(bar + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kVpStages - 1 && s < Q; ++s) load_stage(s);

  // Split merged[m0 .. m0 + 64) into hi, mid, lo while the ring fills.
  for (int i = tid; i < kVpBM * kchunks; i += 32 * kVpWarps) {
    const int r = i / kchunks, c = i % kchunks;
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (m0 + r < M) {
      const float4* src = reinterpret_cast<const float4*>(merged + static_cast<int64_t>(m0 + r) * K + 8 * c);
      const float4 p = src[0], q = src[1];
      v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
      v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
    }
    unsigned t[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x0 = v[2 * e], x1 = v[2 * e + 1];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
        t[term][e] = *reinterpret_cast<const unsigned*>(&b);
        const float2 f = __bfloat1622float2(b);
        x0 -= f.x;  // exact: the rounding error of a round-to-nearest
        x1 -= f.y;
      }
    }
#pragma unroll
    for (int term = 0; term < 3; ++term)
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a_addr(term, r, c)),
                   "r"(t[term][0]), "r"(t[term][1]), "r"(t[term][2]), "r"(t[term][3])
                   : "memory");
  }

  float d[16][4];  // this warp's 16 rows x the warpgroup's 128 columns
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;

  for (int q = 0; q < Q; ++q) {
    mbar_wait(bar + 8 * (q % kVpStages), (q / kVpStages) & 1);  // stage q has landed
    __syncthreads();  // every warp is done with stage q - 1
    if (tid == 0 && q + kVpStages - 1 < Q) load_stage(q + kVpStages - 1);
    const unsigned w_t = w_s + (q % kVpStages) * kVpStageBytes + wg * (kVpStageBytes / 2);
    const int c0 = (q % nk) * (kVpKC / 8);  // first chunk of this slab in a row of A
    unsigned a[12][4];                       // term t, step kk: a[4 t + kk]
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[4 * t + kk], a_addr(t, 16 * wl + (lane & 15), c0 + 2 * kk + (lane >> 4)));
    pin(d, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < 3; ++t) Wgmma<128>::run(d, a[4 * t + kk], smem_desc(w_t + 32 * kk), true);
    wgmma_commit_wait<0>();
    pin(d, a);
    if (q % nk != nk - 1) continue;

    // The tile's logits through this warp's staging tile, 32 columns at a
    // time, so each store instruction writes 32 consecutive floats of a row
    // (rows of an odd V are only 4-byte aligned).
    const int n0 = (blockIdx.x + (q / nk) * gridDim.x) * kVpBN + wg * 128;
    const int g = lane / 4, t = lane % 4;
    const int rows = M - (m0 + 16 * wl) < 16 ? M - (m0 + 16 * wl) : 16;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* s = stg + (g + 8 * h) * kStgLd + 8 * jj + 2 * t;
          s[0] = d[4 * qq + jj][2 * h];
          s[1] = d[4 * qq + jj][2 * h + 1];
          d[4 * qq + jj][2 * h] = 0.0f;
          d[4 * qq + jj][2 * h + 1] = 0.0f;
        }
      __syncwarp();
      const int n = n0 + 32 * qq + lane;
      if (n >= N) continue;
      const float bn = __bfloat162float(bias[n]);
      float* dst = out + static_cast<int64_t>(m0 + 16 * wl) * N + n;
      for (int r = 0; r < rows; ++r) dst[static_cast<int64_t>(r) * N] = stg[r * kStgLd + lane] + bn;
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

int launch_vocab_proj(const float* merged, const bf16* wo_t, const bf16* bias, float* out,
                      int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map;
  const int err = tpucap::tma::encode_2d(&map, wo_t, N, K, K, kVpBN);
  if (err) return err;
  static bool attr_set = false;  // once, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        vocab_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kVpSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int m_tiles = (M + kVpBM - 1) / kVpBM;
  const int tiles = (N + kVpBN - 1) / kVpBN;
  int groups = sm_count() / m_tiles;
  groups = groups < 1 ? 1 : (groups > tiles ? tiles : groups);
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  vocab_proj_kernel<<<dim3(groups, m_tiles), 32 * kVpWarps, kVpSmem, stream>>>(
      merged, map, bias, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16 merge head: tensor cores on the three-term split of fe + h' -------

constexpr int kMhBM = 64;                  // rows per block: one warpgroup's wgmma
constexpr int kMhBN = 32;                  // output columns per block
constexpr int kMhKC = 64;                  // depth of a slab (one TMA box, 128 bytes a row)
constexpr int kMhMaxK = 256;
constexpr int kMhSlabs = kMhMaxK / kMhKC;
constexpr int kMhSlabBytes = kMhBN * 128;  // 32 rows of W_p^T x 64 deep
constexpr size_t kMhSmem = 1024 + kMhSlabs * kMhSlabBytes + 8;

// This lane's pieces of rows g and g + 8 of a 64-deep slab of fe and h', in
// mma's A layout: step kk, register e holds (row g + 8 (e & 1), columns
// 16 kk + 2t + 8 (e >> 1) and the next).
struct MhSlab {
  unsigned fe[4][4];
  float2 h[4][4];
};

__global__ void __launch_bounds__(128, 1)
    merge_head_kernel(const bf16* __restrict__ fe, const float* __restrict__ h32,
                      const __grid_constant__ CUtensorMap wp_t, const bf16* __restrict__ bias,
                      float* __restrict__ out, int M, int N, int K) {
  using namespace tpucap::mma;
  using namespace tpucap::tma;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned w_s = (smem_addr(smem) + 1023) & ~1023u;  // the swizzle's alignment
  const unsigned bar = w_s + kMhSlabs * kMhSlabBytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kMhBN, m0 = blockIdx.y * kMhBM;
  const int nk = K / kMhKC;

  // The block's 32 columns of W_p, as rows n0 .. n0 + 32 of W_p^T: one TMA
  // request a slab, all on one mbarrier, in flight while fe + h' is split.
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar, nk * kMhSlabBytes);
    for (int s = 0; s < nk; ++s) load_2d(w_s + s * kMhSlabBytes, &wp_t, bar, s * kMhKC, n0);
  }

  // Rows past M read nothing and split to zeros.
  const int r0 = m0 + 16 * warp + g, r1 = r0 + 8;
  const bool v0 = r0 < M, v1 = r1 < M;
  const bf16* fe_row[2] = {fe + static_cast<int64_t>(v0 ? r0 : 0) * K + 2 * t,
                           fe + static_cast<int64_t>(v1 ? r1 : 0) * K + 2 * t};
  const float* h_row[2] = {h32 + static_cast<int64_t>(v0 ? r0 : 0) * K + 2 * t,
                           h32 + static_cast<int64_t>(v1 ? r1 : 0) * K + 2 * t};
  auto load = [&](MhSlab& sl, int s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = s * kMhKC + 16 * kk + 8 * (e >> 1);
        const bool v = (e & 1) ? v1 : v0;
        sl.fe[kk][e] = v ? *reinterpret_cast<const unsigned*>(fe_row[e & 1] + col) : 0u;
        sl.h[kk][e] = v ? *reinterpret_cast<const float2*>(h_row[e & 1] + col) : make_float2(0.0f, 0.0f);
      }
  };

  float d[4][4];  // this warp's 16 rows x the block's 32 columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;

  MhSlab buf[2];
  load(buf[0], 0);
#pragma unroll
  for (int s = 0; s < kMhSlabs; ++s) {
    if (s >= nk) break;
    if (s + 1 < nk) load(buf[(s + 1) & 1], s + 1);  // the next slab's loads fly under this one
    // a = fe + h' in f32, split into hi, mid, lo (term t, step kk: a[4 t + kk]).
    unsigned a[12][4];
    const MhSlab& sl = buf[s & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sl.fe[kk][e]));
        float x0 = f.x + sl.h[kk][e].x, x1 = f.y + sl.h[kk][e].y;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
          a[4 * term + kk][e] = *reinterpret_cast<const unsigned*>(&b);
          const float2 r = __bfloat1622float2(b);
          x0 -= r.x;  // exact: the rounding error of a round-to-nearest
          x1 -= r.y;
        }
      }
    if (s == 0) mbar_wait(bar, 0);  // W_p's columns have landed
    pin(d, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int term = 0; term < 3; ++term)
        Wgmma<32>::run(d, a[4 * term + kk], smem_desc(w_s + s * kMhSlabBytes + 32 * kk), true);
    wgmma_commit_wait<0>();
    pin(d, a);
  }

  // Bias and relu from the registers; each store writes 2 floats of a row.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
    if (v0)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(r0) * N + n) =
          make_float2(fmaxf(d[j][0] + b.x, 0.0f), fmaxf(d[j][1] + b.y, 0.0f));
    if (v1)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(r1) * N + n) =
          make_float2(fmaxf(d[j][2] + b.x, 0.0f), fmaxf(d[j][3] + b.y, 0.0f));
  }
}

int launch_merge_head(const bf16* fe, const float* h32, const bf16* wp_t, const bf16* bias,
                      float* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map;
  const int err = tpucap::tma::encode_2d(&map, wp_t, N, K, K, kMhBN);
  if (err) return err;
  const int m_tiles = (M + kMhBM - 1) / kMhBM;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  merge_head_kernel<<<dim3(N / kMhBN, m_tiles), 128, kMhSmem, stream>>>(fe, h32, map, bias, out,
                                                                         M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// merged (M, N) f32 = relu((fe (M, K) bf16 + h32 (M, K) f32) @ wp_t (N, K)^T
// bf16 + bp (N,) bf16): the bf16 route on tensor cores, W_p given K-major.
// K a multiple of 64, at most 256; N a multiple of 32; all 16-byte aligned.
extern "C" int tpucap_merge_head_t(const void* fe, const void* h32, const void* wp_t,
                                   const void* bp, void* out, int M, int N, int K,
                                   void* stream) {
  if (M < 1 || N < kMhBN || N % kMhBN || K < kMhKC || K % kMhKC || K > kMhMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_merge_head(static_cast<const bf16*>(fe), static_cast<const float*>(h32),
                           static_cast<const bf16*>(wp_t), static_cast<const bf16*>(bp),
                           static_cast<float*>(out), M, N, K, static_cast<cudaStream_t>(stream));
}

// The same in f32, and in bf16 for widths tpucap_merge_head_t does not take.
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

// logits (M, N) f32 = merged (M, K) f32 @ wo (K, N) in dtype + bo (N,): the
// f32 route, and the bf16 one for widths tpucap_vocab_proj_t does not take.
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

// logits (M, N) f32 = merged (M, K) f32 @ wo_t (N, K)^T bf16 + bo (N,) bf16:
// the bf16 route on tensor cores, W_o given K-major. K a multiple of 64, at
// most 256; merged and wo_t 16-byte aligned.
extern "C" int tpucap_vocab_proj_t(const void* merged, const void* wo_t,
                                   const void* bo, void* out, int M, int N,
                                   int K, void* stream) {
  if (M < 1 || N < 1 || K < kVpKC || K % kVpKC || K > kVpMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_vocab_proj(static_cast<const float*>(merged), static_cast<const bf16*>(wo_t),
                           static_cast<const bf16*>(bo), static_cast<float*>(out), M, N, K,
                           static_cast<cudaStream_t>(stream));
}
