// Kernels K5b: the backward of softmax attention (kernel K5,
// flash_attention.cu), as two kernels:
//   flash_attention_bwd_dkv  dK, dV for one 64-key tile, looping over every
//                            query tile;
//   flash_attention_bwd_dq   dQ for one 64-query tile, looping over every
//                            key tile.
//
// Replaces the backward of the stock TPU flash attention that
// tpucap/models/encoders/vit.py:_flash_ctx calls when it is differentiated
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd
// at :254, _flash_attention_bwd_dkv's pallas_call at :1121,
// _flash_attention_bwd_dq's at :1456). Its numerics, per image and head,
// from q, k, v (L, 64), dO, the forward's row statistics and
// di = sum_d O dO (f32, computed outside either kernel, as the stock
// backward does too):
//   s  = q k^T in f32, then scaled;       p  = exp(s - lse) in f32
//   dV = p^T dO, p cast to dO's dtype, f32 accumulation
//   dp = dO v^T in f32;                   ds = (dp - di) p scale
//   dK = ds^T q, ds cast to dO's dtype;   dQ = ds k, ds cast to k's dtype
// each gradient accumulated in f32 over every tile and cast once at the
// end. The stock kernel keeps the row max m and sum l and takes
// p = exp(s - m) / l; K5 writes lse = m + ln l instead (one f32 rounding
// apart). On the TPU the tokens are padded to 256 and fenced off by
// segment ids; here keys and queries at or past L are loaded as zero and
// their p set to 0, and no gradient row at or past L is written.
//
// q, k and v are read with the strides of the (B, L, 3H) qkv projection
// they are views of; dQ, dK and dV are written with the same strides into
// one (B, L, 3H) gradient buffer, so autograd gets the projection's
// gradient whole. Each block owns its output rows and sums over the other
// axis in a loop: no atomics, so two runs give the same bits.
//
// Bound on an H100 (ViT-B/16 at batch 64, 12 heads, L = 196, bf16): the
// dK/dV kernel must read q, k, v and dO (77 MB) and the f32 statistics
// and write dK and dV (39 MB): 0.035 ms at 3.35 TB/s against 15.1 GFLOP
// of four products (0.015 ms at 989 TFLOP/s); the dQ kernel 96 MB and
// 11.3 GFLOP (three products): 0.029 ms. Both bound by bytes.
//
// bf16 route: a block of four warps, each with 16 of the block's 64 rows,
// mma.sync m16n8k16 (f32 accumulators) on ldmatrix fragments from
// swizzled shared tiles (mma.cuh); the streamed tiles come through a
// two-stage cp.async ring. dK/dV: each warp computes S^T and dP^T for its
// 16 keys against the query tile, so P^T and dS^T are already A fragments
// for dV += P^T dO and dK += dS^T Q, and both accumulators stay in
// registers. dQ: S and dP for the warp's 16 queries, then dQ += dS K.
// This is the simple design: one (image, head, 64-row tile) a block, no
// wgmma or TMA; each block recomputes s and p, which the two kernels
// both need.
//
// f32 route: eight warps, the same tiles with 16 x 16 f32 FMA tiles
// (tile.cuh), S, P, dP and dS in shared memory, no TF32.
#include <math.h>

#include <cstdint>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;    // head width
constexpr int kT = 64;    // rows of a tile (keys or queries)

// -- bf16: mma.sync -----------------------------------------------------------

constexpr int kWarps = 4;                // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kT * 128;          // bytes of a 64 x 64 bf16 tile
// Two own tiles, a two-stage ring of two tiles, and (dK/dV) the query
// tiles' f32 statistics, two stages of lse and di.
constexpr size_t kSmemMma = 6 * kTile + 2 * 2 * kT * sizeof(float);

// 64 rows of a (.., 64) bf16 array, row r at src + base + (row0 + r) ld,
// into a swizzled tile; rows at or past L are zero.
__device__ __forceinline__ void load_tile(unsigned dst, const bf16* src, int64_t base,
                                          int64_t ld, int row0, int L) {
  using namespace tpucap::mma;
  for (int i = threadIdx.x; i < kT * 8; i += kThreads) {
    const int r = i / 8, ch = i % 8;
    const bool ok = row0 + r < L;
    copy16(dst + swz(r, ch), ok ? src + base + (row0 + r) * ld + 8 * ch : src, ok);
  }
}

// A fragments of this warp's 16 rows of a 64 x 64 tile, k-steps 0 .. 3.
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], unsigned tile, int warp, int lane) {
  using namespace tpucap::mma;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], tile + swz(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
}

// acc (16 x 64) += A B^T: A the warp's fragments (16 x 64), B a 64 x 64
// tile stored by rows of its N index (acc column n = row n of the tile).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const unsigned (&a)[4][4],
                                        unsigned tile, int lane) {
  using namespace tpucap::mma;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];  // b0 of n-tiles 2np, 2np + 1, then b1 of each
      ldmatrix_x4(r, tile + swz(16 * np + (lane & 15), 2 * kk + (lane >> 4)));
      mma_bf16(acc[2 * np], a[kk], r[0], r[2]);
      mma_bf16(acc[2 * np + 1], a[kk], r[1], r[3]);
    }
}

// acc (16 x 64) += A B: A the warp's fragments (16 x 64), B a 64 x 64 tile
// stored by rows of its K index.
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const unsigned (&a)[4][4],
                                       unsigned tile, int lane) {
  using namespace tpucap::mma;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];  // b0, b1 of n-tile 2np, then of 2np + 1
      ldmatrix_x4_trans(r, tile + swz(16 * kk + (lane & 15), 2 * np + (lane >> 4)));
      mma_bf16(acc[2 * np], a[kk], r[0], r[1]);
      mma_bf16(acc[2 * np + 1], a[kk], r[2], r[3]);
    }
}

// A 16 x 64 accumulator, rounded to bf16, as the A fragments of its 64
// columns: k-step kk is n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void to_a(unsigned (&a)[4][4], const float (&c)[8][4]) {
  using tpucap::mma::pack_bf16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
}

// Rows g and g + 8 of the warp's 16 (row0 = the first), columns 8 n + 2 t
// and + 1, rounded to bf16, into dst with row stride ld; rows at or past L
// are not written.
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld, const float (&c)[8][4],
                                           int row0, int L, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    bf16* p = dst + row * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * n) =
          __floats2bfloat162_rn(c[n][2 * r], c[n][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
    dkv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int heads, int64_t sb,
                   int64_t sl, int64_t sh, float scale) {
  using namespace tpucap::mma;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned k_s = smem_addr(smem), v_s = k_s + kTile;
  const unsigned ring = v_s + kTile;  // stage st: Q at ring + 2 st kTile, dO after it
  float* stats = reinterpret_cast<float*>(smem + 6 * kTile);  // stage st: lse, then di

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kT, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const int64_t do_base = (static_cast<int64_t>(b) * L * heads + head) * kD;
  const int64_t do_ld = static_cast<int64_t>(heads) * kD;
  const int64_t st_base = (static_cast<int64_t>(b) * heads + head) * L;
  const int nq = (L + kT - 1) / kT;

  auto load_q = [&](int i) {
    const int st = i & 1;
    load_tile(ring + 2 * st * kTile, q, base, sl, i * kT, L);
    load_tile(ring + (2 * st + 1) * kTile, dout, do_base, do_ld, i * kT, L);
    if (tid < kT) {
      const int r = i * kT + tid;
      stats[2 * kT * st + tid] = r < L ? lse[st_base + r] : 0.0f;
      stats[2 * kT * st + kT + tid] = r < L ? di[st_base + r] : 0.0f;
    }
  };
  load_tile(k_s, k, base, sl, k0, L);
  load_tile(v_s, v, base, sl, k0, L);
  load_q(0);
  commit();

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int i = 0; i < nq; ++i) {
    wait_pending<0>();  // query tile i (and K, V): this thread's copies
    __syncthreads();    // ... every thread's; nobody reads tile i - 1 now
    if (i + 1 < nq) load_q(i + 1);
    commit();
    const int st = i & 1;
    const unsigned q_t = ring + 2 * st * kTile, do_t = q_t + kTile;
    const float* lse_t = stats + 2 * kT * st;
    const float* di_t = lse_t + kT;

    // S^T and dP^T: the warp's 16 keys by the tile's 64 queries.
    unsigned a[4][4];
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    load_a(a, k_s, warp, lane);
    mma_abt(s, a, q_t, lane);
    load_a(a, v_s, warp, lane);
    mma_abt(dp, a, do_t, lane);

    // s[n][e]: key k0 + 16 warp + g + 8 (e / 2), query i 64 + 8 n + 2 t + e % 2.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 16 * warp + g + 8 * (e >> 1);
        const int qc = 8 * n + 2 * t + (e & 1);
        float p = 0.0f, ds = 0.0f;
        if (key < L && i * kT + qc < L) {
          p = expf(s[n][e] * scale - lse_t[qc]);
          ds = (dp[n][e] - di_t[qc]) * p * scale;
        }
        s[n][e] = p;
        dp[n][e] = ds;
      }
    to_a(a, s);   // P^T in dO's dtype
    mma_ab(dv_acc, a, do_t, lane);
    to_a(a, dp);  // dS^T in dO's dtype
    mma_ab(dk_acc, a, q_t, lane);
  }
  store_rows(dk + base, sl, dk_acc, k0 + 16 * warp, L, lane);
  store_rows(dv + base, sl, dv_acc, k0 + 16 * warp, L, lane);
}

__global__ void __launch_bounds__(kThreads)
    dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  bf16* __restrict__ dq, int L, int heads, int64_t sb, int64_t sl, int64_t sh,
                  float scale) {
  using namespace tpucap::mma;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned q_s = smem_addr(smem), do_s = q_s + kTile;
  const unsigned ring = do_s + kTile;  // stage st: K at ring + 2 st kTile, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kT, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const int64_t do_base = (static_cast<int64_t>(b) * L * heads + head) * kD;
  const int64_t do_ld = static_cast<int64_t>(heads) * kD;
  const int64_t st_base = (static_cast<int64_t>(b) * heads + head) * L;
  const int nk = (L + kT - 1) / kT;

  auto load_kv = [&](int j) {
    const int st = j & 1;
    load_tile(ring + 2 * st * kTile, k, base, sl, j * kT, L);
    load_tile(ring + (2 * st + 1) * kTile, v, base, sl, j * kT, L);
  };
  load_tile(q_s, q, base, sl, q0, L);
  load_tile(do_s, dout, do_base, do_ld, q0, L);
  load_kv(0);
  commit();

  // This lane's rows: g and g + 8 of the warp's 16.
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lse_r[r] = row < L ? lse[st_base + row] : 0.0f;
    di_r[r] = row < L ? di[st_base + row] : 0.0f;
  }

  float dq_acc[8][4];
  zero(dq_acc);
  for (int j = 0; j < nk; ++j) {
    wait_pending<0>();
    __syncthreads();
    if (j + 1 < nk) load_kv(j + 1);
    commit();
    const unsigned k_t = ring + 2 * (j & 1) * kTile, v_t = k_t + kTile;

    // S and dP: the warp's 16 queries by the tile's 64 keys.
    unsigned a[4][4];
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    load_a(a, q_s, warp, lane);
    mma_abt(s, a, k_t, lane);
    load_a(a, do_s, warp, lane);
    mma_abt(dp, a, v_t, lane);

    // s[n][e]: query row g + 8 (e / 2), key j 64 + 8 n + 2 t + e % 2.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kT + 8 * n + 2 * t + (e & 1);
        float ds = 0.0f;
        if (key < L) {
          const float p = expf(s[n][e] * scale - lse_r[e >> 1]);
          ds = (dp[n][e] - di_r[e >> 1]) * p * scale;
        }
        dp[n][e] = ds;
      }
    to_a(a, dp);  // dS in k's dtype
    mma_ab(dq_acc, a, k_t, lane);
  }
  store_rows(dq + base, sl, dq_acc, q0 + 16 * warp, L, lane);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// -- f32: FMAs ----------------------------------------------------------------

using tpucap::Tile;

constexpr int kWarpsF = 8;
constexpr int kThreadsF = 32 * kWarpsF;
constexpr int kLdT = kD + 8;  // row stride (floats) of the 64 x 64 operand tiles
constexpr int kLdF = kT + 4;  // row stride (floats) of S / P and dP / dS
constexpr size_t kSmemF32 = (4 * kT * kLdT + 2 * kT * kLdF + 2 * kT) * sizeof(float);

// 64 rows of a (.., 64) f32 array into shared memory (row stride kLdT),
// 16 bytes a thread a step; rows at or past L are zero.
__device__ void load_tile_f32(float* dst, const float* src, int64_t ld, int row0, int L) {
  for (int i = threadIdx.x; i < kT * (kD / 4); i += kThreadsF) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < L) x = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + c);
    *reinterpret_cast<float4*>(dst + r * kLdT + c) = x;
  }
}

// C (64 x 64, row stride kLdF) = A B^T for two 64 x 64 operand tiles stored
// by rows (A's rows are C's rows, B's rows C's columns); two 16 x 16 tiles
// a warp.
__device__ void abt_f32(float* c, const float* a, const float* b) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tt = warp + kWarpsF * j, rt = tt / 4, ct = tt % 4;
    Tile<float, true> acc;
    acc.zero();
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16)
      acc.mma(a + rt * 16 * kLdT + kk, kLdT, b + ct * 16 * kLdT + kk, kLdT);
    acc.store(c + rt * 16 * kLdF + ct * 16, kLdF);
  }
}

// acc[j] += A B for the warp's two 16 x 16 tiles: A (64 x 64, row stride
// kLdF), B a 64 x 64 operand tile stored by rows of its K index.
__device__ void ab_f32(Tile<float, false> (&acc)[2], const float* a, const float* b) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tt = warp + kWarpsF * j, rt = tt / 4, ct = tt % 4;
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16)
      acc[j].mma(a + rt * 16 * kLdF + kk, kLdF, b + kk * kLdT + ct * 16, kLdT);
  }
}

// The warp's two 16 x 16 tiles of a 64 x 64 f32 result, through shared
// memory (stage, row stride kLdF), to rows row0 .. of dst (stride ld);
// rows at or past L are not written.
__device__ void store_f32(float* dst, int64_t ld, Tile<float, false> (&acc)[2], float* stage,
                          int row0, int L) {
  const int warp = threadIdx.x / 32;
  __syncthreads();  // every reader of stage is done
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tt = warp + kWarpsF * j, rt = tt / 4, ct = tt % 4;
    acc[j].store(stage + rt * 16 * kLdF + ct * 16, kLdF);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kT * kD; i += kThreadsF) {
    const int r = i / kD, c = i % kD;
    if (row0 + r < L) dst[(row0 + r) * ld + c] = stage[r * kLdF + c];
  }
}

__global__ void __launch_bounds__(kThreadsF)
    dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   float* __restrict__ dk, float* __restrict__ dv, int L, int heads, int64_t sb,
                   int64_t sl, int64_t sh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kT * kLdT;
  float* qs = vs + kT * kLdT;
  float* dos = qs + kT * kLdT;  // dO
  float* pt = dos + kT * kLdT;  // S^T, then P^T
  float* gt = pt + kT * kLdF;   // dP^T, then dS^T
  float* lse_s = gt + kT * kLdF;
  float* di_s = lse_s + kT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kT, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const int64_t do_base = (static_cast<int64_t>(b) * L * heads + head) * kD;
  const int64_t do_ld = static_cast<int64_t>(heads) * kD;
  const int64_t st_base = (static_cast<int64_t>(b) * heads + head) * L;

  load_tile_f32(ks, k + base, sl, k0, L);
  load_tile_f32(vs, v + base, sl, k0, L);
  Tile<float, false> dk_acc[2], dv_acc[2];
  for (int j = 0; j < 2; ++j) {
    dk_acc[j].zero();
    dv_acc[j].zero();
  }
  for (int q0 = 0; q0 < L; q0 += kT) {
    __syncthreads();  // the previous tile's readers of Q, dO, P, dS are done
    load_tile_f32(qs, q + base, sl, q0, L);
    load_tile_f32(dos, dout + do_base, do_ld, q0, L);
    for (int i = tid; i < kT; i += kThreadsF) {
      lse_s[i] = q0 + i < L ? lse[st_base + q0 + i] : 0.0f;
      di_s[i] = q0 + i < L ? di[st_base + q0 + i] : 0.0f;
    }
    __syncthreads();
    abt_f32(pt, ks, qs);   // S^T
    abt_f32(gt, vs, dos);  // dP^T
    __syncthreads();
    for (int i = tid; i < kT * kT; i += kThreadsF) {
      const int r = i / kT, c = i % kT;  // key k0 + r, query q0 + c
      float p = 0.0f, ds = 0.0f;
      if (k0 + r < L && q0 + c < L) {
        p = expf(pt[r * kLdF + c] * scale - lse_s[c]);
        ds = (gt[r * kLdF + c] - di_s[c]) * p * scale;
      }
      pt[r * kLdF + c] = p;
      gt[r * kLdF + c] = ds;
    }
    __syncthreads();
    ab_f32(dv_acc, pt, dos);
    ab_f32(dk_acc, gt, qs);
  }
  store_f32(dk + base, sl, dk_acc, pt, k0, L);
  store_f32(dv + base, sl, dv_acc, pt, k0, L);
}

__global__ void __launch_bounds__(kThreadsF)
    dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dq, int L, int heads, int64_t sb, int64_t sl, int64_t sh,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kT * kLdT;  // dO
  float* ks = dos + kT * kLdT;
  float* vs = ks + kT * kLdT;
  float* st = vs + kT * kLdT;  // S, then P (unused after dS)
  float* gt = st + kT * kLdF;  // dP, then dS
  float* lse_s = gt + kT * kLdF;
  float* di_s = lse_s + kT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kT, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const int64_t do_base = (static_cast<int64_t>(b) * L * heads + head) * kD;
  const int64_t do_ld = static_cast<int64_t>(heads) * kD;
  const int64_t st_base = (static_cast<int64_t>(b) * heads + head) * L;

  load_tile_f32(qs, q + base, sl, q0, L);
  load_tile_f32(dos, dout + do_base, do_ld, q0, L);
  for (int i = tid; i < kT; i += kThreadsF) {
    lse_s[i] = q0 + i < L ? lse[st_base + q0 + i] : 0.0f;
    di_s[i] = q0 + i < L ? di[st_base + q0 + i] : 0.0f;
  }
  Tile<float, false> dq_acc[2];
  for (int j = 0; j < 2; ++j) dq_acc[j].zero();
  for (int k0 = 0; k0 < L; k0 += kT) {
    __syncthreads();
    load_tile_f32(ks, k + base, sl, k0, L);
    load_tile_f32(vs, v + base, sl, k0, L);
    __syncthreads();
    abt_f32(st, qs, ks);   // S
    abt_f32(gt, dos, vs);  // dP
    __syncthreads();
    for (int i = tid; i < kT * kT; i += kThreadsF) {
      const int r = i / kT, c = i % kT;  // query q0 + r, key k0 + c
      float ds = 0.0f;
      if (k0 + c < L) {
        const float p = expf(st[r * kLdF + c] * scale - lse_s[r]);
        ds = (gt[r * kLdF + c] - di_s[r]) * p * scale;
      }
      gt[r * kLdF + c] = ds;
    }
    __syncthreads();
    ab_f32(dq_acc, gt, ks);
  }
  store_f32(dq + base, sl, dq_acc, st, q0, L);
}

}  // namespace

// q, k, v (B, L, heads, 64) sharing element strides (sb, sl, sh) with unit
// stride on the last axis and 16-byte aligned rows; dout (B, L, heads, 64)
// contiguous; lse, di (B, heads, L) f32 contiguous; dk, dv (dkv) or dq
// with q's strides. 64-row tiles of keys (dkv) or queries (dq), one block
// each per (image, head).
extern "C" int tpucap_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* di, void* dk, void* dv, int B, int L,
                                              int heads, int64_t sb, int64_t sl, int64_t sh,
                                              float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kT - 1) / kT, heads, B);
  static bool attr_set[2] = {false, false};  // once, before any graph capture
  switch (dtype) {
    case tpucap::kF32:
      if (!attr_set[0]) {
        if (const int err = set_smem(dkv_kernel_f32, kSmemF32)) return err;
        attr_set[0] = true;
      }
      dkv_kernel_f32<<<grid, kThreadsF, kSmemF32, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di),
          static_cast<float*>(dk), static_cast<float*>(dv), L, heads, sb, sl, sh, scale);
      break;
    case tpucap::kBF16:
      if (!attr_set[1]) {
        if (const int err = set_smem(dkv_kernel_mma, kSmemMma)) return err;
        attr_set[1] = true;
      }
      dkv_kernel_mma<<<grid, kThreads, kSmemMma, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, heads, sb, sl, sh, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpucap_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* di,
                                             void* dq, int B, int L, int heads, int64_t sb,
                                             int64_t sl, int64_t sh, float scale, int dtype,
                                             void* stream) {
  if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kT - 1) / kT, heads, B);
  static bool attr_set[2] = {false, false};  // once, before any graph capture
  switch (dtype) {
    case tpucap::kF32:
      if (!attr_set[0]) {
        if (const int err = set_smem(dq_kernel_f32, kSmemF32)) return err;
        attr_set[0] = true;
      }
      dq_kernel_f32<<<grid, kThreadsF, kSmemF32, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di),
          static_cast<float*>(dq), L, heads, sb, sl, sh, scale);
      break;
    case tpucap::kBF16:
      if (!attr_set[1]) {
        if (const int err = set_smem(dq_kernel_mma, kSmemMma)) return err;
        attr_set[1] = true;
      }
      dq_kernel_mma<<<grid, kThreads, kSmemMma, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di),
          static_cast<bf16*>(dq), L, heads, sb, sl, sh, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
