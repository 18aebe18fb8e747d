// Kernels K5b: the backward of softmax attention (kernel K5,
// flash_attention.cu), as two kernels:
//   flash_attention_bwd_dkv  dK, dV for a tile of keys, looping over every
//                            query tile;
//   flash_attention_bwd_dq   dQ for a tile of queries, looping over every
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
// segment ids; here rows at or past L are loaded as zero, p is set to 0
// wherever such a row is contracted (a zero key still gives
// exp(0 - lse) != 0), and no gradient row at or past L is written.
//
// q, k and v are read with the strides of the (B, L, 3H) qkv projection
// they are views of; dQ, dK and dV are written with the same strides into
// one (B, L, 3H) gradient buffer, so autograd gets the projection's
// gradient whole. Each block owns its output rows and sums over the other
// axis in a loop: no atomics, so two runs give the same bits. The price is
// that both kernels compute s and p (seven products where five would do).
//
// Bound on an H100 (ViT-B/16 at batch 64, 12 heads, L = 196, bf16): the
// dK/dV kernel must read q, k, v and dO (77 MB) and the f32 statistics
// and write dK and dV (39 MB): 0.035 ms at 3.35 TB/s against 15.1 GFLOP
// of four products (0.015 ms at 989 TFLOP/s); the dQ kernel 96 MB and
// 11.3 GFLOP (three products): 0.029 ms. Both bound by bytes.
//
// bf16 route, on Hopper's warpgroup MMA in the shape of K5's forward: a
// block of one warpgroup covers 64 rows (keys for dK/dV, queries for dQ)
// of one (image, head) and keeps the two operands of those rows (K and V,
// or Q and dO) in shared memory. The other two operands stream by 64-row
// tiles through a 3-stage cp.async ring (the next tile's copies land while
// a tile is used), made visible to the tensor cores by fence.proxy.async,
// one barrier a tile; 3 blocks share an SM.
// dK/dV's ring also carries each query tile's lse and di.
// Per tile, as a chain on the accumulators:
//   dK/dV: S^T = K Q^T and dP^T = V dO^T (K, V as A fragments by ldmatrix;
//     Q, dO read as K-major B straight from the ring), 8 wgmma.m64n64k16
//     and one wait; P^T = 2^(s c - lse log2 e), c = scale log2 e, one FMA
//     and ex2.approx on the special-function unit (lse and di per column
//     from shared memory); dS^T = P^T (dp scale - di scale); both repacked
//     in registers as bf16 A fragments; then dV += P^T dO and dK += dS^T Q
//     with dO and Q read as MN-major B, 8 wgmmas and one wait.
//   dQ: the mirror image, S = Q K^T and dP = dO V^T with the rows' lse and
//     di in registers, then dQ += dS K with K as an MN-major B.
// The accumulators stay in f32 registers and are stored once. A last tile
// of at most 8 rows (L = 196 leaves 4) takes n8 products and one 16-deep
// k-step instead of n64 and four.
//
// The kept operands' A fragments are read from shared memory again for
// each tile. Held in registers across the tile loop they were 3-6 % faster,
// but with the loop's tail branch taken out, ptxas gave their registers to
// the tile's dS fragments, so that every tile after the first multiplied
// by dS instead of Q (wrong results on the card, no warning).
//
// Measured on the card (scripts/kernel_versions.py; PERF.md, K5b's
// versions): blocks of 64 rows beat 128 (three blocks an SM share the
// prologue's wait, where one block of two warpgroups stalls whole); dK/dV's
// registers are held to 168 for its third block; the n8 last tile saves 6 %;
// each thread's copies step by constants (an unrolled loop over fixed rows
// and chunk), where a strided loop spent 15-19 % of the time on address
// arithmetic. Issuing the next tile's S and dP ahead of this tile's
// gradient products, to overlap the exponentials with the tensor cores, was
// 11-13 % slower.
//
// What holds it back: each tile is one chain in order (products, wait,
// exponentials, products, wait) with 3 warpgroups an SM to overlap the
// chains. Before the copy fix, dK/dV's chain alone took 0.078 ms and its
// copies alone 0.060 ms (dQ 0.044 and 0.047), overlapping only in part.
// The 64-row blocks read each streamed tile from L2 four times per (image,
// head). FlashAttention-3's producer warps and ping-pong between
// warpgroups are what comes next.
//
// f32 route: eight warps, one 64-row tile a block, 16 x 16 f32 FMA tiles
// (tile.cuh), S, P, dP and dS in shared memory, no TF32.
#include <math.h>

#include <cstdint>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;    // head width
constexpr int kT = 64;    // rows of a tile (keys or queries)

// -- bf16: wgmma -------------------------------------------------------------

// The design's choices, each timed on the card by scripts/kernel_versions.py
// (see the header).
constexpr int kThreads = 128;       // one warpgroup a block, 64 rows
static_assert(kThreads == 2 * kT, "a thread for each of a tile's 64 lse and 64 di");
constexpr int kBlocksDkv = 3;       // dK/dV blocks an SM holds (registers a thread)
constexpr int kStagesDkv = 3;       // ring stages of streamed (Q, dO) tiles
constexpr int kBlocksDq = 3;        // dQ blocks an SM holds
constexpr int kStagesDq = 3;        // ring stages of streamed (K, V) tiles
constexpr int kTile = kT * 128;     // bytes of a 64 x 64 bf16 tile
constexpr float kLog2e = 1.4426950408889634f;

// From a 1024-byte aligned base (1 KB of slack): the block's own two
// 64-row tiles, the ring of streamed tile pairs and, for dK/dV, each
// stage's 64 lse and 64 di.
constexpr size_t smem_dkv() { return 1024 + 2 * kTile + kStagesDkv * (2 * kTile + 2 * kT * 4); }
constexpr size_t smem_dq() { return 1024 + 2 * kTile + kStagesDq * 2 * kTile; }

// 64 rows from row0 of a (.., 64) bf16 array, row r at src + base + r ld,
// into a swizzled tile at dst; rows at or past L are zero. Each thread
// copies one 16-byte chunk column of every kThreads / 8-th row, so its
// addresses step by a constant.
__device__ __forceinline__ void load_tile(unsigned dst, const bf16* src, int64_t base, int64_t ld,
                                          int row0, int L) {
  using namespace tpucap::mma;
  const int ch = threadIdx.x % 8;
#pragma unroll
  for (int m = 0; m < kT * 8 / kThreads; ++m) {
    const int r = threadIdx.x / 8 + m * (kThreads / 8);
    const bool ok = row0 + r < L;
    copy16(dst + swz(r, ch), ok ? src + base + (row0 + r) * ld + 8 * ch : src, ok);
  }
}

// One 4-byte asynchronous copy; with valid == false the 4 bytes are zero.
__device__ __forceinline__ void copy4(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// A fragments of rows 16 warp .. + 15 of the swizzled tiles at `tiles`,
// k-steps 0 .. 3.
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], unsigned tiles, int warp, int lane) {
  using namespace tpucap::mma;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], tiles + swz(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
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

// An n8 accumulator as the A fragment of k-step 0; its columns 8 .. 15 are 0.
__device__ __forceinline__ void to_a8(unsigned (&a)[1][4], const float (&c)[1][4]) {
  using tpucap::mma::pack_bf16;
  a[0][0] = pack_bf16(c[0][0], c[0][1]);
  a[0][1] = pack_bf16(c[0][2], c[0][3]);
  a[0][2] = 0u;
  a[0][3] = 0u;
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

// d = A B and d2 = A2 B2 for a warpgroup: 64 rows of A (a, a2 from
// registers) against the N rows of the K-major tiles b, b2 (N = 8 or 64),
// then one wait.
template <int N>
__device__ __forceinline__ void two_products(float (&d)[N / 8][4], unsigned (&a)[4][4], unsigned b,
                                             float (&d2)[N / 8][4], unsigned (&a2)[4][4],
                                             unsigned b2) {
  using namespace tpucap::mma;
  pin(d, a);
  pin(d2, a2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<N>::run(d, a[kk], smem_desc(b + 32 * kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<N>::run(d2, a2[kk], smem_desc(b2 + 32 * kk), kk > 0);
  wgmma_commit_wait<0>();
  pin(d, a);
  pin(d2, a2);
}

// d += A B over KA 16-deep k-steps of A (registers) and of the MN-major
// tile at b, then one wait; and the same for two products.
template <int KA>
__device__ __forceinline__ void accumulate(float (&d)[8][4], unsigned (&a)[KA][4], unsigned b) {
  using namespace tpucap::mma;
  pin(d, a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KA; ++kk) Wgmma<64, 1>::run(d, a[kk], smem_desc(b + 2048 * kk), true);
  wgmma_commit_wait<0>();
  pin(d, a);
}

template <int KA>
__device__ __forceinline__ void accumulate(float (&d)[8][4], unsigned (&a)[KA][4], unsigned b,
                                           float (&d2)[8][4], unsigned (&a2)[KA][4], unsigned b2) {
  using namespace tpucap::mma;
  pin(d, a);
  pin(d2, a2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KA; ++kk) {
    Wgmma<64, 1>::run(d, a[kk], smem_desc(b + 2048 * kk), true);
    Wgmma<64, 1>::run(d2, a2[kk], smem_desc(b2 + 2048 * kk), true);
  }
  wgmma_commit_wait<0>();
  pin(d, a);
  pin(d2, a2);
}

// dK, dV for 64 keys of one (image, head). K and V of those keys stay in
// shared memory and are taken as A fragments; the query tiles (Q, dO, and
// their lse and di) stream through the ring. Per query tile: S^T = K Q^T
// and dP^T = V dO^T (Q, dO as K-major B), P^T and dS^T made in the
// accumulators, then dV += P^T dO and dK += dS^T Q (dO, Q as MN-major B).
__global__ void __launch_bounds__(kThreads, kBlocksDkv)
    dkv_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int heads, int64_t sb,
                     int64_t sl, int64_t sh, float scale) {
  using namespace tpucap::mma;
  constexpr int kStages = kStagesDkv;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const unsigned k_s = (smem_addr(smem_wg) + 1023u) & ~1023u;  // swz and smem_desc need 1024
  const unsigned v_s = k_s + kTile;
  const unsigned ring = v_s + kTile;  // stage st: Q at ring + 2 st kTile, dO after it
  const unsigned stats = ring + kStages * 2 * kTile;  // stage st: 64 lse, then 64 di
  const float* stats_p = reinterpret_cast<const float*>(smem_wg + (stats - smem_addr(smem_wg)));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int k0 = blockIdx.x * kT, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const int64_t do_base = (static_cast<int64_t>(b) * L * heads + head) * kD;
  const int64_t do_ld = static_cast<int64_t>(heads) * kD;
  const int64_t st_base = (static_cast<int64_t>(b) * heads + head) * L;
  const int nq = (L + kT - 1) / kT;
  const float c = scale * kLog2e;

  auto load_q = [&](int i) {
    const int st = i % kStages;
    load_tile(ring + 2 * st * kTile, q, base, sl, i * kT, L);
    load_tile(ring + (2 * st + 1) * kTile, dout, do_base, do_ld, i * kT, L);
    const int row = i * kT + tid % kT;  // one statistic a thread: lse, then di
    const float* src = tid < kT ? lse : di;
    copy4(stats + (2 * kT * st + tid) * 4, src + st_base + (row < L ? row : 0), row < L);
  };
  load_tile(k_s, k, base, sl, k0, L);
  load_tile(v_s, v, base, sl, k0, L);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nq) load_q(st);
    commit();
  }

  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  for (int i = 0; i < nq; ++i) {
    wait_pending<kStages - 2>();  // query tile i landed: this thread's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma too
    __syncthreads();              // ... every thread's; nobody reads tile i - 1 now
    if (i + kStages - 1 < nq) load_q(i + kStages - 1);
    commit();
    const int st = i % kStages;
    const unsigned q_t = ring + 2 * st * kTile, do_t = q_t + kTile;
    const float* lse_t = stats_p + 2 * kT * st;
    const float* di_t = lse_t + kT;
    // Only the queries (the contracted axis) are masked: a key row past L
    // gives dK and dV rows that are never stored.
    const int left = L - i * kT;  // queries of this tile below L

    if (left <= 8) {  // the last tile, n8 products and one k-step
      // S^T and dP^T against queries 0 .. 7 only; the products over them
      // take one k-step, whose queries 8 .. 15 are 0.
      float s8[1][4], dp8[1][4];
      unsigned kf[4][4], vf[4][4];
      load_a(kf, k_s, warp, lane);
      load_a(vf, v_s, warp, lane);
      two_products<8>(s8, kf, q_t, dp8, vf, do_t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t + (e & 1);
        float p = 0.0f, ds = 0.0f;
        if (col < left) {
          p = tpucap::exp2_approx(fmaf(s8[0][e], c, -lse_t[col] * kLog2e));
          ds = p * fmaf(dp8[0][e], scale, -di_t[col] * scale);
        }
        s8[0][e] = p;
        dp8[0][e] = ds;
      }
      unsigned pf[1][4], dsf[1][4];
      to_a8(pf, s8);   // P^T in dO's dtype
      to_a8(dsf, dp8);  // dS^T in dO's dtype
      accumulate(dva, pf, do_t, dka, dsf, q_t);
      continue;
    }

    // s[n][e]: key row g + 8 (e / 2) of the warp's 16, query i 64 + 8 n +
    // 2 t + e % 2. p = exp(scale s - lse) as 2^(s c - lse log2 e), one FMA;
    // ds = (dp - di) p scale as p (dp scale - di scale), one FMA and a
    // product (the same f32 result when scale is a power of two).
    float s[8][4], dp[8][4];
    unsigned kf[4][4], vf[4][4];
    load_a(kf, k_s, warp, lane);
    load_a(vf, v_s, warp, lane);
    two_products<64>(s, kf, q_t, dp, vf, do_t);
    const bool ragged = left < kT;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(di_t + 8 * n + 2 * t);
      const float lc[2] = {l2.x * kLog2e, l2.y * kLog2e}, dc[2] = {d2.x * scale, d2.y * scale};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tpucap::exp2_approx(fmaf(s[n][e], c, -lc[e & 1]));
        float ds = p * fmaf(dp[n][e], scale, -dc[e & 1]);
        if (ragged && 8 * n + 2 * t + (e & 1) >= left) p = ds = 0.0f;
        s[n][e] = p;
        dp[n][e] = ds;
      }
    }
    unsigned pf[4][4], dsf[4][4];
    to_a(pf, s);    // P^T in dO's dtype
    to_a(dsf, dp);  // dS^T in dO's dtype
    accumulate(dva, pf, do_t, dka, dsf, q_t);
  }
  store_rows(dk + base, sl, dka, k0 + 16 * warp, L, lane);
  store_rows(dv + base, sl, dva, k0 + 16 * warp, L, lane);
}

// dQ for 64 queries of one (image, head), the mirror image: Q and dO of
// those queries stay in shared memory and are taken as A fragments, the
// rows' lse and di in registers; the key tiles (K, V) stream through the
// ring. Per key tile: S = Q K^T and dP = dO V^T (K, V as K-major B), dS in
// the accumulators, then dQ += dS K (K as MN-major B).
__global__ void __launch_bounds__(kThreads, kBlocksDq)
    dq_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    bf16* __restrict__ dq, int L, int heads, int64_t sb, int64_t sl, int64_t sh,
                    float scale) {
  using namespace tpucap::mma;
  constexpr int kStages = kStagesDq;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const unsigned q_s = (smem_addr(smem_wg) + 1023u) & ~1023u;  // swz and smem_desc need 1024
  const unsigned do_s = q_s + kTile;
  const unsigned ring = do_s + kTile;  // stage st: K at ring + 2 st kTile, V after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kT, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const int64_t do_base = (static_cast<int64_t>(b) * L * heads + head) * kD;
  const int64_t do_ld = static_cast<int64_t>(heads) * kD;
  const int64_t st_base = (static_cast<int64_t>(b) * heads + head) * L;
  const int nk = (L + kT - 1) / kT;
  const float c = scale * kLog2e;

  auto load_kv = [&](int j) {
    const unsigned st = ring + (j % kStages) * 2 * kTile;
    load_tile(st, k, base, sl, j * kT, L);
    load_tile(st + kTile, v, base, sl, j * kT, L);
  };
  load_tile(q_s, q, base, sl, q0, L);
  load_tile(do_s, dout, do_base, do_ld, q0, L);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_kv(st);
    commit();
  }

  // This lane's rows, g and g + 8 of its warp's 16: lse log2(e) and di
  // scale (rows past L: 0; their dQ is never stored).
  float lc[2], dc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lc[r] = row < L ? lse[st_base + row] * kLog2e : 0.0f;
    dc[r] = row < L ? di[st_base + row] * scale : 0.0f;
  }

  float dqa[8][4];
  zero(dqa);
  for (int j = 0; j < nk; ++j) {
    wait_pending<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (j + kStages - 1 < nk) load_kv(j + kStages - 1);
    commit();
    const unsigned k_t = ring + (j % kStages) * 2 * kTile, v_t = k_t + kTile;
    // Keys past L are zero rows, which still give p = 2^(0 - lse) != 0:
    // their ds is set to 0.
    const int left = L - j * kT;  // keys of this tile below L

    if (left <= 8) {  // the last tile, n8 products and one k-step
      float s8[1][4], dp8[1][4];
      unsigned qf[4][4], dof[4][4];
      load_a(qf, q_s, warp, lane);
      load_a(dof, do_s, warp, lane);
      two_products<8>(s8, qf, k_t, dp8, dof, v_t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tpucap::exp2_approx(fmaf(s8[0][e], c, -lc[e >> 1]));
        dp8[0][e] = 2 * t + (e & 1) < left ? p * fmaf(dp8[0][e], scale, -dc[e >> 1]) : 0.0f;
      }
      unsigned dsf[1][4];
      to_a8(dsf, dp8);  // dS in k's dtype
      accumulate(dqa, dsf, k_t);
      continue;
    }

    // s[n][e]: query row g + 8 (e / 2) of the warp's 16, key j 64 + 8 n +
    // 2 t + e % 2.
    float s[8][4], dp[8][4];
    unsigned qf[4][4], dof[4][4];
    load_a(qf, q_s, warp, lane);
    load_a(dof, do_s, warp, lane);
    two_products<64>(s, qf, k_t, dp, dof, v_t);
    const bool ragged = left < kT;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tpucap::exp2_approx(fmaf(s[n][e], c, -lc[e >> 1]));
        float ds = p * fmaf(dp[n][e], scale, -dc[e >> 1]);
        if (ragged && 8 * n + 2 * t + (e & 1) >= left) ds = 0.0f;
        dp[n][e] = ds;
      }
    unsigned dsf[4][4];
    to_a(dsf, dp);  // dS in k's dtype
    accumulate(dqa, dsf, k_t);
  }
  store_rows(dq + base, sl, dqa, q0 + 16 * warp, L, lane);
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

// A kernel of each route with its block and dynamic shared memory; the
// attribute is set once, before any graph capture.
struct Route {
  const void* fn;
  int rows, threads;
  size_t smem;
};

int route(int which, int dtype, Route* r) {
  static bool attr_set[2][2] = {};
  switch (dtype) {
    case tpucap::kF32:
      *r = which == 0 ? Route{reinterpret_cast<const void*>(dkv_kernel_f32), kT, kThreadsF, kSmemF32}
                      : Route{reinterpret_cast<const void*>(dq_kernel_f32), kT, kThreadsF, kSmemF32};
      break;
    case tpucap::kBF16:
      *r = which == 0 ? Route{reinterpret_cast<const void*>(dkv_kernel_wgmma), kT, kThreads, smem_dkv()}
                      : Route{reinterpret_cast<const void*>(dq_kernel_wgmma), kT, kThreads, smem_dq()};
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  bool& done = attr_set[which][dtype];
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        r->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(r->smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

bool bad_shape(int B, int L, int heads) {
  return B < 1 || B > 65535 || heads < 1 || heads > 65535 || L < 1;
}

}  // namespace

// q, k, v (B, L, heads, 64) sharing element strides (sb, sl, sh) with unit
// stride on the last axis and 16-byte aligned rows; dout (B, L, heads, 64)
// contiguous; lse, di (B, heads, L) f32 contiguous; dk, dv (dkv) or dq
// with q's strides. One block per (image, head, tile of rows): 64 keys
// (dkv) or queries (dq) in f32, 64 per warpgroup in bf16.
extern "C" int tpucap_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* di, void* dk, void* dv, int B, int L,
                                              int heads, int64_t sb, int64_t sl, int64_t sh,
                                              float scale, int dtype, void* stream) {
  if (bad_shape(B, L, heads)) return static_cast<int>(cudaErrorInvalidValue);
  Route r;
  if (const int err = route(0, dtype, &r)) return err;
  const dim3 grid((L + r.rows - 1) / r.rows, heads, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tpucap::kF32)
    dkv_kernel_f32<<<grid, r.threads, r.smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dk), static_cast<float*>(dv), L, heads, sb, sl, sh, scale);
  else
    dkv_kernel_wgmma<<<grid, r.threads, r.smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, heads, sb, sl, sh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpucap_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* di,
                                             void* dq, int B, int L, int heads, int64_t sb,
                                             int64_t sl, int64_t sh, float scale, int dtype,
                                             void* stream) {
  if (bad_shape(B, L, heads)) return static_cast<int>(cudaErrorInvalidValue);
  Route r;
  if (const int err = route(1, dtype, &r)) return err;
  const dim3 grid((L + r.rows - 1) / r.rows, heads, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tpucap::kF32)
    dq_kernel_f32<<<grid, r.threads, r.smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dq), L, heads, sb, sl, sh, scale);
  else
    dq_kernel_wgmma<<<grid, r.threads, r.smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<bf16*>(dq), L, heads, sb, sl, sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel of one route (which: 0 dK/dV, 1 dQ; dtype as above):
// its registers a thread, its shared memory a block (static and dynamic),
// and how many of its blocks an SM holds at once.
extern "C" int tpucap_flash_attention_bwd_attributes(int which, int dtype, int* regs,
                                                     int* smem_bytes, int* blocks_per_sm) {
  if (which != 0 && which != 1) return static_cast<int>(cudaErrorInvalidValue);
  Route r;
  if (const int err = route(which, dtype, &r)) return err;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, r.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes + r.smem);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, r.fn, r.threads, r.smem);
  return static_cast<int>(err);
}
