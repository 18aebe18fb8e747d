// Kernel K5: softmax attention of a ViT token grid,
//   ctx[b, l, h] = softmax(scale * q[b, l, h] . k[b, :, h]) @ v[b, :, h]
// over all L tokens (no causal mask), head width 64.
//
// Replaces the stock TPU flash attention that
// tpucap/models/encoders/vit.py:_flash_ctx calls (its forward pallas_call,
// jax/experimental/pallas/ops/tpu/flash_attention.py). Its numerics: s =
// q k^T accumulated in f32; a running max and sum in f32; p = exp(scale s
// - scale m) cast to v's dtype for p @ v, accumulated in f32; normalised
// by the sum once at the end; cast to q's dtype. The f32 route computes
// exactly that (scale, then expf; one division per element). The bf16
// route computes p as 2^(s c - m c), c = scale log2(e), the scale folded
// into one f32 FMA and 2^x taken on the special-function unit (relative
// error 2^-22), and normalises by multiplying with the reciprocal of the
// row sum: each differs from the stock kernel by an f32 ulp or two before
// the cast to bf16 (PERF.md, K5's versions). On the
// TPU the 196 tokens are padded to 256 and the pad fenced off by segment
// ids; here the keys at index >= L are masked inside the kernel and nothing
// is padded. q, k and v are read with strides straight from the (B, L, 3H)
// output of the qkv projection and ctx is written (B, L, heads, 64).
//
// Bound on an H100 (ViT-B/16, batch 256, 12 heads, bf16): 231 MB of
// q, k, v read and 77 MB of ctx written take 0.092 ms at 3.35 TB/s against
// 30.2 GFLOP (0.031 ms at 989 TFLOP/s): bound by bytes. What the kernel
// must avoid is reading K and V many times and waiting on its own loads.
//
// bf16 route (flash_kernel_mma), FlashAttention-2's shape on Hopper's
// warpgroup MMA: a block of two warpgroups (8 warps) covers 128 queries of
// one (image, head), so K and V come from device memory about once per
// (image, head) (the second block of the pair, launched next to it, reads
// them from L2). Per 64-key tile, each warpgroup computes its 64 x 64
// scores S = Q K^T with four wgmma.m64n64k16 whose A, Q, comes from
// registers (ldmatrix from Q in shared memory) and whose B, K, the tensor
// cores read straight from the ring (no ldmatrix, no copy per warp). The
// online softmax runs on the accumulator registers, which hold each row
// within one quad of lanes as mma.sync's do (max and sum reduce by two
// shuffles; 2^x on the special-function unit with the scale folded into
// one FMA). P is repacked in registers as the bf16 A operand of four more
// wgmmas, O += P V, with V read from the ring as an MN-major B; O stays in
// registers and is scaled by the reciprocal of its row sum once, at the
// end. K and V tiles arrive through a 4-stage cp.async ring (the 4 tiles
// of 196 keys in flight at once), made visible to the tensor cores' async
// proxy by a fence, with one barrier per tile; two blocks share an SM.
// The ring's rows are 128 bytes with the XOR swizzle of mma.cuh, which is
// wgmma's 128-byte swizzle when each tile starts on 1024 bytes: the
// kernel rounds its shared-memory base up to 1024 itself (CUDA promises
// the dynamic base only 16), from 1 KB of slack.
// What holds it back (PERF.md, K5's versions): besides the device bytes,
// each tile is a chain the warpgroup runs in order, MMA, then softmax (34
// exponentials a lane on the special-function unit, an eighth of the
// FMA rate), then MMA, and the four warpgroups of an SM overlap those
// phases only in part. A persistent grid and 32 rows a warp were slower;
// FlashAttention-3's producer warps and ping-pong between warpgroups are
// what comes next.
//
// f32 route (flash_kernel_f32): 64 queries per block, S, P and O in shared
// memory, 16 x 16 f32 FMA tiles (tile.cuh), no TF32.
//
// Row statistics for the backward (flash_attention_bwd.cu): given an `lse`
// pointer, both routes also write each row's f32 log-sum-exp of the scaled
// scores, lse = scale m + ln l (m the row's max, l its sum of exp), at
// lse[(b heads + head) L + row]; a null pointer writes nothing (inference).
// The stock kernel saves m and l for its backward instead; the backward
// here takes p = exp(scale s - lse) where it takes exp(scale s - m) / l.
#include <math.h>

#include <cstdint>

#include "mma.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;  // head width

// -- bf16: tensor cores -------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kMinBlocks = 2;      // per SM: at most 128 registers a thread
constexpr int kBM = 16 * kWarps;   // queries per block
constexpr int kBN = 64;            // keys per tile
constexpr int kStages = 4;         // K/V ring: the 4 tiles of 196 keys in flight at once
constexpr int kTile = kBN * 128;   // bytes of a 64 x 64 bf16 tile
// Q, then (K, V) x kStages, from a 1024-byte aligned base: 1 KB of slack.
constexpr size_t kSmemMma = 1024 + kBM * 128 + kStages * 2 * kTile;

__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
    flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int L, int heads, int64_t sb, int64_t sl,
                     int64_t sh, float scale) {
  using namespace tpucap::mma;
  extern __shared__ __align__(1024) unsigned char smem[];
  // Every tile's swizzle (swz, smem_desc) needs a 1024-byte aligned start.
  const unsigned q_s = (smem_addr(smem) + 1023u) & ~1023u;
  const unsigned kv_s = q_s + kBM * 128;  // stage st: K at kv_s + 2 st kTile, V after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBM, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;
  const float c = scale * 1.4426950408889634f;  // scale log2(e)

  // Rows row0 .. row0 + rows of q, k or v, 8 chunks each, zero at or past L.
  auto load_rows = [&](unsigned dst, const bf16* src, int row0, int rows) {
    for (int i = tid; i < rows * 8; i += 32 * kWarps) {
      const int r = i / 8, ch = i % 8;
      const bool ok = row0 + r < L;
      copy16(dst + swz(r, ch), ok ? src + base + (row0 + r) * sl + 8 * ch : src, ok);
    }
  };
  auto load_kv = [&](int j) {
    const unsigned st = kv_s + (j % kStages) * 2 * kTile;
    load_rows(st, k, j * kBN, kBN);
    load_rows(st + kTile, v, j * kBN, kBN);
  };

  const int nt = (L + kBN - 1) / kBN;
  load_rows(q_s, q, q0, kBM);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_kv(st);
    commit();
  }

  // A warpgroup (4 warps, 64 rows) whose rows all lie past L only helps
  // with the copies; a wgmma takes all four of its warps.
  const bool active = q0 + 64 * (warp / 4) < L;
  float o[kD / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows g, g + 8
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int j = 0; j < nt; ++j) {
    wait_pending<kStages - 2>();  // tile j (and Q) landed: this thread's copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma too
    __syncthreads();              // ... every thread's; nobody reads tile j - 1 now
    if (j + kStages - 1 < nt) load_kv(j + kStages - 1);
    commit();
    if (!active) continue;
    // Q's fragments, read again for each tile: Q stays in shared memory.
    unsigned qf[kD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldmatrix_x4(qf[kk], q_s + swz(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
    const unsigned k_t = kv_s + (j % kStages) * 2 * kTile, v_t = k_t + kTile;

    // S = Q K^T, the warpgroup's 64 rows by the tile's 64 keys: n-tile n
    // holds keys 8 n .. 8 n + 7. K is B, K-major; a 16-deep step of d is
    // 32 bytes along its rows.
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    pin(s, qf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      Wgmma<64>::run(s, qf[kk], smem_desc(k_t + 32 * kk), kk > 0);
    wgmma_commit_wait<0>();
    pin(s, qf);

    // Online softmax on the fragments: s[n][e] is row g + 8 (e / 2), key
    // j * 64 + 8 n + 2 t + e % 2. The max is taken over the unscaled f32
    // scores (scale > 0), and exp(scale s - scale m) is evaluated as
    // 2^(s c - m c) with c = scale log2(e), the scale applied in f32 in
    // the one FMA.
    const int k0 = j * kBN;
    const bool ragged = k0 + kBN > L;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && k0 + 8 * n + 2 * t + (e & 1) >= L) s[n][e] = -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // 0 on the first tile; its key 0 is below L, so mx is finite.
      alpha[r] = tpucap::exp2_approx((m[r] - mx[r]) * c);
      m[r] = mx[r];
      mc[r] = mx[r] * c;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tpucap::exp2_approx(fmaf(s[n][e], c, -mc[e / 2]));
        l[e / 2] += p;  // this lane's share of the row sum, of unrounded p
        s[n][e] = p;
        o[n][e] *= alpha[e / 2];
      }

    // O += P V: k-step kk covers keys 16 kk .. 16 kk + 15, i.e. n-tiles
    // 2 kk and 2 kk + 1 of S, which are already P's A fragment. V is B,
    // MN-major; a 16-deep step of keys is 16 rows, 2048 bytes.
    unsigned pf[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    pin(o, pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      Wgmma<64, 1>::run(o, pf[kk], smem_desc(v_t + 2048 * kk), true);
    wgmma_commit_wait<0>();
    pin(o, pf);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / l[r];  // one reciprocal a row, then products
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= L) continue;
    // m is the unscaled max and l sums 2^(s c - m c) = exp(scale (s - m)).
    if (lse != nullptr && t == 0)
      lse[(static_cast<int64_t>(b) * heads + head) * L + row] = m[r] * scale + logf(l[r]);
    bf16* dst = out + ((static_cast<int64_t>(b) * L + row) * heads + head) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int L, int heads, int64_t sb, int64_t sl, int64_t sh, float scale,
               cudaStream_t stream) {
  static bool attr_set = false;  // once, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMma));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((L + kBM - 1) / kBM, heads, B);
  flash_kernel_mma<<<grid, 32 * kWarps, kSmemMma, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, L, heads, sb, sl, sh,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// -- f32: FMAs ----------------------------------------------------------------

using tpucap::Tile;

constexpr int kB = 64;     // queries and keys per tile
constexpr int kWarpsF = 8;
constexpr int kThreads = 32 * kWarpsF;
constexpr int kLdT = kD + 8;  // row stride (floats) of Q, K, V, P
constexpr int kLdF = kB + 4;  // row stride (floats) of S, O
constexpr size_t kSmemF32 = (4 * kB * kLdT + 2 * kB * kLdF + 2 * kB) * sizeof(float);

// 64 rows x 64 columns from global (row stride ld) into shared memory,
// 16 bytes per thread per step; rows at or past L are zero.
__device__ void load_tile(float* dst, const float* src, int row0, int L, int64_t ld) {
  for (int i = threadIdx.x; i < kB * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < L)
      v = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + c);
    *reinterpret_cast<float4*>(dst + r * kLdT + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int L, int heads, int64_t sb, int64_t sl,
                     int64_t sh, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kB * kLdT;
  float* vs = ks + kB * kLdT;
  float* ps = vs + kB * kLdT;
  float* ss = ps + kB * kLdT;
  float* os = ss + kB * kLdF;
  float* m_s = os + kB * kLdF;
  float* l_s = m_s + kB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kB, head = blockIdx.y, b = blockIdx.z;
  const int64_t base = b * sb + head * sh;

  load_tile(qs, q + base, q0, L, sl);
  for (int i = tid; i < kB * kLdF; i += kThreads) os[i] = 0.0f;
  for (int i = tid; i < kB; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }

  for (int k0 = 0; k0 < L; k0 += kB) {
    __syncthreads();  // the previous tile's readers of K, V, P are done
    load_tile(ks, k + base, k0, L, sl);
    load_tile(vs, v + base, k0, L, sl);
    __syncthreads();

    // S = Q K^T: 16 tiles, two per warp.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tt = warp + kWarpsF * j, rt = tt / 4, ct = tt % 4;
      Tile<float, true> t;
      t.zero();
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16)
        t.mma(qs + rt * 16 * kLdT + kk, kLdT, ks + ct * 16 * kLdT + kk, kLdT);
      t.store(ss + rt * 16 * kLdF + ct * 16, kLdF);
    }
    __syncthreads();

    // Online softmax, one row at a time per warp, two columns per lane.
    for (int rr = 0; rr < kB / kWarpsF; ++rr) {
      const int r = warp * (kB / kWarpsF) + rr;
      float s0 = ss[r * kLdF + lane] * scale;
      float s1 = ss[r * kLdF + lane + 32] * scale;
      if (k0 + lane >= L) s0 = -INFINITY;
      if (k0 + lane + 32 >= L) s1 = -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));  // finite: key k0 < L
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m_old - m_new);
      const float sum = warp_sum(p0 + p1);
      ps[r * kLdT + lane] = p0;
      ps[r * kLdT + lane + 32] = p1;
      os[r * kLdF + lane] *= alpha;
      os[r * kLdF + lane + 32] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // O += P V.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tt = warp + kWarpsF * j, rt = tt / 4, ct = tt % 4;
      Tile<float, false> t;
      t.load(os + rt * 16 * kLdF + ct * 16, kLdF);
#pragma unroll
      for (int kk = 0; kk < kB; kk += 16)
        t.mma(ps + rt * 16 * kLdT + kk, kLdT, vs + kk * kLdT + ct * 16, kLdT);
      t.store(os + rt * 16 * kLdF + ct * 16, kLdF);
    }
  }
  __syncthreads();

  for (int i = tid; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    if (q0 + r >= L) continue;
    const int64_t o = ((static_cast<int64_t>(b) * L + q0 + r) * heads + head) * kD + c;
    out[o] = os[r * kLdF + c] / l_s[r];
  }
  if (lse != nullptr)  // m_s holds the scaled max here
    for (int r = tid; r < kB; r += kThreads)
      if (q0 + r < L) lse[(static_cast<int64_t>(b) * heads + head) * L + q0 + r] = m_s[r] + logf(l_s[r]);
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int L, int heads, int64_t sb, int64_t sl, int64_t sh, float scale,
               cudaStream_t stream) {
  static bool attr_set = false;  // once, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemF32));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((L + kB - 1) / kB, heads, B);
  flash_kernel_f32<<<grid, kThreads, kSmemF32, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, L, heads, sb, sl, sh,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (B, L, heads, 64) sharing element strides (sb, sl, sh) with unit
// stride on the last axis, 16-byte aligned rows; out (B, L, heads, 64)
// contiguous; lse (B, heads, L) f32 contiguous, or null.
extern "C" int tpucap_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, void* lse, int B,
                                      int L, int heads, int64_t sb, int64_t sl,
                                      int64_t sh, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpucap::kF32:
      return launch_f32(q, k, v, out, static_cast<float*>(lse), B, L, heads, sb, sl, sh,
                        scale, s);
    case tpucap::kBF16:
      return launch_mma(q, k, v, out, static_cast<float*>(lse), B, L, heads, sb, sl, sh,
                        scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
