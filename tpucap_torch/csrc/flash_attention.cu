// Kernel K5: softmax attention of a ViT token grid,
//   ctx[b, l, h] = softmax(scale * q[b, l, h] . k[b, :, h]) @ v[b, :, h]
// over all L tokens (no causal mask), head width 64.
//
// Replaces the stock TPU flash attention that
// tpucap/models/encoders/vit.py:_flash_ctx calls (its forward pallas_call,
// jax/experimental/pallas/ops/tpu/flash_attention.py), and keeps its
// numerics: s = q k^T accumulated in f32, then s *= scale; a running max
// and sum in f32; p = exp(s - m) cast to v's dtype for p @ v, accumulated
// in f32; normalised by the sum; cast to q's dtype. On the TPU the 196
// tokens are padded to 256 and the pad fenced off by segment ids; here the
// keys at index >= L are masked inside the kernel and nothing is padded.
//
// Bound on an H100 (ViT-B/16, batch 256, 12 heads, bf16): 231 MB of
// q, k, v read and 77 MB of ctx written take 0.092 ms at 3.35 TB/s against
// 30.2 GFLOP (0.031 ms at 989 TFLOP/s): bound by bytes.
//
// Design: one block per (64-query tile, head, image); a loop over 64-key
// tiles with an online softmax, the last tile ragged (196 = 3 * 64 + 4).
// q, k and v are read with strides straight from the (B, L, 3H) output of
// the qkv projection (the split, transpose and pad copies of the TPU path
// are gone) and ctx is written (B, L, heads, 64). Q, K, V, the scores S,
// the probabilities P and the f32 output accumulator O live in shared
// memory; S = Q K^T and O += P V are warp-level 16x16 tiles (tile.cuh):
// bf16 tensor cores with f32 accumulators for bf16, f32 FMAs for f32. Each
// warp owns 8 rows for the softmax update. The simple version: no
// pipelining of the K/V loads, no warp specialisation.
#include <math.h>

#include "tile.cuh"

namespace {

using tpucap::Tile;

constexpr int kD = 64;     // head width
constexpr int kB = 64;     // queries and keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdT = kD + 8;  // row stride (elements) of Q, K, V, P
constexpr int kLdF = kB + 4;  // row stride (floats) of S, O

template <typename T>
constexpr size_t smem_bytes() {
  return 4 * kB * kLdT * sizeof(T) + 2 * kB * kLdF * sizeof(float) + 2 * kB * sizeof(float);
}

// 64 rows x 64 columns from global (row stride ld) into shared memory,
// 16 bytes per thread per step; rows at or past L are zero.
template <typename T>
__device__ void load_tile(T* dst, const T* src, int row0, int L, int64_t ld) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < kB * (kD / kVec); i += kThreads) {
    const int r = i / (kD / kVec), c = (i % (kD / kVec)) * kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < L)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = v;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int L, int heads,
                 int64_t sb, int64_t sl, int64_t sh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kB * kLdT;
  T* vs = ks + kB * kLdT;
  T* ps = vs + kB * kLdT;
  float* ss = reinterpret_cast<float*>(ps + kB * kLdT);
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
      const int tt = warp + kWarps * j, rt = tt / 4, ct = tt % 4;
      Tile<T, true> t;
      t.zero();
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16)
        t.mma(qs + rt * 16 * kLdT + kk, kLdT, ks + ct * 16 * kLdT + kk, kLdT);
      t.store(ss + rt * 16 * kLdF + ct * 16, kLdF);
    }
    __syncthreads();

    // Online softmax, one row at a time per warp, two columns per lane.
    for (int rr = 0; rr < kB / kWarps; ++rr) {
      const int r = warp * (kB / kWarps) + rr;
      float s0 = ss[r * kLdF + lane] * scale;
      float s1 = ss[r * kLdF + lane + 32] * scale;
      if (k0 + lane >= L) s0 = -INFINITY;
      if (k0 + lane + 32 >= L) s1 = -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));  // finite: key k0 < L
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m_old - m_new);
      const float sum = warp_sum(p0 + p1);
      ps[r * kLdT + lane] = tpucap::from_f32<T>(p0);
      ps[r * kLdT + lane + 32] = tpucap::from_f32<T>(p1);
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
      const int tt = warp + kWarps * j, rt = tt / 4, ct = tt % 4;
      Tile<T, false> t;
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
    out[o] = tpucap::from_f32<T>(os[r * kLdF + c] / l_s[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int L, int heads, int64_t sb, int64_t sl, int64_t sh, float scale,
           cudaStream_t stream) {
  if (B < 1 || B > 65535 || heads < 1 || heads > 65535 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // once per dtype, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((L + kB - 1) / kB, heads, B);
  flash_kernel<T><<<grid, kThreads, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), L, heads, sb, sl, sh,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (B, L, heads, 64) sharing element strides (sb, sl, sh) with unit
// stride on the last axis, 16-byte aligned rows; out (B, L, heads, 64)
// contiguous.
extern "C" int tpucap_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int L,
                                      int heads, int64_t sb, int64_t sl,
                                      int64_t sh, float scale, int dtype,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpucap::kF32:
      return launch<float>(q, k, v, out, B, L, heads, sb, sl, sh, scale, s);
    case tpucap::kBF16:
      return launch<__nv_bfloat16>(q, k, v, out, B, L, heads, sb, sl, sh,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
