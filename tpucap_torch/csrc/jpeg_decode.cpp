// The port's own baseline JPEG decoder (host C++17, no libjpeg), with the
// nearest resize of the PIL convention and a thread pool over images.
//
// Counterpart of tpucap/ops/jpeg/jpeg_decode.cpp, which calls libjpeg-turbo
// (jpeg_read_header, out_color_space = JCS_RGB, default decompression
// parameters). This file gives the same bytes as that call at scale 8/8 by
// doing what libjpeg-turbo 2.1 does on that route:
//
// - markers as jdmarker.c reads them: SOI, APPn / COM / DNL (skipped), DQT
//   (8- and 16-bit tables, latched per component at its first scan), SOF0 /
//   SOF1, DHT, DRI, SOS, RSTn, EOI; garbage between markers skipped;
// - Huffman decode as jdhuff.c does it: receive/extend, DC predictors reset
//   at each restart, the restart marker resync of jpeg_resync_to_restart;
//   past the end of the data (or a marker inside a scan) the bit reader
//   feeds zeros, and once a block has needed such bits the rest of the
//   segment is left as zero coefficients (libjpeg's uniform gray);
// - jpeg_idct_islow (jidctint.c) as libjpeg-turbo's SIMD build computes it
//   (see idct_islow);
// - jdsample.c's upsamplers with do_fancy_upsampling on (no merged
//   upsampler): h2v1_fancy_upsample, h2v2_fancy_upsample with the context
//   rows of jdmainct.c (the first row above the image and the last row
//   below it repeat the edge rows), plain replication where the component's
//   downsampled_width <= 2;
// - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16, ONE_HALF
//   rounding, range limit); gray is replicated to RGB.
//
// libjpeg-turbo's SIMD fancy upsampling and color conversion are bit-exact
// with its C code. Its SIMD islow is too wherever the values stay in 16 bits
// (every valid JPEG); idct_islow follows the SIMD build past that, on corrupt
// data, since that build is the one tpucap loads.
//
// Scope: baseline Huffman JPEG, 8-bit, gray or YCbCr with each chroma
// component at 1x1, 2x1 or 2x2 below the largest sampling factors (4:4:4,
// 4:2:2, 4:2:0), one interleaved scan or several baseline scans. Anything
// else returns its own status code (see Status), never an approximation.
// Scaled decode (libjpeg's scale_num / 8 < 1) is not here: a caller asking
// for fast_scale where tpucap's scale search picks less than 8/8 gets
// kScaleNotPorted.
//
// Memory: an image's samples (its component planes, 1.5 bytes a pixel at
// 4:2:0, 3 at 4:4:4), and the coefficients of one MCU row where one scan
// holds every component (a multi-scan image holds all of them, as libjpeg
// does). A side above 65500 is refused as libjpeg refuses it, and a failed
// allocation becomes the image's status, never an abort.
//
// C ABI (ctypes), shaped like tpucap's: tpucap_decode_jpeg_batch and
// tpucap_jpeg_dims, and tpucap_decode_jpeg_files, which reads the files in
// its worker threads (a Python loader thread reading them would trade the
// GIL with the thread that drives the card, file by file); see
// tpucap_torch/ops/jpeg.py for the binding.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// Per-image status. Must match tpucap_torch/ops/jpeg.py:STATUS.
enum Status {
  kOk = 0,
  kCorrupt = 1,           // malformed data that libjpeg rejects too
  kNotJpeg = 2,           // no SOI marker at the start
  kProcess = 3,           // progressive, arithmetic, lossless, hierarchical
  kPrecision = 4,         // sample precision other than 8 bits
  kColorSpace = 5,        // CMYK, YCCK, RGB-coded, two components
  kSampling = 6,          // sampling factors other than 4:4:4/4:2:2/4:2:0
  kScaleNotPorted = 7,    // fast_scale would decode below 8/8
  kUnreadable = 8,        // the file cannot be opened or read
  kTooBig = 9,            // a side above 65500 (libjpeg's JERR_IMAGE_TOO_BIG)
  kNoMemory = 10,         // the host could not allocate the image's planes
};

// jmorecfg.h JPEG_MAX_DIMENSION.
constexpr int kMaxDimension = 65500;

// Zig-zag index -> natural index, with libjpeg's 16 extra entries of 63 that
// absorb a run past the end of a block in corrupt data (jutils.c).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// jdcolor.c's YCbCr -> RGB tables, built once.

struct Tables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  Tables() {
    const int kScaleBits = 16;
    const int64_t kHalf = int64_t{1} << (kScaleBits - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1L << 16) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const Tables kTables;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2, columns then
// rows) in the arithmetic of libjpeg-turbo's SIMD build of it
// (jidctint-avx2.asm / -sse2.asm), which is what tpucap's libjpeg runs:
// dequantization and the sums in0 +- in4, in7 + in3, in5 + in1 in 16-bit
// lanes, each product pair in 32 bits, pass 1's output saturated to 16
// bits, a block whose AC terms are all zero taken as its DC shifted in 16
// bits, and the output clamped to [0, 255]. On every block whose values stay
// in 16 bits (every valid JPEG's) this is jidctint.c's result to the bit;
// only corrupt data that overflows them tells the two apart.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(x); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}
// 32-bit lane arithmetic (paddd / psubd wrap).
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

#if defined(__SSE2__) && !defined(TPUCAP_JPEG_SCALAR)

// The same in SSE2, as jidctint-sse2.asm lays it out: a register holds one
// row of 8 lanes, products in pmaddwd pairs, pass 1's output saturated by
// packssdw and transposed, pass 2's output saturated to bytes and
// transposed back into rows.
// The whole decode takes 1.5-1.6x as long with the scalar version below
// (scripts/jpeg_idct_builds.py, 500 x 375 photos, on an H100's x86 host).

inline __m128i pair(int32_t a, int32_t b) {
  return _mm_set1_epi32(static_cast<int32_t>((static_cast<uint32_t>(b) << 16) |
                                             (static_cast<uint32_t>(a) & 0xFFFF)));
}

inline void transpose8x16(__m128i (&r)[8]) {
  const __m128i t0 = _mm_unpacklo_epi16(r[0], r[1]), t1 = _mm_unpackhi_epi16(r[0], r[1]);
  const __m128i t2 = _mm_unpacklo_epi16(r[2], r[3]), t3 = _mm_unpackhi_epi16(r[2], r[3]);
  const __m128i t4 = _mm_unpacklo_epi16(r[4], r[5]), t5 = _mm_unpackhi_epi16(r[4], r[5]);
  const __m128i t6 = _mm_unpacklo_epi16(r[6], r[7]), t7 = _mm_unpackhi_epi16(r[6], r[7]);
  const __m128i u0 = _mm_unpacklo_epi32(t0, t2), u1 = _mm_unpackhi_epi32(t0, t2);
  const __m128i u2 = _mm_unpacklo_epi32(t1, t3), u3 = _mm_unpackhi_epi32(t1, t3);
  const __m128i u4 = _mm_unpacklo_epi32(t4, t6), u5 = _mm_unpackhi_epi32(t4, t6);
  const __m128i u6 = _mm_unpacklo_epi32(t5, t7), u7 = _mm_unpackhi_epi32(t5, t7);
  r[0] = _mm_unpacklo_epi64(u0, u4);
  r[1] = _mm_unpackhi_epi64(u0, u4);
  r[2] = _mm_unpacklo_epi64(u1, u5);
  r[3] = _mm_unpackhi_epi64(u1, u5);
  r[4] = _mm_unpacklo_epi64(u2, u6);
  r[5] = _mm_unpackhi_epi64(u2, u6);
  r[6] = _mm_unpacklo_epi64(u3, u7);
  r[7] = _mm_unpackhi_epi64(u3, u7);
}

// One 8-point pass on x[0..7] (one register per index k, 8 lanes), each
// output descaled by n bits and packed to 16 bits with saturation.
template <int n>
inline void idct_pass(__m128i (&x)[8]) {
  const __m128i round = _mm_set1_epi32(1 << (n - 1));
  const __m128i lo26 = _mm_unpacklo_epi16(x[2], x[6]), hi26 = _mm_unpackhi_epi16(x[2], x[6]);
  const __m128i k3 = pair(F0_541 + F0_765, F0_541), k2 = pair(F0_541, F0_541 - F1_847);
  const __m128i tmp3l = _mm_madd_epi16(lo26, k3), tmp3h = _mm_madd_epi16(hi26, k3);
  const __m128i tmp2l = _mm_madd_epi16(lo26, k2), tmp2h = _mm_madd_epi16(hi26, k2);
  const __m128i zero = _mm_setzero_si128();
  const __m128i s04 = _mm_add_epi16(x[0], x[4]), d04 = _mm_sub_epi16(x[0], x[4]);
  const __m128i tmp0l = _mm_srai_epi32(_mm_unpacklo_epi16(zero, s04), 16 - kConstBits);
  const __m128i tmp0h = _mm_srai_epi32(_mm_unpackhi_epi16(zero, s04), 16 - kConstBits);
  const __m128i tmp1l = _mm_srai_epi32(_mm_unpacklo_epi16(zero, d04), 16 - kConstBits);
  const __m128i tmp1h = _mm_srai_epi32(_mm_unpackhi_epi16(zero, d04), 16 - kConstBits);
  const __m128i tmp10l = _mm_add_epi32(tmp0l, tmp3l), tmp10h = _mm_add_epi32(tmp0h, tmp3h);
  const __m128i tmp13l = _mm_sub_epi32(tmp0l, tmp3l), tmp13h = _mm_sub_epi32(tmp0h, tmp3h);
  const __m128i tmp11l = _mm_add_epi32(tmp1l, tmp2l), tmp11h = _mm_add_epi32(tmp1h, tmp2h);
  const __m128i tmp12l = _mm_sub_epi32(tmp1l, tmp2l), tmp12h = _mm_sub_epi32(tmp1h, tmp2h);

  // t0..t3 = x7, x5, x3, x1.
  const __m128i z3 = _mm_add_epi16(x[7], x[3]), z4 = _mm_add_epi16(x[5], x[1]);
  const __m128i lo34 = _mm_unpacklo_epi16(z3, z4), hi34 = _mm_unpackhi_epi16(z3, z4);
  const __m128i kz3 = pair(F1_175 - F1_961, F1_175), kz4 = pair(F1_175, F1_175 - F0_390);
  const __m128i z3l = _mm_madd_epi16(lo34, kz3), z3h = _mm_madd_epi16(hi34, kz3);
  const __m128i z4l = _mm_madd_epi16(lo34, kz4), z4h = _mm_madd_epi16(hi34, kz4);
  const __m128i lo03 = _mm_unpacklo_epi16(x[7], x[1]), hi03 = _mm_unpackhi_epi16(x[7], x[1]);
  const __m128i lo12 = _mm_unpacklo_epi16(x[5], x[3]), hi12 = _mm_unpackhi_epi16(x[5], x[3]);
  const __m128i k0 = pair(F0_298 - F0_899, -F0_899), k03 = pair(-F0_899, F1_501 - F0_899);
  const __m128i k1 = pair(F2_053 - F2_562, -F2_562), k12 = pair(-F2_562, F3_072 - F2_562);
  const __m128i o0l = _mm_add_epi32(_mm_madd_epi16(lo03, k0), z3l);
  const __m128i o0h = _mm_add_epi32(_mm_madd_epi16(hi03, k0), z3h);
  const __m128i o3l = _mm_add_epi32(_mm_madd_epi16(lo03, k03), z4l);
  const __m128i o3h = _mm_add_epi32(_mm_madd_epi16(hi03, k03), z4h);
  const __m128i o1l = _mm_add_epi32(_mm_madd_epi16(lo12, k1), z4l);
  const __m128i o1h = _mm_add_epi32(_mm_madd_epi16(hi12, k1), z4h);
  const __m128i o2l = _mm_add_epi32(_mm_madd_epi16(lo12, k12), z3l);
  const __m128i o2h = _mm_add_epi32(_mm_madd_epi16(hi12, k12), z3h);

  auto out = [&](__m128i l, __m128i h) {
    return _mm_packs_epi32(_mm_srai_epi32(_mm_add_epi32(l, round), n),
                           _mm_srai_epi32(_mm_add_epi32(h, round), n));
  };
  x[0] = out(_mm_add_epi32(tmp10l, o3l), _mm_add_epi32(tmp10h, o3h));
  x[7] = out(_mm_sub_epi32(tmp10l, o3l), _mm_sub_epi32(tmp10h, o3h));
  x[1] = out(_mm_add_epi32(tmp11l, o2l), _mm_add_epi32(tmp11h, o2h));
  x[6] = out(_mm_sub_epi32(tmp11l, o2l), _mm_sub_epi32(tmp11h, o2h));
  x[2] = out(_mm_add_epi32(tmp12l, o1l), _mm_add_epi32(tmp12h, o1h));
  x[5] = out(_mm_sub_epi32(tmp12l, o1l), _mm_sub_epi32(tmp12h, o1h));
  x[3] = out(_mm_add_epi32(tmp13l, o0l), _mm_add_epi32(tmp13h, o0h));
  x[4] = out(_mm_sub_epi32(tmp13l, o0l), _mm_sub_epi32(tmp13h, o0h));
}

void idct_islow(const int16_t* coef, const int16_t* qt, uint8_t* out,
                int stride) {
  __m128i x[8];
  __m128i ac = _mm_setzero_si128();
  for (int r = 1; r < 8; ++r) {
    ac = _mm_or_si128(ac, _mm_loadu_si128(reinterpret_cast<const __m128i*>(coef + 8 * r)));
  }
  const __m128i dc = _mm_mullo_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(coef)),
                                     _mm_loadu_si128(reinterpret_cast<const __m128i*>(qt)));
  if (_mm_movemask_epi8(_mm_cmpeq_epi16(ac, _mm_setzero_si128())) == 0xFFFF) {
    const __m128i v = _mm_slli_epi16(dc, kPass1Bits);
    for (int r = 0; r < 8; ++r) x[r] = v;
  } else {
    x[0] = dc;
    for (int r = 1; r < 8; ++r) {
      x[r] = _mm_mullo_epi16(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(coef + 8 * r)),
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(qt + 8 * r)));
    }
    idct_pass<kConstBits - kPass1Bits>(x);
  }
  transpose8x16(x);
  idct_pass<kConstBits + kPass1Bits + 3>(x);
  transpose8x16(x);
  const __m128i center = _mm_set1_epi8(static_cast<char>(0x80));
  for (int r = 0; r < 8; r += 2) {
    const __m128i b = _mm_add_epi8(_mm_packs_epi16(x[r], x[r + 1]), center);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(out + r * stride), b);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(out + (r + 1) * stride),
                     _mm_unpackhi_epi64(b, b));
  }
}

#else

// One 8-point pass on x[0..7] (16-bit), results before descaling in y[0..7].
inline void idct_1d(const int16_t* x, int32_t* y) {
  const int32_t in0 = x[0], in2 = x[2], in4 = x[4], in6 = x[6];
  const int32_t tmp3 = in2 * (F0_541 + F0_765) + in6 * F0_541;
  const int32_t tmp2 = in2 * F0_541 + in6 * (F0_541 - F1_847);
  const int32_t tmp0 = int32_t{wrap16(in0 + in4)} * (1 << kConstBits);
  const int32_t tmp1 = int32_t{wrap16(in0 - in4)} * (1 << kConstBits);
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);

  const int32_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  const int32_t z3 = wrap16(t0 + t2), z4 = wrap16(t1 + t3);
  const int32_t z3p = z3 * (F1_175 - F1_961) + z4 * F1_175;
  const int32_t z4p = z3 * F1_175 + z4 * (F1_175 - F0_390);
  const int32_t o0 = add32(t0 * (F0_298 - F0_899) + t3 * -F0_899, z3p);
  const int32_t o1 = add32(t1 * (F2_053 - F2_562) + t2 * -F2_562, z4p);
  const int32_t o2 = add32(t1 * -F2_562 + t2 * (F3_072 - F2_562), z3p);
  const int32_t o3 = add32(t0 * -F0_899 + t3 * (F1_501 - F0_899), z4p);

  y[0] = add32(tmp10, o3);
  y[7] = sub32(tmp10, o3);
  y[1] = add32(tmp11, o2);
  y[6] = sub32(tmp11, o2);
  y[2] = add32(tmp12, o1);
  y[5] = sub32(tmp12, o1);
  y[3] = add32(tmp13, o0);
  y[4] = sub32(tmp13, o0);
}

inline int32_t descale(int32_t x, int n) { return add32(x, 1 << (n - 1)) >> n; }

void idct_islow(const int16_t* coef, const int16_t* qt, uint8_t* out,
                int stride) {
  int16_t ws[64];  // rows of the column pass's output
  bool ac_zero = true;
  for (int i = 8; i < 64; ++i) ac_zero &= coef[i] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = wrap16(coef[c] * qt[c]);
      const int16_t v = wrap16(static_cast<uint16_t>(dc) << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t x[8];
      int32_t y[8];
      for (int r = 0; r < 8; ++r) x[r] = wrap16(coef[8 * r + c] * qt[8 * r + c]);
      idct_1d(x, y);
      for (int r = 0; r < 8; ++r) {
        ws[8 * r + c] = sat16(descale(y[r], kConstBits - kPass1Bits));
      }
    }
  }
  for (int r = 0; r < 8; ++r) {
    int32_t y[8];
    idct_1d(ws + 8 * r, y);
    uint8_t* o = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = descale(y[c], kConstBits + kPass1Bits + 3);
      o[c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

#endif  // __SSE2__

// ---------------------------------------------------------------------------
// Huffman tables: the DHT contents, and jpeg_make_d_derived_tbl's decoding
// tables with a 9-bit lookahead.

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

constexpr int kLook = 9;

struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t lookup[1 << kLook];  // (length << 8) | symbol, 0 = longer code
  // For an AC table: where the code and its extra bits fit in the
  // lookahead, (value << 16) | (run << 8) | (bits in all); else 0.
  int32_t fast_ac[1 << kLook];

  // Returns false where libjpeg raises JERR_BAD_HUFF_TABLE.
  bool build(const HuffSpec& s, bool is_dc) {
    int sizes[257];
    int codes[256];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = s.bits[l];
      if (p + n > 256) return false;
      while (n--) sizes[p++] = l;
    }
    sizes[p] = 0;
    const int nsym = p;
    int code = 0, si = sizes[0];
    p = 0;
    while (sizes[p]) {
      while (sizes[p] == si) {
        codes[p++] = code;
        ++code;
      }
      if (code >= (1 << si)) return false;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (s.bits[l]) {
        valoffset[l] = p - codes[p];
        p += s.bits[l];
        maxcode[l] = codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, s.vals, 256);
    std::memset(lookup, 0, sizeof(lookup));
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
      for (int i = 1; i <= s.bits[l]; ++i, ++p) {
        int look = codes[p] << (kLook - l);
        for (int c = 1 << (kLook - l); c > 0; --c) {
          lookup[look++] = static_cast<uint16_t>((l << 8) | s.vals[p]);
        }
      }
    }
    for (int look = 0; look < (1 << kLook); ++look) {
      fast_ac[look] = 0;
      const int l = lookup[look] >> 8, sym = lookup[look] & 0xFF;
      const int size = sym & 15;
      if (is_dc || l == 0 || size == 0 || l + size > kLook) continue;
      const int extra = (look >> (kLook - l - size)) & ((1 << size) - 1);
      const int value = extra < (1 << (size - 1)) ? extra - (1 << size) + 1 : extra;
      fast_ac[look] = static_cast<int32_t>(static_cast<uint32_t>(value) << 16) |
                      ((sym >> 4) << 8) | (l + size);
    }
    if (is_dc) {
      for (int i = 0; i < nsym; ++i) {
        if (s.vals[i] > 15) return false;
      }
    }
    return true;
  }
};

// The tables of the JPEG standard's Annex K.3, which libjpeg-turbo's
// jinit_huff_decoder installs in slots 0 and 1 that no DHT defined
// (jstdhuff.c; Motion-JPEG frames omit them).
const uint8_t kStdDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcLumaVals[] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kStdAcLumaVals[] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcChromaVals[] = {
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kStdAcChromaVals[] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffSpec std_spec(const uint8_t* bits, const uint8_t* vals) {
  HuffSpec s;
  s.defined = true;
  std::memcpy(s.bits, bits, 17);
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  std::memcpy(s.vals, vals, n);
  return s;
}

// ---------------------------------------------------------------------------
// Input: the byte source of jpeg_mem_src (a fake EOI past the end) and the
// entropy decoder's bit buffer of jdhuff.c.

struct Source {
  const uint8_t* p;
  const uint8_t* end;
  int fake = 0;
  int unread_marker = 0;

  int byte() {
    if (p < end) return *p++;
    fake ^= 1;  // jpeg_mem_src inserts FF D9 each time the data runs out
    return fake ? 0xFF : 0xD9;
  }

  // jdmarker.c next_marker: skip to the next marker, past any garbage.
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) {
        unread_marker = c;
        return;
      }
    }
  }
};

struct BitReader {
  Source* src;
  uint64_t buf = 0;
  int n = 0;    // bits held, low end of buf
  int pad = 0;  // of which the lowest `pad` are zeros fed past a marker
  bool insufficient = false;

  void reset() {
    n = 0;
    pad = 0;
  }

  // jpeg_fill_bit_buffer: read bytes up to a marker; past it, zeros.
  void need(int k) {
    if (n >= k) return;
    while (src->unread_marker == 0 && n < 57) {
      int c = src->byte();
      if (c == 0xFF) {
        do c = src->byte(); while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          src->unread_marker = c;
          break;
        }
      }
      buf = (buf << 8) | static_cast<uint64_t>(c);
      n += 8;
    }
    if (n < k) {
      const int add = 57 - n;
      buf <<= add;
      n += add;
      pad += add;
    }
  }
  uint32_t peek(int k) {
    need(k);
    return static_cast<uint32_t>(buf >> (n - k)) & ((1u << k) - 1);
  }
  // libjpeg sets insufficient_data when a bit past the marker is consumed.
  void drop(int k) {
    if (pad) {  // zeros past a marker are held
      if (k > n - pad) insufficient = true;
      n -= k;
      if (pad > n) pad = n;
      return;
    }
    n -= k;  // need(k) left at least k real bits
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = static_cast<int>(peek(k));
    drop(k);
    return v;
  }

  int huff(const HuffTable& t) {
    uint32_t look = peek(kLook);
    uint16_t e = t.lookup[look];
    if (e) {
      drop(e >> 8);
      return e & 0xFF;
    }
    // Longer than the lookahead: jpeg_huff_decode's bit-by-bit search.
    const uint32_t code = peek(16);
    for (int l = kLook + 1; l <= 16; ++l) {
      const int32_t c = static_cast<int32_t>(code >> (16 - l));
      if (c <= t.maxcode[l]) {
        drop(l);
        return t.vals[(c + t.valoffset[l]) & 0xFF];
      }
    }
    need(17);
    drop(17);
    return 0;  // JWRN_HUFF_BAD_CODE: libjpeg fakes a zero
  }
};

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

// ---------------------------------------------------------------------------
// The decoder.

struct Component {
  int id, h, v, tq;
  int dc_tbl, ac_tbl;
  int wib, hib;      // width_in_blocks, height_in_blocks
  int bw, bh;        // coefficient grid, padded to whole MCUs
  int dw, dh;        // downsampled_width / height
  bool latched = false;
  int16_t qt[64];
  // Coefficients: one MCU row's block rows in a single-pass image, else
  // all bh block rows; bw blocks a row.
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // wib * 8 x hib * 8 samples
};

struct Decoder {
  Source src;
  BitReader bits;
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int width = 0, height = 0, max_h = 1, max_v = 1;
  std::vector<Component> comps;
  int scans = 0;
  bool single_pass = false;  // the first scan holds every component

  Decoder(const uint8_t* data, size_t size) {
    src.p = data;
    src.end = data + size;
    bits.src = &src;
  }

  // Two bytes, big-endian, as INPUT_2BYTES reads them.
  int u16() {
    const int hi = src.byte();
    return (hi << 8) | src.byte();
  }

  // skip_input_data of jpeg_mem_src: past the end it consumes fake EOIs.
  void skip(long n) {
    if (n <= 0) return;
    const long have = src.end - src.p;
    if (n <= have) {
      src.p += n;
      return;
    }
    src.p = src.end;
    src.fake ^= static_cast<int>((n - have) & 1);
  }

  int read_dqt() {
    long len = u16() - 2;
    while (len > 0) {
      const int pq = src.byte();
      --len;
      const int prec = pq >> 4, t = pq & 15;
      if (t >= 4) return kCorrupt;  // JERR_DQT_INDEX
      const int need = prec ? 128 : 64;
      // libjpeg reads a shorter table into a smaller zig-zag order and
      // fills the rest with 1s; no encoder writes one.
      if (len < need) return kCorrupt;
      for (int i = 0; i < 64; ++i) {
        const int v = prec ? u16() : src.byte();
        qtables[t][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qdefined[t] = true;
      len -= need;
    }
    return len == 0 ? kOk : kCorrupt;  // JERR_BAD_LENGTH
  }

  int read_dht() {
    long len = u16() - 2;
    while (len > 16) {
      int index = src.byte();
      HuffSpec s;
      s.defined = true;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        s.bits[l] = static_cast<uint8_t>(src.byte());
        count += s.bits[l];
      }
      len -= 1 + 16;
      if (count > 256 || count > len) return kCorrupt;  // JERR_BAD_HUFF_TABLE
      for (int i = 0; i < count; ++i) s.vals[i] = static_cast<uint8_t>(src.byte());
      len -= count;
      const bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index < 0 || index >= 4) return kCorrupt;  // JERR_DHT_INDEX
      (ac ? ac_spec : dc_spec)[index] = s;
    }
    return len == 0 ? kOk : kCorrupt;
  }

  // get_dac: arithmetic conditioning, checked and of no use to a Huffman
  // scan.
  int read_dac() {
    long len = u16() - 2;
    while (len > 0) {
      const int index = src.byte(), val = src.byte();
      len -= 2;
      if (index >= 32) return kCorrupt;
      if (index >= 16 ? (val < 1 || val > 63) : ((val & 15) > (val >> 4))) {
        return kCorrupt;
      }
    }
    return len == 0 ? kOk : kCorrupt;
  }

  int read_sof() {
    const long len = u16() - 8;
    const int precision = src.byte();
    height = u16();
    width = u16();
    const int nc = src.byte();
    if (saw_sof) return kCorrupt;  // JERR_SOF_DUPLICATE
    if (height <= 0 || width <= 0 || nc <= 0) return kCorrupt;
    if (len != nc * 3) return kCorrupt;
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = src.byte();
      const int hv = src.byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = src.byte();
    }
    saw_sof = true;
    // jdinput.c initial_setup, which libjpeg runs at the first SOS.
    if (height > kMaxDimension || width > kMaxDimension) return kTooBig;
    if (precision != 8) return kPrecision;
    if (nc > 10) return kCorrupt;
    for (auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kCorrupt;
    }
    return kOk;
  }

  // get_interesting_appn: JFIF (APP0) and Adobe (APP14) decide the color
  // space; the rest is skipped.
  void read_app(int marker) {
    long len = u16() - 2;
    const int n = len >= 14 ? 14 : (len > 0 ? static_cast<int>(len) : 0);
    uint8_t d[14];
    for (int i = 0; i < n; ++i) d[i] = static_cast<uint8_t>(src.byte());
    if (marker == 0xE0 && n >= 14 && d[0] == 'J' && d[1] == 'F' &&
        d[2] == 'I' && d[3] == 'F' && d[4] == 0) {
      saw_jfif = true;
    }
    if (marker == 0xEE && n >= 12 && d[0] == 'A' && d[1] == 'd' &&
        d[2] == 'o' && d[3] == 'b' && d[4] == 'e') {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    skip(len - n);
  }

  // jdmarker.c read_markers: read up to the next SOS (returns -1 with the
  // scan's components in idx) or EOI (returns -2); else a status.
  int read_markers(int* scan_ncomp, int idx[4]) {
    for (;;) {
      if (src.unread_marker == 0) src.next_marker();
      const int m = src.unread_marker;
      src.unread_marker = 0;
      int rc = kOk;
      if (m == 0xC0 || m == 0xC1) {
        rc = read_sof();
      } else if ((m >= 0xC2 && m <= 0xCB && m != 0xC4) || (m >= 0xCD && m <= 0xCF)) {
        return saw_sof ? kCorrupt : kProcess;  // SOF2-15, JPG
      } else if (m == 0xC4) {
        rc = read_dht();
      } else if (m == 0xCC) {
        rc = read_dac();
      } else if (m == 0xDB) {
        rc = read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) return kCorrupt;
        restart_interval = u16();
      } else if (m == 0xDA) {
        rc = read_sos(scan_ncomp, idx);
        return rc == kOk ? -1 : rc;
      } else if (m == 0xD9) {
        return -2;
      } else if (m == 0xE0 || m == 0xEE) {
        read_app(m);
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        skip(u16() - 2);  // APPn, COM, DNL
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn, TEM: no parameters
      } else {
        return kCorrupt;  // SOI again (JERR_SOI_DUPLICATE), JERR_UNKNOWN_MARKER
      }
      if (rc != kOk) return rc;
    }
  }

  int read_sos(int* ncomp, int idx[4]) {
    if (!saw_sof) return kCorrupt;  // JERR_SOS_NO_SOF
    const int len = u16();
    const int n = src.byte();
    if (len != n * 2 + 6 || n < 1 || n > 4) return kCorrupt;
    const int searchable = std::min(static_cast<int>(comps.size()), 4);
    for (int i = 0; i < n; ++i) {
      const int id = src.byte(), t = src.byte();
      // get_sos: the first of the frame's first four components with this
      // id whose scan slot (indexed by the component's own position, as
      // libjpeg-turbo does) is still empty.
      int found = -1;
      for (int c = 0; c < searchable; ++c) {
        if (comps[c].id == id && c >= i) {
          found = c;
          break;
        }
      }
      if (found < 0) return kCorrupt;  // JERR_BAD_COMPONENT_ID
      idx[i] = found;
      comps[found].dc_tbl = t >> 4;
      comps[found].ac_tbl = t & 15;
    }
    src.byte();  // Ss, Se, Ah/Al: a sequential scan only warns on them
    src.byte();
    src.byte();
    *ncomp = n;
    return kOk;
  }

  // What libjpeg settles at the end of jpeg_read_header and in
  // jinit_upsampler: the color space, the sampling, the component sizes.
  int setup() {
    const int nc = static_cast<int>(comps.size());
    if (nc == 3) {
      bool ycc = true;
      if (saw_jfif) {
        ycc = true;
      } else if (saw_adobe) {
        ycc = adobe_transform != 0;
      } else if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) {
        ycc = false;
      }
      if (!ycc) return kColorSpace;
    } else if (nc != 1) {
      return kColorSpace;
    }
    for (auto& c : comps) {
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    for (auto& c : comps) {
      const int rh = max_h / c.h, rv = max_v / c.v;
      const bool exact = max_h % c.h == 0 && max_v % c.v == 0;
      if (!exact || !((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                      (rh == 2 && rv == 2))) {
        return kSampling;
      }
      c.dw = static_cast<int>((int64_t{width} * c.h + max_h - 1) / max_h);
      c.dh = static_cast<int>((int64_t{height} * c.v + max_v - 1) / max_v);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      const int mcux = (width + 8 * max_h - 1) / (8 * max_h);
      const int mcuy = (height + 8 * max_v - 1) / (8 * max_v);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    return kOk;
  }

  // jdmarker.c read_restart_marker with jpeg_resync_to_restart.
  void read_restart(int* next_restart) {
    if (src.unread_marker == 0) src.next_marker();
    const int desired = *next_restart;
    if (src.unread_marker == 0xD0 + desired) {
      src.unread_marker = 0;
    } else {
      for (;;) {
        const int m = src.unread_marker;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) ||
                   m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) ||
                   m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          src.unread_marker = 0;
          break;
        }
        if (action == 3) break;
        src.next_marker();
      }
    }
    *next_restart = (desired + 1) & 7;
  }

  const HuffSpec& huff_spec(bool ac, int slot) const {
    static const HuffSpec std_dc[2] = {
        std_spec(kStdDcLumaBits, kStdDcLumaVals),
        std_spec(kStdDcChromaBits, kStdDcChromaVals)};
    static const HuffSpec std_ac[2] = {
        std_spec(kStdAcLumaBits, kStdAcLumaVals),
        std_spec(kStdAcChromaBits, kStdAcChromaVals)};
    const HuffSpec& s = (ac ? ac_spec : dc_spec)[slot];
    if (s.defined || slot >= 2) return s;
    return (ac ? std_ac : std_dc)[slot];
  }

  // One scan. In a single-pass image each MCU row goes through the IDCT
  // as soon as it is decoded, as libjpeg's single-pass coefficient
  // controller does, so only that row's coefficients are held.
  int decode_scan(int ncomp, const int idx[4]) {
    HuffTable dct[4], act[4];
    int blocks_in_mcu = 0;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comps[idx[i]];
      if (!c.latched) {
        if (c.tq >= 4 || !qdefined[c.tq]) return kCorrupt;  // JERR_NO_QUANT_TABLE
        for (int k = 0; k < 64; ++k) {
          c.qt[k] = static_cast<int16_t>(qtables[c.tq][k]);
        }
        c.latched = true;
      }
      if (c.dc_tbl >= 4 || c.ac_tbl >= 4) return kCorrupt;
      const HuffSpec& dcs = huff_spec(false, c.dc_tbl);
      const HuffSpec& acs = huff_spec(true, c.ac_tbl);
      if (!dcs.defined || !acs.defined) return kCorrupt;  // JERR_NO_HUFF_TABLE
      if (!dct[i].build(dcs, true)) return kCorrupt;
      if (!act[i].build(acs, false)) return kCorrupt;
      blocks_in_mcu += ncomp == 1 ? 1 : c.h * c.v;
    }
    if (blocks_in_mcu > 10) return kCorrupt;  // JERR_BAD_MCU_SIZE

    int mcus_x, mcus_y;
    if (ncomp == 1) {
      mcus_x = comps[idx[0]].wib;
      mcus_y = comps[idx[0]].hib;
    } else {
      mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
      mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    }
    bits.reset();
    bits.insufficient = false;
    int pred[4] = {0, 0, 0, 0};
    int restarts_to_go = restart_interval;
    int next_restart = 0;

    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            bits.reset();
            read_restart(&next_restart);
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            restarts_to_go = restart_interval;
            if (src.unread_marker == 0) bits.insufficient = false;
          }
        }
        if (!bits.insufficient) {
          for (int i = 0; i < ncomp; ++i) {
            Component& c = comps[idx[i]];
            const int nh = ncomp == 1 ? 1 : c.h, nv = ncomp == 1 ? 1 : c.v;
            for (int by = 0; by < nv; ++by) {
              for (int bx = 0; bx < nh; ++bx) {
                const size_t row =
                    single_pass ? by : static_cast<size_t>(my) * nv + by;
                const size_t col = static_cast<size_t>(mx) * nh + bx;
                int16_t* blk = c.coef.data() + (row * c.bw + col) * 64;
                int rc = decode_block(blk, dct[i], act[i], &pred[i]);
                if (rc != kOk) return rc;
              }
            }
          }
        }
        if (restart_interval) --restarts_to_go;
      }
      if (single_pass) {
        for (int i = 0; i < ncomp; ++i) {
          Component& c = comps[idx[i]];
          const int nv = ncomp == 1 ? 1 : c.v;
          idct_rows(c, my * nv, nv);
          std::fill(c.coef.begin(), c.coef.end(), int16_t{0});
        }
      }
    }
    return kOk;
  }

  int decode_block(int16_t* blk, const HuffTable& dc, const HuffTable& ac,
                   int* pred) {
    int s = bits.huff(dc);
    if (s) s = extend(bits.get(s), s);
    if ((*pred >= 0 && s > INT_MAX - *pred) ||
        (*pred < 0 && s < INT_MIN - *pred)) {
      return kCorrupt;  // JERR_BAD_DCT_COEF
    }
    *pred += s;
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      const int32_t fast = ac.fast_ac[bits.peek(kLook)];
      if (fast) {  // code, run and value in one lookup
        bits.drop(fast & 0xFF);
        k += (fast >> 8) & 0xFF;
        blk[kNatural[k]] = static_cast<int16_t>(fast >> 16);
        continue;
      }
      s = bits.huff(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return kOk;
  }

  // Header: SOI, then markers up to the first SOS.
  int read_header(int* ncomp, int idx[4]) {
    if (src.end - src.p < 2 || src.p[0] != 0xFF || src.p[1] != 0xD8) {
      return kNotJpeg;
    }
    src.p += 2;
    int rc = read_markers(ncomp, idx);
    if (rc == -2) return kCorrupt;  // EOI before any image (JERR_NO_IMAGE)
    if (rc != -1) return rc;
    if (!saw_sof) return kCorrupt;
    return setup();
  }

  // Every scan up to EOI (or the data's end, where libjpeg's source feeds
  // a fake EOI), then the IDCT of what no scan put through it yet; the
  // samples are in each component's plane.
  int decode_scans(int ncomp, int idx[4]) {
    single_pass = ncomp == static_cast<int>(comps.size());
    for (auto& c : comps) {
      c.plane.assign(static_cast<size_t>(c.wib) * 8 * c.hib * 8, 0);
      const int rows = !single_pass ? c.bh : (ncomp == 1 ? 1 : c.v);
      c.coef.assign(static_cast<size_t>(c.bw) * rows * 64, 0);
    }
    for (;;) {
      if (scans > 0 && single_pass) {
        return kCorrupt;  // JERR_EOI_EXPECTED: libjpeg ends a one-pass image
      }
      int rc = decode_scan(ncomp, idx);
      if (rc != kOk) return rc;
      ++scans;
      rc = read_markers(&ncomp, idx);
      if (rc == -2) break;
      if (rc != -1) return rc;
    }
    for (auto& c : comps) {
      if (!single_pass) {
        if (!c.latched) {
          // Never scanned: libjpeg leaves its coefficients zero, and its
          // quant table is latched at output time with the zeros it scales.
          for (int k = 0; k < 64; ++k) c.qt[k] = 0;
        }
        idct_rows(c, 0, c.hib);
      }
      std::vector<int16_t>().swap(c.coef);
    }
    return kOk;
  }

  // The IDCT of c's block rows from `first`, n of them (those inside the
  // image), read from c.coef's block rows from 0.
  void idct_rows(Component& c, int first, int n) {
    const size_t stride = static_cast<size_t>(c.wib) * 8;
    for (int r = 0; r < n && first + r < c.hib; ++r) {
      uint8_t* dst = c.plane.data() + static_cast<size_t>(first + r) * 8 * stride;
      const int16_t* src = c.coef.data() + static_cast<size_t>(r) * c.bw * 64;
      for (int bx = 0; bx < c.wib; ++bx) {
        idct_islow(src + bx * 64, c.qt, dst + bx * 8, static_cast<int>(stride));
      }
    }
  }

  // How component c's samples reach image columns xs: jdsample.c's fancy
  // upsampling reads sample i and its neighbor nb with a rounding bias,
  // and at the edges the same formula holds with nb clamped to the edge
  // sample (h2v1: in[0], then (3 in[i] + in[i -+ 1] + 1 or 2) >> 2; h2v2:
  // (3 cs[i] + cs[i -+ 1] + 8 or 7) >> 4 on column sums cs of 3 rows).
  struct Columns {
    int kind;  // 0 full size, 1 h2v1, 2 h2v2, 3 replicated
    std::vector<int> i, nb, bias;
  };

  Columns columns(const Component& c, const std::vector<int>& xs) const {
    Columns m;
    const int rh = max_h / c.h, rv = max_v / c.v;
    m.kind = rh == 1 ? 0 : (c.dw <= 2 ? 3 : (rv == 1 ? 1 : 2));
    for (int x : xs) {
      if (m.kind == 0) {
        m.i.push_back(x);
        continue;
      }
      const int i = x >> 1;
      const bool odd = x & 1;
      m.i.push_back(i);
      m.nb.push_back(odd ? std::min(i + 1, c.dw - 1) : std::max(i - 1, 0));
      m.bias.push_back(m.kind == 1 ? (odd ? 2 : 1) : (odd ? 7 : 8));
    }
    return m;
  }

  // Component c's upsampled samples on image row y at the mapped columns.
  void component_row(const Component& c, const Columns& m, int y,
                     uint8_t* dst) const {
    const size_t stride = static_cast<size_t>(c.wib) * 8;
    const int n = static_cast<int>(m.i.size());
    const int rv = max_v / c.v;
    const uint8_t* in0 = c.plane.data() + static_cast<size_t>(y / rv) * stride;
    if (m.kind == 0 || m.kind == 3) {
      for (int j = 0; j < n; ++j) dst[j] = in0[m.i[j]];
    } else if (m.kind == 1) {
      for (int j = 0; j < n; ++j) {
        dst[j] = static_cast<uint8_t>((in0[m.i[j]] * 3 + in0[m.nb[j]] + m.bias[j]) >> 2);
      }
    } else {
      // h2v2: the row above for an even output row, below for an odd one,
      // the edge rows repeated (jdmainct.c's context rows).
      const int r = y / 2;
      const int r1 = std::min(std::max((y & 1) ? r + 1 : r - 1, 0), c.dh - 1);
      const uint8_t* in1 = c.plane.data() + static_cast<size_t>(r1) * stride;
      for (int j = 0; j < n; ++j) {
        const int cs = in0[m.i[j]] * 3 + in1[m.i[j]];
        const int cn = in0[m.nb[j]] * 3 + in1[m.nb[j]];
        dst[j] = static_cast<uint8_t>((cs * 3 + cn + m.bias[j]) >> 4);
      }
    }
  }

  // Image row y at the mapped columns as RGB (3 bytes a column); tmp holds
  // three rows of samples.
  void rgb_row(int y, const Columns* m, uint8_t* out, uint8_t* tmp) const {
    const int n = static_cast<int>(m[0].i.size());
    if (comps.size() == 1) {
      component_row(comps[0], m[0], y, tmp);
      for (int j = 0; j < n; ++j) out[3 * j] = out[3 * j + 1] = out[3 * j + 2] = tmp[j];
      return;
    }
    uint8_t* yr = tmp;
    uint8_t* cb = tmp + n;
    uint8_t* cr = tmp + 2 * n;
    component_row(comps[0], m[0], y, yr);
    component_row(comps[1], m[1], y, cb);
    component_row(comps[2], m[2], y, cr);
    const Tables& t = kTables;
    for (int j = 0; j < n; ++j) {
      const int Y = yr[j], B = cb[j], R = cr[j];
      out[3 * j] = clamp255(Y + t.cr_r[R]);
      out[3 * j + 1] = clamp255(Y + static_cast<int>((t.cb_g[B] + t.cr_g[R]) >> 16));
      out[3 * j + 2] = clamp255(Y + t.cb_b[B]);
    }
  }
};

// Nearest-neighbor index with the PIL center convention (as tpucap).
inline int nearest_index(int dst, int dst_size, int src_size) {
  double scale = static_cast<double>(src_size) / dst_size;
  int idx = static_cast<int>((dst + 0.5) * scale);
  return std::min(idx, src_size - 1);
}

// tpucap's scale search: the smallest num / 8 whose output covers the
// target.
int scale_num(int h, int w, int target_h, int target_w) {
  int num;
  for (num = 1; num <= 8; ++num) {
    if (static_cast<long>(h) * num / 8 >= target_h &&
        static_cast<long>(w) * num / 8 >= target_w) {
      break;
    }
  }
  return num > 8 ? 8 : num;
}

int decode_one(const uint8_t* data, size_t size, int target_h, int target_w,
               uint8_t* out, int fast_scale) {
  Decoder d(data, size);
  int ncomp = 0, idx[4] = {0, 0, 0, 0};
  int rc = d.read_header(&ncomp, idx);
  if (rc != kOk) return rc;
  if (fast_scale && target_h > 0 && target_w > 0 &&
      scale_num(d.height, d.width, target_h, target_w) != 8) {
    return kScaleNotPorted;
  }
  rc = d.decode_scans(ncomp, idx);
  if (rc != kOk) return rc;

  // Without a resize every row and column; with one (the nearest, PIL
  // convention), only the rows and columns it samples.
  const int sw = d.width, sh = d.height;
  const bool same = target_h <= 0 || target_w <= 0 ||
                    (sh == target_h && sw == target_w);
  const int th = same ? sh : target_h, tw = same ? sw : target_w;
  std::vector<int> xs(tw);
  for (int j = 0; j < tw; ++j) xs[j] = same ? j : nearest_index(j, tw, sw);
  std::vector<Decoder::Columns> maps;
  for (const auto& c : d.comps) maps.push_back(d.columns(c, xs));
  std::vector<uint8_t> tmp(3 * static_cast<size_t>(tw));
  const size_t row_bytes = static_cast<size_t>(tw) * 3;
  int have = -1;
  for (int i = 0; i < th; ++i) {
    const int sy = same ? i : nearest_index(i, th, sh);
    uint8_t* drow = out + static_cast<size_t>(i) * row_bytes;
    if (sy == have) {
      std::memcpy(drow, drow - row_bytes, row_bytes);
    } else {
      d.rgb_row(sy, maps.data(), drow, tmp.data());
      have = sy;
    }
  }
  return kOk;
}

// Runs fn(i) for i in [0, n) on up to n_threads workers (0 = hardware
// concurrency); fn returns a status. Returns the number of failures.
template <typename Fn>
int run_pool(int n, int n_threads, int* status, Fn fn) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min(n_threads, n);
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int rc;
      try {
        rc = fn(i);
      } catch (const std::exception&) {
        rc = kNoMemory;  // only an allocation throws here (std::bad_alloc)
      }
      status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return false;
  long n = -1;
  if (std::fseek(f, 0, SEEK_END) == 0) n = std::ftell(f);
  bool ok = n >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(static_cast<size_t>(n));
    ok = std::fread(buf->data(), 1, buf->size(), f) == buf->size();
  }
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Decode n JPEGs (concatenated in `data` at `offsets[i]`, length
// `sizes[i]`) into `out` (n * target_h * target_w * 3 uint8, NHWC RGB; a
// target of 0 x 0 keeps one image at its own size). `status[i]` receives 0
// on success, else a Status code. Uses up to `n_threads` workers (0 =
// hardware concurrency). Returns the number of failed images.
int tpucap_decode_jpeg_batch(const uint8_t* data, const int64_t* offsets,
                             const int64_t* sizes, int n, int target_h,
                             int target_w, uint8_t* out, int* status,
                             int n_threads, int fast_scale) {
  const size_t img_bytes = static_cast<size_t>(target_h) * target_w * 3;
  return run_pool(n, n_threads, status, [&](int i) {
    return decode_one(data + offsets[i], static_cast<size_t>(sizes[i]),
                      target_h, target_w, out + img_bytes * i, fast_scale);
  });
}

// The same from n files, each read by the worker that decodes it.
int tpucap_decode_jpeg_files(const char* const* paths, int n, int target_h,
                             int target_w, uint8_t* out, int* status,
                             int n_threads, int fast_scale) {
  const size_t img_bytes = static_cast<size_t>(target_h) * target_w * 3;
  return run_pool(n, n_threads, status, [&](int i) {
    std::vector<uint8_t> buf;
    if (!read_file(paths[i], &buf)) return static_cast<int>(kUnreadable);
    return decode_one(buf.data(), buf.size(), target_h, target_w,
                      out + img_bytes * i, fast_scale);
  });
}

// A JPEG's dimensions, from its header up to the first scan. Returns 0 on
// success, else a Status code.
int tpucap_jpeg_dims(const uint8_t* data, int64_t size, int* h, int* w) {
  Decoder d(data, static_cast<size_t>(size));
  int ncomp = 0, idx[4] = {0, 0, 0, 0};
  int rc = d.read_header(&ncomp, idx);
  if (rc != kOk) return rc;
  *h = d.height;
  *w = d.width;
  return 0;
}

}  // extern "C"
