// The port's own JPEG decoder (host C++17, no libjpeg), with the nearest
// resize of the PIL convention and a thread pool over images.
//
// Counterpart of tpucap/ops/jpeg/jpeg_decode.cpp, which calls libjpeg-turbo
// (jpeg_read_header, out_color_space = JCS_RGB, default decompression
// parameters, scale_num / 8 from its scale search). This file gives the
// same bytes as that call at every scale by doing what libjpeg-turbo 2.1
// does on that route:
//
// - markers as jdmarker.c reads them: SOI, APPn / COM / DNL (skipped), DQT
//   (8- and 16-bit tables, latched per component at its first scan),
//   SOF0 / SOF1 / SOF2 / SOF9 / SOF10, DHT, DAC, DRI, SOS, RSTn, EOI;
//   garbage between markers skipped;
// - Huffman decode as jdhuff.c does it: its bit reader byte for byte, its
//   fast path beside the slow one where libjpeg-turbo takes it (see
//   FastBits), receive/extend, DC predictors reset at each restart, the
//   restart marker resync of jpeg_resync_to_restart; past the end of the
//   data (or a marker inside a scan) the bit reader feeds zeros, and once
//   a block has needed such bits the rest of the segment is left as zero
//   coefficients (libjpeg's uniform gray);
// - progressive decode as jdphuff.c does it: DC first and refine, AC first
//   with EOB runs and AC refine with correction bits, the scan checks of
//   start_pass_phuff_decoder; past the end of the data the rest of a
//   segment keeps what earlier scans left; then jdcoefct.c's block
//   smoothing where low coefficients are left inexact (a file cut between
//   scans);
// - arithmetic decode (SOF9 sequential, SOF10 progressive) as jdarith.c
//   does it: the coder of T.81 Annex D with jaricom.c's Qe table, the
//   statistics bins zeroed at each scan and each restart, DAC's
//   conditioning (L, U, Kx); a marker inside the data is legal and zeros
//   are fed after it; a bad code leaves the rest of the scan (up to the
//   next restart) as earlier scans left it;
// - jpeg_calc_output_dimensions at scale n / 8: luma IDCT'd to n x n a
//   block, a subsampled component to 2n (or 4n) while its ratios allow, so
//   4:2:0 chroma below 8/8 needs no upsampling; the IDCT of each size as
//   jddctmgr.c picks it (see idct_for), jpeg_idct_islow at 8 as
//   libjpeg-turbo's SIMD build computes it (see idct_islow);
// - jdsample.c's upsamplers with do_fancy_upsampling on (no merged
//   upsampler): h2v1, h1v2 and h2v2_fancy_upsample with the context rows of
//   jdmainct.c (the first row above the image and the last row below it
//   repeat the edge rows), replication (int_upsample) for other integral
//   ratios, where downsampled_width <= 2, and at 1/8;
// - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16, ONE_HALF
//   rounding, range limit); RGB-coded samples copied; gray replicated;
// - with kLoadImage (the bytes of tpucap's load_image, which calls PIL):
//   CMYK and YCCK files out as JCS_CMYK (ycck_cmyk_convert for YCCK), then
//   what Pillow does with them: the inverted raw mode CMYK;I and its
//   integer CMYK -> RGB conversion (cmyk2rgb); Pillow's NEAREST resize
//   (see pil_nearest); and PIL's refusal of a file whose data ends before
//   its last row is out (kTruncated).

// libjpeg-turbo's SIMD fancy upsampling and color conversion are bit-exact
// with its C code. Its SIMD IDCTs are too wherever the values stay in 16
// bits (every valid JPEG); the IDCTs here follow the SIMD build past that,
// on corrupt data, since that build is the one tpucap loads.
//
// Scope: Huffman or arithmetic JPEG, sequential or progressive, 8-bit,
// gray, YCbCr or RGB (and CMYK / YCCK with kLoadImage), any sampling factors
// with integral ratios. Anything else returns its own status code (see
// Status), never an approximation: 12-bit, lossless and hierarchical JPEGs,
// and CMYK / YCCK out as RGB, libjpeg-turbo 2.1 refuses too.
//
// Memory: an image's samples (its component planes, 1.5 bytes a pixel at
// 4:2:0, 3 at 4:4:4, less below 8/8), and the coefficients of one MCU row
// where one scan holds every component (a multi-scan or progressive image
// holds all of them, as libjpeg does). A side above 65500 is refused as
// libjpeg refuses it, and a failed allocation becomes the image's status,
// never an abort.
//
// C ABI (ctypes), shaped like tpucap's: tpucap_decode_jpeg_batch and
// tpucap_jpeg_dims, and tpucap_decode_jpeg_files, which reads the files in
// its worker threads (a Python loader thread reading them would trade the
// GIL with the thread that drives the card, file by file); see
// tpucap_torch/ops/jpeg.py for the binding. tpucap_jpeg_idct runs the IDCT
// of one DCT size on given blocks, for tests against libjpeg's own.

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
  kNotJpeg = 2,           // no SOI marker at the start (kLoadImage: no FF D8 FF)
  kProcess = 3,           // lossless, hierarchical
  kPrecision = 4,         // sample precision other than 8 bits
  kColorSpace = 5,        // two components; CMYK, YCCK without kLoadImage
  kSampling = 6,          // no integral upsampling ratio
  kUnreadable = 8,        // the file cannot be opened or read
  kTooBig = 9,            // a side above 65500 (libjpeg's JERR_IMAGE_TOO_BIG)
  kNoMemory = 10,         // the host could not allocate the image's planes
  kTruncated = 11,        // kLoadImage: data past the end (PIL's OSError)
};

// jmorecfg.h JPEG_MAX_DIMENSION.
constexpr int kMaxDimension = 65500;

// The flags of the C entry points.
constexpr int kFastScale = 1;  // tpucap's scale search (fast_scale=True)
constexpr int kLoadImage = 2;  // load_image's bytes: PIL's CMYK and resize

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
// The scaled IDCTs that jddctmgr.c selects for a component whose
// DCT_scaled_size is not 8: 8 x 8 coefficients in, N x N samples out.
//
// - 1: jpeg_idct_1x1 (jidctred.c), the DC alone.
// - 2, 4: jidctred.c's 2x2 and 4x4 as libjpeg-turbo's SSE2 build computes
//   them (jidctred-sse2.asm, selected on every x86-64 host because
//   ISLOW_MULT_TYPE is short there): dequantization in 16-bit lanes, each
//   product pair in 32 bits, the output saturated to bytes.
// - 3, 5, 6, 7, 10, 12, 14: jidctint.c's jpeg_idct_NxN, plain C in every
//   build: 64-bit JLONG arithmetic, an int workspace between the passes,
//   the output through the range-limit table, which wraps.
//
// On valid data the SSE2 and C forms of 2x2 and 4x4 agree; on corrupt,
// high-energy blocks they part, and tpucap's libjpeg runs the SSE2 one.

constexpr int64_t fix(double x) {
  return static_cast<int64_t>(x * (1 << kConstBits) + 0.5);
}

// IDCT_range_limit(cinfo)[x & RANGE_MASK]: a 10-bit wrap, then the clamp.
inline uint8_t range_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  return static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
}

// DEQUANTIZE with ISLOW_MULT_TYPE short: int16 times int16, in int.
inline int64_t deq(const int16_t* coef, const int16_t* qt, int i) {
  return int64_t{coef[i]} * qt[i];
}

// The (int) cast of a JLONG, into the workspace or of a quotient.
inline int64_t to_int(int64_t x) { return static_cast<int32_t>(static_cast<uint32_t>(x)); }

void idct_1x1(const int16_t* coef, const int16_t* qt, uint8_t* out, int) {
  const int32_t dc = static_cast<int32_t>(deq(coef, qt, 0));
  out[0] = range_limit(add32(dc, 4) >> 3);
}

// jsimd_idct_4x4_sse2.
void idct_4x4(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  int16_t ws[4][8];  // pass 1's rows 0-3, saturated to 16 bits
  auto q = [&](int r, int c) { return wrap16(coef[8 * r + c] * qt[8 * r + c]); };
  bool ac_zero = true;
  for (int r : {1, 2, 3, 5, 6, 7}) {
    for (int c = 0; c < 8; ++c) ac_zero &= coef[8 * r + c] == 0;
  }
  constexpr int32_t F184 = 15137, F076 = 6270, F256 = 20995, F089 = 7373,
                    F106 = 8697, F217 = 17799, F060 = 4926, F050 = 4176,
                    F145 = 11893, F021 = 1730;
  // One 8 -> 4 pass on x[0..7] (x[4] unused), descaled by n bits.
  auto pass = [](const int32_t* x, int n, int32_t* y) {
    const int32_t tmp0 = x[0] * (1 << (kConstBits + 1));
    const int32_t tmp2e = add32(x[2] * F184, x[6] * -F076);
    const int32_t tmp10 = add32(tmp0, tmp2e), tmp12 = sub32(tmp0, tmp2e);
    const int32_t odd0 = add32(add32(x[1] * F106, x[3] * -F217),
                               add32(x[5] * F145, x[7] * -F021));
    const int32_t odd2 = add32(add32(x[1] * F256, x[3] * F089),
                               add32(x[5] * -F060, x[7] * -F050));
    const int32_t r = 1 << (n - 1);
    y[0] = add32(add32(tmp10, odd2), r) >> n;
    y[3] = add32(sub32(tmp10, odd2), r) >> n;
    y[1] = add32(add32(tmp12, odd0), r) >> n;
    y[2] = add32(sub32(tmp12, odd0), r) >> n;
  };
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {
      const int16_t v = wrap16(static_cast<uint16_t>(q(0, c)) << kPass1Bits);
      for (int r = 0; r < 4; ++r) ws[r][c] = v;
      continue;
    }
    int32_t x[8], y[4];
    for (int r = 0; r < 8; ++r) x[r] = q(r, c);
    pass(x, kConstBits - kPass1Bits + 1, y);
    for (int r = 0; r < 4; ++r) ws[r][c] = sat16(y[r]);
  }
  for (int r = 0; r < 4; ++r) {
    int32_t x[8], y[4];
    for (int c = 0; c < 8; ++c) x[c] = ws[r][c];
    pass(x, kConstBits + kPass1Bits + 3 + 1, y);
    for (int c = 0; c < 4; ++c) {
      const int32_t v = sat16(y[c]);
      out[r * stride + c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// jsimd_idct_2x2_sse2: pass 1's DC column stays in 32 bits; its odd
// columns are saturated to 16 bits before pass 2's products.
void idct_2x2(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  constexpr int32_t F362 = 29692, F127 = 10426, F085 = 6967, F072 = 5906;
  auto q = [&](int r, int c) -> int32_t { return wrap16(coef[8 * r + c] * qt[8 * r + c]); };
  auto odd = [](int32_t x1, int32_t x3, int32_t x5, int32_t x7) {
    return add32(add32(x1 * F362, x3 * -F127), add32(x5 * F085, x7 * -F072));
  };
  constexpr int n1 = kConstBits - kPass1Bits + 2, n2 = kConstBits + kPass1Bits + 3 + 2;
  int32_t a[8], b[8];  // pass 1's two rows, columns 0, 1, 3, 5, 7
  for (int c : {0, 1, 3, 5, 7}) {
    const int32_t tmp10 = q(0, c) * (1 << (kConstBits + 2));
    const int32_t tmp0 = odd(q(1, c), q(3, c), q(5, c), q(7, c));
    a[c] = add32(add32(tmp10, tmp0), 1 << (n1 - 1)) >> n1;
    b[c] = add32(sub32(tmp10, tmp0), 1 << (n1 - 1)) >> n1;
  }
  for (int r = 0; r < 2; ++r) {
    const int32_t* x = r ? b : a;
    const int32_t tmp10 = static_cast<int32_t>(static_cast<uint32_t>(x[0]) << (kConstBits + 2));
    const int32_t tmp0 = odd(sat16(x[1]), sat16(x[3]), sat16(x[5]), sat16(x[7]));
    const int32_t v0 = sat16(add32(add32(tmp10, tmp0), 1 << (n2 - 1)) >> n2);
    const int32_t v1 = sat16(add32(sub32(tmp10, tmp0), 1 << (n2 - 1)) >> n2);
    out[r * stride] = static_cast<uint8_t>((v0 < -128 ? -128 : (v0 > 127 ? 127 : v0)) + 128);
    out[r * stride + 1] = static_cast<uint8_t>((v1 < -128 ? -128 : (v1 > 127 ? 127 : v1)) + 128);
  }
}

// jidctint.c's scaled IDCTs share this frame: pass 1 over the input's
// columns (N of them, 8 for N > 8) into an int workspace of N rows, pass 2
// over those rows. Each kernel takes the 1-D inputs (x[0..7], zero where
// the pass has fewer), the rounding term added to x[0] << CONST_BITS and
// which pass it is, and returns N outputs (pass 1's descaled, pass 2's
// before the final shift).
template <int N, typename Kernel>
void idct_scaled(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride,
                 Kernel kernel) {
  constexpr int cols = N > 8 ? 8 : N;
  int64_t ws[N][8] = {};
  for (int c = 0; c < cols; ++c) {
    int64_t x[8];
    for (int r = 0; r < 8; ++r) x[r] = deq(coef + c, qt + c, 8 * r);
    int64_t y[N];
    kernel(x, int64_t{1} << (kConstBits - kPass1Bits - 1), true, y);
    for (int r = 0; r < N; ++r) ws[r][c] = to_int(y[r]);
  }
  for (int r = 0; r < N; ++r) {
    int64_t x[8] = {};
    for (int c = 0; c < cols; ++c) x[c] = ws[r][c];
    int64_t y[N];
    kernel(x, int64_t{1} << (kPass1Bits + 2 + kConstBits), false, y);
    for (int c = 0; c < N; ++c) out[r * stride + c] = range_limit(y[c] >> (kConstBits + kPass1Bits + 3));
  }
}

// In pass 1, jidctint.c right-shifts every output by CONST_BITS -
// PASS1_BITS, except the few it builds already shifted.
#define IDCT_OUT(i, v, shifted_in_pass1)                                      \
  y[i] = pass1 ? ((shifted_in_pass1) ? (v) : (v) >> (kConstBits - kPass1Bits)) \
               : (v)

void idct_3x3(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<3>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    const int64_t tmp0 = x[0] * (int64_t{1} << kConstBits) + fudge;
    const int64_t tmp12 = x[2] * fix(0.707106781);
    const int64_t tmp10 = tmp0 + tmp12;
    const int64_t tmp2 = tmp0 - tmp12 - tmp12;
    const int64_t odd = x[1] * fix(1.224744871);
    IDCT_OUT(0, tmp10 + odd, false);
    IDCT_OUT(2, tmp10 - odd, false);
    IDCT_OUT(1, tmp2, false);
  });
}

void idct_5x5(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<5>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    int64_t tmp12 = x[0] * (int64_t{1} << kConstBits) + fudge;
    const int64_t z1 = (x[2] + x[4]) * fix(0.790569415);
    int64_t z2 = (x[2] - x[4]) * fix(0.353553391);
    int64_t z3 = tmp12 + z2;
    const int64_t tmp10 = z3 + z1, tmp11 = z3 - z1;
    tmp12 -= z2 * 4;
    z2 = x[1];
    z3 = x[3];
    const int64_t zo = (z2 + z3) * fix(0.831253876);
    const int64_t tmp0 = zo + z2 * fix(0.513743148);
    const int64_t tmp1 = zo - z3 * fix(2.176250899);
    IDCT_OUT(0, tmp10 + tmp0, false);
    IDCT_OUT(4, tmp10 - tmp0, false);
    IDCT_OUT(1, tmp11 + tmp1, false);
    IDCT_OUT(3, tmp11 - tmp1, false);
    IDCT_OUT(2, tmp12, false);
  });
}

void idct_6x6(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<6>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    int64_t tmp0 = x[0] * (int64_t{1} << kConstBits) + fudge;
    int64_t tmp10 = x[4] * fix(0.707106781);
    int64_t tmp1 = tmp0 + tmp10;
    int64_t tmp11 = tmp0 - tmp10 - tmp10;
    if (pass1) tmp11 >>= kConstBits - kPass1Bits;
    tmp0 = x[2] * fix(1.224744871);
    tmp10 = tmp1 + tmp0;
    const int64_t tmp12 = tmp1 - tmp0;
    const int64_t z1 = x[1], z2 = x[3], z3 = x[5];
    tmp1 = (z1 + z3) * fix(0.366025404);
    tmp0 = tmp1 + (z1 + z2) * (int64_t{1} << kConstBits);
    const int64_t tmp2 = tmp1 + (z3 - z2) * (int64_t{1} << kConstBits);
    tmp1 = (z1 - z2 - z3) * (int64_t{1} << (pass1 ? kPass1Bits : kConstBits));
    IDCT_OUT(0, tmp10 + tmp0, false);
    IDCT_OUT(5, tmp10 - tmp0, false);
    IDCT_OUT(1, tmp11 + tmp1, true);
    IDCT_OUT(4, tmp11 - tmp1, true);
    IDCT_OUT(2, tmp12 + tmp2, false);
    IDCT_OUT(3, tmp12 - tmp2, false);
  });
}

void idct_7x7(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<7>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    int64_t tmp13 = x[0] * (int64_t{1} << kConstBits) + fudge;
    int64_t z1 = x[2], z2 = x[4], z3 = x[6];
    int64_t tmp10 = (z2 - z3) * fix(0.881747734);
    int64_t tmp12 = (z1 - z2) * fix(0.314692123);
    const int64_t tmp11 = tmp10 + tmp12 + tmp13 - z2 * fix(1.841218003);
    int64_t tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = tmp0 * fix(1.274162392) + tmp13;
    tmp10 += tmp0 - z3 * fix(0.077722536);
    tmp12 += tmp0 - z1 * fix(2.470602249);
    tmp13 += z2 * fix(1.414213562);
    z1 = x[1];
    z2 = x[3];
    z3 = x[5];
    int64_t tmp1 = (z1 + z2) * fix(0.935414347);
    int64_t tmp2 = (z1 - z2) * fix(0.170262339);
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = (z2 + z3) * -fix(1.378756276);
    tmp1 += tmp2;
    z2 = (z1 + z3) * fix(0.613604268);
    tmp0 += z2;
    tmp2 += z2 + z3 * fix(1.870828693);
    IDCT_OUT(0, tmp10 + tmp0, false);
    IDCT_OUT(6, tmp10 - tmp0, false);
    IDCT_OUT(1, tmp11 + tmp1, false);
    IDCT_OUT(5, tmp11 - tmp1, false);
    IDCT_OUT(2, tmp12 + tmp2, false);
    IDCT_OUT(4, tmp12 - tmp2, false);
    IDCT_OUT(3, tmp13, false);
  });
}

void idct_10x10(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<10>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    int64_t z3 = x[0] * (int64_t{1} << kConstBits) + fudge;
    int64_t z4 = x[4];
    int64_t z1 = z4 * fix(1.144122806);
    int64_t z2 = z4 * fix(0.437016024);
    int64_t tmp10 = z3 + z1, tmp11 = z3 - z2;
    int64_t tmp22 = z3 - (z1 - z2) * 2;
    if (pass1) tmp22 >>= kConstBits - kPass1Bits;
    z2 = x[2];
    z3 = x[6];
    z1 = (z2 + z3) * fix(0.831253876);
    int64_t tmp12 = z1 + z2 * fix(0.513743148);
    int64_t tmp13 = z1 - z3 * fix(2.176250899);
    const int64_t tmp20 = tmp10 + tmp12, tmp24 = tmp10 - tmp12;
    const int64_t tmp21 = tmp11 + tmp13, tmp23 = tmp11 - tmp13;
    z1 = x[1];
    z2 = x[3];
    z3 = x[5];
    z4 = x[7];
    tmp11 = z2 + z4;
    tmp13 = z2 - z4;
    tmp12 = tmp13 * fix(0.309016994);
    const int64_t z5 = z3 * (int64_t{1} << kConstBits);
    z2 = tmp11 * fix(0.951056516);
    z4 = z5 + tmp12;
    tmp10 = z1 * fix(1.396802247) + z2 + z4;
    const int64_t tmp14 = z1 * fix(0.221231742) - z2 + z4;
    z2 = tmp11 * fix(0.587785252);
    z4 = z5 - tmp12 - tmp13 * (int64_t{1} << (kConstBits - 1));
    tmp12 = pass1 ? (z1 - tmp13 - z3) * (1 << kPass1Bits)
                  : (z1 - tmp13) * (int64_t{1} << kConstBits) - z5;
    tmp11 = z1 * fix(1.260073511) - z2 - z4;
    tmp13 = z1 * fix(0.642039522) - z2 + z4;
    IDCT_OUT(0, tmp20 + tmp10, false);
    IDCT_OUT(9, tmp20 - tmp10, false);
    IDCT_OUT(1, tmp21 + tmp11, false);
    IDCT_OUT(8, tmp21 - tmp11, false);
    IDCT_OUT(2, tmp22 + tmp12, true);
    IDCT_OUT(7, tmp22 - tmp12, true);
    IDCT_OUT(3, tmp23 + tmp13, false);
    IDCT_OUT(6, tmp23 - tmp13, false);
    IDCT_OUT(4, tmp24 + tmp14, false);
    IDCT_OUT(5, tmp24 - tmp14, false);
  });
}

void idct_12x12(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<12>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    constexpr int64_t one = int64_t{1} << kConstBits;
    int64_t z3 = x[0] * one + fudge;
    int64_t z4 = x[4] * fix(1.224744871);
    int64_t tmp10 = z3 + z4, tmp11 = z3 - z4;
    int64_t z1 = x[2];
    z4 = z1 * fix(1.366025404);
    z1 *= one;
    int64_t z2 = x[6] * one;
    int64_t tmp12 = z1 - z2;
    const int64_t tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
    tmp12 = z4 + z2;
    const int64_t tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
    tmp12 = z4 - z1 - z2;
    const int64_t tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;
    z1 = x[1];
    z2 = x[3];
    z3 = x[5];
    z4 = x[7];
    tmp11 = z2 * fix(1.306562965);
    int64_t tmp14 = z2 * -F0_541;
    tmp10 = z1 + z3;
    int64_t tmp15 = (tmp10 + z4) * fix(0.860918669);
    tmp12 = tmp15 + tmp10 * fix(0.261052384);
    tmp10 = tmp12 + tmp11 + z1 * fix(0.280143716);
    int64_t tmp13 = (z3 + z4) * -fix(1.045510580);
    tmp12 += tmp13 + tmp14 - z3 * fix(1.478575242);
    tmp13 += tmp15 - tmp11 + z4 * fix(1.586706681);
    tmp15 += tmp14 - z1 * fix(0.676326758) - z4 * fix(1.982889723);
    z1 -= z4;
    z2 -= z3;
    z3 = (z1 + z2) * F0_541;
    tmp11 = z3 + z1 * F0_765;
    tmp14 = z3 - z2 * F1_847;
    IDCT_OUT(0, tmp20 + tmp10, false);
    IDCT_OUT(11, tmp20 - tmp10, false);
    IDCT_OUT(1, tmp21 + tmp11, false);
    IDCT_OUT(10, tmp21 - tmp11, false);
    IDCT_OUT(2, tmp22 + tmp12, false);
    IDCT_OUT(9, tmp22 - tmp12, false);
    IDCT_OUT(3, tmp23 + tmp13, false);
    IDCT_OUT(8, tmp23 - tmp13, false);
    IDCT_OUT(4, tmp24 + tmp14, false);
    IDCT_OUT(7, tmp24 - tmp14, false);
    IDCT_OUT(5, tmp25 + tmp15, false);
    IDCT_OUT(6, tmp25 - tmp15, false);
  });
}

void idct_14x14(const int16_t* coef, const int16_t* qt, uint8_t* out, int stride) {
  idct_scaled<14>(coef, qt, out, stride, [](const int64_t* x, int64_t fudge, bool pass1, int64_t* y) {
    constexpr int64_t one = int64_t{1} << kConstBits;
    int64_t z1 = x[0] * one + fudge;
    int64_t z4 = x[4];
    int64_t z2 = z4 * fix(1.274162392);
    int64_t z3 = z4 * fix(0.314692123);
    z4 = z4 * fix(0.881747734);
    int64_t tmp10 = z1 + z2, tmp11 = z1 + z3, tmp12 = z1 - z4;
    int64_t tmp23 = z1 - (z2 + z3 - z4) * 2;
    if (pass1) tmp23 >>= kConstBits - kPass1Bits;
    z1 = x[2];
    z2 = x[6];
    z3 = (z1 + z2) * fix(1.105676686);
    int64_t tmp13 = z3 + z1 * fix(0.273079590);
    int64_t tmp14 = z3 - z2 * fix(1.719280954);
    int64_t tmp15 = z1 * fix(0.613604268) - z2 * fix(1.378756276);
    const int64_t tmp20 = tmp10 + tmp13, tmp26 = tmp10 - tmp13;
    const int64_t tmp21 = tmp11 + tmp14, tmp25 = tmp11 - tmp14;
    const int64_t tmp22 = tmp12 + tmp15, tmp24 = tmp12 - tmp15;
    z1 = x[1];
    z2 = x[3];
    z3 = x[5];
    const int64_t z4s = x[7] * one;
    tmp14 = z1 + z3;
    tmp11 = (z1 + z2) * fix(1.334852607);
    tmp12 = tmp14 * fix(1.197448846);
    tmp10 = tmp11 + tmp12 + z4s - z1 * fix(1.126980169);
    tmp14 = tmp14 * fix(0.752406978);
    int64_t tmp16 = tmp14 - z1 * fix(1.061150426);
    z1 -= z2;
    tmp15 = z1 * fix(0.467085129) - z4s;
    tmp16 += tmp15;
    tmp13 = (z2 + z3) * -fix(0.158341681) - z4s;
    tmp11 += tmp13 - z2 * fix(0.424103948);
    tmp12 += tmp13 - z3 * fix(2.373959773);
    tmp13 = (z3 - z2) * fix(1.405321284);
    tmp14 += tmp13 + z4s - z3 * fix(1.6906431334);
    tmp15 += tmp13 + z2 * fix(0.674957567);
    tmp13 = pass1 ? (z1 + x[7] - z3) * (1 << kPass1Bits) : (z1 - z3) * one + z4s;
    IDCT_OUT(0, tmp20 + tmp10, false);
    IDCT_OUT(13, tmp20 - tmp10, false);
    IDCT_OUT(1, tmp21 + tmp11, false);
    IDCT_OUT(12, tmp21 - tmp11, false);
    IDCT_OUT(2, tmp22 + tmp12, false);
    IDCT_OUT(11, tmp22 - tmp12, false);
    IDCT_OUT(3, tmp23 + tmp13, true);
    IDCT_OUT(10, tmp23 - tmp13, true);
    IDCT_OUT(4, tmp24 + tmp14, false);
    IDCT_OUT(9, tmp24 - tmp14, false);
    IDCT_OUT(5, tmp25 + tmp15, false);
    IDCT_OUT(8, tmp25 - tmp15, false);
    IDCT_OUT(6, tmp26 + tmp16, false);
    IDCT_OUT(7, tmp26 - tmp16, false);
  });
}

#undef IDCT_OUT

using IdctFn = void (*)(const int16_t*, const int16_t*, uint8_t*, int);

// jddctmgr.c's choice for a DCT_scaled_size; null where it has none.
IdctFn idct_for(int size) {
  switch (size) {
    case 1: return idct_1x1;
    case 2: return idct_2x2;
    case 3: return idct_3x3;
    case 4: return idct_4x4;
    case 5: return idct_5x5;
    case 6: return idct_6x6;
    case 7: return idct_7x7;
    case 8: return idct_islow;
    case 10: return idct_10x10;
    case 12: return idct_12x12;
    case 14: return idct_14x14;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// Huffman tables: the DHT contents, and jpeg_make_d_derived_tbl's decoding
// tables with jdhuff.c's 8-bit lookahead.

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// HUFF_LOOKAHEAD.
constexpr int kLook = 8;

struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // (length << 8) | symbol; length kLook + 1 for a longer code.
  uint16_t lookup[1 << kLook];
  // For an AC table: where the code and its extra bits fit in the
  // lookahead, (value << 16) | (run << 8) | (code length << 4) | size;
  // else 0.
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
    for (auto& e : lookup) e = (kLook + 1) << 8;
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
      if (is_dc || l > kLook || size == 0 || l + size > kLook) continue;
      const int extra = (look >> (kLook - l - size)) & ((1 << size) - 1);
      const int value = extra < (1 << (size - 1)) ? extra - (1 << size) + 1 : extra;
      fast_ac[look] = static_cast<int32_t>(static_cast<uint32_t>(value) << 16) |
                      ((sym >> 4) << 8) | (l << 4) | size;
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
  long past_end = 0;  // reads past the end of the data

  int byte() {
    if (p < end) return *p++;
    ++past_end;
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

// jdhuff.c's bit reader as its slow path runs it (jpeg_fill_bit_buffer,
// HUFF_DECODE, CHECK_BIT_BUFFER / GET_BITS), byte for byte, since where
// it stands decides libjpeg-turbo's choice of path for the next MCU.
struct BitReader {
  Source* src;
  uint64_t buf = 0;  // get_buffer: the low n bits are unread
  int n = 0;         // bits_left
  bool insufficient = false;

  void reset() { n = 0; }

  // jpeg_fill_bit_buffer: at least 57 bits, up to a marker; past one,
  // zeros, and insufficient_data, where nbits are needed and not there.
  // FF (FF...) 00 is one FF data byte.
  void fill(int nbits) {
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
    if (src->unread_marker != 0 && nbits > n) {
      insufficient = true;
      buf <<= 57 - n;
      n = 57;
    }
  }
  int get(int k) {  // CHECK_BIT_BUFFER and GET_BITS
    if (n < k) fill(k);
    n -= k;
    return static_cast<int>(buf >> n) & ((1 << k) - 1);
  }
  // The lookahead, filled first as HUFF_DECODE fills it; -1 where fewer
  // than kLook bits remain even then.
  int look() {
    if (n < kLook) fill(0);
    return n < kLook ? -1 : static_cast<int>(buf >> (n - kLook)) & ((1 << kLook) - 1);
  }

  // HUFF_DECODE, and jpeg_huff_decode for a code longer than the
  // lookahead (or where the lookahead is short).
  int huff(const HuffTable& t) {
    const int lk = look();
    int l = 1;
    if (lk >= 0) {
      const int e = t.lookup[lk];
      l = e >> 8;
      if (l <= kLook) {
        n -= l;
        return e & 0xFF;
      }
    }
    int32_t code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: libjpeg fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

// The bit reader of jdhuff.c's decode_mcu_fast (jdhuff.h's GET_BYTE and
// FILL_BIT_BUFFER_FAST): six bytes at a time once 16 bits or fewer are
// left, straight from the buffer. Unlike the slow path it takes any FF
// not followed by 00 for a marker, FF FF 00 too (fill bytes before a
// stuffed FF, which the slow path reads as one FF): from there it reads
// zeros, and libjpeg-turbo decodes the MCU again on the slow path.
struct FastBits {
  const uint8_t* p;
  uint64_t buf;
  int n;
  bool marker = false;

  void fill() {
    if (n > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = *p++, c1 = *p;
      buf = (buf << 8) | static_cast<uint64_t>(c0);
      n += 8;
      if (c0 == 0xFF) {
        ++p;
        if (c1 != 0) {
          marker = true;
          p -= 2;
          buf &= ~uint64_t{0xFF};
        }
      }
    }
  }
  int get(int k) {  // GET_BITS, after a fill
    n -= k;
    return static_cast<int>(buf >> n) & ((1 << k) - 1);
  }
  int look() const { return static_cast<int>(buf >> (n - kLook)) & ((1 << kLook) - 1); }
  // HUFF_DECODE_FAST.
  int huff(const HuffTable& t) {
    fill();
    const int e = t.lookup[look()];
    int l = e >> 8;
    n -= l;
    if (l <= kLook) return e & 0xFF;
    int32_t code = static_cast<int32_t>(buf >> n) & ((1 << l) - 1);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    return l > 16 ? 0 : t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

// ---------------------------------------------------------------------------
// jdarith.c's arithmetic decoder.

// jaricom.c's jpeg_aritab, T.81 Table D.2: (Qe_Value << 16) |
// (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS; the last
// entry is the fixed probability 0.5 of T.851.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// arith_decode: the C and A registers and the bit counter ct (-16 before
// the two bytes that start a segment, -1 after a bad code). Bytes come
// from the source as get_byte reads them; after a marker, zeros.
struct ArithCoder {
  Source* src;
  int64_t c = 0, a = 0;
  int ct = -16;

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // One binary decision with statistics bin *st (sections D.2.4-D.2.6).
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (src->unread_marker == 0) {
          data = src->byte();
          if (data == 0xFF) {
            do data = src->byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;  // a stuffed zero
            } else {
              src->unread_marker = data;  // legal here: zeros from now on
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first two bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);  // Switch_MPS, Next_Index_LPS
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);  // Next_Index_MPS
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      // Conditional LPS exchange.
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      // Conditional MPS exchange.
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// ---------------------------------------------------------------------------
// The decoder.

// jdsample.c's method for one direction of a component.
enum Upsample {
  kSame = 0,    // fullsize_upsample
  kFancy = 1,   // the triangle filter of h2v1 / h1v2 / h2v2_fancy_upsample
  kRepeat = 2,  // int_upsample (and h2v1 / h2v2_upsample): replication
};

struct Component {
  int id, h, v, tq;
  int dc_tbl, ac_tbl;
  int wib, hib;      // width_in_blocks, height_in_blocks
  int bw, bh;        // coefficient grid, padded to whole MCUs
  int ds = 8;        // DCT_scaled_size: the side of a block's IDCT output
  int dw, dh;        // downsampled_width / height at that size
  int up_h = kSame, up_v = kSame;  // Upsample, per direction
  int hx = 1, vx = 1;              // h_expand, v_expand where kRepeat
  bool latched = false;
  int16_t qt[64];     // the IDCT's multipliers (ISLOW_MULT_TYPE is short)
  uint16_t qraw[64];  // the quantization table as latched
  // jdphuff.c's progression status: the Al each coefficient was last
  // coded with (-1 never), and the same before the component's last scan.
  int coef_bits[64], prev_bits[64];
  // Coefficients: one MCU row's block rows in a single-pass image, else
  // all bh block rows; bw blocks a row.
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // wib * ds x hib * ds samples
};

struct Decoder {
  Source src;
  BitReader bits;
  ArithCoder arith;
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool rgb = false;  // jpeg_color_space JCS_RGB: three components, no transform
  bool pil = false;       // kLoadImage: four components admitted
  bool ycck = false;      // jpeg_color_space JCS_YCCK (else CMYK) of four
  int width = 0, height = 0, max_h = 1, max_v = 1;
  int scale = 8;               // scale_num / 8, the luma IDCT's side
  int out_w = 0, out_h = 0;    // output_width / height at that scale
  std::vector<Component> comps;
  bool progressive = false;    // SOF2, SOF10
  bool arithmetic = false;     // SOF9, SOF10
  // get_dac's conditioning of each arithmetic table (get_soi's defaults),
  // and jdarith.c's statistics bins.
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int dc_context[4] = {0, 0, 0, 0};
  int ss = 0, se = 63, ah = 0, al = 0;  // the scan's spectral selection
  int scans = 0;               // SOS markers read (input_scan_number)
  bool single_pass = false;  // the first scan holds every component
  long scan_past_end = 0;    // src.past_end when a single-pass scan ended
  unsigned eobrun = 0;       // jdphuff.c's EOBRUN
  int last_good_imcu = 0;    // master->last_good_iMCU_row

  Decoder(const uint8_t* data, size_t size) {
    src.p = data;
    src.end = data + size;
    bits.src = &src;
    arith.src = &src;
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
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
    src.past_end += n - have;
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

  // get_dac: arithmetic conditioning for the scans after it (of no use to
  // a Huffman scan): Kx of an AC table, L and U of a DC table.
  int read_dac() {
    long len = u16() - 2;
    while (len > 0) {
      const int index = src.byte(), val = src.byte();
      len -= 2;
      if (index >= 32) return kCorrupt;  // JERR_DAC_INDEX
      if (index >= 16) {
        dac_k[index - 16] = static_cast<uint8_t>(val);  // any value
      } else {
        if ((val & 15) > (val >> 4)) return kCorrupt;  // JERR_DAC_VALUE
        dac_l[index] = static_cast<uint8_t>(val & 15);
        dac_u[index] = static_cast<uint8_t>(val >> 4);
      }
    }
    return len == 0 ? kOk : kCorrupt;
  }

  int read_sof(bool prog, bool arith_coded) {
    progressive = prog;
    arithmetic = arith_coded;
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
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, 0);
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
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
        rc = read_sof(m == 0xC2 || m == 0xCA, m >= 0xC9);
      } else if ((m >= 0xC3 && m <= 0xCB && m != 0xC4) || (m >= 0xCD && m <= 0xCF)) {
        // SOF3/5-7/11/13-15 (lossless, hierarchical: libjpeg-turbo 2.1
        // refuses them), JPG.
        return saw_sof ? kCorrupt : kProcess;
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
      // libjpeg-turbo's check that this component is not already in the
      // scan (the slot search alone lets a repeated id through).
      for (int pi = 0; pi < i; ++pi) {
        if (idx[pi] == found) return kCorrupt;  // JERR_BAD_COMPONENT_ID
      }
      idx[i] = found;
      comps[found].dc_tbl = t >> 4;
      comps[found].ac_tbl = t & 15;
    }
    // Ss, Se, Ah/Al: a sequential scan only warns on them.
    ss = src.byte();
    se = src.byte();
    const int a = src.byte();
    ah = a >> 4;
    al = a & 15;
    ++scans;
    *ncomp = n;
    return kOk;
  }

  // What libjpeg settles at the end of jpeg_read_header: the color space
  // (default_decompress_parms) and the component sizes (initial_setup);
  // then the 8/8 output.
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
      rgb = !ycc;
    } else if (nc == 4 && pil) {
      // Adobe's transform 0 is CMYK, any other YCCK; no Adobe marker, CMYK.
      ycck = saw_adobe && adobe_transform != 0;
    } else if (nc != 1) {
      return kColorSpace;  // JERR_CONVERSION_NOTIMPL out as RGB
    }
    for (auto& c : comps) {
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    const int mcux = (width + 8 * max_h - 1) / (8 * max_h);
    const int mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.wib = static_cast<int>((int64_t{width} * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hib = static_cast<int>((int64_t{height} * c.v + 8 * max_v - 1) / (8 * max_v));
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    return choose_scale(8);
  }

  // jpeg_calc_output_dimensions at scale n / 8, then jinit_upsampler's
  // method per component. Luma's IDCT gives n x n samples a block; a
  // component sampled below it takes twice that while both of its ratios
  // allow, so 4:2:0 chroma below 8/8 is IDCT'd at 2n and not upsampled.
  int choose_scale(int n) {
    scale = n;
    out_w = static_cast<int>((int64_t{width} * n + 7) / 8);
    out_h = static_cast<int>((int64_t{height} * n + 7) / 8);
    // do_fancy_upsampling, off where min_DCT_scaled_size is 1.
    const bool fancy = n > 1;
    for (auto& c : comps) {
      int s = n;
      while (s < 8 && (max_h * n) % (c.h * s * 2) == 0 &&
             (max_v * n) % (c.v * s * 2) == 0) {
        s *= 2;
      }
      c.ds = s;
      c.dw = static_cast<int>((int64_t{width} * c.h * s + 8 * max_h - 1) / (8 * max_h));
      c.dh = static_cast<int>((int64_t{height} * c.v * s + 8 * max_v - 1) / (8 * max_v));
      // An input group of hin x vin samples becomes max_h x max_v pixels.
      const int hin = c.h * s / n, vin = c.v * s / n;
      c.up_h = c.up_v = kSame;
      c.hx = c.vx = 1;
      if (hin == max_h && vin == max_v) {
        // fullsize_upsample
      } else if (hin * 2 == max_h && vin == max_v && fancy && c.dw > 2) {
        c.up_h = kFancy;  // h2v1_fancy_upsample
      } else if (hin == max_h && vin * 2 == max_v && fancy) {
        c.up_v = kFancy;  // h1v2_fancy_upsample
      } else if (hin * 2 == max_h && vin * 2 == max_v && fancy && c.dw > 2) {
        c.up_h = c.up_v = kFancy;  // h2v2_fancy_upsample
      } else if (max_h % hin == 0 && max_v % vin == 0) {
        c.up_h = c.up_v = kRepeat;  // int_upsample, h2v1_upsample, h2v2_upsample
        c.hx = max_h / hin;
        c.vx = max_v / vin;
      } else {
        return kSampling;  // JERR_FRACT_SAMPLE_NOTIMPL
      }
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
    if (s.defined || slot >= 2 || progressive) return s;  // jdhuff.c only
    return (ac ? std_ac : std_dc)[slot];
  }

  // start_pass_phuff_decoder: the scan parameters' checks (a bad
  // progression is fatal; a bogus one only warns, and decoding goes on) and
  // the progression status of the scan's components.
  int start_progressive_scan(int ncomp, const int idx[4]) {
    bool bad = false;
    if (ss == 0) {
      bad = se != 0;
    } else {
      bad = ss > se || se >= 64 || ncomp != 1;  // AC scans hold one component
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) return kCorrupt;  // JERR_BAD_PROGRESSION
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comps[idx[i]];
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k) {
        c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
      }
      for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
    return kOk;
  }

  // One scan. In a single-pass image each MCU row goes through the IDCT
  // as soon as it is decoded, as libjpeg's single-pass coefficient
  // controller does, so only that row's coefficients are held.
  int decode_scan(int ncomp, const int idx[4]) {
    HuffTable dct[4], act[4];
    int blocks_in_mcu = 0;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comps[idx[i]];
      blocks_in_mcu += ncomp == 1 ? 1 : c.h * c.v;
    }
    if (blocks_in_mcu > 10) return kCorrupt;  // JERR_BAD_MCU_SIZE
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comps[idx[i]];
      if (!c.latched) {
        if (c.tq >= 4 || !qdefined[c.tq]) return kCorrupt;  // JERR_NO_QUANT_TABLE
        for (int k = 0; k < 64; ++k) {
          c.qraw[k] = qtables[c.tq][k];
          c.qt[k] = static_cast<int16_t>(qtables[c.tq][k]);
        }
        c.latched = true;
      }
    }
    if (progressive) {
      const int rc = start_progressive_scan(ncomp, idx);
      if (rc != kOk) return rc;
    }
    // The tables the scan reads: a DC refinement none, an AC scan only AC.
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss != 0;
    // False where libjpeg raises JERR_NO_HUFF_TABLE or JERR_BAD_HUFF_TABLE.
    auto table = [&](bool ac, int slot, HuffTable* t) {
      if (slot >= 4) return false;
      const HuffSpec& spec = huff_spec(ac, slot);
      return spec.defined && t->build(spec, !ac);
    };
    for (int i = 0; i < ncomp && !arithmetic; ++i) {
      const Component& c = comps[idx[i]];
      if (need_dc && !table(false, c.dc_tbl, &dct[i])) return kCorrupt;
      if (need_ac && !table(true, c.ac_tbl, &act[i])) return kCorrupt;
    }

    int mcus_x, mcus_y;
    if (ncomp == 1) {
      mcus_x = comps[idx[0]].wib;
      mcus_y = comps[idx[0]].hib;
    } else {
      mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
      mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    }
    const int imcu_div = ncomp == 1 ? comps[idx[0]].v : 1;
    bits.reset();
    bits.insufficient = false;
    int pred[4] = {0, 0, 0, 0};
    eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_restart = 0;
    // jdarith.c's start_pass; its decoder never sets insufficient_data.
    if (arithmetic) start_arith(ncomp, idx, pred, need_dc, need_ac);

    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (!bits.insufficient) last_good_imcu = my / imcu_div;
        if (arithmetic) {
          // process_restart: the marker resync, then fresh statistics and
          // a fresh coder; after a bad code (ct -1) the rest of the segment
          // is skipped (a DC refinement, which skips nothing, has none).
          if (restart_interval && restarts_to_go-- == 0) {
            read_restart(&next_restart);
            start_arith(ncomp, idx, pred, need_dc, need_ac);
            restarts_to_go = restart_interval - 1;
          }
          for_each_block(ncomp, idx, my, mx, [&](int i, int16_t* blk) {
            if (arith.ct == -1) return kOk;
            const Component& c = comps[idx[i]];
            if (!progressive) {
              if (arith_dc(i, c.dc_tbl, &pred[i])) {
                blk[0] = static_cast<int16_t>(pred[i]);
                arith_ac(blk, c.ac_tbl, 1, 63);
              }
            } else if (ss == 0) {
              if (ah != 0) {
                if (arith.decode(&fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              } else if (arith_dc(i, c.dc_tbl, &pred[i])) {
                blk[0] = static_cast<int16_t>(static_cast<uint32_t>(pred[i]) << al);
              }
            } else if (ah == 0) {
              arith_ac(blk, c.ac_tbl, ss, se);
            } else {
              arith_ac_refine(blk, c.ac_tbl);
            }
            return kOk;
          });
          continue;
        }
        if (restart_interval) {
          if (restarts_to_go == 0) {
            bits.reset();
            read_restart(&next_restart);
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            eobrun = 0;
            restarts_to_go = restart_interval;
            if (src.unread_marker == 0) bits.insufficient = false;
          }
        }
        // jdhuff.c's decode_mcu: the fast path where no restart interval is
        // set and 512 bytes a block remain before the end of the data;
        // where it meets what it takes for a marker, the MCU again on the
        // slow path, over the blocks the fast one wrote (only the slow
        // path's nonzero ACs overwrite them).
        if (!progressive && !bits.insufficient && restart_interval == 0 &&
            src.unread_marker == 0 && src.end - src.p >= 512 * blocks_in_mcu) {
          FastBits f{src.p, bits.buf, bits.n};
          int fpred[4] = {pred[0], pred[1], pred[2], pred[3]};
          for_each_block(ncomp, idx, my, mx, [&](int i, int16_t* blk) {
            decode_block_fast(f, blk, dct[i], act[i], &fpred[i]);
            return static_cast<int>(kOk);
          });
          if (!f.marker) {
            src.p = f.p;
            bits.buf = f.buf;
            bits.n = f.n;
            std::copy(fpred, fpred + 4, pred);
            continue;
          }
        }
        // Past the end of the data a sequential scan leaves its blocks zero;
        // a progressive one leaves what earlier scans put there (a DC
        // refinement reads on, its zero bits change nothing).
        if (!bits.insufficient || (progressive && ss == 0 && ah != 0)) {
          const int rc = for_each_block(ncomp, idx, my, mx, [&](int i, int16_t* blk) {
            if (!progressive) {
              decode_block(blk, dct[i], act[i], &pred[i]);
            } else if (ss == 0) {
              if (ah == 0) return decode_dc_first(blk, dct[i], &pred[i]);
              decode_dc_refine(blk);
            } else if (ah == 0) {
              decode_ac_first(blk, act[i]);
            } else {
              decode_ac_refine(blk, act[i]);
            }
            return static_cast<int>(kOk);
          });
          if (rc != kOk) return rc;
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

  // jdarith.c's start_pass and process_restart: the statistics of the
  // tables the scan reads zeroed, with the DC predictors and contexts, and
  // the coder reset.
  void start_arith(int ncomp, const int idx[4], int* pred, bool need_dc, bool need_ac) {
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comps[idx[i]];
      if (need_dc) {
        std::fill(dc_stats[c.dc_tbl], dc_stats[c.dc_tbl] + 64, uint8_t{0});
        pred[i] = 0;
        dc_context[i] = 0;
      }
      if (need_ac) std::fill(ac_stats[c.ac_tbl], ac_stats[c.ac_tbl] + 256, uint8_t{0});
    }
    arith.reset();
  }

  // Figures F.23-F.24 once the magnitude category's first decisions set
  // *m: the rest of the category in bins x, x + 1, ... (*m doubling at
  // each 1), then the bits below *m in the bins 14 further on. Returns
  // |v| - 1, or -1 on a magnitude overflow (JWRN_ARITH_BAD_CODE: ct -1).
  int arith_magnitude(int* m, uint8_t* x) {
    while (arith.decode(x)) {
      if ((*m <<= 1) == 0x8000) {
        arith.ct = -1;
        return -1;
      }
      ++x;
    }
    int v = *m;
    x += 14;
    for (int b = *m >> 1; b; b >>= 1) {
      if (arith.decode(x)) v |= b;
    }
    return v;
  }

  // decode_mcu's (and decode_mcu_DC_first's) DC: the difference in the
  // context that the last one left (its conditioning from DAC's L and U),
  // the predictor kept in 16 bits. False after a bad code.
  bool arith_dc(int i, int tbl, int* pred) {
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    if (arith.decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    const int sign = arith.decode(st + 1);
    st += 2 + sign;
    int m = arith.decode(st), mag = 0;
    if (m != 0 && (mag = arith_magnitude(&m, dc_stats[tbl] + 20)) < 0) return false;
    if (m < ((1 << dac_l[tbl]) >> 1)) {
      dc_context[i] = 0;  // zero diff category
    } else if (m > ((1 << dac_u[tbl]) >> 1)) {
      dc_context[i] = 12 + sign * 4;  // large diff category
    } else {
      dc_context[i] = 4 + sign * 4;  // small diff category
    }
    *pred = (*pred + (sign ? -(mag + 1) : mag + 1)) & 0xFFFF;
    return true;
  }

  // AC coefficients first..last of one block (Figure F.20; decode_mcu's and
  // decode_mcu_AC_first's), scaled by Al: an EOB decision, zero runs, the
  // sign at the fixed bin, the magnitude in the bins of Kx's band.
  void arith_ac(int16_t* blk, int tbl, int first, int last) {
    uint8_t* stats = ac_stats[tbl];
    for (int k = first; k <= last; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (arith.decode(st)) return;  // EOB
      while (arith.decode(st + 1) == 0) {
        st += 3;
        if (++k > last) {
          arith.ct = -1;  // spectral overflow
          return;
        }
      }
      const int sign = arith.decode(&fixed_bin);
      st += 2;
      int m = arith.decode(st), mag = m;
      if (m != 0 && arith.decode(st)) {
        m = 2;
        mag = arith_magnitude(&m, stats + (k <= dac_k[tbl] ? 189 : 217));
        if (mag < 0) return;
      }
      const int v = sign ? -(mag + 1) : mag + 1;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << (progressive ? al : 0));
    }
  }

  // decode_mcu_AC_refine: past the last coefficient nonzero before this
  // scan an EOB decision; a correction bit for each nonzero coefficient,
  // +-1 << Al for a newly nonzero one (its sign at the fixed bin).
  void arith_ac_refine(int16_t* blk, int tbl) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    while (kex > 0 && blk[kNatural[kex]] == 0) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith.decode(st)) return;  // EOB
      for (;;) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          if (arith.decode(st + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (arith.decode(st + 1)) {
          *c = static_cast<int16_t>(arith.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          arith.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  // The next DC difference.
  int dc_diff(const HuffTable& dc) {
    const int s = bits.huff(dc);
    return s ? extend(bits.get(s), s) : 0;
  }

  // fn(i, block) on the blocks of MCU (mx, my) of a scan in order, i the
  // component's place in the scan; stops at the first status fn returns.
  template <typename Fn>
  int for_each_block(int ncomp, const int idx[4], int my, int mx, Fn fn) {
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comps[idx[i]];
      const int nh = ncomp == 1 ? 1 : c.h, nv = ncomp == 1 ? 1 : c.v;
      for (int by = 0; by < nv; ++by) {
        for (int bx = 0; bx < nh; ++bx) {
          const size_t row = single_pass ? by : static_cast<size_t>(my) * nv + by;
          const size_t col = static_cast<size_t>(mx) * nh + bx;
          const int rc = fn(i, c.coef.data() + (row * c.bw + col) * 64);
          if (rc != kOk) return rc;
        }
      }
    }
    return kOk;
  }

  // decode_mcu_DC_first: the DC, scaled by Al. Unlike jdhuff.c, jdphuff.c
  // refuses a predictor that would overflow (JERR_BAD_DCT_COEF).
  int decode_dc_first(int16_t* blk, const HuffTable& dc, int* pred) {
    const int s = dc_diff(dc);
    if ((*pred >= 0 && s > INT_MAX - *pred) ||
        (*pred < 0 && s < INT_MIN - *pred)) {
      return kCorrupt;
    }
    *pred += s;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(*pred) << al);
    return kOk;
  }

  // decode_mcu_DC_refine: one more bit of the DC's two's complement.
  void decode_dc_refine(int16_t* blk) {
    if (bits.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  // decode_mcu_AC_first: the band's first pass, with end-of-band runs.
  void decode_ac_first(int16_t* blk, const HuffTable& ac) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int s = bits.huff(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(bits.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(s) << al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {
        eobrun = 1u << r;  // EOBr: 2^r + r appended bits
        if (r) eobrun += static_cast<unsigned>(bits.get(r));
        --eobrun;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: newly nonzero coefficients of +-1 << Al, and a
  // correction bit for each coefficient already nonzero.
  void decode_ac_refine(int16_t* blk, const HuffTable& ac) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t* c) {
      if (bits.get(1) && (*c & p1) == 0) {
        *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int s = bits.huff(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = bits.get(1) ? p1 : m1;  // a size other than 1 only warns
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += static_cast<unsigned>(bits.get(r));
          break;  // the rest of the block is handled by the EOB logic
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;  // the zero coefficient the new one goes to
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // decode_mcu_slow's block. The DC predictor wraps where it overflows,
  // as libjpeg-turbo's does.
  void decode_block(int16_t* blk, const HuffTable& dc, const HuffTable& ac,
                    int* pred) {
    *pred = static_cast<int>(static_cast<uint32_t>(*pred) +
                             static_cast<uint32_t>(dc_diff(dc)));
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      const int lk = bits.look();
      const int32_t fast = lk >= 0 ? ac.fast_ac[lk] : 0;
      if (fast) {  // code, run and value in one lookup: no fill between
        bits.n -= ((fast >> 4) & 15) + (fast & 15);
        k += (fast >> 8) & 0xFF;
        blk[kNatural[k]] = static_cast<int16_t>(fast >> 16);
        continue;
      }
      int s = bits.huff(ac);
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
  }

  // decode_mcu_fast's block: the six-byte fills before each code and
  // before its extra bits.
  static void decode_block_fast(FastBits& f, int16_t* blk, const HuffTable& dc,
                                const HuffTable& ac, int* pred) {
    int s = f.huff(dc);
    if (s) {
      f.fill();
      s = extend(f.get(s), s);
    }
    *pred = static_cast<int>(static_cast<uint32_t>(*pred) + static_cast<uint32_t>(s));
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      f.fill();
      const int32_t fast = ac.fast_ac[f.look()];
      if (fast && f.n - ((fast >> 4) & 15) > 16) {  // no fill before its bits
        f.n -= ((fast >> 4) & 15) + (fast & 15);
        k += (fast >> 8) & 0xFF;
        blk[kNatural[k]] = static_cast<int16_t>(fast >> 16);
        continue;
      }
      s = f.huff(ac);
      const int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        f.fill();
        blk[kNatural[k]] = static_cast<int16_t>(extend(f.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // Header: SOI, then markers up to the first SOS.
  int read_header(int* ncomp, int idx[4]) {
    if (src.end - src.p < 2 || src.p[0] != 0xFF || src.p[1] != 0xD8) {
      return kNotJpeg;
    }
    // kLoadImage: PIL's JPEG plugin takes only files that start FF D8 FF;
    // any other goes to PIL (which refuses it), where libjpeg would skip
    // to the next marker.
    if (pil && (src.end - src.p < 3 || src.p[2] != 0xFF)) return kNotJpeg;
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
    single_pass = !progressive && ncomp == static_cast<int>(comps.size());
    for (auto& c : comps) {
      c.plane.assign(static_cast<size_t>(c.wib) * c.ds * c.hib * c.ds, 0);
      const int rows = !single_pass ? c.bh : (ncomp == 1 ? 1 : c.v);
      c.coef.assign(static_cast<size_t>(c.bw) * rows * 64, 0);
    }
    for (bool first = true;; first = false) {
      if (!first && single_pass) {
        return kCorrupt;  // JERR_EOI_EXPECTED: libjpeg ends a one-pass image
      }
      int rc = decode_scan(ncomp, idx);
      if (rc != kOk) return rc;
      scan_past_end = src.past_end;
      rc = read_markers(&ncomp, idx);
      if (rc == -2) break;
      if (rc != -1) return rc;
    }
    const bool smooth = progressive && smoothing_ok();
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      Component& c = comps[ci];
      if (!single_pass) {
        if (!c.latched) {
          // Never scanned: libjpeg leaves its coefficients zero, and its
          // quant table is latched at output time with the zeros it scales.
          for (int k = 0; k < 64; ++k) c.qt[k] = 0;
        }
        if (smooth) {
          smooth_rows(ci);
        } else {
          idct_rows(c, 0, c.hib);
        }
      }
      std::vector<int16_t>().swap(c.coef);
    }
    return kOk;
  }

  // jdcoefct.c's block smoothing (libjpeg-turbo 2.1), which a progressive
  // image gets where its scans left any of the first nine AC coefficients
  // of some component short of full precision: a file cut between scans,
  // or a scan script that never refines them. smoothing_ok latches each
  // component's coef_bits[0..9], and those from before its last scan.
  // setup() admits one, three or four components.
  int latch_now[4][10], latch_prev[4][10];

  bool smoothing_ok() {
    bool useful = false;
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      const Component& c = comps[ci];
      if (!c.latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24}) {
        if (c.qraw[pos] == 0) return false;  // no divide by zero
      }
      if (c.coef_bits[0] < 0) return false;  // no DC at all
      latch_now[ci][0] = c.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        latch_prev[ci][k] = scans > 1 ? c.prev_bits[k] : -1;
        latch_now[ci][k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // decompress_smooth_data for component ci: each block's IDCT on a copy
  // whose still-zero, imprecise low AC coefficients (and, where no AC
  // coefficient is known at all, its DC) are estimated from the DC values
  // of a 5 x 5 neighborhood of blocks.
  void smooth_rows(size_t ci) {
    Component& c = comps[ci];
    const int v = c.v;
    const int last_imcu = (height + 8 * max_v - 1) / (8 * max_v) - 1;
    const size_t stride = static_cast<size_t>(c.wib) * c.ds;
    const IdctFn idct = idct_for(c.ds);
    const int64_t q00 = c.qraw[0];
    auto dc = [&](int row, int col) -> int {
      return c.coef[(static_cast<size_t>(row) * c.bw + col) * 64];
    };
    for (int out_row = 0; out_row <= last_imcu; ++out_row) {
      int block_rows = v;
      if (out_row == last_imcu) {
        block_rows = c.hib % v;
        if (block_rows == 0) block_rows = v;
      }
      // The status before the last scan where that scan stopped short of
      // this row (a file cut inside it).
      const int* bits_of = out_row > last_good_imcu ? latch_prev[ci] : latch_now[ci];
      const bool change_dc = bits_of[1] == -1 && bits_of[2] == -1 && bits_of[3] == -1 &&
                             bits_of[4] == -1 && bits_of[5] == -1 && bits_of[6] == -1 &&
                             bits_of[7] == -1 && bits_of[8] == -1 && bits_of[9] == -1;
      for (int block_row = 0; block_row < block_rows; ++block_row) {
        const int g = out_row * v + block_row;
        const int prev = (block_row > 0 || out_row > 0) ? g - 1 : g;
        const int prev2 = (block_row > 1 || out_row > 1) ? g - 2 : prev;
        const int next = (block_row < block_rows - 1 || out_row < last_imcu) ? g + 1 : g;
        const int next2 =
            (block_row < block_rows - 2 || out_row + 1 < last_imcu) ? g + 2 : next;
        const int rows[5] = {prev2, prev, g, next, next2};
        // DC[r][0..4]: the sliding registers DC01-DC25 of jdcoefct.c, which
        // start as column 0 everywhere (narrow images keep some of that).
        int d[5][5];
        for (int r = 0; r < 5; ++r) {
          for (int k = 0; k < 5; ++k) d[r][k] = dc(rows[r], 0);
        }
        const int last_col = c.wib - 1;
        uint8_t* out = c.plane.data() + static_cast<size_t>(g) * c.ds * stride;
        for (int b = 0; b <= last_col; ++b) {
          int16_t ws[64];
          std::memcpy(ws, c.coef.data() + (static_cast<size_t>(g) * c.bw + b) * 64, sizeof(ws));
          if (b == 0 && b < last_col) {
            for (int r = 0; r < 5; ++r) d[r][3] = dc(rows[r], 1);
          }
          if (b + 1 < last_col) {
            for (int r = 0; r < 5; ++r) d[r][4] = dc(rows[r], b + 2);
          }
          smooth_block(ws, d, bits_of, change_dc, c.qraw, q00);
          idct(ws, c.qt, out + static_cast<size_t>(b) * c.ds, static_cast<int>(stride));
          for (int r = 0; r < 5; ++r) {
            for (int k = 0; k < 4; ++k) d[r][k] = d[r][k + 1];
          }
        }
      }
    }
  }

  // The estimates of one block. DCnn of jdcoefct.c is d[(nn - 1) / 5][(nn - 1) % 5].
  static void smooth_block(int16_t* ws, const int (&d)[5][5], const int* bits_of,
                           bool change_dc, const uint16_t* q, int64_t q00) {
#define DC(nn) int64_t{d[((nn) - 1) / 5][((nn) - 1) % 5]}
    auto estimate = [&](int bit, int pos, int64_t num) {
      const int a = bits_of[bit];
      if (a == 0 || ws[pos] != 0) return;
      const int64_t qk = q[pos];
      num *= q00;
      // (int) of the quotient, then the clamp to what Al leaves unknown.
      int64_t pred = to_int(((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8));
      if (a > 0 && pred >= (int64_t{1} << a)) pred = (int64_t{1} << a) - 1;
      ws[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
    };
    // AC01, AC10, AC20, AC11, AC02 (coef_bits 1-5).
    estimate(1, 1, change_dc ?
        -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) - 13 * DC(9) + 3 * DC(10) -
        3 * DC(11) + 38 * DC(12) - 38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
        13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25) :
        -7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15));
    estimate(2, 8, change_dc ?
        -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) + 13 * DC(7) +
        38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) - 13 * DC(17) - 38 * DC(18) -
        13 * DC(19) + DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25) :
        -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23));
    estimate(3, 16, change_dc ?
        DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) - 14 * DC(13) - 5 * DC(14) +
        2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23) :
        -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23));
    estimate(4, 9, change_dc ?
        -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) + DC(21) - DC(25) :
        DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) + DC(22) - DC(24) +
        DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9));
    estimate(5, 2, change_dc ?
        2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) - 14 * DC(13) + 7 * DC(14) +
        DC(15) + 2 * DC(17) - 5 * DC(18) + 2 * DC(19) :
        -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15));
    if (!change_dc) return;
    // AC03, AC12, AC21, AC30, then the DC itself.
    estimate(6, 3, DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19));
    estimate(7, 10, DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19));
    estimate(8, 17, DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19));
    estimate(9, 24, DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19));
    const int64_t num = q00 * (
        -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) - 6 * DC(6) + 6 * DC(7) +
        42 * DC(8) + 6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) + 152 * DC(13) +
        42 * DC(14) - 8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) + 6 * DC(19) -
        6 * DC(20) - 2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24) - 2 * DC(25));
    const int64_t pred = to_int(((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
    ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
#undef DC
  }

  // The IDCT of c's block rows from `first`, n of them (those inside the
  // image), read from c.coef's block rows from 0.
  void idct_rows(Component& c, int first, int n) {
    const size_t stride = static_cast<size_t>(c.wib) * c.ds;
    const IdctFn idct = idct_for(c.ds);
    for (int r = 0; r < n && first + r < c.hib; ++r) {
      uint8_t* dst = c.plane.data() + static_cast<size_t>(first + r) * c.ds * stride;
      const int16_t* src = c.coef.data() + static_cast<size_t>(r) * c.bw * 64;
      for (int bx = 0; bx < c.wib; ++bx) {
        idct(src + bx * 64, c.qt, dst + bx * c.ds, static_cast<int>(stride));
      }
    }
  }

  // How component c's samples reach image columns xs. jdsample.c's fancy
  // upsampling reads sample i and its neighbor nb with a rounding bias, and
  // at the edges the same formula holds with nb clamped to the edge sample
  // (h2v1: in[0], then (3 in[i] + in[i -+ 1] + 1 or 2) >> 2; h2v2:
  // (3 cs[i] + cs[i -+ 1] + 8 or 7) >> 4 on column sums cs of 3 rows).
  // Replication reads sample x / h_expand.
  struct Columns {
    std::vector<int> i, nb, bias;
  };

  Columns columns(const Component& c, const std::vector<int>& xs) const {
    Columns m;
    for (int x : xs) {
      if (c.up_h != kFancy) {
        m.i.push_back(x / c.hx);
        continue;
      }
      const int i = x >> 1;
      const bool odd = x & 1;
      m.i.push_back(i);
      m.nb.push_back(odd ? std::min(i + 1, c.dw - 1) : std::max(i - 1, 0));
      m.bias.push_back(c.up_v == kFancy ? (odd ? 7 : 8) : (odd ? 2 : 1));
    }
    return m;
  }

  // Component c's upsampled samples on image row y at the mapped columns.
  void component_row(const Component& c, const Columns& m, int y,
                     uint8_t* dst) const {
    const size_t stride = static_cast<size_t>(c.wib) * c.ds;
    const int n = static_cast<int>(m.i.size());
    if (c.up_v == kFancy) {
      // h1v2 and h2v2: the row above for an even output row, below for an
      // odd one, the edge rows repeated (jdmainct.c's context rows).
      const int r = y / 2;
      const int r1 = std::min(std::max((y & 1) ? r + 1 : r - 1, 0), c.dh - 1);
      const uint8_t* in0 = c.plane.data() + static_cast<size_t>(r) * stride;
      const uint8_t* in1 = c.plane.data() + static_cast<size_t>(r1) * stride;
      if (c.up_h == kFancy) {
        for (int j = 0; j < n; ++j) {
          const int cs = in0[m.i[j]] * 3 + in1[m.i[j]];
          const int cn = in0[m.nb[j]] * 3 + in1[m.nb[j]];
          dst[j] = static_cast<uint8_t>((cs * 3 + cn + m.bias[j]) >> 4);
        }
      } else {
        const int bias = (y & 1) ? 2 : 1;
        for (int j = 0; j < n; ++j) {
          dst[j] = static_cast<uint8_t>((in0[m.i[j]] * 3 + in1[m.i[j]] + bias) >> 2);
        }
      }
      return;
    }
    const uint8_t* in0 = c.plane.data() + static_cast<size_t>(y / c.vx) * stride;
    if (c.up_h == kFancy) {
      for (int j = 0; j < n; ++j) {
        dst[j] = static_cast<uint8_t>((in0[m.i[j]] * 3 + in0[m.nb[j]] + m.bias[j]) >> 2);
      }
    } else {
      for (int j = 0; j < n; ++j) dst[j] = in0[m.i[j]];
    }
  }

  // Image row y at the mapped columns as RGB (3 bytes a column); tmp holds
  // four rows of samples. Gray is replicated, RGB-coded samples copied
  // (rgb_rgb_convert), YCbCr converted with jdcolor.c's tables, CMYK and
  // YCCK as cmyk_row says.
  void rgb_row(int y, const Columns* m, uint8_t* out, uint8_t* tmp) const {
    const int n = static_cast<int>(m[0].i.size());
    if (comps.size() == 1) {
      component_row(comps[0], m[0], y, tmp);
      for (int j = 0; j < n; ++j) out[3 * j] = out[3 * j + 1] = out[3 * j + 2] = tmp[j];
      return;
    }
    uint8_t* c0 = tmp;
    uint8_t* c1 = tmp + n;
    uint8_t* c2 = tmp + 2 * n;
    component_row(comps[0], m[0], y, c0);
    component_row(comps[1], m[1], y, c1);
    component_row(comps[2], m[2], y, c2);
    if (comps.size() == 4) {
      component_row(comps[3], m[3], y, tmp + 3 * n);
      cmyk_row(c0, c1, c2, tmp + 3 * n, n, out);
      return;
    }
    if (rgb) {
      for (int j = 0; j < n; ++j) {
        out[3 * j] = c0[j];
        out[3 * j + 1] = c1[j];
        out[3 * j + 2] = c2[j];
      }
      return;
    }
    const Tables& t = kTables;
    for (int j = 0; j < n; ++j) {
      const int Y = c0[j], B = c1[j], R = c2[j];
      out[3 * j] = clamp255(Y + t.cr_r[R]);
      out[3 * j + 1] = clamp255(Y + static_cast<int>((t.cb_g[B] + t.cr_g[R]) >> 16));
      out[3 * j + 2] = clamp255(Y + t.cb_b[B]);
    }
  }

  // Four components as PIL reads them: libjpeg's JCS_CMYK output
  // (ycck_cmyk_convert: YCC -> RGB with jdcolor.c's tables, each subtracted
  // from 255 through the range limit, K passed through), Pillow's raw mode
  // CMYK;I, which inverts every byte (its JPEG plugin takes Adobe's
  // polarity for every CMYK file), then Pillow's cmyk2rgb:
  // nk - nk * x / 255 rounded as MULDIV255, nk = 255 - K.
  void cmyk_row(const uint8_t* c0, const uint8_t* c1, const uint8_t* c2,
                const uint8_t* c3, int n, uint8_t* out) const {
    const Tables& t = kTables;
    for (int j = 0; j < n; ++j) {
      int cmy[3] = {c0[j], c1[j], c2[j]};
      if (ycck) {
        const int Y = c0[j], B = c1[j], R = c2[j];
        cmy[0] = clamp255(255 - (Y + t.cr_r[R]));
        cmy[1] = clamp255(255 - (Y + static_cast<int>((t.cb_g[B] + t.cr_g[R]) >> 16)));
        cmy[2] = clamp255(255 - (Y + t.cb_b[B]));
      }
      const int nk = c3[j];  // 255 - (255 - K)
      for (int k = 0; k < 3; ++k) {
        const int tmp = (255 - cmy[k]) * nk + 128;
        out[3 * j + k] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
      }
    }
  }
};

// Nearest-neighbor index with the PIL center convention (as tpucap).
inline int nearest_index(int dst, int dst_size, int src_size) {
  double scale = static_cast<double>(src_size) / dst_size;
  int idx = static_cast<int>((dst + 0.5) * scale);
  return std::min(idx, src_size - 1);
}

// The indices of Pillow's NEAREST resize (ImagingScaleAffine): the same
// centers, summed step by step in double, so that near a sample edge the
// sum can land on the other side of it than (i + 0.5) * scale (40 -> 60
// takes row 2 for row 4, where nearest_index takes row 3).
std::vector<int> pil_nearest(int dst_size, int src_size) {
  const double a = static_cast<double>(src_size) / dst_size;
  std::vector<int> idx(dst_size);
  double xo = a * 0.5;
  for (int i = 0; i < dst_size; ++i, xo += a) {
    idx[i] = std::min(static_cast<int>(xo), src_size - 1);
  }
  return idx;
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
               uint8_t* out, int flags) {
  Decoder d(data, size);
  d.pil = flags & kLoadImage;
  int ncomp = 0, idx[4] = {0, 0, 0, 0};
  int rc = d.read_header(&ncomp, idx);
  if (rc != kOk) return rc;
  if ((flags & kFastScale) && target_h > 0 && target_w > 0) {
    const int n = scale_num(d.height, d.width, target_h, target_w);
    if (n != 8 && (rc = d.choose_scale(n)) != kOk) return rc;
  }
  rc = d.decode_scans(ncomp, idx);
  if (rc != kOk) return rc;
  // PIL's source suspends where jpeg_mem_src would feed a fake EOI, and
  // load_image raises "image file is truncated" unless every row was out
  // by then: only a single-pass image's search for EOI may run out.
  if (d.pil && (d.single_pass ? d.scan_past_end : d.src.past_end) > 0) return kTruncated;

  // Without a resize every row and column; with one (the nearest, PIL
  // convention), only the rows and columns it samples.
  const int sw = d.out_w, sh = d.out_h;
  const bool same = target_h <= 0 || target_w <= 0 ||
                    (sh == target_h && sw == target_w);
  const int th = same ? sh : target_h, tw = same ? sw : target_w;
  std::vector<int> xs(tw), ys(th);
  if (!same && d.pil) {
    xs = pil_nearest(tw, sw);
    ys = pil_nearest(th, sh);
  } else {
    for (int j = 0; j < tw; ++j) xs[j] = same ? j : nearest_index(j, tw, sw);
    for (int i = 0; i < th; ++i) ys[i] = same ? i : nearest_index(i, th, sh);
  }
  std::vector<Decoder::Columns> maps;
  for (const auto& c : d.comps) maps.push_back(d.columns(c, xs));
  std::vector<uint8_t> tmp(4 * static_cast<size_t>(tw));
  const size_t row_bytes = static_cast<size_t>(tw) * 3;
  int have = -1;
  for (int i = 0; i < th; ++i) {
    const int sy = ys[i];
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
// hardware concurrency). `flags`: kFastScale (1) picks tpucap's scale
// N / 8; kLoadImage (2) gives tpucap's load_image bytes (PIL): CMYK and
// YCCK admitted and converted as Pillow converts them, Pillow's NEAREST
// resize. Returns the number of failed images.
int tpucap_decode_jpeg_batch(const uint8_t* data, const int64_t* offsets,
                             const int64_t* sizes, int n, int target_h,
                             int target_w, uint8_t* out, int* status,
                             int n_threads, int flags) {
  const size_t img_bytes = static_cast<size_t>(target_h) * target_w * 3;
  return run_pool(n, n_threads, status, [&](int i) {
    return decode_one(data + offsets[i], static_cast<size_t>(sizes[i]),
                      target_h, target_w, out + img_bytes * i, flags);
  });
}

// The same from n files, each read by the worker that decodes it.
int tpucap_decode_jpeg_files(const char* const* paths, int n, int target_h,
                             int target_w, uint8_t* out, int* status,
                             int n_threads, int flags) {
  const size_t img_bytes = static_cast<size_t>(target_h) * target_w * 3;
  return run_pool(n, n_threads, status, [&](int i) {
    std::vector<uint8_t> buf;
    if (!read_file(paths[i], &buf)) return static_cast<int>(kUnreadable);
    return decode_one(buf.data(), buf.size(), target_h, target_w,
                      out + img_bytes * i, flags);
  });
}

// A JPEG's dimensions, from its header up to the first scan. Returns 0 on
// success, else a Status code.
int tpucap_jpeg_dims(const uint8_t* data, int64_t size, int* h, int* w) {
  Decoder d(data, static_cast<size_t>(size));
  d.pil = true;  // a CMYK header reads, as jpeg_read_header reads it
  int ncomp = 0, idx[4] = {0, 0, 0, 0};
  int rc = d.read_header(&ncomp, idx);
  if (rc != kOk) return rc;
  *h = d.height;
  *w = d.width;
  return 0;
}

// n blocks (64 coefficients each, natural order) through the IDCT that a
// component of DCT_scaled_size `size` takes, with one quantization table
// (64 entries, natural order, as libjpeg's dct_table holds it); block i's
// size x size samples at out + i * size * size. Returns -1 for a size
// libjpeg has no IDCT for. For tests against libjpeg's own functions.
int tpucap_jpeg_idct(int size, const int16_t* coef, const int16_t* qt, int n,
                     uint8_t* out) {
  const IdctFn fn = idct_for(size);
  if (fn == nullptr) return -1;
  for (int i = 0; i < n; ++i) fn(coef + 64 * i, qt, out + i * size * size, size);
  return 0;
}

}  // extern "C"
