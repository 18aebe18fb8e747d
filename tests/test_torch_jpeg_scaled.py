"""The port's JPEG decoder at tpucap's default ``fast_scale=True``: every
scale N/8 that tpucap's scale search picks, against tpucap's libjpeg-turbo
decode (``tpucap.ops.jpeg.decode_jpeg_batch``) on the CPU.

Tolerance: none. Every decoded byte must equal tpucap's; on corrupt data the
port must refuse exactly the images libjpeg refuses. The scaled IDCTs are
also held, block by block, to libjpeg's own functions (the SIMD dispatch
tpucap's library makes), linked from this host's static ``libjpeg.a``.
"""

import ctypes
import struct
import subprocess

import numpy as np
import pytest
import torch
from PIL import ImageFile
from test_torch_jpeg import SAMPLING, encode, fixtures_script, make_image

from tpucap.ops import jpeg as jax_jpeg
from tpucap_torch import _build
from tpucap_torch.ops import jpeg

torch.set_num_threads(2)
# PIL's optimized-table encoder needs the whole file in one buffer.
ImageFile.MAXBLOCK = 1 << 22

# One block through the IDCT libjpeg-turbo selects for a DCT_scaled_size
# (jddctmgr.c with the SIMD build's choices): stdin holds int size, int n,
# short qt[64], short coef[n][64]; stdout gets n * size * size samples.
IDCT_REF_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

typedef void (*idct_fn)(j_decompress_ptr, jpeg_component_info *, JCOEFPTR, JSAMPARRAY, JDIMENSION);
#define DECL(name) extern void name(j_decompress_ptr, jpeg_component_info *, JCOEFPTR, JSAMPARRAY, JDIMENSION)
DECL(jpeg_idct_1x1); DECL(jpeg_idct_3x3); DECL(jpeg_idct_5x5); DECL(jpeg_idct_6x6);
DECL(jpeg_idct_7x7); DECL(jpeg_idct_10x10); DECL(jpeg_idct_12x12); DECL(jpeg_idct_14x14);
DECL(jpeg_idct_2x2); DECL(jpeg_idct_4x4); DECL(jpeg_idct_islow);
DECL(jsimd_idct_2x2); DECL(jsimd_idct_4x4); DECL(jsimd_idct_islow);
extern int jsimd_can_idct_2x2(void), jsimd_can_idct_4x4(void), jsimd_can_idct_islow(void);

int main(void) {
  int hdr[2];
  short qt[64];
  if (fread(hdr, sizeof(int), 2, stdin) != 2 || fread(qt, 2, 64, stdin) != 64) return 2;
  int size = hdr[0], n = hdr[1];
  short *coef = malloc((size_t)n * 128);
  if (fread(coef, 128, n, stdin) != (size_t)n) return 3;
  /* prepare_range_limit_table (jdmaster.c) */
  static JSAMPLE mem[5 * 256 + 128];
  JSAMPLE *table = mem + 256;
  for (int i = 0; i < 256; i++) table[i] = (JSAMPLE)i;
  struct jpeg_decompress_struct cinfo;
  jpeg_component_info comp;
  memset(&cinfo, 0, sizeof(cinfo));
  memset(&comp, 0, sizeof(comp));
  cinfo.sample_range_limit = table;
  table += 128;
  for (int i = 128; i < 512; i++) table[i] = 255;
  memcpy(table + 1024 - 128, cinfo.sample_range_limit, 128);
  comp.dct_table = qt;
  idct_fn fn;
  switch (size) {
    case 1: fn = jpeg_idct_1x1; break;
    case 2: fn = jsimd_can_idct_2x2() ? jsimd_idct_2x2 : jpeg_idct_2x2; break;
    case 3: fn = jpeg_idct_3x3; break;
    case 4: fn = jsimd_can_idct_4x4() ? jsimd_idct_4x4 : jpeg_idct_4x4; break;
    case 5: fn = jpeg_idct_5x5; break;
    case 6: fn = jpeg_idct_6x6; break;
    case 7: fn = jpeg_idct_7x7; break;
    case 8: fn = jsimd_can_idct_islow() ? jsimd_idct_islow : jpeg_idct_islow; break;
    case 10: fn = jpeg_idct_10x10; break;
    case 12: fn = jpeg_idct_12x12; break;
    case 14: fn = jpeg_idct_14x14; break;
    default: return 4;
  }
  JCOEF blk[64] __attribute__((aligned(16)));
  JSAMPLE buf[16][16] __attribute__((aligned(16)));
  JSAMPROW rows[16];
  for (int r = 0; r < 16; r++) rows[r] = buf[r];
  for (int i = 0; i < n; i++) {
    memcpy(blk, coef + 64 * i, sizeof(blk));
    fn(&cinfo, &comp, blk, rows, 0);
    for (int r = 0; r < size; r++) fwrite(buf[r], 1, size, stdout);
  }
  return 0;
}
"""

IDCT_SIZES = [1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14]


def compile_c(source, out, *args):
    src = out.with_suffix(".c")
    src.write_text(source)
    subprocess.run(["gcc", "-O2", "-o", str(out), str(src), *args], check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def compress(tmp_path_factory):
    """compress(image, ...) -> JPEG bytes through this host's libjpeg
    (``scripts/make_torch_jpeg_fixtures.py``'s compressor)."""
    return fixtures_script.libjpeg_compressor(tmp_path_factory.mktemp("cjpeg"))


@pytest.fixture(scope="module")
def idct_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("idct")
    static = subprocess.run(["gcc", "-print-file-name=libjpeg.a"], capture_output=True,
                            text=True).stdout.strip()
    exe = compile_c(IDCT_REF_C, d / "idct_ref", static)

    def run(size, coef, qt):
        data = struct.pack("2i", size, len(coef)) + qt.astype(np.int16).tobytes()
        proc = subprocess.run([str(exe)], input=data + coef.astype(np.int16).tobytes(),
                              capture_output=True, check=True)
        return np.frombuffer(proc.stdout, np.uint8).reshape(len(coef), size, size)

    return run


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The decoder as the port builds it, and its scalar-IDCT build."""
    so = tmp_path_factory.mktemp("scalar") / "jpeg_decode_scalar.so"
    cmd = ["g++", *_build.HOST_FLAGS, "-DTPUCAP_JPEG_SCALAR", "-o", str(so),
           str(_build.CSRC / "jpeg_decode.cpp")]
    subprocess.run(cmd, check=True, capture_output=True)
    return {"sse2": _build.build_host("jpeg_decode"), "scalar": ctypes.CDLL(str(so))}


def port_idct(lib, size, coef, qt):
    coef = np.ascontiguousarray(coef, np.int16)
    qt = np.ascontiguousarray(qt, np.int16)
    out = np.zeros((len(coef), size, size), np.uint8)
    ptr = ctypes.c_void_p
    rc = lib.tpucap_jpeg_idct(size, ptr(coef.ctypes.data), ptr(qt.ctypes.data), len(coef),
                              ptr(out.ctypes.data))
    assert rc == 0
    return out


def idct_blocks(kind, rng, n=4000):
    """Coefficient blocks and one table: as an encoder writes them, and
    corrupt ones (any int16, tables of a 16-bit DQT above 32767 included)."""
    c = np.zeros((n, 64), np.int64)
    if kind == "valid":
        c[:, 0] = rng.integers(-128, 128, n)
        np.put_along_axis(c, rng.integers(1, 64, (n, 6)), rng.integers(-40, 41, (n, 6)), 1)
        q = rng.integers(1, 30, 64)
    elif kind == "dc_only":
        c[:, 0] = rng.integers(-32768, 32768, n)
        q = rng.integers(-32768, 32768, 64)
    elif kind == "sparse":
        np.put_along_axis(c, rng.integers(0, 64, (n, 3)), rng.integers(-32768, 32768, (n, 3)), 1)
        q = rng.integers(-32768, 32768, 64)
    elif kind == "dense":
        c = rng.integers(-2000, 2000, (n, 64)) * (rng.random((n, 64)) < 0.3)
        q = rng.integers(1, 256, 64)
    else:
        c = rng.integers(-32768, 32768, (n, 64))
        q = rng.integers(-32768, 32768, 64)
    return c, q


@pytest.mark.parametrize("kind", ["valid", "dense", "dc_only", "sparse", "extreme"])
def test_scaled_idcts_match_libjpegs_own(idct_ref, builds, kind):
    """Each DCT_scaled_size's IDCT, SSE2 and scalar builds, against the
    function libjpeg-turbo dispatches to for it: the SSE2 2x2 / 4x4 and
    islow, jidctint.c's 3x3-14x14 (whose range limit wraps), on valid and
    on corrupt, high-energy blocks, where the SSE2 forms saturate."""
    rng = np.random.default_rng(IDCT_SIZES[len(kind) % len(IDCT_SIZES)] + len(kind))
    coef, qt = idct_blocks(kind, rng)
    for size in IDCT_SIZES:
        want = idct_ref(size, coef, qt)
        for name, lib in builds.items():
            got = port_idct(lib, size, coef, qt)
            bad = np.nonzero((got != want).reshape(len(coef), -1).any(1))[0]
            assert not len(bad), f"{name} {size}x{size}: {len(bad)} blocks differ, first {bad[0]}"


def scale_targets(h, w):
    """{N: a square target for which tpucap's search picks N / 8}."""
    found = {}
    for size in range(1, max(h, w) + 2):
        found.setdefault(jpeg.scale_num(h, w, size), size)
    return found


def assert_scaled_decodes(blob, h, w, extra=()):
    """Port == tpucap at each scale tpucap's search picks for this image."""
    for n, size in sorted(scale_targets(h, w).items()) + [(None, s) for s in extra]:
        want = jax_jpeg.decode_jpeg_batch([blob], size)
        got = jpeg.decode_jpeg_batch([blob], size, n_threads=1)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} -> {size} (scale {n}/8)")


# 1 x 1 and widths whose chroma is 1-3 samples wide, odd sides, a photo.
PIL_SIZES = [(1, 1), (2, 5), (5, 3), (9, 6), (13, 29), (40, 33), (75, 100), (375, 500)]


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", PIL_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_every_scale_matches_libjpeg(hw, sampling):
    """PIL's samplings (4:2:0 chroma IDCT'd at 2N without upsampling,
    4:2:2 chroma at N and upsampled, 1/8 replicated) at every scale, plain,
    with optimized tables and with restarts."""
    h, w = hw
    rng = np.random.default_rng(h * 1000 + w)
    for q, opts in [(35, {}), (90, {"optimize": True}), (75, {"restart_marker_blocks": 1})]:
        blob = encode(make_image(rng, h, w, gray=sampling == "gray"), q, SAMPLING[sampling], **opts)
        assert_scaled_decodes(blob, h, w)


def test_scaled_batch_of_mixed_images():
    """One threaded call whose images take different scales."""
    rng = np.random.default_rng(31)
    blobs = [encode(make_image(rng, h, w, gray=s == "gray"), 80, SAMPLING[s])
             for (h, w), s in zip([(64, 48), (120, 200), (33, 17), (375, 500), (300, 90)],
                                  ["420", "422", "444", "gray", "420"])]
    np.testing.assert_array_equal(jpeg.decode_jpeg_batch(blobs, 30, n_threads=3),
                                  jax_jpeg.decode_jpeg_batch(blobs, 30))


def test_scaled_corrupt_and_truncated_data_follow_libjpeg():
    """Truncated and corrupted files decoded at 1/8-4/8: the same images
    refused, the same bytes where both decode."""
    rng = np.random.default_rng(37)
    bases = [encode(make_image(rng, 80, 120), 85, s, **opts)
             for s in (0, 1, 2) for opts in ({}, {"restart_marker_blocks": 2})]
    decoded = refused = 0
    for trial in range(150):
        blob = bytearray(bases[trial % len(bases)])
        kind = trial % 3
        if kind == 0:
            blob = blob[: rng.integers(1, len(blob))]
        else:
            start = bytes(blob).index(b"\xff\xda") + 14 if kind == 2 else 0
            for _ in range(rng.integers(1, 4)):
                blob[rng.integers(start, len(blob) - 2)] = rng.integers(0, 256)
        blob = bytes(blob)
        size = [10, 20, 30, 40][trial % 4]
        try:
            want = jax_jpeg.decode_jpeg_batch([blob], size)
        except ValueError:
            with pytest.raises(ValueError):
                jpeg.decode_jpeg_batch([blob], size)
            refused += 1
            continue
        np.testing.assert_array_equal(jpeg.decode_jpeg_batch([blob], size), want)
        decoded += 1
    assert decoded > 80 and refused > 5


def photo(rng, h, w):
    """Smooth color with noise, as test_torch_jpeg.make_image, as an array."""
    return np.asarray(make_image(rng, h, w))


# Sampling factors (Y, Cb, Cr) that only libjpeg writes; the first two are
# 4:4:0 and 4:1:1, then 3:1 and others whose ratios are integral.
HELPER_SAMPLINGS = {
    "440": "1x2,1x1,1x1",
    "411": "4x1,1x1,1x1",
    "31": "3x1,1x1,1x1",
    "13": "1x3,1x1,1x1",
    "42": "4x2,1x1,1x1",
    "22_12": "2x2,1x2,1x2",
    "22_12_11": "2x2,1x2,1x1",
    "32": "3x2,1x1,1x1",
}
HELPER_SIZES = [(1, 1), (3, 5), (7, 2), (17, 11), (40, 71), (96, 130)]


@pytest.mark.parametrize("sampling", list(HELPER_SAMPLINGS))
@pytest.mark.parametrize("hw", HELPER_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_other_samplings_match_libjpeg(compress, hw, sampling):
    """4:4:0 through h1v2_fancy_upsample (its context rows as h2v2's),
    4:1:1, 3:1 and other integral ratios through int_upsample, at every
    scale, at the image's own size, and with restarts."""
    h, w = hw
    rng = np.random.default_rng(h * 7 + w)
    for q, restart in [(40, 0), (92, 1)]:
        blob = compress(photo(rng, h, w), q, HELPER_SAMPLINGS[sampling], restart=restart)
        assert_scaled_decodes(blob, h, w, extra=[max(h, w) + 3])
        np.testing.assert_array_equal(jpeg.decode_jpeg(blob), native(blob, h, w))


def native(blob, h, w):
    return fixtures_script.tpucap_native(blob, h, w)


@pytest.mark.parametrize("sampling", ["1x1,1x1,1x1", "2x2,1x1,1x1", "2x1,1x1,1x1", "1x2,1x1,1x1"])
def test_rgb_coded_images_match_libjpeg(compress, sampling):
    """Three components with jpeg_color_space RGB: the Adobe marker's
    transform 0, or component IDs 'R', 'G', 'B' with neither JFIF nor
    Adobe; samples copied (rgb_rgb_convert), at every scale."""
    rng = np.random.default_rng(41)
    for h, w in [(1, 1), (13, 22), (64, 50)]:
        blob = compress(photo(rng, h, w), 80, sampling, color="rgb")
        assert b"Adobe" in blob and b"JFIF" not in blob
        assert_scaled_decodes(blob, h, w)
        i = blob.index(b"\xff\xee")
        plain = blob[:i] + blob[i + 2 + int.from_bytes(blob[i + 2 : i + 4], "big"):]
        assert b"Adobe" not in plain and b"\x03R" in plain
        assert_scaled_decodes(plain, h, w)
        np.testing.assert_array_equal(jpeg.decode_jpeg(plain), native(plain, h, w))


def with_sampling(blob, factors):
    """The JPEG with its SOF0 component sampling bytes replaced."""
    i = blob.index(b"\xff\xc0") + 10
    out = bytearray(blob)
    for k, hv in enumerate(factors):
        out[i + 3 * k + 1] = hv
    return bytes(out)


def test_fractional_sampling_is_refused_as_libjpeg_refuses_it(compress):
    """Y 3x1 with chroma 2x1 has no integral upsampling ratio:
    JERR_FRACT_SAMPLE_NOTIMPL in libjpeg, a ValueError naming the sampling
    in the port, at every scale."""
    blob = with_sampling(compress(photo(np.random.default_rng(43), 32, 48), 80, "1x1,1x1,1x1"),
                         [0x31, 0x21, 0x21])
    for size in (4, 24, 48):
        with pytest.raises(ValueError):
            jax_jpeg.decode_jpeg_batch([blob], size)
        with pytest.raises(ValueError, match="chroma sampling"):
            jpeg.decode_jpeg_batch([blob], size)


def test_arithmetic_coding_is_refused_naming_it(compress):
    """Arithmetic-coded JPEGs (SOF9 sequential, SOF10 progressive), refused
    by the port until it decoded them: the same files now give tpucap's
    libjpeg-turbo bytes at every scale (tests/test_torch_jpeg_arith.py
    holds the rest)."""
    img = photo(np.random.default_rng(61), 20, 30)
    for scans, marker in [("0", b"\xff\xc9"), ("1", b"\xff\xca")]:
        blob = compress(img, 80, arith=True, scans=scans)
        assert marker in blob
        assert jax_jpeg.decode_jpeg_batch([blob], 16).shape == (1, 16, 16, 3)
        assert_scaled_decodes(blob, 20, 30)
