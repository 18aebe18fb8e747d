"""The port's own JPEG decoder (``tpucap_torch/csrc/jpeg_decode.cpp`` through
``tpucap_torch.ops.jpeg``) against tpucap's libjpeg-turbo decode
(``tpucap.ops.jpeg``, ``fast_scale=False``), on JPEGs that PIL encodes from
seeded numpy images.

Tolerance: none. Every decoded byte must equal tpucap's, at the image's own
size and after the nearest resize to smaller and larger targets; on
truncated and corrupted data the port must accept and refuse the same
images as libjpeg and give the same bytes where both decode.
"""

import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tpucap.ops import jpeg as jax_jpeg
from tpucap_torch import _build
from tpucap_torch.ops import jpeg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "torch_jpeg"
_spec = importlib.util.spec_from_file_location(
    "make_torch_jpeg_fixtures", ROOT / "scripts" / "make_torch_jpeg_fixtures.py"
)
fixtures_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures_script)

# 3 x 4: chroma 2 wide at 4:2:2 and 4:2:0, where libjpeg replicates.
SIZES = [(1, 1), (3, 4), (7, 9), (8, 8), (15, 17), (16, 16), (33, 65), (96, 80)]
SAMPLING = {"444": 0, "422": 1, "420": 2, "gray": None}
QUALITIES = [30, 75, 95, 100]
OPTIONS = [{}, {"optimize": True}, {"restart_marker_blocks": 2}]


def make_image(rng, h, w, gray=False):
    """A smooth gradient with noise, so every block has AC terms."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / max(w, 1), y * 255 / max(h, 1), (x + y) * 7 % 256], -1)
    img = np.clip(base + rng.normal(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)
    im = Image.fromarray(img)
    return im.convert("L") if gray else im


def encode(im, quality, sampling, **opts):
    buf = io.BytesIO()
    if sampling is not None:
        opts["subsampling"] = sampling
    im.save(buf, "JPEG", quality=quality, **opts)
    return buf.getvalue()


def assert_same_decode(blob, targets):
    """Port == tpucap at the image's own size and at each square target."""
    h, w = jpeg.jpeg_dims(blob)
    with Image.open(io.BytesIO(blob)) as im:
        assert im.size == (w, h)
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(blob), fixtures_script.tpucap_native(blob, h, w)
    )
    for size in targets:
        np.testing.assert_array_equal(
            jpeg.decode_jpeg_batch([blob], size, fast_scale=False, n_threads=1),
            jax_jpeg.decode_jpeg_batch([blob], size, fast_scale=False),
        )


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decode_matches_libjpeg(hw, sampling):
    """Each size and sampling at every quality, plain, with optimized
    Huffman tables and with restart markers; at native size, shrunk and
    enlarged."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    h, w = hw
    targets = sorted({max(1, min(h, w) // 2), max(h, w) + 3, 24})
    for q in QUALITIES:
        for opts in OPTIONS:
            im = make_image(rng, h, w, gray=sampling == "gray")
            assert_same_decode(encode(im, q, SAMPLING[sampling], **opts), targets)


def test_batch_of_mixed_images_matches_libjpeg():
    """One call, several threads, images of every kind in one batch."""
    rng = np.random.default_rng(3)
    blobs = [
        encode(make_image(rng, h, w, gray=s == "gray"), q, SAMPLING[s])
        for (h, w), s, q in zip(SIZES, ["420", "422", "444", "gray"] * 2, QUALITIES * 2)
    ]
    np.testing.assert_array_equal(
        jpeg.decode_jpeg_batch(blobs, 40, fast_scale=False, n_threads=3),
        jax_jpeg.decode_jpeg_batch(blobs, 40, fast_scale=False),
    )


@settings(max_examples=40, deadline=None)
@given(
    h=st.integers(1, 72),
    w=st.integers(1, 72),
    sampling=st.sampled_from(list(SAMPLING)),
    quality=st.integers(1, 100),
    optimize=st.booleans(),
    restart=st.integers(0, 3),
    size=st.integers(1, 90),
    seed=st.integers(0, 2**16),
    progressive=st.booleans(),
    fast_size=st.integers(1, 72),
)
def test_decode_matches_libjpeg_hypothesis(h, w, sampling, quality, optimize, restart, size, seed,
                                           progressive, fast_size):
    """Baseline or progressive, at full scale and at the scale tpucap's
    fast_scale search picks for a target up to the image's size."""
    im = make_image(np.random.default_rng(seed), h, w, gray=sampling == "gray")
    opts = {"optimize": optimize, "progressive": progressive}
    if restart:
        opts["restart_marker_blocks"] = restart
    blob = encode(im, quality, SAMPLING[sampling], **opts)
    assert_same_decode(blob, [size])
    np.testing.assert_array_equal(jpeg.decode_jpeg_batch([blob], fast_size),
                                  jax_jpeg.decode_jpeg_batch([blob], fast_size))


def test_corrupt_and_truncated_data_follow_libjpeg():
    """Truncated files, flipped bytes anywhere and flipped bytes in the scan:
    the port refuses exactly the images libjpeg refuses, and where both
    decode (libjpeg's zero fill and restart resync) the bytes agree."""
    rng = np.random.default_rng(11)
    bases = [
        encode(make_image(rng, 37, 53), 80, s, **opts)
        for s in (0, 1, 2)
        for opts in ({}, {"restart_marker_blocks": 1}, {"restart_marker_blocks": 3})
    ]
    decoded = refused = 0
    for trial in range(240):
        blob = bytearray(bases[trial % len(bases)])
        kind = trial % 3
        if kind == 0:
            blob = blob[: rng.integers(1, len(blob))]
        else:
            start = bytes(blob).index(b"\xff\xda") + 14 if kind == 2 else 0
            for _ in range(rng.integers(1, 4)):
                blob[rng.integers(start, len(blob) - 2)] = rng.integers(0, 256)
        blob = bytes(blob)
        try:
            want = jax_jpeg.decode_jpeg_batch([blob], 40, fast_scale=False)
        except ValueError:
            with pytest.raises(ValueError):
                jpeg.decode_jpeg_batch([blob], 40, fast_scale=False)
            refused += 1
            continue
        np.testing.assert_array_equal(jpeg.decode_jpeg_batch([blob], 40, fast_scale=False), want)
        decoded += 1
    assert decoded > 100 and refused > 20


def test_missing_huffman_tables_take_the_standard_ones():
    """libjpeg-turbo fills DHT slots 0 and 1 that a file never defines with
    the tables of the standard (Motion-JPEG frames omit them)."""
    blob = encode(make_image(np.random.default_rng(5), 20, 30), 75, 2)
    out, i = bytearray(blob[:2]), 2
    while blob[i + 1] != 0xDA:
        n = (blob[i + 2] << 8) | blob[i + 3]
        if blob[i + 1] != 0xC4:
            out += blob[i : i + 2 + n]
        i += 2 + n
    stripped = bytes(out + blob[i:])
    assert b"\xff\xc4" not in stripped[:i]
    assert_same_decode(stripped, [16])


# Zig-zag position -> natural index (row-major 8 x 8).
ZIGZAG = [8 * y + x for _, _, y, x in sorted(
    (x + y, y if (x + y) % 2 else -y, y, x) for y in range(8) for x in range(8))]
# Huffman tables for the hand-made files: every DC size a 4-bit code, every
# AC symbol (EOB, ZRL, run/size) an 8-bit code, codes in symbol order.
AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
AC_CODE = {sym: i for i, sym in enumerate(AC_SYMBOLS)}


class BitWriter:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, v, k):
        self.acc = (self.acc << k) | (v & ((1 << k) - 1))
        self.n += k
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out += bytes([b, 0]) if b == 0xFF else bytes([b])
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def encode_block(bits, zz, pred):
    """One block's coefficients (zig-zag order) with baseline Huffman
    coding; returns its DC, the next predictor."""
    zz = [int(v) for v in zz]
    diff = zz[0] - pred
    size = abs(diff).bit_length()
    bits.put(size, 4)
    bits.put(diff if diff > 0 else diff - 1, size)
    run = 0
    for v in zz[1:]:
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(AC_CODE[0xF0], 8)
            run -= 16
        size = abs(v).bit_length()
        bits.put(AC_CODE[(run << 4) | size], 8)
        bits.put(v if v > 0 else v - 1, size)
        run = 0
    if run:
        bits.put(AC_CODE[0x00], 8)
    return zz[0]


def segment(marker, payload):
    return bytes([0xFF, marker, (len(payload) + 2) >> 8, (len(payload) + 2) & 0xFF]) + payload


def handmade_jpeg(rng, h, w, scans):
    """A baseline 4:2:0 YCbCr JPEG of random coefficients, its components
    coded in the given scans (lists of component indices): one scan of all
    three is what encoders write; several scans are baseline JPEG too, and
    libjpeg then buffers every coefficient of the image."""
    def ceil_div(a, b):
        return -(-a // b)

    sampling = [(2, 2), (1, 1), (1, 1)]
    mcux, mcuy = ceil_div(w, 16), ceil_div(h, 16)
    coef = []
    for ch, cv in sampling:
        blocks = np.zeros((mcuy * cv, mcux * ch, 64), np.int64)
        blocks[..., 0] = rng.integers(-60, 61, blocks.shape[:2])
        low = rng.integers(-6, 7, (*blocks.shape[:2], 9)) * (rng.random((*blocks.shape[:2], 9)) < 0.5)
        blocks[..., 1:10] = low
        far = rng.integers(20, 64, blocks.shape[:2])  # a long run: ZRL codes
        np.put_along_axis(blocks, far[..., None], rng.integers(-3, 4, (*blocks.shape[:2], 1)), -1)
        coef.append(blocks)
    dht = (bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
           + bytes([0x10]) + bytes([0] * 7 + [len(AC_SYMBOLS)] + [0] * 8) + bytes(AC_SYMBOLS))
    sof = bytes([8, h >> 8, h & 255, w >> 8, w & 255, 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    out = b"\xff\xd8" + segment(0xDB, bytes([0] + [2] * 64 + [1] + [3] * 64))
    out += segment(0xC0, sof) + segment(0xC4, dht)
    for comps in scans:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps) + bytes([0, 63, 0]))
        bits, pred = BitWriter(), {c: 0 for c in comps}
        if len(comps) == 1:  # one block an MCU, over the component's own blocks
            (c,) = comps
            ch, cv = sampling[c]
            for by in range(ceil_div(ceil_div(h * cv, 2), 8)):
                for bx in range(ceil_div(ceil_div(w * ch, 2), 8)):
                    pred[c] = encode_block(bits, coef[c][by, bx], pred[c])
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    for c in comps:
                        ch, cv = sampling[c]
                        for by in range(cv):
                            for bx in range(ch):
                                pred[c] = encode_block(bits, coef[c][my * cv + by, mx * ch + bx], pred[c])
        out += bits.flush()
    return out + b"\xff\xd9"


@pytest.mark.parametrize(
    "scans", [[[0, 1, 2]], [[0], [1], [2]], [[0], [1, 2]], [[2], [0], [1]]],
    ids=["one", "three", "luma-then-chroma", "cr-first"],
)
def test_multi_scan_baseline_matches_libjpeg(scans):
    """Components coded in separate scans (the whole coefficient grid held
    until the last scan) decode as libjpeg decodes them, and as the same
    coefficients in one scan (one MCU row held at a time)."""
    blob = handmade_jpeg(np.random.default_rng(17), 37, 53, scans)
    assert_same_decode(blob, [24, 60])
    one = handmade_jpeg(np.random.default_rng(17), 37, 53, [[0, 1, 2]])
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), jpeg.decode_jpeg(one))


def with_size(blob, h, w):
    """The JPEG with its SOF0 header's height and width replaced."""
    i = blob.index(b"\xff\xc0")
    return blob[: i + 5] + bytes([h >> 8, h & 255, w >> 8, w & 255]) + blob[i + 9 :]


def test_sides_above_65500_are_refused_as_libjpeg_refuses_them():
    blob = encode(make_image(np.random.default_rng(19), 16, 16), 75, 0)
    for h, w in [(65535, 65535), (16, 65501), (65501, 16)]:
        huge = with_size(blob, h, w)
        with pytest.raises(ValueError):
            jax_jpeg.decode_jpeg_batch([huge], 8, fast_scale=False)
        with pytest.raises(ValueError, match="65500 pixels"):
            jpeg.decode_jpeg_batch([huge], 8, fast_scale=False)
        with pytest.raises(ValueError, match="65500 pixels"):
            jpeg.jpeg_dims(huge)


def test_an_image_too_large_for_the_host_is_a_status_not_an_abort(tmp_path):
    """65500 x 65500 is inside libjpeg's limit. In a process limited to 1 GiB
    of address space its size is read without allocating the image, and its
    decode, in two worker threads, fails to allocate and reports it per
    image instead of aborting the process."""
    import subprocess
    import sys

    blob = with_size(encode(make_image(np.random.default_rng(23), 16, 16, gray=True), 75, None),
                     65500, 65500)
    (tmp_path / "huge.jpg").write_bytes(blob)
    lib = _build.build_host("jpeg_decode")
    child = f"""
import ctypes, resource
resource.setrlimit(resource.RLIMIT_AS, (1 << 30, 1 << 30))
lib = ctypes.CDLL({lib._name!r})
blob = open({str(tmp_path / "huge.jpg")!r}, "rb").read()
h, w = ctypes.c_int(), ctypes.c_int()
print(lib.tpucap_jpeg_dims(blob, len(blob), ctypes.byref(h), ctypes.byref(w)), h.value, w.value)
data = blob + blob
offsets = (ctypes.c_int64 * 2)(0, len(blob))
sizes = (ctypes.c_int64 * 2)(len(blob), len(blob))
out = (ctypes.c_uint8 * (2 * 8 * 8 * 3))()
status = (ctypes.c_int * 2)()
failed = lib.tpucap_decode_jpeg_batch(data, offsets, sizes, 2, 8, 8, out, status, 2, 0)
print(failed, status[0], status[1])
"""
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    dims, decode = (line.split() for line in proc.stdout.splitlines())
    assert dims == ["0", "65500", "65500"]
    assert decode[0] == "2" and decode[1] == decode[2]
    with pytest.raises(ValueError, match=r"\[0, 1\]: image 0: the host could not allocate"):
        jpeg._raise_for(np.array([int(decode[1])] * 2), ["image 0", "image 1"])


def test_fast_scale_is_exact_at_full_scale_and_refuses_below():
    """fast_scale=True (the default) is tpucap's decode at the scale its
    search picks: 8/8 for 40 x 30 -> 32, 5/8 for a 500 x 375 photo -> 224.
    Below 8/8 the port used to refuse; it now decodes libjpeg's bytes."""
    rng = np.random.default_rng(7)
    # tpucap's search picks 8/8 for 40 x 30 -> 32 (7/8 gives 35 x 26).
    blob = encode(make_image(rng, 30, 40), 85, 2)
    assert jpeg.scale_num(30, 40, 32) == 8
    full = jpeg.decode_jpeg_batch([blob], 32, fast_scale=True)
    np.testing.assert_array_equal(full, jpeg.decode_jpeg_batch([blob], 32, fast_scale=False))
    np.testing.assert_array_equal(full, jax_jpeg.decode_jpeg_batch([blob], 32, fast_scale=True))
    photo = (FIXTURES / "a_420.jpg").read_bytes()
    assert jpeg.scale_num(375, 500, 224) == 5
    want = jax_jpeg.decode_jpeg_batch([blob, photo], 224)
    np.testing.assert_array_equal(jpeg.decode_jpeg_batch([blob, photo], 224), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg_files([FIXTURES / "a_420.jpg"], 224), want[1:])
    assert not np.array_equal(want[1:], jax_jpeg.decode_jpeg_batch([photo], 224, fast_scale=False))


@pytest.mark.parametrize(
    "h,w,size", [(30, 40, 32), (375, 500, 224), (500, 375, 299), (8, 8, 1), (9, 70, 9), (64, 64, 64)]
)
def test_scale_search_is_tpucaps(h, w, size):
    """The port's fast_scale decode equals tpucap's at whatever scale the
    search picks; where it picks 8/8, that is the full-scale decode."""
    blob = encode(make_image(np.random.default_rng(h + w), h, w), 90, 0)
    full = jax_jpeg.decode_jpeg_batch([blob], size, fast_scale=False)
    fast = jax_jpeg.decode_jpeg_batch([blob], size)
    np.testing.assert_array_equal(jpeg.decode_jpeg_batch([blob], size), fast)
    if jpeg.scale_num(h, w, size) == 8:
        np.testing.assert_array_equal(fast, full)


def with_dqt_entries(blob, n):
    """The JPEG with its first DQT segment holding n entries of table 0."""
    i = blob.index(b"\xff\xdb")
    length = int.from_bytes(blob[i + 2 : i + 4], "big")
    return blob[:i] + segment(0xDB, bytes([0]) + bytes([2] * n)) + blob[i + 2 + length :]


def test_out_of_scope_images_raise_value_error_naming_them(tmp_path):
    """What libjpeg-turbo refuses, the port refuses with a ValueError naming
    it: CMYK, 12-bit samples (SOF0 and SOF1), a DQT table of 32 entries
    (libjpeg-turbo reads 64 and the segment's length comes out wrong), PNG.
    A progressive JPEG, once refused, decodes to tpucap's bytes."""
    rng = np.random.default_rng(9)
    im = make_image(rng, 24, 24)
    buf = io.BytesIO()
    im.save(buf, "JPEG", progressive=True)
    progressive = buf.getvalue()
    buf = io.BytesIO()
    im.convert("CMYK").save(buf, "JPEG")
    cmyk = buf.getvalue()
    buf = io.BytesIO()
    im.save(buf, "PNG")
    png = buf.getvalue()
    good = encode(im, 75, 2)
    sof = good.index(b"\xff\xc0")
    twelve = good[: sof + 4] + bytes([12]) + good[sof + 5 :]
    twelve_sof1 = twelve[: sof + 1] + b"\xc1" + twelve[sof + 2 :]
    short_dqt = with_dqt_entries(good, 32)
    refused = [cmyk, twelve, twelve_sof1, short_dqt, png]
    for blob in refused:
        with pytest.raises(ValueError):
            jax_jpeg.decode_jpeg_batch([blob], 24, fast_scale=False)
    with pytest.raises(ValueError, match=r"\[1, 2, 3, 4, 5\].*image 1: color space.*CMYK"
                       r".*image 2: sample precision.*image 3: sample precision"
                       r".*image 4: corrupt.*image 5: not a JPEG"):
        jpeg.decode_jpeg_batch([good, *refused], 24, fast_scale=False)
    np.testing.assert_array_equal(jpeg.decode_jpeg_batch([good, progressive], 24),
                                  jax_jpeg.decode_jpeg_batch([good, progressive], 24))
    path = tmp_path / "photo.png"
    path.write_bytes(png)
    with pytest.raises(ValueError, match="photo.png: not a JPEG"):
        jpeg.decode_jpeg_files([path], 24)
    with pytest.raises(ValueError, match=r"\[1\]: .*missing.jpg: cannot be read"):
        jpeg.decode_jpeg_files([FIXTURES / "a_420.jpg", tmp_path / "missing.jpg"], 24, fast_scale=False)
    with pytest.raises(ValueError):
        jpeg.jpeg_dims(png)


@pytest.mark.parametrize("name", sorted(json.loads((FIXTURES / "digests.json").read_text())["files"]))
def test_committed_fixtures_decode_to_their_digests(name):
    """The digests chip_smoke.py holds the card's build against, at 8/8 and
    at tpucap's default fast_scale (5/8): the port gives them, and tpucap
    still does (so the file cannot go stale). The CMYK and YCCK files hold
    tpucap's load_image digests, which the port's load_image route gives;
    the decoder's RGB route refuses them, as tpucap's does."""
    from tpucap_torch.data.preprocess import load_images

    digests = json.loads((FIXTURES / "digests.json").read_text())
    want = digests["files"][name]
    blob = (FIXTURES / name).read_bytes()
    size = digests["size"]
    assert fixtures_script.reference_digests(blob) == want
    assert list(jpeg.jpeg_dims(blob)) == want["shape"]
    if want.get("reference") == "load_image":
        assert fixtures_script.sha256(jpeg.decode_jpeg(blob, load_image=True)) == want["native"]
        got = load_images([FIXTURES / name], size=size)[0]
        assert fixtures_script.sha256(got) == want[str(size)]
        with pytest.raises(ValueError, match="color space"):
            jpeg.decode_jpeg_files([FIXTURES / name], size)
        return
    assert fixtures_script.sha256(jpeg.decode_jpeg(blob)) == want["native"]
    got = jpeg.decode_jpeg_files([FIXTURES / name], size, fast_scale=False)[0]
    assert fixtures_script.sha256(got) == want[str(size)]
    got = jpeg.decode_jpeg_batch([blob], size, fast_scale=False)[0]
    assert fixtures_script.sha256(got) == want[str(size)]
    got = jpeg.decode_jpeg_files([FIXTURES / name], size)[0]
    assert fixtures_script.sha256(got) == want[f"{size}_fast"]


def test_build_host_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"building broken.cpp failed:(.|\n)*error"):
        _build.build_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_host_names_the_library_by_digest():
    lib = _build.build_host("jpeg_decode")
    assert _build.build_host("jpeg_decode") is lib
    (built,) = [p for p in _build.BUILD.glob("jpeg_decode-*.so")
                if p.name == Path(lib._name).name]
    digest = built.stem.split("-", 1)[1]
    assert digest == _build._digest(_build.CSRC / "jpeg_decode.cpp", [], _build.HOST_FLAGS)


def test_scalar_idct_build_matches_libjpeg(tmp_path):
    """Hosts without SSE2 build the scalar IDCT (the same arithmetic, lane by
    lane): built here with TPUCAP_JPEG_SCALAR, it must give libjpeg's bytes
    too, on valid and on corrupt data, at 8/8 and at the scaled sizes."""
    import ctypes
    import subprocess

    so = tmp_path / "jpeg_decode_scalar.so"
    cmd = ["g++", *_build.HOST_FLAGS, "-DTPUCAP_JPEG_SCALAR", "-o", str(so),
           str(_build.CSRC / "jpeg_decode.cpp")]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    rng = np.random.default_rng(13)
    blobs = [encode(make_image(rng, h, w, gray=s == "gray"), q, SAMPLING[s])
             for (h, w), s, q in zip(SIZES, ["420", "422", "444", "gray"] * 2, QUALITIES * 2)]
    corrupt = bytearray(blobs[-1])
    corrupt[len(corrupt) // 2] ^= 0x5A
    blobs.append(bytes(corrupt))
    data = np.frombuffer(b"".join(blobs), np.uint8)
    sizes = np.array([len(b) for b in blobs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    ptr = ctypes.c_void_p
    # 30 at 8/8; with fast_scale, every scale these sizes pick (1/8-8/8),
    # through each scaled IDCT (4:2:0 chroma at 2, 4, ..., 14).
    for size, fast in [(30, 0), *[(s, 1) for s in (1, 2, 3, 4, 5, 6, 7, 9, 11, 13)]]:
        out = np.zeros((len(blobs), size, size, 3), np.uint8)
        status = np.zeros(len(blobs), np.int32)
        lib.tpucap_decode_jpeg_batch(
            ptr(data.ctypes.data), ptr(offsets.ctypes.data), ptr(sizes.ctypes.data),
            len(blobs), size, size, ptr(out.ctypes.data), ptr(status.ctypes.data), 2, fast,
        )
        assert not status.any()
        np.testing.assert_array_equal(
            out, jax_jpeg.decode_jpeg_batch(blobs, size, fast_scale=bool(fast)), err_msg=f"{size}")


@pytest.mark.parametrize("name", ["a_420.jpg", "c_444.jpg", "d_gray.jpg", "e_restart.jpg"])
def test_fill_bytes_before_a_stuffed_ff_follow_libjpegs_fast_path(name):
    """An FF inserted before a stuffed FF 00 in the scan (not valid JPEG):
    libjpeg-turbo's slow path reads FF FF 00 as one FF byte, its fast path
    (no restart interval, 512 bytes a block still to come) as a marker,
    decoding zeros from there, then decodes the MCU again on the slow path
    over what the fast one wrote. The port follows both, so the bytes agree
    wherever the FF lands; with restart markers (e_restart) only the slow
    path runs."""
    blob = (FIXTURES / name).read_bytes()
    sos = blob.index(b"\xff\xda")
    stuffed = [i for i in range(sos + 12, len(blob) - 2) if blob[i] == 0xFF and blob[i + 1] == 0]
    for i in stuffed[:: max(1, len(stuffed) // 24)]:
        bad = blob[:i] + b"\xff" + blob[i:]
        for fast in (False, True):
            np.testing.assert_array_equal(
                jpeg.decode_jpeg_batch([bad], 224, fast_scale=fast),
                jax_jpeg.decode_jpeg_batch([bad], 224, fast_scale=fast), err_msg=f"FF at {i}")


def gray_dc_jpeg(blocks_h, blocks_w, diff, progressive=False):
    """A gray JPEG of blocks_h x blocks_w blocks, every DC difference diff and
    no AC (a progressive one: its DC scan alone)."""
    size = abs(diff).bit_length()
    h, w = 8 * blocks_h, 8 * blocks_w
    dht = bytes([0x00, 0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16))
    if not progressive:
        dht += bytes([0x10, 1] + [0] * 15) + bytes([0x00])
    sof = bytes([8, h >> 8, h & 255, w >> 8, w & 255, 1, 1, 0x11, 0])
    out = b"\xff\xd8" + segment(0xDB, bytes([0] + [1] * 64))
    out += segment(0xC2 if progressive else 0xC0, sof) + segment(0xC4, dht)
    out += segment(0xDA, bytes([1, 1, 0, 0, 0 if progressive else 63, 0]))
    bits = BitWriter()
    for _ in range(blocks_h * blocks_w):
        bits.put(size, 5)
        bits.put(diff if diff > 0 else diff - 1, size)
        if not progressive:
            bits.put(0, 1)  # EOB
    return out + bits.flush() + b"\xff\xd9"


def test_dc_predictor_overflow_follows_libjpeg():
    """-32767 a block overflows the DC predictor at block 65539:
    libjpeg-turbo's sequential decoder lets it wrap (on its fast path and,
    13 blocks before the end, on its slow path) and the port gives the same
    bytes; its progressive decoder refuses it (JERR_BAD_DCT_COEF), and so
    does the port."""
    for blocks_h, blocks_w in [(16, 4097), (32, 2060)]:
        blob = gray_dc_jpeg(blocks_h, blocks_w, -32767)
        np.testing.assert_array_equal(jpeg.decode_jpeg_batch([blob], 48),
                                      jax_jpeg.decode_jpeg_batch([blob], 48))
    blob = gray_dc_jpeg(16, 4097, -32767, progressive=True)
    with pytest.raises(ValueError):
        jax_jpeg.decode_jpeg_batch([blob], 48)
    with pytest.raises(ValueError, match="corrupt"):
        jpeg.decode_jpeg_batch([blob], 48)
    ok = gray_dc_jpeg(16, 4096, -32767, progressive=True)
    np.testing.assert_array_equal(jpeg.decode_jpeg_batch([ok], 48),
                                  jax_jpeg.decode_jpeg_batch([ok], 48))
