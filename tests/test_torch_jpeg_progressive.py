"""Progressive JPEG (SOF2) in the port's decoder against tpucap's
libjpeg-turbo decode (``tpucap.ops.jpeg.decode_jpeg_batch``) on the CPU: at
full scale and at every scale tpucap's ``fast_scale`` search picks, with
restarts, successive approximation and custom scan scripts, and on files cut
after each scan or anywhere, where libjpeg-turbo 2.1 smooths the blocks
whose low coefficients are not yet exact (jdcoefct.c).

Tolerance: none. Every decoded byte must equal tpucap's; the port must
refuse exactly the images libjpeg refuses.
"""

import io

import numpy as np
import pytest
import torch
from test_torch_jpeg import SAMPLING, make_image
from test_torch_jpeg_scaled import (  # noqa: F401  (module-scoped fixture)
    assert_scaled_decodes,
    compress,
    native,
    photo,
)

from tpucap.ops import jpeg as jax_jpeg
from tpucap_torch.ops import jpeg

torch.set_num_threads(2)


def encode_progressive(im, quality, sampling, **opts):
    buf = io.BytesIO()
    if sampling is not None:
        opts["subsampling"] = sampling
    im.save(buf, "JPEG", quality=quality, progressive=True, **opts)
    return buf.getvalue()


def scan_starts(blob):
    """Offsets of the SOS markers, after the header's."""
    i, out = 2, []
    while i < len(blob) - 1:
        if blob[i] == 0xFF and blob[i + 1] == 0xDA:
            out.append(i)
        i += 1
    return out


def same_or_both_refuse(blob, size, fast_scale=True):
    """Port == tpucap, or both raise ValueError; returns whether decoded."""
    try:
        want = jax_jpeg.decode_jpeg_batch([blob], size, fast_scale=fast_scale)
    except ValueError:
        with pytest.raises(ValueError):
            jpeg.decode_jpeg_batch([blob], size, fast_scale=fast_scale)
        return False
    got = jpeg.decode_jpeg_batch([blob], size, fast_scale=fast_scale, n_threads=1)
    np.testing.assert_array_equal(got, want, err_msg=f"-> {size} fast_scale={fast_scale}")
    return True


SIZES = [(1, 1), (5, 3), (16, 16), (37, 53), (120, 90), (375, 500)]


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_progressive_matches_libjpeg(hw, sampling):
    """PIL's progressive files (jpeg_simple_progression: spectral selection
    and successive approximation), plain and with restart markers, at every
    scale, at their own size and at 8/8 resized."""
    h, w = hw
    rng = np.random.default_rng(h * 31 + w)
    for q, opts in [(80, {}), (95, {"restart_marker_blocks": 1}), (50, {"restart_marker_blocks": 3})]:
        blob = encode_progressive(make_image(rng, h, w, gray=sampling == "gray"), q,
                                  SAMPLING[sampling], **opts)
        assert blob[blob.index(b"\xff\xc2") + 1] == 0xC2
        assert_scaled_decodes(blob, h, w)
        np.testing.assert_array_equal(jpeg.decode_jpeg(blob), native(blob, h, w))
        same_or_both_refuse(blob, max(h, w) + 3, fast_scale=False)


@pytest.mark.parametrize("sampling", ["gray", "420", "422", "444"])
def test_progressive_cut_after_each_scan_matches_libjpeg(sampling):
    """A file cut after each of its scans leaves low coefficients short of
    full precision, so libjpeg-turbo 2.1 smooths the blocks: DC
    interpolation while no AC is known, then the 5 x 5 estimates of AC01-
    AC02; at every scale."""
    rng = np.random.default_rng(len(sampling))
    for h, w in [(40, 56), (375, 500)]:
        blob = encode_progressive(make_image(rng, h, w, gray=sampling == "gray"), 85,
                                  SAMPLING[sampling])
        for cut in scan_starts(blob)[1:] + [len(blob) - 2]:
            part = blob[:cut]
            for size in (7, 24, max(h, w) + 2):
                assert same_or_both_refuse(part, size)
            assert same_or_both_refuse(part, 24, fast_scale=False)


# Scan scripts (components/Ss/Se/Ah/Al): successive approximation three
# deep, non-interleaved DC, DC alone (smoothed although complete), chroma
# AC never sent, a band left unrefined.
SCRIPTS = {
    "deep_sa": "0,1,2/0/0/0/2;0,1,2/0/0/2/1;0/1/5/0/3;1/1/63/0/1;2/1/63/0/1;0/6/63/0/2;"
               "0/1/5/3/2;0/1/63/2/1;0,1,2/0/0/1/0;1/1/63/1/0;2/1/63/1/0;0/1/63/1/0",
    "separate_dc": "0/0/0/0/1;1/0/0/0/1;2/0/0/0/1;0/1/63/0/0;1/1/63/0/0;2/1/63/0/0;"
                   "2/0/0/1/0;0/0/0/1/0;1/0/0/1/0",
    "dc_only": "0,1,2/0/0/0/0",
    "no_chroma_ac": "0,1,2/0/0/0/0;0/1/63/0/0",
    "unrefined": "0,1,2/0/0/0/0;0/1/9/0/1;0/10/63/0/0;1/1/63/0/0;2/1/63/0/0",
}


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("sampling", ["2x2,1x1,1x1", "1x2,1x1,1x1", "4x1,1x1,1x1", "1x1,1x1,1x1"])
def test_progressive_scan_scripts_match_libjpeg(compress, script, sampling):  # noqa: F811
    """libjpeg-written scan scripts at 4:2:0, 4:4:0, 4:1:1 and 4:4:4, with
    and without restarts, whole and cut inside their scans."""
    rng = np.random.default_rng(len(script) * 7 + len(sampling))
    h, w = 45, 70
    for restart in (0, 2):
        blob = compress(photo(rng, h, w), 85, sampling, scans=SCRIPTS[script], restart=restart)
        assert_scaled_decodes(blob, h, w)
        np.testing.assert_array_equal(jpeg.decode_jpeg(blob), native(blob, h, w))
        for cut in rng.integers(scan_starts(blob)[0] + 12, len(blob), 3):
            same_or_both_refuse(blob[:cut], 30)


def test_progressive_gray_and_rgb_scripts_match_libjpeg(compress):  # noqa: F811
    rng = np.random.default_rng(47)
    gray = compress(np.asarray(make_image(rng, 33, 61, gray=True)), 75, "1x1",
                    scans="0/0/0/0/1;0/1/8/0/2;0/9/63/0/2;0/1/63/2/1;0/0/0/1/0;0/1/63/1/0")
    rgb = compress(photo(rng, 33, 61), 75, "1x1,1x1,1x1", color="rgb", scans="1")
    for blob in (gray, rgb):
        assert_scaled_decodes(blob, 33, 61)


def test_progressive_corrupt_and_truncated_data_follow_libjpeg():
    """Cut anywhere (smoothing with the status from before the cut scan on
    the rows it did not reach), flipped bytes in the scans, with and
    without restarts: the same images refused, the same bytes."""
    rng = np.random.default_rng(53)
    bases = [encode_progressive(make_image(rng, 60, 90), 85, s, **opts)
             for s in (0, 2) for opts in ({}, {"restart_marker_blocks": 2})]
    decoded = refused = 0
    for trial in range(160):
        blob = bytearray(bases[trial % len(bases)])
        first = scan_starts(bytes(blob))[0] + 10
        if trial % 2:
            blob = blob[: rng.integers(first, len(blob))]
        else:
            for _ in range(rng.integers(1, 4)):
                blob[rng.integers(first, len(blob) - 2)] = rng.integers(0, 256)
        ok = same_or_both_refuse(bytes(blob), [9, 30, 95][trial % 3])
        decoded += ok
        refused += not ok
    assert decoded > 100 and refused > 5


def with_scan_params(blob, k, params):
    """The JPEG with its k-th scan's Ss, Se and Ah/Al bytes replaced."""
    i = scan_starts(blob)[k]
    n = blob[i + 4]
    at = i + 5 + 2 * n
    return blob[:at] + bytes(params) + blob[at + 3:]


def test_bad_progression_is_refused_and_a_bogus_one_decodes():
    """start_pass_phuff_decoder: a DC scan with Se > 0, an AC band past 63,
    Ss > Se, or Al > 13 is fatal in libjpeg and refused by the port; an
    AC scan before any DC, or a refinement whose Ah is not the last Al,
    only warns, and both decode the same bytes."""
    blob = encode_progressive(make_image(np.random.default_rng(59), 40, 48), 85, 2)
    fatal = [(0, [0, 5, 0x00]), (3, [5, 64, 0x00]), (3, [9, 4, 0x00]), (3, [1, 5, 0x0E]),
             (0, [0, 0, 0x31])]
    for k, params in fatal:
        bad = with_scan_params(blob, k, params)
        with pytest.raises(ValueError):
            jax_jpeg.decode_jpeg_batch([bad], 24)
        with pytest.raises(ValueError, match="corrupt"):
            jpeg.decode_jpeg_batch([bad], 24)
    scans = scan_starts(blob)
    # The first scan's DC Al raised: the DC refinement's Ah disagrees.
    bogus = [with_scan_params(blob, 0, [0, 0, 0x02])]
    # The second scan (Y's first AC band, with the DHT before it) moved in
    # front of the first (every DC): AC before DC.
    dht = blob.index(b"\xff\xc4", scans[0])
    end = min(blob.index(m, scans[1] + 2) for m in (b"\xff\xc4", b"\xff\xda"))
    bogus.append(blob[: scans[0]] + blob[dht:end] + blob[scans[0]:dht] + blob[end:])
    for b in bogus:
        for size in (12, 24, 48):
            assert same_or_both_refuse(b, size)
    # The DHT before that scan dropped: its AC table is undefined, and a
    # progressive decoder installs no standard tables (jdphuff.c).
    missing = blob[:dht] + blob[scans[1]:]
    with pytest.raises(ValueError):
        jax_jpeg.decode_jpeg_batch([missing], 24)
    with pytest.raises(ValueError, match="corrupt"):
        jpeg.decode_jpeg_batch([missing], 24)


def test_a_huge_progressive_image_is_a_status_not_an_abort(tmp_path):
    """A progressive image holds every coefficient, as libjpeg does: 65500 x
    65500 gray needs 8.6 GB of them. Under a 1 GiB address-space limit the
    allocation fails in the worker thread and becomes the image's status."""
    import subprocess
    import sys

    from test_torch_jpeg import with_size

    blob = encode_progressive(make_image(np.random.default_rng(67), 16, 16, gray=True), 75, None)
    i = blob.index(b"\xff\xc2")
    huge = with_size(blob[:i] + b"\xff\xc0" + blob[i + 2 :], 65500, 65500)
    huge = huge[:i] + b"\xff\xc2" + huge[i + 2 :]
    (tmp_path / "huge.jpg").write_bytes(huge)
    lib = jpeg._lib()
    child = f"""
import ctypes, resource
resource.setrlimit(resource.RLIMIT_AS, (1 << 30, 1 << 30))
lib = ctypes.CDLL({lib._name!r})
blob = open({str(tmp_path / "huge.jpg")!r}, "rb").read()
out = (ctypes.c_uint8 * (8 * 8 * 3))()
status = (ctypes.c_int * 1)()
offsets = (ctypes.c_int64 * 1)(0)
sizes = (ctypes.c_int64 * 1)(len(blob))
print(lib.tpucap_decode_jpeg_batch(blob, offsets, sizes, 1, 8, 8, out, status, 2, 1), status[0])
"""
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "10"]
    assert "allocate" in jpeg.STATUS[10]


def test_scan_component_lists_follow_libjpeg():
    """Every list of three component ids (1-3 and an unknown 9) in the first
    SOS of a baseline and of a progressive file: libjpeg-turbo refuses a
    component named twice, an unknown id, and (its slot search) a component
    listed before one that precedes it in the frame, so only the frame's
    order decodes; the port refuses and decodes the same files."""
    import itertools

    rng = np.random.default_rng(71)
    im = make_image(rng, 24, 32)
    baseline = io.BytesIO()
    im.save(baseline, "JPEG", quality=80, subsampling=0)
    blobs = [baseline.getvalue(), encode_progressive(im, 80, 0)]
    decoded = refused = 0
    for blob in blobs:
        i = scan_starts(blob)[0]
        assert blob[i + 4] == 3
        for ids in itertools.product([1, 2, 3, 9], repeat=3):
            b = bytearray(blob)
            for k, cid in enumerate(ids):
                b[i + 5 + 2 * k] = cid
            ok = same_or_both_refuse(bytes(b), 16)
            decoded += ok
            refused += not ok
    assert decoded == 2 and refused == 2 * 4**3 - 2
