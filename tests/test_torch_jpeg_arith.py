"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) in the port's
decoder against tpucap's libjpeg-turbo decode
(``tpucap.ops.jpeg.decode_jpeg_batch``) on the CPU: every sampling the
decoder takes, restart intervals, DAC conditioning (L, U and Kx, also
values no encoder writes), every scale tpucap's ``fast_scale`` search picks
and 8/8, files cut after each scan and inside one, a marker inside the
data, and a seeded fuzz of cut and corrupted files. Lossless and
hierarchical files stay refused, as libjpeg-turbo 2.1 refuses them.

Files come from this host's libjpeg (``scripts/make_torch_jpeg_fixtures.py``'s
compressor, which writes a DAC segment before every arithmetic scan).

Tolerance: none. Every decoded byte must equal tpucap's; the port must
refuse exactly the images libjpeg refuses.
"""

import numpy as np
import pytest
import torch
from test_torch_jpeg import make_image
from test_torch_jpeg_progressive import SCRIPTS, same_or_both_refuse, scan_starts
from test_torch_jpeg_scaled import (  # noqa: F401  (module-scoped fixture)
    assert_scaled_decodes,
    compress,
    native,
    photo,
)

from tpucap.ops import jpeg as jax_jpeg
from tpucap_torch.ops import jpeg

torch.set_num_threads(2)

# libjpeg_compressor's sampling strings: the decoder's six common ones.
SAMPLINGS = {
    "420": "2x2,1x1,1x1",
    "422": "2x1,1x1,1x1",
    "444": "1x1,1x1,1x1",
    "gray": "1x1",
    "411": "4x1,1x1,1x1",
    "440": "1x2,1x1,1x1",
}
HW = [(1, 1), (9, 14), (37, 53)]


def image(rng, h, w, sampling):
    gray = sampling == "gray"
    return np.asarray(make_image(rng, h, w, gray=gray)) if gray else photo(rng, h, w)


def assert_all_scales(blob, h, w):
    """Port == tpucap at every scale the search picks, at 8/8 resized up,
    and at the image's own size."""
    assert_scaled_decodes(blob, h, w)
    assert same_or_both_refuse(blob, max(h, w) + 3, fast_scale=False)
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), native(blob, h, w))


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_arithmetic_matches_libjpeg(compress, progressive, sampling):  # noqa: F811
    """Sequential and jpeg_simple_progression files at each sampling and
    size, plain and with a restart every MCU and every 3."""
    rng = np.random.default_rng(len(sampling) * 10 + progressive)
    marker = b"\xff\xca" if progressive else b"\xff\xc9"
    for h, w in HW:
        for q, restart in [(75, 0), (92, 1), (40, 3)]:
            blob = compress(image(rng, h, w, sampling), q, SAMPLINGS[sampling],
                            scans="1" if progressive else "0", restart=restart, arith=True)
            assert marker in blob
            assert_all_scales(blob, h, w)


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_arithmetic_scan_scripts_match_libjpeg(compress, script):  # noqa: F811
    """SOF10 with successive approximation three deep, non-interleaved DC,
    DC alone (smoothed although complete), chroma AC never sent, a band
    left unrefined; at 4:2:0 and 4:4:0, with and without restarts."""
    rng = np.random.default_rng(len(script))
    h, w = 45, 70
    for sampling in ("2x2,1x1,1x1", "1x2,1x1,1x1"):
        for restart in (0, 2):
            blob = compress(photo(rng, h, w), 85, sampling, scans=SCRIPTS[script],
                            restart=restart, arith=True)
            assert b"\xff\xca" in blob
            assert_all_scales(blob, h, w)


def test_non_interleaved_sequential_scans_match_libjpeg(compress):  # noqa: F811
    """SOF9 with one scan a component (a multi-scan sequential image, which
    holds every coefficient), and Y's scan split off from chroma's."""
    rng = np.random.default_rng(3)
    for scans in ("0/0/63/0/0;1/0/63/0/0;2/0/63/0/0", "0/0/63/0/0;1,2/0/63/0/0"):
        for restart in (0, 1):
            blob = compress(photo(rng, 30, 41), 80, "2x2,1x1,1x1", scans=scans,
                            restart=restart, arith=True)
            assert b"\xff\xc9" in blob
            assert_all_scales(blob, 30, 41)


def with_dac(blob, entries):
    """The JPEG with each DAC segment's (index, value) pairs replaced by
    ``entries``."""
    out, i = bytearray(), 0
    while True:
        j = blob.find(b"\xff\xcc", i)
        if j < 0:
            return bytes(out + blob[i:])
        length = int.from_bytes(blob[j + 2 : j + 4], "big")
        payload = bytes(b for pair in entries for b in pair)
        out += blob[i:j] + b"\xff\xcc" + (len(payload) + 2).to_bytes(2, "big") + payload
        i = j + 2 + length


@pytest.mark.parametrize("dac", [(0, 1, 5), (1, 3, 10), (0, 0, 1), (5, 15, 63), (15, 15, 2)],
                         ids=lambda d: "L%d_U%d_K%d" % d)
def test_dac_conditioning_matches_libjpeg(compress, dac):  # noqa: F811
    """Each DC table's L and U and each AC table's Kx as the encoder's DAC
    writes them, sequential and progressive, with restarts."""
    rng = np.random.default_rng(sum(dac))
    for scans, restart in [("0", 0), ("1", 2)]:
        blob = compress(photo(rng, 33, 47), 85, "2x2,1x1,1x1", scans=scans, restart=restart,
                        arith=True, dac=dac)
        assert blob.count(b"\xff\xcc") >= 1
        assert_all_scales(blob, 33, 47)


def test_dac_values_no_encoder_writes_follow_libjpeg(compress):  # noqa: F811
    """get_dac checks an index below 32 and L <= U, and takes any Kx (0,
    and past 63, which conditions every coefficient alike); a DAC read
    between scans applies to the scans after it. The same files refused
    and the same bytes."""
    rng = np.random.default_rng(11)
    seq = compress(photo(rng, 24, 40), 80, "2x2,1x1,1x1", arith=True)
    prog = compress(photo(rng, 24, 40), 80, "2x2,1x1,1x1", scans="1", arith=True)
    decoded = [with_dac(seq, [(0, 0x00), (1, 0x21), (16, 0), (17, 200)]),
               with_dac(prog, [(0, 0xF0), (1, 0x11), (16, 255), (17, 64)]),
               with_dac(seq, [])]
    for blob in decoded:
        assert same_or_both_refuse(blob, 20)
        assert same_or_both_refuse(blob, 24, fast_scale=False)
    # The conditioning of the scans from the second on: a DAC between scans.
    i = scan_starts(prog)[1]
    j = prog.rindex(b"\xff\xcc", 0, i)
    between = prog[:j] + with_dac(prog[j:], [(16, 1), (17, 60)])
    assert same_or_both_refuse(between, 20)
    for entries in ([(32, 0x10)], [(0, 0x12)], [(15, 0x3F)]):  # index 32; L 2 > U 1; L 15 > U 3
        assert not same_or_both_refuse(with_dac(seq, entries), 20)


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_arithmetic_cut_files_match_libjpeg(compress, progressive):  # noqa: F811
    """Files cut after each scan and at points inside one: past the end the
    coder reads zeros after libjpeg's fake EOI, and progressive images are
    smoothed as their scans left them (jdarith.c keeps coef_bits as
    jdphuff.c does); at every scale."""
    rng = np.random.default_rng(5 + progressive)
    for sampling in ("2x2,1x1,1x1", "1x1"):
        h, w = 40, 56
        img = image(rng, h, w, "gray" if sampling == "1x1" else "420")
        for restart in (0, 2):
            blob = compress(img, 85, sampling, scans="1" if progressive else "0",
                            restart=restart, arith=True)
            for cut in scan_starts(blob)[1:] + [len(blob) - 2]:
                part = blob[:cut]
                for size in (7, 24, max(h, w) + 2):
                    assert same_or_both_refuse(part, size)
                assert same_or_both_refuse(part, 24, fast_scale=False)
            # Anywhere, a marker segment between scans included.
            for cut in rng.integers(scan_starts(blob)[0] + 8, len(blob) - 2, 4):
                for size in (7, 24):
                    same_or_both_refuse(blob[:cut], size)


def test_a_marker_inside_arithmetic_data_follows_libjpeg(compress):  # noqa: F811
    """A marker inside the data is legal in arithmetic coding: the coder
    reads zeros from there to the end of the scan, then the marker is read
    as the next one (a COM here, then EOI); a stuffed FF 00 stays data."""
    rng = np.random.default_rng(13)
    for scans in ("0", "1"):
        blob = compress(photo(rng, 48, 64), 85, "2x2,1x1,1x1", scans=scans, arith=True)
        first = scan_starts(blob)[0]
        start = first + 2 + int.from_bytes(blob[first + 2 : first + 4], "big")
        for at in (start + 5, start + (len(blob) - start) // 3):
            com = blob[:at] + b"\xff\xfe\x00\x04ab" + blob[at:]
            assert same_or_both_refuse(com, 32)
            assert same_or_both_refuse(com, 64, fast_scale=False)
            zero = blob[:at] + b"\xff\x00" + blob[at:]
            assert same_or_both_refuse(zero, 32)


def test_arithmetic_fuzz_follows_libjpeg(compress):  # noqa: F811
    """240 cut or corrupted mutants of eight arithmetic files (samplings,
    scan scripts, restarts, DAC values): bad codes (spectral and magnitude
    overflow, which end a segment's decoding), wrong restart markers,
    broken headers. The same images refused, the same bytes where both
    decode, at random targets and both fast_scale settings."""
    rng = np.random.default_rng(17)
    scripts = [SCRIPTS["deep_sa"], SCRIPTS["separate_dc"], "1", "0"]
    samplings = ["2x2,1x1,1x1", "1x1,1x1,1x1", "2x1,1x1,1x1", "4x1,1x1,1x1"]
    bases = [compress(photo(rng, 31 + 7 * i, 50 - 3 * i), 60 + 4 * i, samplings[i % 4],
                      scans=scripts[i % 4], restart=[0, 1, 3][i % 3], arith=True,
                      dac=(i % 3, 3 + i % 3, 2 + 9 * i))
             for i in range(8)]
    decoded = refused = 0
    for trial in range(240):
        blob = bytearray(bases[trial % len(bases)])
        sos = scan_starts(bytes(blob))[0]
        kind = trial % 3
        if kind == 0:
            blob = blob[: rng.integers(sos, len(blob))]
        else:
            start = sos + 10 if kind == 2 else 2
            for _ in range(rng.integers(1, 4)):
                blob[rng.integers(start, len(blob) - 2)] = rng.integers(0, 256)
        ok = same_or_both_refuse(bytes(blob), [5, 17, 40, 100][trial % 4], bool(trial % 5))
        decoded += ok
        refused += not ok
    assert decoded > 120 and refused > 20


@pytest.mark.parametrize("marker", [0xC3, 0xC5, 0xC6, 0xC7, 0xC8, 0xCB, 0xCD, 0xCE, 0xCF])
def test_lossless_and_hierarchical_markers_are_refused(compress, marker):  # noqa: F811
    """SOF3, SOF5-7, SOF11, SOF13-15 (lossless and hierarchical) and JPG:
    libjpeg-turbo 2.1 refuses them, in place of an arithmetic or a Huffman
    file's SOF, and so does the port."""
    rng = np.random.default_rng(marker)
    for arith in (False, True):
        blob = compress(photo(rng, 16, 24), 80, "2x2,1x1,1x1", arith=arith)
        sof = blob.index(b"\xff\xc9" if arith else b"\xff\xc0")
        bad = blob[: sof + 1] + bytes([marker]) + blob[sof + 2 :]
        with pytest.raises(ValueError):
            jax_jpeg.decode_jpeg_batch([bad], 16)
        with pytest.raises(ValueError, match="lossless or hierarchical"):
            jpeg.decode_jpeg_batch([bad], 16)
