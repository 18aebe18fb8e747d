"""JPEG files to captions: the port's loader (``tpucap_torch.data.pipeline``)
and ``caption_dataset`` / ``extract_features`` / ``caption_images`` against
tpucap's, on the CPU, same weights (the module-scoped ``pipelines`` of
``test_torch_pipeline.py``: ResNet-50 at input 64, BN folded, lstm1, f32).
The JPEG files are 64 to 96 pixels a side, so the host resizes them to the
encoder's 64 (tpucap through libjpeg and PIL's nearest, the port through its
own decoder).

Captions must be identical, token for token. Features: the encoder
tolerance of ``test_torch_pipeline.py`` (1e-4 of the output's scale), the
decoded pixels being identical.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_pipeline import pipelines  # noqa: F401  (module-scoped fixture)

from tpucap_torch.data.pipeline import image_batch_loader, prefetch
from tpucap_torch.ops.jpeg import decode_jpeg_files, jpeg_dims, scale_num

torch.set_num_threads(2)

# (height, width, PIL subsampling): 4:2:0, 4:2:2, 4:4:4; none 64 x 64.
SHAPES = [(80, 72, 2), (72, 80, 1), (96, 64, 0), (64, 96, 2), (70, 70, 2)]


@pytest.fixture(scope="module")
def jpeg_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(21)
    paths = []
    for i, (h, w, sub) in enumerate(SHAPES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = d / f"img{i}.jpg"
        Image.fromarray(img).save(path, quality=90, subsampling=sub)
        paths.append(str(path))
    return paths


def test_loader_yields_every_batch_in_order_with_the_tail(jpeg_paths):
    got = list(image_batch_loader(jpeg_paths, size=40, batch_size=2, fast_scale=False))
    assert [chunk for chunk, _ in got] == [jpeg_paths[0:2], jpeg_paths[2:4], jpeg_paths[4:]]
    for chunk, batch in got:
        assert batch.dtype == np.uint8 and batch.shape == (len(chunk), 40, 40, 3)
        np.testing.assert_array_equal(batch, decode_jpeg_files(chunk, 40, fast_scale=False))


@pytest.mark.parametrize(
    "kw,chunks",
    [
        ({"drop_remainder": True}, [[0, 1], [2, 3]]),
        ({"num_epochs": 2}, [[0, 1], [2, 3], [4]] * 2),
        ({"num_workers": 3}, [[0, 1], [2, 3], [4]]),
    ],
)
def test_loader_options(jpeg_paths, kw, chunks):
    got = list(image_batch_loader(jpeg_paths, size=24, batch_size=2, fast_scale=False, **kw))
    assert [chunk for chunk, _ in got] == [[jpeg_paths[i] for i in c] for c in chunks]
    for chunk, batch in got:
        np.testing.assert_array_equal(batch, decode_jpeg_files(chunk, 24, fast_scale=False))


def test_loader_error_reaches_the_caller(jpeg_paths, tmp_path):
    bad = tmp_path / "notes.jpg"
    bad.write_bytes(b"not an image")
    loader = image_batch_loader(
        [*jpeg_paths[:2], str(bad)], size=24, batch_size=2, fast_scale=False
    )
    chunk, _ = next(loader)
    assert chunk == jpeg_paths[:2]
    with pytest.raises(ValueError, match="notes.jpg: not a JPEG"):
        next(loader)


def test_prefetch_runs_ahead_and_stops_when_closed():
    made = {i: threading.Event() for i in range(6)}

    def work(i):
        made[i].set()
        return i * i

    it = prefetch(range(6), work, depth=1)
    assert next(it) == (0, 0)
    # While the caller holds item 0, the thread makes item 1.
    assert made[1].wait(timeout=10)
    assert next(it) == (1, 1)
    it.close()
    assert not any(t.name.startswith("tpucap-loader") for t in threading.enumerate())
    with pytest.raises(KeyError):
        list(prefetch([0, 99], lambda i: made[i], depth=2))


def test_prefetch_under_thread_switching_keeps_every_item_in_order():
    """Stress: a switch interval of 10 us, 400 items through a queue of 2."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = []
        done = threading.Event()

        def consume():
            for item, out in prefetch(range(400), lambda i: [i] * (i % 7), depth=2):
                got.append((item, out))
            done.set()

        consumer = threading.Thread(target=consume)
        consumer.start()
        consumer.join(timeout=60)
        assert done.is_set() and not consumer.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert got == [(i, [i] * (i % 7)) for i in range(400)]


def test_loader_refuses_shuffle(jpeg_paths):
    with pytest.raises(NotImplementedError, match="shuffle"):
        image_batch_loader(jpeg_paths, size=24, batch_size=2, shuffle=True)


@pytest.mark.parametrize("method", ["beam", "greedy"])
def test_caption_dataset_matches_jax(pipelines, jpeg_paths, method):  # noqa: F811
    """Two batches of 3, the second a padded tail of 2."""
    jpipe, pipe = pipelines
    want = jpipe.caption_dataset(jpeg_paths, batch_size=3, method=method, fast_scale=False)
    got = pipe.caption_dataset(jpeg_paths, batch_size=3, method=method, fast_scale=False)
    assert got == want
    assert len(got) == len(jpeg_paths) and len(set(want)) > 1


def test_caption_dataset_fast_scale_and_unported_knobs(pipelines, jpeg_paths, tmp_path):  # noqa: F811
    """tpucap's default fast_scale=True: these files pick 8/8 at 64, and
    three larger ones pick 4/8, 5/8 and 3/8 (their chroma IDCT'd at 8, 10
    and 6), with the captions tpucap gives; parallelism other than none
    raises."""
    jpipe, pipe = pipelines
    assert pipe.caption_dataset(jpeg_paths, batch_size=3) == pipe.caption_dataset(
        jpeg_paths, batch_size=3, fast_scale=False
    )
    rng = np.random.default_rng(23)
    large = []
    for i, (h, w, sub) in enumerate([(150, 200, 2), (110, 170, 1), (210, 180, 2)]):
        path = tmp_path / f"large{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            path, quality=90, subsampling=sub)
        large.append(str(path))
    paths = [*large, *jpeg_paths[:2]]
    assert [decode_scale(p) for p in large] == [4, 5, 3]
    want = jpipe.caption_dataset(paths, batch_size=3)
    assert pipe.caption_dataset(paths, batch_size=3) == want
    with pytest.raises(NotImplementedError, match="parallelism"):
        pipe.caption_dataset(jpeg_paths, parallelism="dp")
    with pytest.raises(NotImplementedError, match="parallelism"):
        pipe.extract_features(jpeg_paths, parallelism="dp")


def decode_scale(path):
    """The scale tpucap's search picks for a file at the encoder's 64."""
    h, w = jpeg_dims(open(path, "rb").read())
    return scale_num(h, w, 64)


def test_extract_features_matches_jax(pipelines, jpeg_paths):  # noqa: F811
    jpipe, pipe = pipelines
    want = np.asarray(jpipe.extract_features(jpeg_paths, batch_size=3))
    got = pipe.extract_features(jpeg_paths, batch_size=3)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(jpeg_paths), 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_caption_images_matches_jax(pipelines, jpeg_paths):  # noqa: F811
    jpipe, pipe = pipelines
    want = jpipe.caption_images(jpeg_paths, method="beam")
    assert pipe.caption_images(jpeg_paths, method="beam") == want
    assert len(set(want)) > 1


def test_caption_images_takes_progressive_and_rgb_coded_files(pipelines, tmp_path):  # noqa: F811
    """extract_features / caption_images (tpucap reads through PIL at full
    scale) on a progressive file, a progressive 4:2:2 one and an RGB-coded
    one (the Adobe marker's transform 0): the same captions as tpucap."""
    jpipe, pipe = pipelines
    rng = np.random.default_rng(29)
    paths = []
    for i, opts in enumerate([{"progressive": True, "subsampling": 2},
                              {"progressive": True, "subsampling": 1},
                              {"keep_rgb": True, "subsampling": 0}]):
        path = tmp_path / f"kind{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(
            path, quality=90, **opts)
        paths.append(str(path))
    assert b"Adobe" in open(paths[2], "rb").read()
    want = np.asarray(jpipe.extract_features(paths, batch_size=3))
    got = pipe.extract_features(paths, batch_size=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert pipe.caption_images(paths, method="beam") == jpipe.caption_images(paths, method="beam")


# The load_image route (extract_features, caption_images) on every kind of
# file tpucap's load_image opens through PIL: CMYK JPEGs with and without
# the Adobe marker, YCCK, arithmetic-coded, and PNG, BMP and GIF files.
OTHER_KINDS = ["cmyk_adobe", "cmyk_plain", "ycck", "cmyk_progressive", "arith", "png_rgb",
               "png_rgba", "png_palette", "png_gray", "bmp", "gif"]


@pytest.fixture(scope="module")
def other_paths(tmp_path_factory):
    """{kind: path}, 70 x 90 (wider than tall) and 90 x 70 alternately."""
    from test_torch_jpeg import fixtures_script

    d = tmp_path_factory.mktemp("other")
    compress = fixtures_script.libjpeg_compressor(d)
    rng = np.random.default_rng(31)
    paths = {}
    for i, kind in enumerate(OTHER_KINDS):
        h, w = (70, 90) if i % 2 else (90, 70)
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ink = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        path = d / f"{kind}.{kind.split('_')[0] if kind[:3] in ('png', 'bmp', 'gif') else 'jpg'}"
        if kind in ("cmyk_adobe", "cmyk_plain"):
            blob = compress(ink, 90, "1x1,1x1,1x1,1x1", color="cmyk")
            if kind == "cmyk_plain":
                i0 = blob.index(b"\xff\xee")
                blob = blob[:i0] + blob[i0 + 2 + int.from_bytes(blob[i0 + 2 : i0 + 4], "big"):]
                assert b"Adobe" not in blob
            path.write_bytes(blob)
        elif kind == "ycck":
            path.write_bytes(compress(ink, 90, "2x2,1x1,1x1,2x2", color="ycck"))
        elif kind == "cmyk_progressive":
            path.write_bytes(compress(ink, 85, "2x1,1x1,1x1,1x1", color="cmyk", scans="1", arith=True))
        elif kind == "arith":
            path.write_bytes(compress(rgb, 85, "2x2,1x1,1x1", arith=True, restart=2))
        elif kind == "png_rgba":
            Image.fromarray(ink, "RGBA").save(path)
        elif kind == "png_palette":
            Image.fromarray(rgb).quantize(64).save(path)
        elif kind == "png_gray":
            Image.fromarray(rgb[..., 0]).save(path)
        else:
            Image.fromarray(rgb).save(path)
        paths[kind] = str(path)
    return paths


@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_load_images_give_tpucaps_load_image_bytes(other_paths, kind):
    """The port's load_images against tpucap's load_image (PIL), uint8 equal:
    at 64 (down) and 96 (up), and at 63 and 75, where Pillow's NEAREST,
    summing its steps in double, takes another row or column than tpucap's
    C resize (floor((i + 0.5) * src / dst)) for both 70 and 90."""
    from tpucap.data.preprocess import load_image
    from tpucap_torch.data.preprocess import load_images

    def c_resize(dst, src):
        return [min(int((i + 0.5) * (src / dst)), src - 1) for i in range(dst)]

    def pil_resize(dst, src):
        step, out = src / dst, []
        x = step * 0.5
        for _ in range(dst):
            out.append(min(int(x), src - 1))
            x += step
        return out

    for size in (63, 75):
        assert all(c_resize(size, src) != pil_resize(size, src) for src in (70, 90))
    path = other_paths[kind]
    for size in (64, 96, 63, 75):
        want = load_image(path, (size, size)).astype(np.uint8)
        np.testing.assert_array_equal(load_images([path], size=size)[0], want,
                                      err_msg=f"{kind} -> {size}")


def test_extract_features_and_caption_images_take_every_format(pipelines, other_paths,  # noqa: F811
                                                               jpeg_paths):
    """One call over all the kinds and two baseline JPEGs, in batches of 4
    (the JPEGs decoded in one C call, the rest through PIL, the rows put
    back in order): tpucap's features within the encoder tolerance, its
    captions token for token."""
    jpipe, pipe = pipelines
    paths = [*other_paths.values(), *jpeg_paths[:2]]
    want = np.asarray(jpipe.extract_features(paths, batch_size=4))
    got = pipe.extract_features(paths, batch_size=4)
    assert got.shape == want.shape == (len(paths), 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert pipe.caption_images(paths, method="beam") == jpipe.caption_images(paths, method="beam")


def test_caption_dataset_still_refuses_cmyk(pipelines, other_paths, jpeg_paths):  # noqa: F811
    """caption_dataset's decoder converts to RGB, which libjpeg-turbo does not
    do from CMYK or YCCK: tpucap refuses them, and so does the port."""
    jpipe, pipe = pipelines
    for kind in ("cmyk_adobe", "ycck"):
        paths = [jpeg_paths[0], other_paths[kind]]
        with pytest.raises(ValueError):
            jpipe.caption_dataset(paths, batch_size=2)
        with pytest.raises(ValueError, match=f"{kind}.jpg: color space"):
            pipe.caption_dataset(paths, batch_size=2)


def test_refused_jpegs_never_reach_pil(other_paths, jpeg_paths, tmp_path, monkeypatch):
    """A file that starts with a JPEG SOI is the port decoder's alone: one it
    refuses raises naming the file and why, with PIL never asked. Without
    PIL, a JPEG still decodes and any other file raises ImportError naming
    PIL, as tpucap's load_image would."""
    from tpucap_torch.data import preprocess

    def no_pil(path, size):
        raise AssertionError(f"{path} reached PIL")

    twelve = tmp_path / "twelve.jpg"
    blob = open(jpeg_paths[0], "rb").read()
    sof = blob.index(b"\xff\xc0")
    twelve.write_bytes(blob[: sof + 4] + bytes([12]) + blob[sof + 5 :])
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(b"\xff\xd8\xff\xdb")
    monkeypatch.setattr(preprocess, "pil_load", no_pil)
    with pytest.raises(ValueError, match=r"twelve.jpg: sample precision.*cut.jpg: corrupt"):
        preprocess.load_images([jpeg_paths[0], str(twelve), other_paths["ycck"], str(cut)], size=32)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "PIL", None)
    jpegs = preprocess.load_images([jpeg_paths[0], other_paths["cmyk_adobe"]], size=32)
    assert jpegs.shape == (2, 32, 32, 3)
    with pytest.raises(ImportError, match="PIL"):
        preprocess.load_images([jpeg_paths[0], other_paths["png_rgb"]], size=32)


def test_cut_and_corrupt_jpegs_follow_load_image(other_paths, jpeg_paths, tmp_path):
    """96 cut or corrupted mutants of baseline, progressive, arithmetic and
    CMYK / YCCK files on the load_image route. PIL's source suspends where
    libjpeg's would feed a fake EOI, and load_image raises "image file is
    truncated" (or, for arithmetic data, "broken data stream") unless every
    row was out by then; corrupt data only warns. The port refuses the same
    files and gives the same bytes for the rest; a single-scan file whose
    EOI is missing after another marker decodes in both."""
    from tpucap.data.preprocess import load_image
    from tpucap_torch.data.preprocess import load_images

    rng = np.random.default_rng(37)
    bases = [open(p, "rb").read() for p in
             [jpeg_paths[0], other_paths["arith"], other_paths["ycck"],
              other_paths["cmyk_progressive"]]]
    baseline = bases[0]
    mutants = [baseline[:-2] + b"\xff\xfe\x00\x04ab", baseline[:-2] + b"\xff\xd3"]
    for trial in range(96):
        blob = bytearray(bases[trial % len(bases)])
        sos = bytes(blob).index(b"\xff\xda")
        if trial % 3 == 0:
            blob = blob[: rng.integers(sos, len(blob))]
        elif trial % 3 == 1:
            blob = blob[: len(blob) - rng.integers(1, 4)]
        else:
            for _ in range(rng.integers(1, 4)):
                blob[rng.integers(sos + 10, len(blob) - 2)] = rng.integers(0, 256)
        mutants.append(bytes(blob))
    decoded = refused = 0
    for k, blob in enumerate(mutants):
        path = tmp_path / f"m{k}.jpg"
        path.write_bytes(blob)
        size = [16, 33, 64][k % 3]
        try:
            want = load_image(str(path), (size, size)).astype(np.uint8)
        except OSError:
            with pytest.raises(ValueError, match=f"m{k}.jpg: (truncated|corrupt)"):
                load_images([path], size=size)
            refused += 1
            continue
        np.testing.assert_array_equal(load_images([path], size=size)[0], want, err_msg=f"m{k}")
        decoded += 1
    assert decoded > 25 and refused > 25


def test_soi_not_followed_by_ff_follows_each_route(pipelines, jpeg_paths, tmp_path):  # noqa: F811
    """A JPEG with a 00 after its SOI: PIL's JPEG plugin takes only files that
    start FF D8 FF, so tpucap's load_image (extract_features, caption_images)
    raises UnidentifiedImageError, and the port's load_image route sends the
    file to PIL, which raises the same; libjpeg skips the byte to the next
    marker, so caption_dataset decodes it in both, to the same captions."""
    from PIL import UnidentifiedImageError

    from tpucap.data.preprocess import load_image
    from tpucap_torch.data.preprocess import load_images

    jpipe, pipe = pipelines
    blob = open(jpeg_paths[0], "rb").read()
    odd = tmp_path / "soi_00.jpg"
    odd.write_bytes(blob[:2] + b"\x00" + blob[2:])
    paths = [str(odd), jpeg_paths[1]]
    with pytest.raises(UnidentifiedImageError):
        load_image(str(odd), (64, 64))
    with pytest.raises(UnidentifiedImageError):
        load_images([str(odd)], size=64)
    for p in (jpipe, pipe):
        with pytest.raises(UnidentifiedImageError):
            p.extract_features(paths, batch_size=2)
        with pytest.raises(UnidentifiedImageError):
            p.caption_images(paths, method="beam")
    want = jpipe.caption_dataset(paths, batch_size=2, method="beam", fast_scale=False)
    assert pipe.caption_dataset(paths, batch_size=2, method="beam", fast_scale=False) == want
    np.testing.assert_array_equal(
        decode_jpeg_files([str(odd)], 64, fast_scale=False),
        decode_jpeg_files([jpeg_paths[0]], 64, fast_scale=False),
    )
