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
