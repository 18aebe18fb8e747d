"""Image preprocessing with Keras-parity numerics (the port's copy of
``tpucap.data.preprocess``):

- caffe (VGG16/ResNet-50): RGB->BGR, then per-channel mean subtract;
- tf (InceptionV3): x/127.5 - 1;
- torch: x/255, then ImageNet mean/std.

``load_images`` is tpucap's ``load_image`` (PIL's decode, ``convert("RGB")``,
then the nearest resize) over a batch of files:

- a file that starts with FF D8 FF (a JPEG SOI and a marker, the test of
  PIL's JPEG plugin) goes through the port's own decoder at
  scale 8/8 (``fast_scale=False``) with Pillow's NEAREST resize, which gives
  PIL's bytes for every JPEG it decodes: Huffman or arithmetic, sequential
  or progressive, gray, YCbCr, RGB, and CMYK or YCCK converted as Pillow
  converts them. A JPEG it refuses raises ``ValueError`` naming the file,
  and never reaches PIL; so does one whose data ends before its image
  does, which ``load_image`` refuses as truncated (tpucap's own decoder
  and ``caption_dataset`` decode it, as libjpeg does);
- any other file (PNG, BMP, GIF, ..., and one whose SOI is not followed by
  FF, which PIL refuses and libjpeg would decode) goes through
  ``load_image``'s own steps in PIL, which is imported there and nowhere
  else in the port.
"""

from __future__ import annotations

import numpy as np

CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)
TORCH_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
TORCH_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_input(x, mode: str = "caffe"):
    """x: float array (..., 3) RGB in [0, 255] -> model input (numpy f32)."""
    x = np.asarray(x, np.float32)
    if mode == "caffe":
        x = x[..., ::-1]  # RGB -> BGR
        return x - CAFFE_MEAN_BGR
    if mode == "tf":
        return x / 127.5 - 1.0
    if mode == "torch":
        return (x / 255.0 - TORCH_MEAN) / TORCH_STD
    raise ValueError(f"unknown preprocess mode {mode!r}")


def pil_load(path, size: int) -> np.ndarray:
    """One non-JPEG file as ``load_image`` reads it -> (size, size, 3) uint8:
    ``Image.open``, ``convert("RGB")``, the NEAREST resize where the size
    differs. Raises ImportError naming PIL where it is not installed."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.Resampling.NEAREST)
        return np.asarray(img, np.uint8)


def load_images(paths, *, size: int) -> np.ndarray:
    """Image files -> (N, size, size, 3) uint8 RGB, as tpucap's
    ``load_image`` gives them: JPEGs through the port's decoder in one
    threaded call, the other files through ``pil_load``, in order."""
    # Imported here: tpucap_torch.ops imports this module's constants.
    from tpucap_torch.ops import jpeg

    paths = [str(p) for p in paths]
    out, status = jpeg.decode_files(paths, size, fast_scale=False, load_image=True)
    not_jpeg = status == 2  # no FF D8 FF: jpeg_decode.cpp's kNotJpeg
    if (status[~not_jpeg] != 0).any():
        jpeg._raise_for(np.where(not_jpeg, 0, status), paths)
    for i in np.flatnonzero(not_jpeg):
        out[i] = pil_load(paths[i], size)
    return out


def preprocess_batch(paths, *, size: int, mode: str) -> np.ndarray:
    """Decode + nearest resize + normalize image files -> (N, size, size, 3)
    f32."""
    return preprocess_input(load_images(paths, size=size).astype(np.float32), mode)
