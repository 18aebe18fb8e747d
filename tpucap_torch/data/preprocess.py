"""Image preprocessing with Keras-parity numerics (the port's copy of
``tpucap.data.preprocess``):

- caffe (VGG16/ResNet-50): RGB->BGR, then per-channel mean subtract;
- tf (InceptionV3): x/127.5 - 1;
- torch: x/255, then ImageNet mean/std.

``preprocess_batch`` reads image files through the port's own JPEG decoder
at scale 8/8 with the nearest resize (``fast_scale=False``), which gives
PIL's bytes for a baseline or progressive JPEG in gray, YCbCr or RGB, where
tpucap's ``load_image`` calls PIL. Other formats (PNG, ...) and CMYK JPEGs,
which PIL converts, raise ``ValueError``: the port has no PIL.
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


def preprocess_batch(paths, *, size: int, mode: str) -> np.ndarray:
    """Decode + nearest resize + normalize image files -> (N, size, size, 3)
    f32."""
    # Imported here: tpucap_torch.ops imports this module's constants.
    from tpucap_torch.ops.jpeg import decode_jpeg_files

    images = decode_jpeg_files(paths, size, fast_scale=False)
    return preprocess_input(images.astype(np.float32), mode)
