"""Image writers and reader (``psld_tpu/utils/images.py``), NHWC numpy.

PNGs are written by the native codec (:mod:`psld_tpu_torch.native`: 8-bit
gray, RGB or RGBA, one IDAT chunk, filter 0 on every row, a thread an
image), so the image-folder datasets read them back through it. Images
are read with Pillow.
"""

from __future__ import annotations

import numpy as np

from psld_tpu_torch import native


def data_scaler(img, norm: bool = True) -> np.ndarray:
    """uint8 image -> [-1, 1] (norm) or [0, 1]."""
    img = np.asarray(img).astype(np.float32)
    if norm:
        return img / 127.5 - 1.0
    return img / 255.0


def to_uint8(batch: np.ndarray, denorm: bool = True) -> np.ndarray:
    """float NHWC -> uint8, optionally denormalizing x*0.5+0.5."""
    x = np.asarray(batch, np.float32)
    if denorm:
        x = x * 0.5 + 0.5
    return (x * 255.0).clip(0, 255).astype(np.uint8)


def save_as_images(batch, file_name: str = "output", denorm: bool = True):
    """Save an NHWC float batch as ``<file_name>_<i>.png``."""
    native.write_png_batch(to_uint8(batch, denorm=denorm), file_name)


def save_as_np(batch, file_name: str = "output", denorm: bool = True):
    """Save an NHWC float batch as ``<file_name>_<i>.npy``, min-max
    normalized per sample when ``denorm``."""
    x = np.asarray(batch, np.float32)
    if denorm:
        b = x.shape[0]
        flat = x.reshape(b, -1)
        lo = flat.min(axis=1).reshape(b, 1, 1, 1)
        hi = flat.max(axis=1).reshape(b, 1, 1, 1)
        x = (x - lo) / np.maximum(hi - lo, 1e-8)
    for i, img in enumerate(x):
        np.save(f"{file_name}_{i}.npy", img)


def load_images_rgb(paths) -> np.ndarray:
    """Image files (PNG, JPEG, any mode Pillow reads) as an (N, H, W, 3)
    uint8 batch, converted to RGB by Pillow; all must share one size."""
    from PIL import Image

    paths = list(paths)
    if not paths:
        return np.empty((0, 0, 0, 3), np.uint8)
    imgs = []
    for p in paths:
        with Image.open(p) as img:
            imgs.append(np.asarray(img.convert("RGB"), np.uint8))
    return np.stack(imgs)
