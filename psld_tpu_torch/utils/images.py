"""Image writers and reader (``psld_tpu/utils/images.py``), NHWC numpy.

PNGs are encoded with the standard library (zlib + struct): 8-bit gray,
RGB or RGBA, one IDAT chunk, filter 0 on every row. Images are read with
Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


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


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, C) uint8 with C in {1, 3, 4} -> PNG bytes."""
    h, w, c = img.shape
    if img.dtype != np.uint8 or c not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes (H, W, 1|3|4) uint8, got "
                         f"{img.shape} {img.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_as_images(batch, file_name: str = "output", denorm: bool = True):
    """Save an NHWC float batch as ``<file_name>_<i>.png``."""
    for i, img in enumerate(to_uint8(batch, denorm=denorm)):
        with open(f"{file_name}_{i}.png", "wb") as f:
            f.write(encode_png(img))


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
