"""Sample-quality sanity metrics over image directories, without weights
(``psld_tpu/eval/pixel_stats.py``), in NumPy.

They catch the common failures: residual noise (high total variation),
mode collapse (low diversity across samples) and range or denormalisation
bugs (shifted moments). Sanity metrics, not a stand-in for FID.

Reported per directory, plus deltas:

* ``mean`` / ``std``: pixel moments in [0, 1];
* ``tv``: mean absolute difference of horizontally and vertically
  adjacent pixels (noise reads ~0.5, natural images ~0.03);
* ``diversity``: the mean over pixels of the std across samples;
* ``hist_l1``: the L1 distance of per-channel 64-bin histograms.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from psld_tpu_torch.utils.images import load_images_rgb

_BINS = 64
_CHUNK = 256


@dataclasses.dataclass
class DirStats:
    n: int
    mean: float
    std: float
    tv: float
    diversity: float
    hist: np.ndarray  # (C, _BINS), normalized

    def to_dict(self) -> dict:
        return {"n": self.n, "mean": round(self.mean, 4),
                "std": round(self.std, 4), "tv": round(self.tv, 4),
                "diversity": round(self.diversity, 4)}


def image_files(path: str) -> list:
    """The PNG and JPEG files under ``path``, recursively, sorted."""
    return sorted(
        f for ext in ("*.png", "*.jpg", "*.jpeg")
        for f in glob.glob(os.path.join(path, "**", ext), recursive=True))


def _iter_images(path: str, limit: int | None = None):
    files = image_files(path)
    if limit:
        files = files[:limit]
    for start in range(0, len(files), _CHUNK):
        for img in load_images_rgb(files[start:start + _CHUNK]):
            yield np.asarray(img, np.float32) / 255.0


def compute_dir_stats(path: str, limit: int | None = None) -> DirStats:
    n = 0
    n_div = 0  # images in the diversity moments: the first-seen shape only
    s = ss = tv = 0.0
    px_sum = px_sq = None
    hist = np.zeros((3, _BINS), np.float64)
    for img in _iter_images(path, limit):
        n += 1
        s += float(img.mean())
        ss += float((img * img).mean())
        tv += float(np.abs(np.diff(img, axis=0)).mean()
                    + np.abs(np.diff(img, axis=1)).mean()) / 2.0
        if px_sum is None:
            px_sum = np.zeros_like(img, np.float64)
            px_sq = np.zeros_like(img, np.float64)
        if img.shape == px_sum.shape:
            px_sum += img
            px_sq += img * img
            n_div += 1
        for c in range(3):
            h, _ = np.histogram(img[..., c], bins=_BINS, range=(0.0, 1.0))
            hist[c] += h
    if n == 0:
        raise ValueError(f"no images under {path}")
    mean = s / n
    var = max(ss / n - mean * mean, 0.0)
    pvar = np.maximum(px_sq / n_div - (px_sum / n_div) ** 2, 0.0)
    hist /= hist.sum(axis=1, keepdims=True)
    return DirStats(n=n, mean=mean, std=float(np.sqrt(var)), tv=tv / n,
                    diversity=float(np.sqrt(pvar).mean()), hist=hist)


def compare_dirs(path1: str, path2: str, limit: int | None = None) -> dict:
    a = compute_dir_stats(path1, limit)
    b = compute_dir_stats(path2, limit)
    hist_l1 = float(np.abs(a.hist - b.hist).sum(axis=1).mean())
    return {
        "input1": a.to_dict(),
        "input2": b.to_dict(),
        "delta": {
            "mean": round(abs(a.mean - b.mean), 4),
            "std": round(abs(a.std - b.std), 4),
            "tv": round(abs(a.tv - b.tv), 4),
            "diversity": round(abs(a.diversity - b.diversity), 4),
            "hist_l1": round(hist_l1, 4),
        },
    }
