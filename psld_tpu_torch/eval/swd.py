"""Sliced Wasserstein distance between image directories
(``psld_tpu/eval/swd.py``), in NumPy: a distributional quality metric
without weights (ProGAN's protocol, Karras et al. 2018, appendix A).

Per level of a Laplacian pyramid: 7x7x3 patches at ``patches_per_image``
random positions an image, each descriptor set normalized per colour
channel over itself, both sets trimmed to one count, projected onto
``n_proj`` random unit directions, sorted, and the mean absolute
difference taken, ``repeats`` times with fresh directions. Values are
scaled by 1e3, per level (finest first) and as ``avg``.
"""

from __future__ import annotations

import numpy as np

from psld_tpu_torch.eval.pixel_stats import _iter_images

_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64)
_K /= _K.sum()


def _blur(x: np.ndarray) -> np.ndarray:
    """Separable 5-tap binomial blur over H and W (reflect padding) of
    (N, H, W, C)."""
    for axis in (1, 2):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (2, 2)
        xp = np.pad(x, pad, mode="reflect")
        out = np.zeros_like(x)
        for i, k in enumerate(_K):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(i, i + x.shape[axis])
            out += k * xp[tuple(sl)]
        x = out
    return x


def _down(x: np.ndarray) -> np.ndarray:
    return _blur(x)[:, ::2, ::2]


def _up(x: np.ndarray) -> np.ndarray:
    n, h, w, c = x.shape
    out = np.zeros((n, h * 2, w * 2, c), x.dtype)
    out[:, ::2, ::2] = x
    return 4.0 * _blur(out)  # the gain restores brightness after stuffing


def laplacian_pyramid(x: np.ndarray, min_res: int = 16) -> list:
    """High-frequency residuals per scale, then the low-pass base."""
    levels = []
    while min(x.shape[1], x.shape[2]) > min_res and \
            x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        d = _down(x)
        levels.append(x - _up(d))
        x = d
    levels.append(x)
    return levels


def _descriptors(level: np.ndarray, patches_per_image: int, patch: int,
                 rng: np.random.Generator) -> np.ndarray:
    n, h, w, c = level.shape
    if h < patch or w < patch:
        patch = min(h, w)
    ys = rng.integers(0, h - patch + 1, (n, patches_per_image))
    xs = rng.integers(0, w - patch + 1, (n, patches_per_image))
    out = np.empty((n * patches_per_image, patch, patch, c), np.float64)
    k = 0
    for i in range(n):
        img = level[i]
        for j in range(patches_per_image):
            out[k] = img[ys[i, j]:ys[i, j] + patch,
                         xs[i, j]:xs[i, j] + patch]
            k += 1
    mu = out.mean(axis=(0, 1, 2), keepdims=True)
    sd = out.std(axis=(0, 1, 2), keepdims=True) + 1e-8
    return ((out - mu) / sd).reshape(len(out), -1)


def sliced_wasserstein(a: np.ndarray, b: np.ndarray, n_proj: int = 512,
                       repeats: int = 4,
                       rng: np.random.Generator | None = None) -> float:
    """Random-projection Wasserstein-1 between two descriptor sets."""
    rng = rng or np.random.default_rng(0)
    m = min(len(a), len(b))
    dists = []
    for _ in range(repeats):
        ia = rng.permutation(len(a))[:m]
        ib = rng.permutation(len(b))[:m]
        dirs = rng.standard_normal((a.shape[1], n_proj))
        dirs /= np.sqrt((dirs * dirs).sum(axis=0, keepdims=True))
        pa = np.sort(a[ia] @ dirs, axis=0)
        pb = np.sort(b[ib] @ dirs, axis=0)
        dists.append(float(np.abs(pa - pb).mean()))
    return float(np.mean(dists))


def _load_dir(path: str, limit: int | None) -> np.ndarray:
    imgs = list(_iter_images(path, limit))
    if not imgs:
        raise ValueError(f"no images under {path}")
    shape = imgs[0].shape
    return np.stack([i for i in imgs if i.shape == shape]).astype(np.float64)


def swd_dirs(path1: str, path2: str, limit: int | None = None,
             patches_per_image: int = 128, patch: int = 7,
             min_res: int = 16, n_proj: int = 512, repeats: int = 4,
             seed: int = 0) -> dict:
    """Multi-scale SWD between two image directories; values x1e3, keyed
    by level resolution, plus ``avg``."""
    a, b = _load_dir(path1, limit), _load_dir(path2, limit)
    if a.shape[1:] != b.shape[1:]:
        raise ValueError(
            f"image shapes differ: {a.shape[1:]} vs {b.shape[1:]}")
    out, vals = {}, []
    for la, lb in zip(laplacian_pyramid(a, min_res),
                      laplacian_pyramid(b, min_res)):
        # the same seed for both sets: identical patch positions
        da = _descriptors(la, patches_per_image, patch,
                          np.random.default_rng(seed))
        db = _descriptors(lb, patches_per_image, patch,
                          np.random.default_rng(seed))
        v = 1e3 * sliced_wasserstein(da, db, n_proj, repeats,
                                     np.random.default_rng(seed + 1))
        out[f"{la.shape[1]}x{la.shape[2]}"] = round(v, 4)
        vals.append(v)
    out["avg"] = round(float(np.mean(vals)), 4)
    return out
