"""Datasets (``psld_tpu/data/datasets.py``): numpy-native NHWC image sets
for training, the prior source for generation, and the image-and-mask
pairs of inpainting.

No downloads: CIFAR-10 is parsed from its standard pickles on disk, MNIST
(the inpainting masks) from its idx file, and a ``synthetic`` dataset
makes procedural images from a seed. All are numpy on this side and in
the JAX package, so the same seed gives the same images. The image-folder
datasets (``celeba64``, ``celebahq``, ``afhqv2``) read a directory of
images a user supplies, in the JAX package's layout and sort order.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np
import torch

from psld_tpu_torch import native
from psld_tpu_torch.registry import register_module
from psld_tpu_torch.utils.images import data_scaler

logger = logging.getLogger(__name__)


class ArrayDataset:
    """In-memory uint8 NHWC images + optional integer targets."""

    def __init__(self, images: np.ndarray, targets=None, norm: bool = True,
                 return_target: bool = False, subsample_size=None):
        if subsample_size is not None:
            images = images[: int(subsample_size)]
            targets = None if targets is None \
                else targets[: int(subsample_size)]
        self.images = images
        self.targets = targets
        self.norm = norm
        self.return_target = return_target

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = data_scaler(self.images[idx], norm=self.norm)
        if self.return_target:
            return img, int(self.targets[idx])
        return img

    def batch(self, idxs: np.ndarray):
        """Vectorized batch fetch."""
        imgs = data_scaler(self.images[idxs], norm=self.norm)
        if self.return_target:
            return imgs, self.targets[idxs].astype(np.int32)
        return imgs


@register_module(category="datasets", name="cifar10")
class CIFAR10Dataset(ArrayDataset):
    """CIFAR-10 train split parsed from ``cifar-10-batches-py`` pickles."""

    def __init__(self, root, norm=True, return_target=False,
                 subsample_size=None, image_size=32, hflip=False, **kwargs):
        del hflip  # augmentation happens in the loader
        if image_size != 32:
            raise ValueError("CIFAR-10 is 32x32")
        base = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            raise ValueError(
                f"CIFAR-10 not found under {root} (need cifar-10-batches-py/)")
        imgs, targets = [], []
        for i in range(1, 6):
            with open(os.path.join(base, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(np.asarray(d[b"data"], np.uint8))
            targets.extend(d[b"labels"])
        images = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        super().__init__(images, np.asarray(targets, np.int64), norm=norm,
                         return_target=return_target,
                         subsample_size=subsample_size)


@register_module(category="datasets", name="synthetic")
class SyntheticDataset(ArrayDataset):
    """Procedural dataset for smoke tests: colored Gaussian blobs on
    gradient backgrounds, 10 pseudo-classes."""

    def __init__(self, root=None, norm=True, return_target=False,
                 subsample_size=None, image_size=32, n=512, seed=0, **kwargs):
        rng = np.random.default_rng(seed)
        n = int(subsample_size or n)
        s = int(image_size)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        images = np.empty((n, s, s, 3), np.uint8)
        targets = rng.integers(0, 10, n)
        for i in range(n):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            sig = rng.uniform(0.08, 0.25)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig**2))
            color = rng.uniform(0.3, 1.0, 3)
            bg = rng.uniform(0, 0.4) + rng.uniform(-0.2, 0.2) * yy
            img = bg[..., None] + blob[..., None] * color
            images[i] = (img.clip(0, 1) * 255).astype(np.uint8)
        super().__init__(images, targets, norm=norm,
                         return_target=return_target)


class _ImageFolder:
    """Lazy folder dataset: images resized (bilinear) to ``image_size``
    and scaled by ``data_scaler``; the base of CelebA and AFHQ.

    ``batch(idxs)`` decodes with the native codec (:mod:`psld_tpu_torch.
    native`, threads over the batch) when the folder is the preprocessed
    layout: every file a PNG the codec takes, RGB (or palette) and at
    ``image_size``, which the first batch checks from every file's header.
    Any other folder (JPEG, a resize, gray, RGBA, 16-bit) is read by
    Pillow, as is every single item (``__getitem__``). The choice is made
    once, logged at INFO with the first file that sent the folder to
    Pillow, and never changes: a decode error raises."""

    def __init__(self, paths, targets=None, image_size=64, norm=True,
                 return_target=False, subsample_size=None):
        if subsample_size is not None:
            paths = paths[: int(subsample_size)]
            targets = None if targets is None \
                else targets[: int(subsample_size)]
        self.paths = paths
        self.targets = targets
        self.image_size = int(image_size)
        self.norm = norm
        self.return_target = return_target
        self._native = None  # decided at the first batch

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        from PIL import Image

        with Image.open(path) as img:
            img = img.convert("RGB")
            if img.size != (self.image_size, self.image_size):
                img = img.resize((self.image_size, self.image_size),
                                 Image.BILINEAR)
            return data_scaler(np.asarray(img, np.uint8), norm=self.norm)

    def __getitem__(self, idx):
        img = self._load(self.paths[idx])
        if self.return_target:
            return img, int(self.targets[idx])
        return img

    @property
    def native(self) -> bool:
        """Whether batches decode through the native codec."""
        if self._native is None:
            want = (self.image_size, self.image_size, 3)

            def refusal(path):
                """Why the codec does not take ``path``, or None."""
                if not path.lower().endswith(".png"):
                    return "not a .png"
                try:
                    info = native.read_png_info(path)
                except native.UnsupportedPng:
                    return "a PNG variant the codec does not decode"
                return None if info == want else f"(h, w, c) {info}"

            why = None
            for path in self.paths:
                why = refusal(path)
                if why is not None:
                    logger.info("%s: %d images read by Pillow: %s is %s, "
                                "not an RGB PNG of %s", type(self).__name__,
                                len(self.paths), path, why, want)
                    break
            else:
                logger.info("%s: %d images read by the native codec",
                            type(self).__name__, len(self.paths))
            self._native = why is None
        return self._native

    def batch(self, idxs):
        paths = [self.paths[i] for i in idxs]
        if self.native:
            imgs = data_scaler(native.read_png_batch(
                paths, self.image_size, self.image_size, 3), norm=self.norm)
        else:
            imgs = np.stack([self._load(p) for p in paths])
        if self.return_target:
            return imgs, self.targets[idxs].astype(np.int32)
        return imgs


@register_module(category="datasets", name="celeba64")
class CelebADataset(_ImageFolder):
    """CelebA from a flat directory of images (PNG, JPEG, WebP)."""

    def __init__(self, root, norm=True, image_size=64, return_target=False,
                 subsample_size=None, **kwargs):
        if not os.path.isdir(root):
            raise ValueError(f"The specified root: {root} does not exist")
        paths = sorted(
            os.path.join(root, p) for p in os.listdir(root)
            if p.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        super().__init__(paths, None, image_size=image_size, norm=norm,
                         return_target=False, subsample_size=subsample_size)


@register_module(category="datasets", name="celebahq")
class CelebAHQDataset(_ImageFolder):
    """CelebA-HQ: ``<root>/<split>/male`` then ``<root>/<split>/female``,
    each sorted."""

    def __init__(self, root, norm=True, image_size=256, return_target=False,
                 subsample_size=None, split="train", **kwargs):
        paths = []
        for sub in ("male", "female"):
            d = os.path.join(root, split, sub)
            if os.path.isdir(d):
                paths.extend(os.path.join(d, p) for p in sorted(os.listdir(d)))
        if not paths:
            raise ValueError(f"No CelebA-HQ images under {root}/{split}")
        super().__init__(paths, None, image_size=image_size, norm=norm,
                         subsample_size=subsample_size)


@register_module(category="datasets", name="afhqv2")
class AFHQv2Dataset(_ImageFolder):
    """AFHQv2: ``cat``, ``dog`` and ``wild`` (labels 0, 1, 2) under
    ``<root>/<split>``, or under ``<root>`` where there is no such
    directory; each sorted."""

    CLASSES = ("cat", "dog", "wild")

    def __init__(self, root, norm=True, image_size=128, return_target=False,
                 subsample_size=None, split="train", **kwargs):
        base = os.path.join(root, split) if os.path.isdir(
            os.path.join(root, split)) else root
        paths, targets = [], []
        for label, cls in enumerate(self.CLASSES):
            d = os.path.join(base, cls)
            if os.path.isdir(d):
                for p in sorted(os.listdir(d)):
                    paths.append(os.path.join(d, p))
                    targets.append(label)
        if not paths:
            raise ValueError(f"No AFHQv2 images under {base}")
        super().__init__(paths, np.asarray(targets, np.int64),
                         image_size=image_size, norm=norm,
                         return_target=return_target,
                         subsample_size=subsample_size)


def load_mnist_images(root: str) -> np.ndarray:
    """MNIST's train images, (N, 28, 28) uint8, from the standard idx file
    ``train-images-idx3-ubyte`` under ``root`` or ``root/MNIST/raw``."""
    candidates = [
        os.path.join(root, "MNIST", "raw", "train-images-idx3-ubyte"),
        os.path.join(root, "train-images-idx3-ubyte"),
    ]
    for path in candidates:
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            n = int.from_bytes(data[4:8], "big")
            return np.frombuffer(data, np.uint8, offset=16).reshape(n, 28, 28)
    raise FileNotFoundError(f"MNIST idx files not found under {root}")


@register_module(category="datasets", name="inpaint")
class InpaintDataset:
    """Pairs base-dataset images with binary masks cut from MNIST digits:
    mask = 1 - (digit > 0), resized nearest to the image size, repeated
    over 3 channels; 1 marks the known region. Where MNIST is absent under
    ``data.root``, ``mask_mode`` is ``square``: a known frame around an
    unknown centre square of half the image's side."""

    def __init__(self, config, dataset):
        self.config = config
        self.dataset = dataset
        self.size = int(config.data.image_size)
        try:
            self._digits = load_mnist_images(config.data.root)
            self.mask_mode = "mnist"
        except (FileNotFoundError, ValueError):
            self._digits = None
            self.mask_mode = "square"

    def _mask(self, idx):
        if self.mask_mode == "mnist":
            digit = self._digits[idx % len(self._digits)]
            ys = (np.arange(self.size) * 28 // self.size).clip(0, 27)
            digit = digit[np.ix_(ys, ys)]
            mask = 1 - (digit > 0).astype(np.float32)
        else:
            mask = np.ones((self.size, self.size), np.float32)
            q = self.size // 4
            mask[q: 3 * q, q: 3 * q] = 0.0
        return np.repeat(mask[..., None], 3, axis=-1)

    def __len__(self):
        n = int(self.config.evaluation.n_samples)
        return min(n, len(self.dataset))

    def __getitem__(self, idx):
        img = self.dataset[idx]
        mask = self._mask(idx)
        if mask.shape != img.shape:
            raise ValueError(f"mask {mask.shape} vs image {img.shape}")
        return img, mask

    def batch(self, idxs):
        imgs = self.dataset.batch(idxs)
        masks = np.stack([self._mask(int(i)) for i in idxs])
        return imgs, masks


def batch_generator(seed: int, batch_idx: int, device,
                    rank: int | None = None) -> torch.Generator:
    """The generator of one batch, seeded from (seed, batch_idx), and
    under per-rank fan-out from ``rank`` as numpy's spawn key (so rank 0
    too draws apart from a run of one process); it draws both the
    batch's prior sample and its trajectory noise."""
    words = np.random.SeedSequence(
        [int(seed), int(batch_idx)],
        spawn_key=() if rank is None else (int(rank),))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words.generate_state(1, np.uint64)[0]))
    return gen


@register_module(category="datasets", name="latent")
class SDELatentDataset:
    """Draws prior samples per batch on the batch's device, so large runs
    need no host memory."""

    def __init__(self, sde, config):
        self.sde = sde
        self.shape = (int(config.data.num_channels),
                      int(config.data.image_size))

    def sample_batch(self, generator, batch_size: int, device=None,
                     dtype=torch.float32):
        c, s = self.shape
        return self.sde.prior_sampling(generator, (batch_size, s, s, c),
                                       dtype=dtype, device=device)
