"""Datasets (``psld_tpu/data/datasets.py``): numpy-native NHWC image sets
for training, the prior source for generation, and the image-and-mask
pairs of inpainting.

No downloads: CIFAR-10 is parsed from its standard pickles on disk, MNIST
(the inpainting masks) from its idx file, and a ``synthetic`` dataset
makes procedural images from a seed. All are numpy on this side and in
the JAX package, so the same seed gives the same images. The image-folder
datasets (CelebA, AFHQ) are not ported yet.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from psld_tpu_torch.registry import register_module
from psld_tpu_torch.utils.images import data_scaler


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


def batch_generator(seed: int, batch_idx: int, device) -> torch.Generator:
    """The generator of one batch, seeded from (seed, batch_idx); it draws
    both the batch's prior sample and its trajectory noise."""
    words = np.random.SeedSequence([int(seed), int(batch_idx)])
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
