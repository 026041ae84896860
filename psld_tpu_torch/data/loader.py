"""Host-side input pipeline (``psld_tpu/data/loader.py``), one process.

shuffle=True, drop_last=True, ``batch_size = min(len(dataset),
batch_size)``, random horizontal flip. Batches are NHWC float32 numpy
arrays. The permutation and the flips come from one numpy generator, as
in the JAX package: the same seed gives the same batches.
"""

from __future__ import annotations

import numpy as np

from psld_tpu_torch.registry import get_module


def get_dataset(config):
    """Config-driven dataset construction."""
    name = str(config.data.name).lower()
    if name == "cifar10" and int(config.data.image_size) != 32:
        raise ValueError("CIFAR-10 is 32x32")
    cls = get_module("datasets", name)
    return cls(
        config.data.root,
        norm=bool(config.data.norm),
        image_size=int(config.data.image_size),
        return_target=bool(config.data.get("return_target", False)),
    )


class EpochLoader:
    """Numpy epoch iterator: per-epoch reshuffle, drop-last batching,
    optional random hflip."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, hflip: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = min(len(dataset), int(batch_size))
        if self.batch_size <= 0:
            raise ValueError("empty dataset")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.hflip = hflip
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _augment(self, imgs: np.ndarray) -> np.ndarray:
        if not self.hflip:
            return imgs
        flip = self.rng.random(imgs.shape[0]) < 0.5
        out = imgs.copy()
        out[flip] = out[flip, :, ::-1]
        return out

    def __iter__(self):
        n = len(self.dataset)
        idxs = self.rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for start in range(0, stop, self.batch_size):
            batch = self.dataset.batch(idxs[start: start + self.batch_size])
            if isinstance(batch, tuple):
                imgs, targets = batch
                yield self._augment(imgs).astype(np.float32), targets
            else:
                yield self._augment(batch).astype(np.float32)
