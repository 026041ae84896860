"""Host-side input pipeline (``psld_tpu/data/loader.py``).

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
    optional random hflip.

    Several processes: pass ``process_index``/``process_count`` and the
    same seed everywhere. The permutation is then the same in every
    process, and each loads only its contiguous slice of every global
    batch. ``batch_size`` is always the GLOBAL batch, cut down to a
    multiple of ``process_count``. Under spatial parallelism a process
    is a data group: the loops pass its index and count, so the ranks of
    a spatial group load the same rows."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, hflip: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = min(len(dataset), int(batch_size))
        self.batch_size -= self.batch_size % process_count
        if self.batch_size <= 0:
            raise ValueError(f"a dataset of {len(dataset)} cannot fill "
                             f"{process_count} processes")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.hflip = hflip
        self.rng = np.random.default_rng(seed)
        self.local_size = self.batch_size // process_count
        self.local_offset = process_index * self.local_size

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _augment(self, imgs: np.ndarray) -> np.ndarray:
        # the flips are drawn per LOCAL batch from the same generator in
        # every process, so all processes flip the same rows of their
        # slices: the JAX package's behaviour, kept as it is
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
            lo = start + self.local_offset
            batch = self.dataset.batch(
                idxs[lo: min(lo + self.local_size, start + self.batch_size)])
            if isinstance(batch, tuple):
                imgs, targets = batch
                yield self._augment(imgs).astype(np.float32), targets
            else:
                yield self._augment(batch).astype(np.float32)
