"""Prediction writers (``psld_tpu/eval/writers.py``).

Layout and naming as the JAX package: ``<output_dir>[/<path_prefix>]/
images/output_<sample_prefix>_<rank>_<batch>_<i>.png``, plus ``batch/``
and ``corrupt/`` beside ``images/`` for inpainting.
"""

from __future__ import annotations

import os

import numpy as np

from psld_tpu_torch.utils.images import save_as_images, save_as_np


class SimpleImageWriter:
    def __init__(self, output_dir, sample_prefix="", path_prefix="",
                 save_mode="image", is_norm=True, is_augmented=True):
        self.output_dir = output_dir
        self.sample_prefix = sample_prefix
        self.path_prefix = str(path_prefix)
        self.is_norm = is_norm
        self.is_augmented = is_augmented
        self.save_fn = save_as_images if save_mode == "image" else save_as_np

    def _base(self):
        if self.path_prefix != "":
            return os.path.join(self.output_dir, self.path_prefix)
        return self.output_dir

    def write_batch(self, samples, rank: int, batch_idx: int):
        samples = np.asarray(samples)
        if self.is_augmented:
            samples = samples[..., : samples.shape[-1] // 2]
        img_dir = os.path.join(self._base(), "images")
        os.makedirs(img_dir, exist_ok=True)
        self.save_fn(
            samples,
            file_name=os.path.join(
                img_dir, f"output_{self.sample_prefix}_{rank}_{batch_idx}"),
            denorm=self.is_norm,
        )


class InpaintingImageWriter(SimpleImageWriter):
    """Also writes the ground-truth batch (``batch/``) and the masked
    input (``corrupt/``) under the samples' file names, when given the
    ``(images, masks)`` batch."""

    def write_batch(self, samples, rank: int, batch_idx: int, batch=None):
        super().write_batch(samples, rank, batch_idx)
        if batch is None:
            return
        img, mask = (np.asarray(b) for b in batch)
        base = self._base()
        batch_dir = os.path.join(base, "batch")
        corr_dir = os.path.join(base, "corrupt")
        os.makedirs(batch_dir, exist_ok=True)
        os.makedirs(corr_dir, exist_ok=True)
        img = img * 0.5 + 0.5
        name = f"output_{self.sample_prefix}_{rank}_{batch_idx}"
        self.save_fn(img * mask, file_name=os.path.join(corr_dir, name),
                     denorm=False)
        self.save_fn(img, file_name=os.path.join(batch_dir, name),
                     denorm=False)
