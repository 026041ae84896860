"""Prediction writer (``psld_tpu/eval/writers.py::SimpleImageWriter``).

Layout and naming as the JAX package: ``<output_dir>[/<path_prefix>]/
images/output_<sample_prefix>_<rank>_<batch>_<i>.png``.
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
