"""Prior source for generation (``psld_tpu/data/datasets.py``:
``SDELatentDataset``). Image datasets come with the training slice."""

from __future__ import annotations

import numpy as np
import torch

from psld_tpu_torch.registry import register_module


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
