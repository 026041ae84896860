"""Abstract SDE contract (``psld_tpu/sde/base.py``).

Image tensors are NHWC with the phase-space state ``z = cat([x, m], -1)``
on the trailing channel axis; random draws take an explicit
``torch.Generator``.
"""

from __future__ import annotations

import abc

import torch


class SDE(abc.ABC):
    """A forward-time Ito SDE dz = f(z,t) dt + g(t) dW on t in [0, T]."""

    def __init__(self, n_timesteps: int):
        self.N = n_timesteps

    @property
    def T(self) -> float:
        return 1.0

    @property
    def is_augmented(self) -> bool:
        """Whether the state carries a momentum half (phase space)."""
        return False

    @abc.abstractmethod
    def sde(self, z, t):
        """Forward drift and diffusion ``(f, g)`` at (z, t)."""

    @abc.abstractmethod
    def reverse_sde(self, z, t, score_fn, probability_flow=False):
        """Reverse drift/diffusion in flipped time (t measured from T)."""

    @abc.abstractmethod
    def prior_sampling(self, generator, shape, dtype=None, device=None):
        """Sample z_T from the equilibrium prior."""

    def timestep_vector(self, t: float, batch: int,
                        device=None) -> torch.Tensor:
        """A scalar time as a float64 per-batch vector on ``device``:
        filled there, so a sampler step copies nothing from the host."""
        return torch.full((batch,), float(t), dtype=torch.float64,
                          device=device)
