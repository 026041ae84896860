"""Abstract SDE contract (``psld_tpu/sde/base.py``).

Image tensors are NHWC with the phase-space state ``z = cat([x, m], -1)``
on the trailing channel axis; random draws take an explicit
``torch.Generator``.
"""

from __future__ import annotations

import abc


class SDE(abc.ABC):
    """A forward-time Ito SDE dz = f(z,t) dt + g(t) dW on t in [0, T]."""

    def __init__(self, n_timesteps: int):
        self.N = n_timesteps

    @property
    def T(self) -> float:
        return 1.0

    @abc.abstractmethod
    def sde(self, z, t):
        """Forward drift and diffusion ``(f, g)`` at (z, t)."""

    @abc.abstractmethod
    def reverse_sde(self, z, t, score_fn, probability_flow=False):
        """Reverse drift/diffusion in flipped time (t measured from T)."""

    @abc.abstractmethod
    def prior_sampling(self, generator, shape, dtype=None, device=None):
        """Sample z_T from the equilibrium prior."""
