"""Sampler abstractions (``psld_tpu/samplers/base.py``).

The JAX package compiles a trajectory into one ``lax.scan``; PyTorch runs
eagerly, so a sampler here is a plain Python loop over a float64 time
grid held on the host.
"""

from __future__ import annotations

import abc

import numpy as np
import torch


def make_timesteps(n_steps: int, eval_eps: float, t_max: float = 1.0,
                   stride_type: str = "uniform") -> torch.Tensor:
    """float64 grid of length ``n_steps + 1`` on the host."""
    t_final = t_max - eval_eps
    ts = np.linspace(0.0, t_final, n_steps + 1, dtype=np.float64)
    if stride_type == "quadratic":
        ts = t_final * np.flip(1.0 - (ts / t_final) ** 2)
    elif stride_type != "uniform":
        raise ValueError(f"Unknown stride type: {stride_type}")
    return torch.from_numpy(np.ascontiguousarray(ts))


class Sampler(abc.ABC):
    """``score_fn(z, t) -> eps`` is the network bound to its weights."""

    def __init__(self, config, sde, score_fn):
        self.config = config
        self.sde = sde
        self.score_fn = score_fn

    @abc.abstractmethod
    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        ...
