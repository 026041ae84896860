"""Sampler abstractions (``psld_tpu/samplers/base.py``).

The JAX package compiles a trajectory into one ``lax.scan``; PyTorch runs
eagerly, so a sampler here is a plain Python loop over a float64 time
grid held on the host.
"""

from __future__ import annotations

import abc
import inspect

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
    """``score_fn(z, t) -> eps`` is the network bound to its weights.

    ``corrector_fn``, when given, runs after predictor steps: the keyed
    form ``(x, t, dt, draw)`` (a stochastic corrector, such as
    :class:`~psld_tpu_torch.samplers.correctors.LangevinCorrector`, whose
    ``draw(j, like)`` is its j-th standard normal draw) or the
    reference's ``(x, t, dt)``; either returns ``(x, x_mean)``.

    ``guided`` samplers also take a classifier (``clf_fn``) and run
    through ``class_cond_sample``."""

    guided = False

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        self.config = config
        self.sde = sde
        self.score_fn = score_fn
        self.corrector_fn = corrector_fn
        self._corrector_keyed = False
        if corrector_fn is not None:
            try:
                n_params = len(inspect.signature(corrector_fn).parameters)
            except (TypeError, ValueError):
                n_params = 3
            self._corrector_keyed = n_params >= 4

    def corrector_update_fn(self, x, t: float, dt: float, draw=None):
        if self.corrector_fn is None:
            return x, x
        if self._corrector_keyed:
            return self.corrector_fn(x, t, dt, draw)
        return self.corrector_fn(x, t, dt)

    @abc.abstractmethod
    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        ...
