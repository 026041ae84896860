"""Reverse-SDE Euler--Maruyama sampler
(``psld_tpu/samplers/sde_samplers.py::EulerMaruyamaSampler``).

Randomness comes from an explicit ``torch.Generator`` on the batch's
device. ``noise(i, x)``, when given, supplies the i-th step's standard
normal draw instead; the parity tests hand in the JAX key stream's draws
through it.
"""

from __future__ import annotations

import torch

from psld_tpu_torch.registry import register_module
from psld_tpu_torch.samplers.base import Sampler


def _em_update(sde, score_fn, x, t: float, dt: float, noise=None,
               flag: float = 1.0):
    """One Euler--Maruyama step at host-side float64 ``t``/``dt``.
    ``noise=None`` gives the mean-only step. ``dt`` is rounded to
    ``x.dtype`` before use, as in the JAX package."""
    tv = sde.timestep_vector(t, x.shape[0], x.device)
    f, g = sde.reverse_sde(x, tv, score_fn)
    dt_c = torch.tensor(dt, dtype=torch.float64).to(x.dtype)
    x_mean = x + f * dt_c
    if noise is None:
        return x_mean, x_mean
    return x_mean + flag * g * torch.sqrt(dt_c) * noise, x_mean


def _step_grid(sde, ts: torch.Tensor, denoise: bool, eps: float):
    """(t, dt, noise_flag) rows as Python floats; with ``denoise`` the
    final mean-only step at t = T - eps, dt = eps is appended."""
    ts = ts.tolist()
    rows = [(t0, t1 - t0, 1.0) for t0, t1 in zip(ts[:-1], ts[1:])]
    if denoise:
        rows.append((sde.T - eps, eps, 0.0))
    return rows


@register_module(category="samplers", name="em_sde")
class EulerMaruyamaSampler(Sampler):
    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        """Run the reverse SDE from the prior draw ``batch`` (NHWC)."""
        del n_discrete_steps  # len(ts) - 1
        x = batch
        for i, (t, dt, flag) in enumerate(_step_grid(self.sde, ts, denoise,
                                                     eps)):
            z = None
            if flag:
                z = noise(i, x) if noise is not None else torch.randn(
                    x.shape, generator=generator, dtype=x.dtype,
                    device=x.device)
            x, _ = _em_update(self.sde, self.score_fn, x, t, dt, z, flag)
        return x
