"""The Variance-Preserving SDE baseline (``psld_tpu/sde/vpsde.py``).

dx = -1/2 beta(t) x dt + sqrt(beta(t)) dW with beta linear in t and the
closed-form Gaussian kernel ``x_t = a(t) x_0 + std(t) eps``,
``log a(t) = -t^2 (beta_1 - beta_0) / 4 - t beta_0 / 2`` and
``std(t) = sqrt(-expm1(2 log a(t)))``: the ``expm1`` form keeps the
digits of ``std`` near t = 0, where ``1 - exp`` loses them all in
float32.

Time vectors are float64 tensors, and every coefficient stays float64
until :func:`~psld_tpu_torch.utils.numerics.to_edge` rounds it once to
the image tensor's dtype and device, as the port's PSLD does.
"""

from __future__ import annotations

import math

import torch

from psld_tpu_torch.registry import register_module
from psld_tpu_torch.sde.base import SDE
from psld_tpu_torch.utils.numerics import bcast_right, to_edge


@register_module(category="sde", name="vpsde")
class VPSDE(SDE):
    def __init__(self, config):
        super().__init__(config.model.sde.n_timesteps)
        self.beta_0 = float(config.model.sde.beta_min)
        self.beta_1 = float(config.model.sde.beta_max)

    def __repr__(self):
        return f"VPSDE(beta_0={self.beta_0}, beta_1={self.beta_1})"

    def beta_t(self, t):
        return self.beta_0 + t * (self.beta_1 - self.beta_0)

    @property
    def type(self) -> str:
        return "vpsde"

    def _log_mean_coeff(self, t):
        return -0.25 * t * t * (self.beta_1 - self.beta_0) \
            - 0.5 * t * self.beta_0

    def _std(self, t):
        return torch.sqrt(-torch.expm1(2.0 * self._log_mean_coeff(t)))

    def get_score(self, eps, t):
        """score = -eps / std(t); the float64 std is cast to ``eps``'s
        dtype and device at the edge."""
        return -eps / to_edge(self._std(t), eps)

    def cond_marginal_prob(self, x_0, t):
        """The kernel's mean, in ``x_0``'s dtype, and its std, float64
        broadcast to ``x_0``'s rank."""
        mean = to_edge(torch.exp(self._log_mean_coeff(t)), x_0) * x_0
        return mean, bcast_right(self._std(t), x_0.ndim)

    def perturb_data(self, x_0, t, eps):
        """x_t = mean + std * eps."""
        mean, std = self.cond_marginal_prob(x_0, t)
        return mean + eps * std.to(device=eps.device, dtype=eps.dtype)

    def sde(self, x_t, t):
        """Forward drift and diffusion; ``t`` is a float64 vector [B]."""
        beta = to_edge(self.beta_t(t), x_t)
        return -0.5 * beta * x_t, torch.sqrt(beta) * torch.ones_like(x_t)

    def reverse_sde(self, x_t, t, score_fn, probability_flow=False):
        """Reverse drift/diffusion; ``t`` is measured from 0 at the prior
        end. ``score_fn(x, t)`` predicts eps in float32; the probability
        flow halves the score and has no diffusion."""
        t = self.T - t
        f, g = self.sde(x_t, t)
        eps_pred = score_fn(x_t.float(),
                            t.to(device=x_t.device, dtype=torch.float32))
        score = self.get_score(eps_pred, t).to(x_t.dtype)
        score = 0.5 * score if probability_flow else score
        f_bar = -f + g * g * score
        g_bar = torch.zeros_like(g) if probability_flow else g
        return f_bar, g_bar

    def prior_sampling(self, generator, shape, dtype=torch.float32,
                       device=None):
        """x ~ N(0, I) of the NHWC ``shape``, from ``generator`` (which
        lives on ``device``)."""
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    def prior_logp(self, z):
        """log N(z; 0, I) per sample, float64: the squared norm summed in
        ``z``'s dtype, the constant added in float64."""
        n = math.prod(z.shape[1:])
        dims = tuple(range(1, z.ndim))
        return -0.5 * n * math.log(2 * math.pi) \
            - (0.5 * (z * z).sum(dims)).double()

    def likelihood_weighting(self, t):
        """g(t)^2 = beta(t)."""
        return self.beta_t(t)
