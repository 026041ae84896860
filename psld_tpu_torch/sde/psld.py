"""Phase-Space Langevin Diffusion SDE, the part EM sampling needs
(``psld_tpu/sde/psld.py``; the math is derived in that module's docstring).

State ``z = (x, m)``; ``E(s) = exp(A s / 2) = e^{-lam s}(I + s N / 2)``
with the nilpotent ``N`` of the critically damped system, and the kernel
covariance ``E Sigma_0 E^T + D I0 + S I1 + Q I2``.

Time vectors are float64 tensors; every coefficient stays float64 until
:func:`~psld_tpu_torch.utils.numerics.to_edge` casts it to the image
tensor's dtype and device, as ``_mean`` and ``get_score`` do in the JAX
package. ``perturb_data``, ``get_coeff``, ``sscs_transition`` and the
likelihood pieces come with the training and SSCS slices.
"""

from __future__ import annotations

import math

import torch

from psld_tpu_torch.registry import register_module
from psld_tpu_torch.sde.base import SDE
from psld_tpu_torch.utils.numerics import ou_weight_integrals, to_edge


def split_xm(z: torch.Tensor):
    """Split a phase-space tensor into (x, m) halves on the channel axis."""
    return torch.chunk(z, 2, dim=-1)


def join_xm(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, m], dim=-1)


@register_module(category="sde", name="psld")
class PSLD(SDE):
    def __init__(self, config):
        super().__init__(config.model.sde.n_timesteps)
        sde_cfg = config.model.sde
        self.beta_0 = float(sde_cfg.beta_min)
        self.beta_1 = float(sde_cfg.beta_max)
        self.nu = float(sde_cfg.nu)
        self.gamma = float(sde_cfg.gamma)
        if self.nu == 0 and self.gamma == 0:
            raise ValueError("PSLD needs nu != 0 or gamma != 0")
        self.m_inv = (self.gamma - self.nu) ** 2 / 4.0
        self.m = 1.0 / self.m_inv
        self.kappa = float(sde_cfg.kappa)
        self.mm_0 = self.kappa * self.m
        self.eps = float(sde_cfg.numerical_eps)
        self.decomp_mode = str(sde_cfg.decomp_mode)
        if self.decomp_mode not in ("lower", "upper"):
            raise ValueError(f"decomp_mode {self.decomp_mode!r}")

        # constants of the nilpotent split
        self._lam = (self.gamma + self.nu) / 4.0
        self._a = (self.nu - self.gamma) / 4.0  # (N/2)[0,0]
        self._b = self.m_inv / 2.0              # (N/2)[0,1]
        self._c = -0.5                          # (N/2)[1,0]
        self._dx = self.gamma                   # D[0,0]
        self._dm = self.m * self.nu             # D[1,1]

    def __repr__(self):
        return (f"PSLD(m_inv={self.m_inv}, gamma={self.gamma}, "
                f"nu={self.nu}, decomp={self.decomp_mode})")

    # -- schedule ------------------------------------------------------------
    def beta_t(self, t):
        return self.beta_0 + t * (self.beta_1 - self.beta_0)

    def b_t(self, t):
        return self.beta_0 * t + 0.5 * (t * t) * (self.beta_1 - self.beta_0)

    @property
    def mode(self) -> str:
        if self.gamma == 0:
            return "score_m"
        if self.nu == 0:
            return "score_x"
        return "score_xm"

    # -- matrix exponential pieces --------------------------------------------
    def _exp_half_As(self, s):
        """Entries of E(s) = exp(A s / 2) as per-batch scalars."""
        decay = torch.exp(-self._lam * s)
        e11 = decay * (1.0 + self._a * s)
        e12 = decay * (self._b * s)
        e21 = decay * (self._c * s)
        e22 = decay * (1.0 - self._a * s)
        return e11, e12, e21, e22

    def _cov_inhom(self, s):
        """Driven part of the kernel covariance: D I0 + S I1 + Q I2."""
        a, b, c = self._a, self._b, self._c
        dx, dm = self._dx, self._dm
        i0, i1, i2 = ou_weight_integrals(2.0 * self._lam, s)
        s_xx, s_xm, s_mm = 2.0 * a * dx, b * dm + c * dx, -2.0 * a * dm
        q_xx = a * a * dx + b * b * dm
        q_xm = a * c * dx - a * b * dm
        q_mm = c * c * dx + a * a * dm
        xx = dx * i0 + s_xx * i1 + q_xx * i2
        xm = s_xm * i1 + q_xm * i2
        mm = dm * i0 + s_mm * i1 + q_mm * i2
        return xx, xm, mm

    def _cov_from_s(self, xx_0, mm_0, s):
        """Kernel covariance entries (xx, xm, mm) given s = b(t)."""
        e11, e12, e21, e22 = self._exp_half_As(s)
        xx_h = e11 * e11 * xx_0 + e12 * e12 * mm_0
        xm_h = e11 * e21 * xx_0 + e12 * e22 * mm_0
        mm_h = e21 * e21 * xx_0 + e22 * e22 * mm_0
        xx, xm, mm = self._cov_inhom(s)
        return xx_h + xx + self.eps, xm_h + xm, mm_h + mm + self.eps

    def _cov(self, xx_0, mm_0, t):
        return self._cov_from_s(xx_0, mm_0, self.b_t(t))

    def get_inv_coeff(self, var):
        """Inverse-transpose of the triangular covariance factor."""
        xx, xm, mm = var
        det = xx * mm - xm * xm
        if self.decomp_mode == "lower":
            li11 = torch.rsqrt(xx)
            li12 = -xm / (torch.sqrt(xx) * torch.sqrt(det))
            li22 = torch.sqrt(xx / det)
            return li11, li12, torch.zeros_like(li11), li22
        ui22 = torch.rsqrt(mm)
        ui21 = -xm / (torch.sqrt(mm) * torch.sqrt(det))
        ui11 = torch.sqrt(mm / det)
        return ui11, torch.zeros_like(ui11), ui21, ui22

    # -- score ---------------------------------------------------------------
    def get_score(self, eps, xx_0, mm_0, t):
        """score = -(L^-T) eps, zero-filling the unused half in the
        reduced-output modes. ``eps`` is the network output; the float64
        coefficients are cast to its dtype and device at the edge."""
        c11, c12, c21, c22 = self.get_inv_coeff(self._cov(xx_0, mm_0, t))

        def coef(c):
            return to_edge(c, eps)

        if self.decomp_mode == "lower" and self.mode == "score_m":
            return join_xm(torch.zeros_like(eps), -coef(c22) * eps)
        if self.decomp_mode == "upper" and self.mode == "score_x":
            return join_xm(-coef(c11) * eps, torch.zeros_like(eps))
        eps_x, eps_m = split_xm(eps)
        score_x = -coef(c11) * eps_x - coef(c12) * eps_m
        score_m = -coef(c21) * eps_x - coef(c22) * eps_m
        return join_xm(score_x, score_m)

    # -- dynamics ------------------------------------------------------------
    def sde(self, z_t, t):
        """Forward drift/diffusion; ``t`` is a float64 vector [B]."""
        x_t, m_t = split_xm(z_t)
        beta = to_edge(self.beta_t(t), x_t)
        drift_x = 0.5 * beta * (self.m_inv * m_t - self.gamma * x_t)
        drift_m = 0.5 * beta * (-self.nu * m_t - x_t)
        diff_x = torch.sqrt(beta * self.gamma) * torch.ones_like(x_t)
        diff_m = torch.sqrt(beta * self.m * self.nu) * torch.ones_like(m_t)
        return join_xm(drift_x, drift_m), join_xm(diff_x, diff_m)

    def reverse_sde(self, z_t, t, score_fn, probability_flow=False):
        """Reverse drift/diffusion; ``t`` is measured from 0 at the prior
        end. ``score_fn(z, t)`` predicts eps in float32."""
        t = self.T - t
        f, g = self.sde(z_t, t)
        eps_pred = score_fn(z_t.float(),
                            t.to(device=z_t.device, dtype=torch.float32))
        score = self.get_score(eps_pred, 0.0, self.mm_0, t).to(z_t.dtype)
        score = 0.5 * score if probability_flow else score
        f_bar = -f + g * g * score
        g_bar = torch.zeros_like(g) if probability_flow else g
        return f_bar, g_bar

    # -- prior ---------------------------------------------------------------
    def prior_sampling(self, generator, shape, dtype=torch.float32,
                       device=None):
        """x ~ N(0, I), m ~ N(0, M I). ``shape`` is the NHWC x-shape; the
        output doubles the trailing channel axis. ``generator`` lives on
        ``device``."""
        p_x = torch.randn(shape, generator=generator, dtype=dtype,
                          device=device)
        p_m = torch.randn(shape, generator=generator, dtype=dtype,
                          device=device) * math.sqrt(self.m)
        return join_xm(p_x, p_m)

    def timestep_vector(self, t: float, batch: int,
                        device=None) -> torch.Tensor:
        """A scalar time as a float64 per-batch vector on ``device``:
        filled there, so a sampler step copies nothing from the host."""
        return torch.full((batch,), float(t), dtype=torch.float64,
                          device=device)
