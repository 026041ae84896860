"""Phase-Space Langevin Diffusion SDE, the part EM sampling and training
need (``psld_tpu/sde/psld.py``; the math is derived in that module's
docstring).

State ``z = (x, m)``; ``E(s) = exp(A s / 2) = e^{-lam s}(I + s N / 2)``
with the nilpotent ``N`` of the critically damped system, and the kernel
covariance ``E Sigma_0 E^T + D I0 + S I1 + Q I2``.

Time vectors are float64 tensors; every coefficient stays float64 until
:func:`~psld_tpu_torch.utils.numerics.to_edge` casts it to the image
tensor's dtype and device, as ``_mean`` and ``get_score`` do in the JAX
package. With ``PSLD_DEBUG_NUMERICS`` set, both factorizations of
``get_coeff`` and ``get_inv_coeff`` raise on a non-finite factor
(:mod:`psld_tpu_torch.utils.debug`).
"""

from __future__ import annotations

import math

import torch

from psld_tpu_torch.registry import register_module
from psld_tpu_torch.sde.base import SDE
from psld_tpu_torch.utils.debug import check_finite
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

    @property
    def type(self) -> str:
        return f"psld-{self.mode}"

    @property
    def is_augmented(self) -> bool:
        return True

    # -- matrix exponential pieces --------------------------------------------
    def _exp_half_As(self, s):
        """Entries of E(s) = exp(A s / 2) as per-batch scalars."""
        decay = torch.exp(-self._lam * s)
        e11 = decay * (1.0 + self._a * s)
        e12 = decay * (self._b * s)
        e21 = decay * (self._c * s)
        e22 = decay * (1.0 - self._a * s)
        return e11, e12, e21, e22

    def kernel_mean_coeff(self, t):
        """Perturbation-kernel mean map coefficients at time t ([B] each)."""
        return self._exp_half_As(self.b_t(t))

    def _mean(self, x_0, m_0, t):
        """Kernel mean, NHWC with ``t`` of shape [B]; the float64
        coefficients are cast to ``x_0``'s dtype at the edge."""
        e11, e12, e21, e22 = (to_edge(c, x_0)
                              for c in self.kernel_mean_coeff(t))
        return join_xm(e11 * x_0 + e12 * m_0, e21 * x_0 + e22 * m_0)

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

    def sscs_transition(self, t, dt):
        """Mean map and covariance of the reverse-time linear sub-flow over
        [t, t+dt] in sampler time (the SSCS analytical half-step).

        Without the score step's linear terms the reverse drift is ``dz/dtau
        = 1/2 beta(T - tau) Abar z`` with ``Abar`` = A with its skew part
        negated: the forward integrals apply with ``s = b(T - t) - b(T - t
        - dt) > 0`` and the xm entries negated. ``t`` is a float64 [B]
        vector, ``dt`` a float; every entry stays float64, and the
        ``eps`` guard sits on the diagonal."""
        s = self.b_t(self.T - t) - self.b_t(self.T - (t + dt))
        decay = torch.exp(-self._lam * s)
        m11 = decay * (1.0 + self._a * s)
        m12 = -decay * (self._b * s)
        m21 = -decay * (self._c * s)
        m22 = decay * (1.0 - self._a * s)
        xx, xm, mm = self._cov_inhom(s)
        return (m11, m12, m21, m22), (xx + self.eps, -xm, mm + self.eps)

    def get_coeff(self, var):
        """Triangular factor of the 2x2 kernel covariance: lower, the
        Cholesky L with Sigma = L L^T; upper, U with Sigma = U U^T.
        Returns (c11, c12, c21, c22) per-batch scalars."""
        xx, xm, mm = var
        if self.decomp_mode == "lower":
            l11 = torch.sqrt(xx)
            l21 = xm / l11
            l22 = torch.sqrt(mm - l21 * l21)
            check_finite("PSLD.get_coeff (lower)", l11, l21, l22)
            return l11, torch.zeros_like(l11), l21, l22
        u22 = torch.sqrt(mm)
        u12 = xm / u22
        u11 = torch.sqrt(xx - u12 * u12)
        check_finite("PSLD.get_coeff (upper)", u11, u12, u22)
        return u11, u12, torch.zeros_like(u22), u22

    def get_inv_coeff(self, var):
        """Inverse-transpose of the triangular covariance factor."""
        xx, xm, mm = var
        det = xx * mm - xm * xm
        if self.decomp_mode == "lower":
            li11 = torch.rsqrt(xx)
            li12 = -xm / (torch.sqrt(xx) * torch.sqrt(det))
            li22 = torch.sqrt(xx / det)
            check_finite("PSLD.get_inv_coeff (lower)", li11, li12, li22)
            return li11, li12, torch.zeros_like(li11), li22
        ui22 = torch.rsqrt(mm)
        ui21 = -xm / (torch.sqrt(mm) * torch.sqrt(det))
        ui11 = torch.sqrt(mm / det)
        check_finite("PSLD.get_inv_coeff (upper)", ui11, ui21, ui22)
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

    # -- forward perturbation --------------------------------------------------
    def cond_marginal_prob(self, x_0, m_0, xx_0, mm_0, t):
        """Mean and 2x2 covariance of the perturbation kernel."""
        return self._mean(x_0, m_0, t), self._cov(xx_0, mm_0, t)

    def perturb_data(self, x_0, m_0, xx_0, mm_0, t, eps):
        """z_t = mean + L eps; ``eps`` has 2C channels. Returns
        (z_t, mean, covariance entries)."""
        mu_t, var = self.cond_marginal_prob(x_0, m_0, xx_0, mm_0, t)
        eps_x, eps_m = split_xm(eps)
        c11, c12, c21, c22 = (to_edge(c, eps_x) for c in self.get_coeff(var))
        noise = join_xm(c11 * eps_x + c12 * eps_m, c21 * eps_x + c22 * eps_m)
        return mu_t.to(eps.dtype) + noise, mu_t, var

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

    def prior_logp(self, z):
        """log N(x; 0, I) + log N(m; 0, M I) per sample, float64: the
        squared norms are summed in ``z``'s dtype, and the constants added
        in float64, as the JAX package does under x64."""
        x, m = split_xm(z)
        n = math.prod(x.shape[1:])
        dims = tuple(range(1, x.ndim))
        logp_x = -0.5 * n * math.log(2 * math.pi) \
            - (0.5 * (x * x).sum(dims)).double()
        logp_m = -0.5 * n * math.log(2 * math.pi * self.m) \
            - (0.5 * self.m_inv * (m * m).sum(dims)).double()
        return logp_x + logp_m

    def likelihood_weighting(self, t):
        """(beta gamma, beta M nu) at time ``t``: the diffusion's squares
        on the x and m halves."""
        beta = self.beta_t(t)
        return beta * self.gamma, beta * self.m * self.nu
