"""Phase-space Langevin diffusion (Pandey and Mandt, "A Complete Recipe
for Diffusion Generative Models", ICCV 2023), plain PyTorch: the forward
SDE, its perturbation kernel, the reverse-time Euler--Maruyama step and
the hybrid score matching (HSM) loss.

The state ``z = (x, m)`` is NHWC with x and m as the two halves of the
channel axis. With ``b(t) = int_0^t beta``, the SDE is
``dz = 1/2 beta(t) A z dt + sqrt(beta(t) D) dW`` with
``A = [[-gamma, 1/M], [-1, -nu]]``, ``D = diag(gamma, M nu)`` and
``1/M = (gamma - nu)^2 / 4``. The kernel's mean map is ``exp(A b / 2)``
and its covariance solves ``dS/db = A/2 S + S A^T/2 + D``; both are taken
here from 2x2 and 4x4 matrix exponentials in float64 (Van Loan's block
form for the covariance), then cast to the image's dtype.
"""

from __future__ import annotations

import torch


class PSLD:
    def __init__(self, sde: dict):
        self.beta_0 = float(sde["beta_min"])
        self.beta_1 = float(sde["beta_max"])
        self.nu = float(sde["nu"])
        self.gamma = float(sde["gamma"])
        self.kappa = float(sde["kappa"])
        self.num_eps = float(sde["numerical_eps"])
        if str(sde["decomp_mode"]) != "lower":
            raise NotImplementedError("the reference writes the lower "
                                      "Cholesky factor")
        self.m_inv = (self.gamma - self.nu) ** 2 / 4.0
        self.M = 1.0 / self.m_inv
        self.mm_0 = self.kappa * self.M  # HSM's initial momentum variance
        f64 = torch.float64
        self.A = torch.tensor([[-self.gamma, self.m_inv], [-1.0, -self.nu]],
                              dtype=f64)
        self.D = torch.tensor([[self.gamma, 0.0], [0.0, self.M * self.nu]],
                              dtype=f64)

    def beta(self, t):
        return self.beta_0 + t * (self.beta_1 - self.beta_0)

    def b(self, t):
        return self.beta_0 * t + 0.5 * t * t * (self.beta_1 - self.beta_0)

    def mean_map(self, t):
        """exp(A b(t) / 2), (B, 2, 2) float64 for float64 times ``t`` (B,)."""
        s = self.b(t.double().cpu())
        return torch.linalg.matrix_exp(self.A[None] * (s / 2.0)[:, None, None])

    def cov(self, t, xx_0: float, mm_0: float):
        """Kernel covariance from diag(xx_0, mm_0) at time ``t``, (B, 2, 2)
        float64, with the numerical eps on the diagonal."""
        s = self.b(t.double().cpu())
        n = s.shape[0]
        blk = torch.zeros(n, 4, 4, dtype=torch.float64)
        blk[:, :2, :2] = -self.A / 2.0
        blk[:, :2, 2:] = self.D
        blk[:, 2:, 2:] = self.A.T / 2.0
        e = torch.linalg.matrix_exp(blk * s[:, None, None])
        phi = e[:, 2:, 2:].transpose(1, 2)
        driven = phi @ e[:, :2, 2:]
        s0 = torch.diag(torch.tensor([xx_0, mm_0], dtype=torch.float64))
        out = phi @ s0 @ phi.transpose(1, 2) + driven
        out = 0.5 * (out + out.transpose(1, 2))
        return out + self.num_eps * torch.eye(2, dtype=torch.float64)

    def prior(self, shape, generator, device):
        """x ~ N(0, I), m ~ N(0, M I); ``shape`` is the NHWC x-shape."""
        x = torch.randn(shape, generator=generator, device=device)
        m = torch.randn(shape, generator=generator, device=device)
        return torch.cat([x, m * self.M ** 0.5], dim=-1)


def _apply(mat, z):
    """Per-row 2x2 ``mat`` (B, 2, 2) applied to the (x, m) halves of
    ``z``, in z's dtype."""
    x, m = torch.chunk(z, 2, dim=-1)
    c = mat.to(device=z.device, dtype=z.dtype)[:, :, :, None, None, None]
    return torch.cat([c[:, 0, 0] * x + c[:, 0, 1] * m,
                      c[:, 1, 0] * x + c[:, 1, 1] * m], dim=-1)


def em_step(sde: PSLD, net, z, t: float, dt: float, noise=None):
    """One reverse-time Euler--Maruyama step of the sampler at sampler time
    ``t`` (0 at the prior) with step ``dt``: ``z + (-f + g^2 score) dt + g
    sqrt(dt) noise``, or the mean alone when ``noise`` is None (the final
    denoise row). ``net(z, t)`` predicts eps. Returns ``(z_next,
    g^2 score dt)``: the second is the part the network moves."""
    b = z.shape[0]
    tf = torch.full((b,), 1.0 - t, dtype=torch.float64)
    beta = float(sde.beta(tf[0]))
    drift = _apply(sde.A[None].expand(b, 2, 2) * (0.5 * beta), z)
    g2 = torch.tensor([sde.gamma * beta, sde.M * sde.nu * beta],
                      dtype=torch.float64)
    eps = net(z, tf.to(device=z.device, dtype=torch.float32))
    chol = torch.linalg.cholesky(sde.cov(tf, 0.0, sde.mm_0))
    score = -_apply(torch.linalg.inv(chol).transpose(1, 2), eps)
    x_g2, m_g2 = (float(v) for v in g2)
    g2_t = torch.cat([torch.full_like(z[..., :z.shape[-1] // 2], x_g2),
                      torch.full_like(z[..., :z.shape[-1] // 2], m_g2)], -1)
    dt32 = torch.tensor(dt, dtype=torch.float64).to(z.dtype).item()
    moved = g2_t * score * dt32
    z_next = z + (-drift + g2_t * score) * dt32
    if noise is not None:
        z_next = z_next + torch.sqrt(g2_t) * (dt32 ** 0.5) * noise
    return z_next, moved


def hsm_loss(sde: PSLD, net, x_0, t, eps):
    """HSM: m_0 = 0 and the kernel from diag(0, kappa M); ``x_0`` NHWC
    images, ``t`` float64 (B,), ``eps`` (B, H, W, 2C) standard normals.
    The mean over every element of (eps - net(z_t, t))^2."""
    z0 = torch.cat([x_0, torch.zeros_like(x_0)], dim=-1)
    mean = _apply(sde.mean_map(t), z0)
    chol = torch.linalg.cholesky(sde.cov(t, 0.0, sde.mm_0))
    z_t = mean + _apply(chol, eps)
    pred = net(z_t, t.to(device=x_0.device, dtype=torch.float32))
    return ((eps - pred) ** 2).mean()
