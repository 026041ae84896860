"""Numerics helpers of the SDE core (``psld_tpu/utils/numerics.py``).

Every delicate PSLD quantity is a function of the per-batch time vector
alone, so the port computes it in float64 (whatever device the time
vector is on) and casts to the image tensor's dtype at the edge.
"""

from __future__ import annotations

import torch


def bcast_right(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a per-batch vector ``[B]`` to rank ``ndim``
    (``[B, 1, 1, 1]``)."""
    if t.ndim == ndim:
        return t
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


def to_edge(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-batch coefficient ``[B]`` broadcast to ``like``'s rank and
    cast to its dtype and device: the one place float64 meets a tensor."""
    return bcast_right(c, like.ndim).to(device=like.device, dtype=like.dtype)


def expm1_div_x(x: torch.Tensor) -> torch.Tensor:
    """(e^x - 1)/x, accurate near 0."""
    small = x.abs() < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    exact = torch.expm1(safe) / safe
    taylor = 1.0 + x / 2.0 + x * x / 6.0
    return torch.where(small, taylor, exact)


def _phi1(x: torch.Tensor) -> torch.Tensor:
    """(1 - e^{-x}(1+x)) / x^2, with its series below |x| = 1e-2."""
    small = x.abs() < 1e-2
    safe = torch.where(small, torch.ones_like(x), x)
    exact = (1.0 - torch.exp(-safe) * (1.0 + safe)) / (safe * safe)
    taylor = 0.5 - x / 3.0 + x**2 / 8.0 - x**3 / 30.0 + x**4 / 144.0
    return torch.where(small, taylor, exact)


def _phi2(x: torch.Tensor) -> torch.Tensor:
    """(2 - e^{-x}(2 + 2x + x^2)) / x^3, with its series below 5e-2."""
    small = x.abs() < 5e-2
    safe = torch.where(small, torch.ones_like(x), x)
    exact = (2.0 - torch.exp(-safe) * (2.0 + 2.0 * safe + safe * safe)) \
        / safe**3
    taylor = 1.0 / 3.0 - x / 4.0 + x**2 / 10.0 - x**3 / 36.0 \
        + x**4 / 168.0
    return torch.where(small, taylor, exact)


def ou_weight_integrals(lam2: float, s: torch.Tensor):
    """``I_k = int_0^s u^k e^{-lam2 u} du`` for k = 0, 1, 2, in
    cancellation-safe form (accurate for |lam2 s| << 1 and for s < 0)."""
    x = lam2 * s
    i0 = s * expm1_div_x(-x)
    i1 = s * s * _phi1(x)
    i2 = s * s * s * _phi2(x)
    return i0, i1, i2
