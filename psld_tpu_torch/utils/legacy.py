"""Legacy schedule helpers (``psld_tpu/utils/legacy.py``): the NCSN noise
ladder and the discrete DDPM schedule, in numpy, with the JAX package's
dtypes (float32 arrays; the DDPM products taken in float64 before the
cast). No path of the port calls them; they serve NCSNv1/v2-style
experiments with :mod:`psld_tpu_torch.models.legacy_layers`.
"""

from __future__ import annotations

import numpy as np


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int):
    """Geometric noise ladder sigma_max -> sigma_min, float32."""
    return np.exp(
        np.linspace(np.log(sigma_max), np.log(sigma_min), num_scales)
    ).astype(np.float32)


def get_ddpm_params(beta_min: float = 0.1, beta_max: float = 20.0,
                    num_diffusion_timesteps: int = 1000) -> dict:
    """Discrete DDPM schedule derived from the continuous VP betas."""
    n = num_diffusion_timesteps
    betas = np.linspace(beta_min / n, beta_max / n, n, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    return {
        "betas": betas.astype(np.float32),
        "alphas": alphas.astype(np.float32),
        "alphas_cumprod": alphas_cumprod.astype(np.float32),
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod).astype(np.float32),
        "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod).astype(
            np.float32),
        "beta_min": beta_min,
        "beta_max": beta_max,
        "num_diffusion_timesteps": n,
    }
