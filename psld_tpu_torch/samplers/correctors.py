"""Langevin corrector of predictor--corrector sampling
(``psld_tpu/samplers/correctors.py``).

After each predictor step at reverse-grid time ``t``, ``n`` steps of

    u <- u + step * score(u, T - t) + sqrt(2 * step) * z

with one step size for the batch from the target signal-to-noise ratio,
``step = 2 * (snr * ||z|| / max(||score||, 1e-20))^2``, the norms taken
per sample and averaged over the batch. In PSLD's reduced-output modes
the half of the state that carries no score gets neither drift nor
noise.

Config keys, under ``evaluation.sampler``: ``corrector`` (``none`` or
``langevin``), ``corrector_snr`` (default 0.16), ``corrector_steps``
(default 1). Each step costs one network forward.
"""

from __future__ import annotations

import torch

from psld_tpu_torch.parallel import spatial
from psld_tpu_torch.registry import get_module, register_module
from psld_tpu_torch.sde.psld import join_xm


@register_module(category="correctors", name="langevin")
class LangevinCorrector:
    """The keyed corrector hook: ``corrector(u, t, dt, draw) -> (u,
    u_mean)``, where ``draw(j, like)`` is the standard normal draw of the
    j-th step, shaped like ``like``."""

    def __init__(self, config, sde, score_fn):
        scfg = config.evaluation.sampler
        self.sde = sde
        self.score_fn = score_fn
        self.snr = float(scfg.get("corrector_snr", 0.16))
        self.steps = int(scfg.get("corrector_steps", 1))
        # the batch's mean; lockstep sampling takes it over every rank
        self.batch_mean = torch.mean

    def _live_mask(self, u):
        """1 where the state carries a score: in PSLD's reduced-output
        modes the other half of ``get_score`` is zero-filled, and noise
        there would random-walk with no drift to restore it. An SDE
        without modes (the VP-SDE) is live everywhere."""
        half = torch.ones_like(u[..., : u.shape[-1] // 2])
        mode = getattr(self.sde, "mode", None)
        if mode == "score_m":
            return join_xm(torch.zeros_like(half), half)
        if mode == "score_x":
            return join_xm(half, torch.zeros_like(half))
        return torch.ones_like(u)

    def _score(self, u, t_phys):
        """The marginal's score from the eps network: PSLD's conversion
        needs the stationary covariance (``mm_0``), the VP-SDE's only
        the std."""
        eps_pred = self.score_fn(u.float(), t_phys.float())
        if hasattr(self.sde, "mm_0"):
            score = self.sde.get_score(eps_pred, 0.0, self.sde.mm_0, t_phys)
        else:
            score = self.sde.get_score(eps_pred, t_phys)
        return score.to(u.dtype)

    def __call__(self, u, t: float, dt: float, draw):
        del dt
        sde = self.sde
        t_phys = sde.timestep_vector(sde.T - t, u.shape[0], u.device)
        dims = tuple(range(1, u.ndim))
        mask = self._live_mask(u)
        u_mean = u
        for j in range(self.steps):
            score = self._score(u, t_phys) * mask
            z = draw(j, u) * mask
            # batch-mean norms give one scalar step: per-sample norms
            # blow the step up for samples near a mode, where the score
            # goes to 0
            # a sample's norm over the whole image: under spatial
            # parallelism its rows' sums added over the group
            g_norm = self.batch_mean(torch.sqrt(
                spatial.group_sum((score * score).sum(dims))))
            z_norm = self.batch_mean(torch.sqrt(
                spatial.group_sum((z * z).sum(dims))))
            step = 2.0 * (self.snr * z_norm
                          / torch.clamp_min(g_norm, 1e-20)) ** 2
            u_mean = u + step * score
            u = u_mean + torch.sqrt(2.0 * step) * z
        return u, u_mean


def build_corrector(config, sde, score_fn):
    """The corrector ``evaluation.sampler.corrector`` names, or None."""
    name = str(config.evaluation.sampler.get("corrector", "none"))
    if name in ("none", "None", ""):
        return None
    return get_module("correctors", name)(config, sde, score_fn)
