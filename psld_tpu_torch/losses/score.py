"""Score-matching losses of the VP-SDE and of PSLD, and the
time-conditional cross-entropy of PSLD's guidance classifier
(``psld_tpu/losses/score.py``).

A criterion is built from (config, sde) and called with explicit
tensors. ``score_fn`` is any ``(z, t) -> eps_pred`` callable. The random
draws (the momentum ``m0`` of DSM, the noise ``eps``) come from ``rng``,
an object with ``normal(shape)`` such as
:class:`psld_tpu_torch.train.steps.StepRandom`, or are handed in, which is
how a test feeds this loss and the JAX package's the same numbers.

Under spatial parallelism a criterion sees a rank's slice of the height
and its ``mean`` is over that slice: the shards are of one size, so the
training step's one all-reduce over every rank divided by the world
size (``parallel.distributed.GradReducer``) is the global batch's mean,
the same as sums over the group divided by the global count, and the
logged loss is the global batch's.
"""

from __future__ import annotations

import math

import torch

from psld_tpu_torch.registry import get_module, register_module
from psld_tpu_torch.sde.psld import split_xm
from psld_tpu_torch.utils.numerics import to_edge


def _reduce(loss: torch.Tensor, strategy: str) -> torch.Tensor:
    return loss.mean() if strategy == "mean" else loss.sum()


@register_module(category="losses", name="score_loss")
class ScoreLoss:
    """Epsilon-prediction loss of an SDE without a momentum half (the
    VP-SDE). ``training.loss.weighting`` ``fid`` is the plain l2 (or l1)
    loss on eps; ``nll`` weights the squared score error by g(t)^2 and
    needs l2."""

    def __init__(self, config, sde):
        lcfg = config.training.loss
        if lcfg.weighting not in ("nll", "fid"):
            raise ValueError(f"training.loss.weighting {lcfg.weighting!r}")
        if lcfg.weighting == "nll" and lcfg.l_type != "l2":
            raise ValueError("l_type can only be `l2` when using nll "
                             "weighting")
        self.sde = sde
        self.l_type = lcfg.l_type
        self.weighting = lcfg.weighting
        self.reduce_strategy = "mean" if lcfg.reduce_mean else "sum"

    def __call__(self, x_0, t, score_fn, rng=None, eps=None):
        """``x_0`` NHWC float32, ``t`` float64 [B]; ``eps`` (C channels)
        is drawn from ``rng`` unless given."""
        if eps is None:
            eps = rng.normal(x_0.shape)
        eps = eps.to(x_0.dtype)
        x_t = self.sde.perturb_data(x_0, t, eps)
        eps_pred = score_fn(x_t.float(),
                            t.to(device=x_t.device, dtype=torch.float32))
        if self.weighting == "nll":
            gt2 = to_edge(self.sde.likelihood_weighting(t), eps_pred).float()
            diff = self.sde.get_score(eps_pred, t) \
                - self.sde.get_score(eps, t)
            return _reduce(diff * diff * gt2, self.reduce_strategy)
        diff = eps - eps_pred
        loss = diff * diff if self.l_type == "l2" else diff.abs()
        return _reduce(loss, self.reduce_strategy)


def _sample_momentum(sde, x_0, mode: str, rng=None, m0=None):
    """DSM: m_0 ~ N(0, mm_0 I), kernel mm_0 = 0; HSM: m_0 = 0, kernel
    mm_0 = kappa M. An injected ``m0`` is the standard-normal draw, before
    its scaling."""
    if mode == "hsm":
        return torch.zeros_like(x_0), sde.mm_0
    if m0 is None:
        m0 = rng.normal(x_0.shape)
    return math.sqrt(sde.mm_0) * m0.to(x_0.dtype), 0.0


@register_module(category="losses", name="psld_score_loss")
class PSLDScoreLoss:
    """HSM/DSM epsilon-prediction loss for PSLD."""

    def __init__(self, config, sde):
        if config.training.loss.weighting not in ("fid",):
            raise ValueError("psld_score_loss takes weighting=fid")
        if config.training.mode not in ("hsm", "dsm"):
            raise ValueError(f"training.mode {config.training.mode!r}")
        if not isinstance(sde, get_module("sde", "psld")):
            raise TypeError("psld_score_loss needs the PSLD SDE")
        self.sde = sde
        self.l_type = config.training.loss.l_type
        self.mode = config.training.mode
        self.decomp_mode = config.model.sde.decomp_mode
        self.reduce_strategy = (
            "mean" if config.training.loss.reduce_mean else "sum")

    def __call__(self, x_0, t, score_fn, rng=None, eps=None, m0=None):
        """``x_0`` NHWC float32, ``t`` float64 [B]. Draw order: m0 (DSM
        only), then eps."""
        m_0, mm_0 = _sample_momentum(self.sde, x_0, self.mode, rng, m0)
        if eps is None:
            eps = rng.normal(x_0.shape[:-1] + (2 * x_0.shape[-1],))
        eps = eps.to(x_0.dtype)
        z_t, _, _ = self.sde.perturb_data(x_0, m_0, 0.0, mm_0, t, eps)
        eps_pred = score_fn(z_t.float(),
                            t.to(device=z_t.device, dtype=torch.float32))

        # target selection by (sde.mode, decomp)
        eps_x, eps_m = split_xm(eps)
        if self.sde.mode == "score_m" and self.decomp_mode == "lower":
            target = eps_m
        elif self.sde.mode == "score_x" and self.decomp_mode == "upper":
            target = eps_x
        else:
            target = eps
        if eps_pred.shape != target.shape:
            raise ValueError(f"network output {tuple(eps_pred.shape)} vs "
                             f"target {tuple(target.shape)}")
        diff = target - eps_pred
        return _reduce(diff * diff, self.reduce_strategy)


@register_module(category="losses", name="tce_loss")
class PSLDTimeCELoss:
    """Time-conditional cross-entropy of the guidance classifier: the
    clean image is perturbed to time t with the score model's kernel and
    the classifier names its class. ``config`` holds both the
    ``diffusion`` and the ``clf`` trees; the mode and the reduction are
    the diffusion training's."""

    def __init__(self, config, sde):
        dcfg = config.diffusion.training
        if dcfg.mode not in ("hsm", "dsm"):
            raise ValueError(f"diffusion.training.mode {dcfg.mode!r}")
        if not isinstance(sde, get_module("sde", "psld")):
            raise TypeError("tce_loss needs the PSLD SDE")
        self.sde = sde
        self.mode = dcfg.mode
        self.reduce_strategy = "mean" if dcfg.loss.reduce_mean else "sum"

    def __call__(self, x_0, y, t, clf_fn, rng=None, eps=None, m0=None):
        """``(loss, top1)`` for NHWC float32 ``x_0``, integer labels ``y``
        [B] and float64 ``t`` [B]. Draw order as for
        :class:`PSLDScoreLoss`: m0 (DSM only), then eps."""
        m_0, mm_0 = _sample_momentum(self.sde, x_0, self.mode, rng, m0)
        if eps is None:
            eps = rng.normal(x_0.shape[:-1] + (2 * x_0.shape[-1],))
        u_t, _, _ = self.sde.perturb_data(x_0, m_0, 0.0, mm_0, t,
                                          eps.to(x_0.dtype))
        logits = clf_fn(u_t.float(),
                        t.to(device=u_t.device, dtype=torch.float32))
        y = y.to(device=logits.device, dtype=torch.int64)
        log_probs = torch.log_softmax(logits, dim=-1)
        nll = -log_probs.gather(1, y[:, None])[:, 0]
        top1 = (logits.argmax(dim=-1) == y).float().mean()
        return _reduce(nll, self.reduce_strategy), top1
