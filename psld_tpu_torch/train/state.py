"""Train state and optimizer (``psld_tpu/train/state.py``).

The optimizer is optax's chain, written out: global-norm clip, Adam (or
AdamW when ``weight_decay`` is not 0) and the learning-rate schedule with
linear warmup. Where PyTorch's own pieces differ from optax, optax's rule
is kept:

* the clip scales by ``clip / norm`` only when ``norm >= clip``, with no
  epsilon in the denominator (``clip_grad_norm_`` adds 1e-6);
* the schedule is read at the count *before* the update, so with warmup
  the first step has learning rate 0;
* Adam's ``eps`` stands outside the root, after bias correction;
* weight decay skips ``GaussianFourierProjection.W``, which is fixed: it
  has ``requires_grad=False``, its gradient counts as 0 and it never
  moves.

Parameters, EMA and moments are updated **in place** (``torch._foreach_*``
passes over the float32 tensors): the state that goes into a step is the
state that comes out. The Adam and EMA passes lie outside any kernel in
the JAX package too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``params`` and ``ema_params`` map the score network's state_dict
    keys to float32 tensors; ``opt_state`` is ``{"mu", "nu", "count"}``
    with the Adam moments under the same keys. ``step`` and ``count`` are
    host integers."""

    step: int
    params: Params
    ema_params: Params
    opt_state: dict


def _decays(name: str) -> bool:
    """False for the frozen Fourier embedding (``_decay_mask``)."""
    return not any(part.startswith("GaussianFourierProjection")
                   for part in name.split("."))


class Optimizer:
    """Adam + warmup + global-norm clip, as ``make_optimizer`` chains
    them in the JAX package."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float = 0.0, warmup: int = 0,
                 grad_clip: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.warmup = warmup
        self.grad_clip = grad_clip

    def init(self, params: Params) -> dict:
        return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                "count": 0}

    def learning_rate(self, count: int) -> float:
        """Linear from 0 to ``lr`` over ``warmup`` updates, then ``lr``."""
        if self.warmup > 0 and count < self.warmup:
            return self.lr - self.lr * (1.0 - count / self.warmup)
        return self.lr

    def clip_(self, grads: list, norm: torch.Tensor) -> None:
        """Scale ``grads`` in place by ``clip / norm`` where ``norm >=
        clip``; ``norm`` stays on its device (no host sync)."""
        if self.grad_clip == 0:
            return
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                             self.grad_clip / norm)
        torch._foreach_mul_(grads, factor)

    def update_(self, grads: Params, opt_state: dict, params: Params,
                grad_norm: torch.Tensor) -> None:
        """One update of ``params`` and ``opt_state``, in place. ``grads``
        holds a tensor for every key of ``params`` and is consumed."""
        keys = list(params)
        g = [grads[k] for k in keys]
        mu = [opt_state["mu"][k] for k in keys]
        nu = [opt_state["nu"][k] for k in keys]
        p = [params[k] for k in keys]
        self.clip_(g, grad_norm)
        count = opt_state["count"]
        lr = self.learning_rate(count)
        count += 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        # update = mu_hat / (sqrt(nu_hat) + eps), built in the grads' room
        torch._foreach_copy_(g, nu)
        torch._foreach_div_(g, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(g)
        torch._foreach_add_(g, self.eps)
        torch._foreach_reciprocal_(g)
        torch._foreach_mul_(g, mu)
        torch._foreach_div_(g, 1.0 - self.b1 ** count)
        if self.weight_decay:
            decayed = [(u, q) for k, u, q in zip(keys, g, p) if _decays(k)]
            torch._foreach_add_([u for u, _ in decayed],
                                [q for _, q in decayed],
                                alpha=self.weight_decay)
        torch._foreach_add_(p, g, alpha=-lr)
        opt_state["count"] = count


def make_optimizer(opt_config) -> Optimizer:
    """The optimizer of ``training.optimizer``. ``flatten`` is accepted and
    has no effect: it changes only how XLA lays out the Adam pass."""
    if opt_config.name != "Adam":
        raise NotImplementedError(f"Optimizer {opt_config.name} not supported")
    return Optimizer(
        lr=float(opt_config.lr), b1=float(opt_config.beta_1),
        b2=float(opt_config.beta_2), eps=float(opt_config.eps),
        weight_decay=float(opt_config.weight_decay),
        warmup=int(opt_config.warmup),
        grad_clip=float(opt_config.get("grad_clip", 0) or 0))


def init_state(params: Params, optimizer: Optimizer) -> TrainState:
    """A fresh state around ``params``; the EMA is a real copy."""
    return TrainState(step=0, params=params,
                      ema_params={k: v.detach().clone()
                                  for k, v in params.items()},
                      opt_state=optimizer.init(params))


def ema_update_(ema_params: Params, params: Params, tau: float) -> None:
    """targ = tau * targ + (1 - tau) * src, in place."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, tau)
    torch._foreach_add_(ema, [params[k] for k in keys], alpha=1.0 - tau)


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, float32, on device."""
    norms = torch._foreach_norm(grads)
    return torch.linalg.vector_norm(torch.stack(norms).float())


def count_params(params: Params) -> int:
    return sum(math.prod(v.shape) for v in params.values())
