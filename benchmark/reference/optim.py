"""The optimizer of the training step, plain PyTorch: the gradients'
global norm clipped to ``grad_clip`` (scaled by clip / norm where the norm
is at least the clip), Adam with its learning rate read at the update
count before the update (linear warmup from 0), ``eps`` outside the root
after bias correction, and the EMA ``ema = tau ema + (1 - tau) params``
after the update. As optax chains ``clip_by_global_norm``, ``adam`` and
the schedule."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, opt: dict, ema_decay: float):
        if float(opt.get("weight_decay", 0) or 0) != 0:
            raise NotImplementedError("the reference writes Adam without "
                                      "weight decay")
        self.lr = float(opt["lr"])
        self.b1, self.b2 = float(opt["beta_1"]), float(opt["beta_2"])
        self.eps = float(opt["eps"])
        self.warmup = int(opt["warmup"])
        self.clip = float(opt.get("grad_clip", 0) or 0)
        self.tau = float(ema_decay)

    def init(self, params: dict) -> dict:
        return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                "count": 0, "ema": {k: v.clone() for k, v in params.items()}}

    def rate(self, count: int) -> float:
        if self.warmup > 0 and count < self.warmup:
            return self.lr * count / self.warmup
        return self.lr

    @staticmethod
    def global_norm(grads: dict) -> torch.Tensor:
        return torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))

    def clipped(self, grads: dict) -> dict:
        """The gradients as the update takes them."""
        norm = self.global_norm(grads)
        if self.clip and norm >= self.clip:
            scale = float(self.clip / norm)
            return {k: g * scale for k, g in grads.items()}
        return dict(grads)

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict) -> None:
        """One step in place on ``params`` and ``state``; ``grads`` holds
        the leaves that train (a leaf without one does not move)."""
        g = self.clipped(grads)
        lr = self.rate(state["count"])
        state["count"] += 1
        c = state["count"]
        for k, p in params.items():
            if k not in g:
                continue
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_(g[k], alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g[k], g[k], value=1 - self.b2)
            upd = (mu / (1 - self.b1 ** c)) / (
                torch.sqrt(nu / (1 - self.b2 ** c)) + self.eps)
            p.sub_(lr * upd)
        for k, e in state["ema"].items():
            e.mul_(self.tau).add_(params[k], alpha=1 - self.tau)
