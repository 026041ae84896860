"""The training steps of the score model and of its guidance classifier
(``psld_tpu/train/steps.py``).

One score step: t ~ U[train_eps, T] in float64 -> loss -> gradients ->
global-norm clip -> Adam(+warmup) -> EMA. A classifier step: t -> loss and
top-1 -> gradients -> Adam(+warmup), no clip, no EMA. PyTorch runs them
eagerly; nothing is compiled.

``training.bf16`` follows the JAX package: float32 master weights; the
forward runs on bfloat16 casts of them and a bfloat16 input and returns
float32, and the cast's gradient lands in float32. That is
``torch.func.functional_call`` on bfloat16 copies of the parameters. The
copies are leaves filled by one multi-tensor copy, and their bfloat16
gradients are cast up by another: the same numbers as autograd through
``p.to(torch.bfloat16)`` gives, without a cast kernel and its backward
for each of ~700 parameters. ``torch.autocast`` is not used, since it
picks a dtype per op. Loss math, SDE coefficients, Adam moments and the
EMA stay float32/float64.

Randomness is explicit. A run has one seeded :class:`StepRandom`; a step
draws from it, in a fixed order, t, then m0 (PSLD's DSM only), then eps,
then the dropout seed words, and every draw can be handed in instead (``t=``,
``eps=``, ``m0=``, ``dropout_seeds=``). JAX's threefry stream is not
reproduced: tests feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Callable

import torch

from psld_tpu_torch.models.layers import dropout_is_hashed
from psld_tpu_torch.train.state import (TrainState, ema_update_, global_norm,
                                        make_optimizer)


class StepRandom:
    """The random source of a run: a host generator for what must be known
    on the host (the times' uniforms, the dropout seed words) and, seeded
    from it, a generator on ``device`` for the image-sized normals."""

    def __init__(self, seed: int, device="cpu"):
        self.device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        if self.device.type == "cpu":
            self.dev = self.host
        else:
            self.dev = torch.Generator(device=self.device).manual_seed(
                int(torch.randint(0, 2 ** 62, (), generator=self.host)))

    def uniform(self, n: int) -> torch.Tensor:
        """float64 U[0, 1) of length ``n``, on the host."""
        return torch.rand(n, dtype=torch.float64, generator=self.host)

    def normal(self, shape) -> torch.Tensor:
        """float32 N(0, 1) on the run's device."""
        return torch.randn(tuple(shape), dtype=torch.float32,
                           generator=self.dev, device=self.device)

    def seed_words(self, n_sites: int, words: int = 2) -> list:
        """``n_sites`` tuples of uint32 words, as host integers."""
        return [tuple(row) for row in torch.randint(
            0, 2 ** 32, (n_sites, words), dtype=torch.int64,
            generator=self.host).tolist()]


def sample_times(rng: StepRandom, batch: int, train_eps: float,
                 t_max: float = 1.0) -> torch.Tensor:
    """t ~ U[train_eps, T], float64 on the host."""
    return rng.uniform(batch) * (t_max - train_eps) + train_eps


def _at(values, i: int, accum: int):
    """Microbatch ``i``'s share of an injected draw."""
    if values is None:
        return None
    return values[i] if accum > 1 else values


class _Compute:
    """The parameters a forward runs on, and the way back of their
    gradients. Without ``bf16`` they are the float32 parameters
    themselves. With it they are bfloat16 leaf copies, made once and
    refreshed by one multi-tensor copy a step, and their bfloat16
    gradients are cast up to float32 by another."""

    def __init__(self, net, bf16: bool):
        self.net = net
        self.bf16 = bf16
        self.half: dict = {}
        self.hashed = dropout_is_hashed(net.dropout_impl) \
            and 0.0 < net.dropout < 1.0

    def params(self, params):
        if not self.bf16:
            return params
        if self.half.keys() != params.keys():
            self.half.clear()
            self.half.update({k: torch.empty_like(v, dtype=torch.bfloat16)
                              .requires_grad_(v.requires_grad)
                              for k, v in params.items()})
        with torch.no_grad():
            torch._foreach_copy_(list(self.half.values()),
                                 list(params.values()))
        return self.half

    def forward_fn(self, p, rng, seeds):
        """``(z, t) -> float32 output`` of a train-mode forward on ``p``.
        Called by a criterion after it has drawn m0 and eps, so the
        dropout seed words are the step's last draw."""
        def fn(z, tt):
            words = seeds
            if words is None and self.hashed:
                words = rng.seed_words(self.net.dropout_sites)
            z = z.to(torch.bfloat16) if self.bf16 else z
            out = torch.func.functional_call(
                self.net, p, (z, tt), dict(
                    train=True, dropout_seeds=words,
                    generator=None if rng is None else rng.dev))
            return out.float()

        return fn

    def grads(self, loss, p) -> list:
        """float32 gradients of ``loss`` for the trainable entries of
        ``p``, in their order."""
        leaves = [v for v in p.values() if v.requires_grad]
        grads = torch.autograd.grad(loss, leaves)
        if self.bf16:  # the cast's gradient: up to float32, in one pass
            low, grads = grads, [torch.empty_like(g, dtype=torch.float32)
                                 for g in grads]
            torch._foreach_copy_(grads, low)
        return list(grads)


def _full(grads: list, params) -> dict:
    """The trainable gradients keyed as ``params``, zeros elsewhere."""
    trainable = iter(grads)
    return {k: next(trainable) if v.requires_grad else torch.zeros_like(v)
            for k, v in params.items()}


def make_train_step(net, sde, criterion, config) -> tuple[Callable, object]:
    """Build the score-model train step.

    Returns ``(step, optimizer)`` with ``step(state, batch, rng, *, t=None,
    eps=None, m0=None, dropout_seeds=None) -> (state, metrics)``. ``batch``
    is NHWC float32 on the device of ``state``; with ``training.grad_accum
    = A > 1`` it is A stacked microbatches [A, B, ...], the injected draws
    are sequences of A, and gradients are averaged before one optimizer
    update. ``state`` is updated in place and returned. ``metrics`` holds
    ``loss`` and ``grad_norm`` (the norm before clipping) as 0-dim tensors
    on the device: reading them is the caller's sync."""
    tcfg = config.training
    train_eps = float(tcfg.train_eps)
    tau = float(tcfg.ema_decay)
    use_ema = bool(tcfg.use_ema)
    accum = int(tcfg.get("grad_accum", 1))
    optimizer = make_optimizer(tcfg.optimizer)
    compute = _Compute(net, bool(tcfg.get("bf16", False)))

    def micro_grads(state, batch, rng, t, eps, m0, seeds):
        if t is None:
            t = sample_times(rng, batch.shape[0], train_eps, sde.T)
        t = t.to(batch.device)
        p = compute.params(state.params)
        # m0 is PSLD's momentum draw: the VP-SDE's criterion has none
        draws = {"eps": eps} if m0 is None else {"eps": eps, "m0": m0}
        loss = criterion(batch, t, compute.forward_fn(p, rng, seeds), rng,
                         **draws)
        return loss.detach().float(), compute.grads(loss, p)

    def step(state: TrainState, batch, rng=None, *, t=None, eps=None,
             m0=None, dropout_seeds=None):
        if accum > 1:
            loss, grads = None, None
            for i in range(accum):
                loss_i, g_i = micro_grads(
                    state, batch[i], rng, _at(t, i, accum),
                    _at(eps, i, accum), _at(m0, i, accum),
                    _at(dropout_seeds, i, accum))
                if grads is None:
                    loss, grads = loss_i, g_i
                else:
                    loss = loss + loss_i
                    torch._foreach_add_(grads, g_i)
            loss = loss / accum
            torch._foreach_div_(grads, accum)
        else:
            loss, grads = micro_grads(state, batch, rng, t, eps, m0,
                                      dropout_seeds)
        grad_norm = global_norm(grads)
        with torch.no_grad():
            optimizer.update_(_full(grads, state.params), state.opt_state,
                              state.params, grad_norm)
            if use_ema:
                ema_update_(state.ema_params, state.params, tau)
            else:
                for k, v in state.params.items():
                    state.ema_params[k].copy_(v)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step, optimizer


def make_clf_train_step(net, sde, criterion, config) -> tuple[Callable,
                                                              object]:
    """Build the classifier's train step. ``config`` holds the
    ``diffusion`` and ``clf`` trees.

    Returns ``(step, optimizer)`` with ``step(state, x, y, rng, *, t=None,
    eps=None, m0=None, dropout_seeds=None) -> (state, metrics)``: NHWC
    float32 images ``x`` and integer labels ``y`` on the state's device.
    ``clf.training.train_eps`` and ``clf.training.bf16`` fall back to the
    diffusion training's. The optimizer is ``clf.training.optimizer``,
    whose config has no ``grad_clip``: nothing is clipped. There is no
    EMA: ``ema_params`` stay as they were. ``metrics`` holds ``loss`` and
    ``top1`` as 0-dim tensors on the device."""
    ccfg, dcfg = config.clf.training, config.diffusion.training
    train_eps = float(ccfg.get("train_eps", dcfg.train_eps))
    optimizer = make_optimizer(ccfg.optimizer)
    compute = _Compute(net, bool(ccfg.get("bf16", dcfg.get("bf16", False))))

    def step(state: TrainState, x, y, rng=None, *, t=None, eps=None,
             m0=None, dropout_seeds=None):
        if t is None:
            t = sample_times(rng, x.shape[0], train_eps, sde.T)
        t = t.to(x.device)
        p = compute.params(state.params)
        loss, top1 = criterion(x, y, t,
                               compute.forward_fn(p, rng, dropout_seeds),
                               rng, eps=eps, m0=m0)
        grads = compute.grads(loss, p)
        norm = global_norm(grads) if optimizer.grad_clip else None
        with torch.no_grad():
            optimizer.update_(_full(grads, state.params), state.opt_state,
                              state.params, norm)
        state.step += 1
        return state, {"loss": loss.detach().float(), "top1": top1}

    return step, optimizer
