"""The training step (``psld_tpu/train/steps.py``).

One step: t ~ U[train_eps, T] in float64 -> loss -> gradients -> global-norm
clip -> Adam(+warmup) -> EMA. PyTorch runs it eagerly; nothing is compiled.

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
draws from it, in a fixed order, t, then m0 (DSM only), then eps, then the
dropout seed words, and every draw can be handed in instead (``t=``,
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
    bf16 = bool(tcfg.get("bf16", False))
    optimizer = make_optimizer(tcfg.optimizer)
    hashed = dropout_is_hashed(net.dropout_impl) and 0.0 < net.dropout < 1.0

    half: dict = {}  # bfloat16 leaf copies of the parameters, made once

    def compute_params(params):
        """The parameters the forward runs on: themselves, or under
        ``bf16`` their bfloat16 copies, refreshed in one pass."""
        if not bf16:
            return params
        if half.keys() != params.keys():
            half.clear()
            half.update({k: torch.empty_like(v, dtype=torch.bfloat16)
                         .requires_grad_(v.requires_grad)
                         for k, v in params.items()})
        with torch.no_grad():
            torch._foreach_copy_(list(half.values()), list(params.values()))
        return half

    def loss_fn(p, batch, t, rng, eps, m0, seeds):
        def score_fn(z, tt):
            # the criterion has drawn m0 and eps by now: the seed words
            # come last
            words = seeds
            if words is None and hashed:
                words = rng.seed_words(net.dropout_sites)
            z = z.to(torch.bfloat16) if bf16 else z
            out = torch.func.functional_call(
                net, p, (z, tt), dict(train=True, dropout_seeds=words,
                                      generator=None if rng is None
                                      else rng.dev))
            return out.float()

        return criterion(batch, t, score_fn, rng, eps=eps, m0=m0)

    def micro_grads(state, batch, rng, t, eps, m0, seeds):
        if t is None:
            t = sample_times(rng, batch.shape[0], train_eps, sde.T)
        t = t.to(batch.device)
        p = compute_params(state.params)
        leaves = [v for v in p.values() if v.requires_grad]
        loss = loss_fn(p, batch, t, rng, eps, m0, seeds)
        grads = torch.autograd.grad(loss, leaves)
        if bf16:  # the cast's gradient: up to float32, in one pass
            low, grads = grads, [torch.empty_like(g, dtype=torch.float32)
                                 for g in grads]
            torch._foreach_copy_(grads, low)
        return loss.detach().float(), grads

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
                    loss, grads = loss_i, list(g_i)
                else:
                    loss = loss + loss_i
                    torch._foreach_add_(grads, g_i)
            loss = loss / accum
            torch._foreach_div_(grads, accum)
        else:
            loss, grads = micro_grads(state, batch, rng, t, eps, m0,
                                      dropout_seeds)
            grads = list(grads)
        grad_norm = global_norm(grads)
        trainable = iter(grads)
        full = {k: next(trainable) if v.requires_grad else torch.zeros_like(v)
                for k, v in state.params.items()}
        with torch.no_grad():
            optimizer.update_(full, state.opt_state, state.params, grad_norm)
            if use_ema:
                ema_update_(state.ema_params, state.params, tau)
            else:
                for k, v in state.params.items():
                    state.ema_params[k].copy_(v)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step, optimizer
