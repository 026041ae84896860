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

Data parallelism (:mod:`psld_tpu_torch.parallel`): under a process group
of N ranks, ``batch`` is this rank's rows of the global batch, and the
step computes what one process computes at the global batch, as the JAX
package's step does on an N-device mesh. Every draw is made for the
global batch from generators seeded alike on every rank, and each rank
keeps its rows (:class:`StepRandom` with ``shard``); the dropout seed
words are the same on every rank, and each dropout site drops its rows
as the global batch's forward would (``batch_shard`` of the network).
The gradients and the loss are averaged over the ranks (summed, for a
``sum`` reduction) in one bucketed all-reduce after ``grad_accum`` and
before the clip's norm (:class:`~psld_tpu_torch.parallel.distributed.
GradReducer`): the all-reduce XLA inserts in the JAX package. With
``training.fsdp`` the step takes a :class:`~psld_tpu_torch.parallel.fsdp.
Layout`: the sharded leaves are all-gathered into the compute copies
before the forward and their gradients reduce-scattered after the
backward, and the clip's norm adds the squared norms of every rank's
chunks.
"""

from __future__ import annotations

from typing import Callable

import torch

from psld_tpu_torch.models.layers import dropout_is_hashed
from psld_tpu_torch.parallel import distributed
from psld_tpu_torch.parallel.mesh import shard_batch
from psld_tpu_torch.train.state import (TrainState, ema_update_, global_norm,
                                        make_optimizer)


class StepRandom:
    """The random source of a run: a host generator for what must be known
    on the host (the times' uniforms, the dropout seed words) and, seeded
    from it, a generator on ``device`` for the image-sized normals.

    ``shard = (index, count)``: the draws of a batch of B rows are rows
    ``index * B`` to ``(index + 1) * B`` of the draws of ``count * B``
    rows, which every rank makes alike."""

    def __init__(self, seed: int, device="cpu", shard=(0, 1)):
        self.device = torch.device(device)
        self.index, self.count = (int(v) for v in shard)
        self.host = torch.Generator().manual_seed(int(seed))
        if self.device.type == "cpu":
            self.dev = self.host
        else:
            self.dev = torch.Generator(device=self.device).manual_seed(
                int(torch.randint(0, 2 ** 62, (), generator=self.host)))

    def uniform(self, n: int) -> torch.Tensor:
        """float64 U[0, 1) of length ``n``, on the host."""
        return shard_batch(torch.rand(n * self.count, dtype=torch.float64,
                                      generator=self.host),
                           self.index, self.count)

    def normal(self, shape) -> torch.Tensor:
        """float32 N(0, 1) on the run's device."""
        shape = tuple(shape)
        return shard_batch(torch.randn(
            (shape[0] * self.count,) + shape[1:], dtype=torch.float32,
            generator=self.dev, device=self.device), self.index, self.count)

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
    themselves. With it they are bfloat16 leaf copies (``half``), made
    once and refreshed by one multi-tensor copy a step, and their
    bfloat16 gradients are cast up to float32 by another. Under FSDP
    (``layout``) the copies of the sharded leaves, bfloat16 or float32,
    are full tensors all-gathered from every rank's chunks before each
    forward."""

    def __init__(self, net, bf16: bool, layout=None):
        self.net = net
        self.bf16 = bf16
        self.layout = layout
        self.half: dict = {}
        self._copied: list = []
        self.hashed = dropout_is_hashed(net.dropout_impl) \
            and 0.0 < net.dropout < 1.0
        self.shard = distributed.process_info()

    def _sharded(self, key) -> bool:
        return self.layout is not None and self.layout.is_sharded(key)

    def params(self, params):
        if not self.bf16 and self.layout is None:
            return params
        if self.half.keys() != params.keys():
            dtype = torch.bfloat16 if self.bf16 else torch.float32
            self.half.clear()
            for k, v in params.items():
                if self._sharded(k):
                    t = self.layout.empty_full(k, dtype, v.device)
                elif self.bf16:
                    t = torch.empty_like(v, dtype=dtype)
                else:  # float32 and replicated: the parameter itself
                    self.half[k] = v
                    continue
                self.half[k] = t.requires_grad_(v.requires_grad)
            self._copied = [k for k in params
                            if self.bf16 and not self._sharded(k)]
        with torch.no_grad():
            if self._copied:
                torch._foreach_copy_([self.half[k] for k in self._copied],
                                     [params[k] for k in self._copied])
            if self.layout is not None:
                self.layout.gather(params, self.half)
        return self.half

    def forward_fn(self, p, rng, seeds):
        """``(z, t) -> float32 output`` of a train-mode forward on ``p``.
        Called by a criterion after it has drawn m0 and eps, so the
        dropout seed words are the step's last draw."""
        extra = {} if self.shard[1] == 1 else {"batch_shard": self.shard}

        def fn(z, tt):
            words = seeds
            if words is None and self.hashed:
                words = rng.seed_words(self.net.dropout_sites)
            z = z.to(torch.bfloat16) if self.bf16 else z
            out = torch.func.functional_call(
                self.net, p, (z, tt), dict(
                    train=True, dropout_seeds=words,
                    generator=None if rng is None else rng.dev, **extra))
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


class _Sync:
    """The cross-rank part of a step, under a process group or FSDP:
    ``sync(keys, grads, scalars, need_norm) -> (grads, scalars, norm)``.

    ``grads`` are the full float32 gradients of the trainable ``keys``,
    ``scalars`` 0-dim float32 tensors (the loss). Data parallel: all of
    them averaged over the ranks in one :class:`GradReducer` (summed when
    ``mean`` is false: a ``sum`` reduction of the loss), the norm that of
    the averaged gradients. FSDP: the sharded keys' gradients
    reduce-scattered to this rank's chunks (and divided by the world size
    when ``mean``), the rest through the reducer, and the norm the root
    of the per-leaf squared norms summed over the ranks (a replicated
    leaf counted once). The scalars come back as new tensors."""

    def __init__(self, mean: bool, layout=None):
        self.mean = bool(mean)
        self.layout = layout
        self.reducer = distributed.GradReducer(mean)
        self.rank, self.world = distributed.process_info()
        self._weights = None

    def __call__(self, keys, grads, scalars, need_norm: bool):
        n = len(scalars)
        if self.layout is None:
            out = self.reducer(list(grads) + list(scalars))
            grads = out[:len(grads)]
            norm = global_norm(grads) if need_norm else None
            return grads, [v.clone() for v in out[len(grads):]], norm
        sharded = {k: g for k, g in zip(keys, grads)
                   if self.layout.is_sharded(k)}
        chunks = self.layout.reduce_scatter(sharded) if sharded else {}
        if self.mean and chunks:
            torch._foreach_div_(list(chunks.values()), self.world)
        rest = [g for k, g in zip(keys, grads) if k not in chunks]
        out = self.reducer(rest + list(scalars))
        rest_iter = iter(out[:len(rest)])
        merged = [chunks[k] if k in chunks else next(rest_iter)
                  for k in keys]
        norm = None
        if need_norm:
            if self._weights is None:  # a replicated leaf counts once
                self._weights = torch.tensor(
                    [1.0 if k in chunks or self.rank == 0 else 0.0
                     for k in keys], device=merged[0].device)
            norms = torch.stack(torch._foreach_norm(merged)).float()
            sq = norms * norms * self._weights
            distributed.all_reduce_(sq)
            norm = torch.linalg.vector_norm(torch.sqrt(sq))
        return merged, [v.clone() for v in out[len(out) - n:]], norm


def _sync_for(criterion, layout):
    """The step's :class:`_Sync`, or None for one process without FSDP."""
    if layout is None and not distributed.initialized():
        return None
    return _Sync(getattr(criterion, "reduce_strategy", "mean") == "mean",
                 layout)


def _trainable(params) -> list:
    return [k for k, v in params.items() if v.requires_grad]


def _full(grads: list, params) -> dict:
    """The trainable gradients keyed as ``params``, zeros elsewhere."""
    trainable = iter(grads)
    return {k: next(trainable) if v.requires_grad else torch.zeros_like(v)
            for k, v in params.items()}


def make_train_step(net, sde, criterion, config,
                    fsdp=None) -> tuple[Callable, object]:
    """Build the score-model train step.

    Returns ``(step, optimizer)`` with ``step(state, batch, rng, *, t=None,
    eps=None, m0=None, dropout_seeds=None) -> (state, metrics)``. ``batch``
    is NHWC float32 on the device of ``state``; with ``training.grad_accum
    = A > 1`` it is A stacked microbatches [A, B, ...], the injected draws
    are sequences of A, and gradients are averaged before one optimizer
    update. ``state`` is updated in place and returned. ``metrics`` holds
    ``loss`` and ``grad_norm`` (the norm before clipping) as 0-dim tensors
    on the device: reading them is the caller's sync.

    Under a process group ``batch`` and the injected t, eps and m0 are
    this rank's rows, the loss and the norm are the global batch's (the
    same on every rank). ``fsdp`` (a :class:`~psld_tpu_torch.parallel.
    fsdp.Layout`) takes a state sharded by it (``fsdp.shard_state``)."""
    tcfg = config.training
    train_eps = float(tcfg.train_eps)
    tau = float(tcfg.ema_decay)
    use_ema = bool(tcfg.use_ema)
    accum = int(tcfg.get("grad_accum", 1))
    optimizer = make_optimizer(tcfg.optimizer)
    compute = _Compute(net, bool(tcfg.get("bf16", False)), fsdp)
    sync = _sync_for(criterion, fsdp)

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
        if sync is None:
            grad_norm = global_norm(grads)
        else:
            grads, (loss,), grad_norm = sync(_trainable(state.params), grads,
                                             [loss], True)
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


def make_clf_train_step(net, sde, criterion, config,
                        fsdp=None) -> tuple[Callable, object]:
    """Build the classifier's train step. ``config`` holds the
    ``diffusion`` and ``clf`` trees.

    Returns ``(step, optimizer)`` with ``step(state, x, y, rng, *, t=None,
    eps=None, m0=None, dropout_seeds=None) -> (state, metrics)``: NHWC
    float32 images ``x`` and integer labels ``y`` on the state's device.
    ``clf.training.train_eps`` and ``clf.training.bf16`` fall back to the
    diffusion training's. The optimizer is ``clf.training.optimizer``,
    whose config has no ``grad_clip``: nothing is clipped. There is no
    EMA: ``ema_params`` stay as they were. ``metrics`` holds ``loss`` and
    ``top1`` as 0-dim tensors on the device. Processes and ``fsdp`` as
    for :func:`make_train_step`; ``top1`` is the global batch's."""
    ccfg, dcfg = config.clf.training, config.diffusion.training
    train_eps = float(ccfg.get("train_eps", dcfg.train_eps))
    optimizer = make_optimizer(ccfg.optimizer)
    compute = _Compute(net, bool(ccfg.get("bf16", dcfg.get("bf16", False))),
                       fsdp)
    sync = _sync_for(criterion, fsdp)

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
        loss = loss.detach().float()
        if sync is None:
            norm = global_norm(grads) if optimizer.grad_clip else None
        else:
            grads, (loss, top1), norm = sync(
                _trainable(state.params), grads, [loss, top1.float()],
                bool(optimizer.grad_clip))
            if not sync.mean:  # top-1 is a mean whatever the loss sums
                top1 = top1 / sync.world
        with torch.no_grad():
            optimizer.update_(_full(grads, state.params), state.opt_state,
                              state.params, norm)
        state.step += 1
        return state, {"loss": loss, "top1": top1}

    return step, optimizer
