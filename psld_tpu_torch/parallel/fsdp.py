"""Fully sharded data parallelism (ZeRO-3) by hand over the functional
training step (``psld_tpu/parallel/fsdp.py``).

The JAX package shards every large parameter, EMA and Adam-moment leaf
along one of its dimensions and lets XLA derive the all-gathers and the
reduce-scatters. The port's step runs ``torch.func.functional_call`` on
compute copies of the parameters and takes gradients with
``torch.autograd.grad``, so the collectives are written out here:

* a leaf that :func:`fsdp_spec` shards keeps 1/N of its parameter, EMA
  and Adam moments on each of the N ranks: chunk r of its elements in
  memory order (every update is elementwise, so the chunk's layout is
  free, and the bytes a rank holds equal the JAX package's
  ``per_device_bytes``); smaller leaves are replicated;
* before the forward the chunks are all-gathered into the full compute
  copies (:meth:`Layout.gather`), bfloat16 when the step computes in
  bfloat16;
* after the backward the full gradients are summed and scattered back to
  the chunks (:meth:`Layout.reduce_scatter`).

Both collectives run in buckets of the sharded leaves, one call a bucket.
Checkpoints hold the full state (:func:`gather_state`), so a checkpoint
saved under FSDP restores without it and the other way round.
"""

from __future__ import annotations

import math

import torch

from psld_tpu_torch.parallel import distributed
from psld_tpu_torch.train.state import TrainState

# leaves smaller than this many elements stay replicated: gathering a tiny
# bias costs more in collective latency than its replication costs memory
DEFAULT_MIN_SIZE = 2 ** 14


def fsdp_spec(shape, n_shards: int, axis_name: str = "data",
              min_size: int = DEFAULT_MIN_SIZE) -> tuple:
    """The JAX package's choice, as a tuple: ``axis_name`` at the largest
    dimension that divides by ``n_shards`` (ties go to the trailing one),
    None elsewhere; ``()`` (replicated) for scalars, leaves of fewer than
    ``min_size`` elements and leaves with no such dimension."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < max(min_size, 2):
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % n_shards == 0 and (best is None or d >= shape[best]):
            best = i
    if best is None:
        return ()
    return tuple(axis_name if i == best else None for i in range(len(shape)))


def _dense(t) -> bool:
    """Whether ``t``'s elements fill its storage span without gaps or
    overlaps (any order of dimensions)."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()),
                               key=lambda d: d[1]):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


def memory_flat(t):
    """A 1-D view of the dense tensor ``t`` in memory order."""
    if not _dense(t):
        raise ValueError(f"not a dense tensor: shape {tuple(t.shape)}, "
                         f"strides {tuple(t.stride())}")
    return t.as_strided((t.numel(),), (1,), t.storage_offset())


def _aligned(n: int) -> int:
    return -(-n // distributed.ALIGN) * distributed.ALIGN


class Layout:
    """The FSDP layout of a parameter dict over the ranks of the process
    group (or ``rank``/``world``): which keys are sharded, each sharded
    key's chunk, and the buckets of the collectives.

    ``params`` gives the full tensors' shapes and strides (the compute
    copies take the same strides, channels_last convolution weights
    included). :data:`DEFAULT_MIN_SIZE` is read when a layout is made. A
    bucket lays out, for each rank, the chunks of its keys
    one after another, each at an offset aligned to
    ``distributed.ALIGN`` elements."""

    def __init__(self, params: dict, rank: int | None = None,
                 world: int | None = None):
        if rank is None or world is None:
            rank, world = distributed.process_info()
        self.rank, self.world = int(rank), int(world)
        self.shapes = {k: tuple(v.shape) for k, v in params.items()}
        self.strides = {k: tuple(v.stride()) for k, v in params.items()}
        self.sharded = {k for k, s in self.shapes.items()
                        if fsdp_spec(s, self.world,
                                     min_size=DEFAULT_MIN_SIZE)}
        self.chunk = {k: math.prod(self.shapes[k]) // self.world
                      for k in self.sharded}
        # buckets of (key, offset) over the sharded keys in dict order
        self.buckets: list = []
        keys, size = [], 0
        for k in params:
            if k not in self.sharded:
                continue
            keys.append((k, size))
            size += _aligned(self.chunk[k])
            if size * 4 * self.world >= distributed.BUCKET_BYTES:
                self.buckets.append((keys, size))
                keys, size = [], 0
        if keys:
            self.buckets.append((keys, size))

    def is_sharded(self, key: str) -> bool:
        return key in self.sharded

    def empty_full(self, key: str, dtype, device):
        """An uninitialized full tensor of ``key``, strided as the
        parameter it stands for."""
        return torch.empty_strided(self.shapes[key], self.strides[key],
                                   dtype=dtype, device=device)

    def _full_view(self, key: str, t):
        """``t``'s elements as (world, chunk) in the parameter's memory
        order; a tensor strided otherwise is copied into that order."""
        if tuple(t.stride()) != self.strides[key] or not _dense(t):
            t = torch.empty_strided(self.shapes[key], self.strides[key],
                                    dtype=t.dtype,
                                    device=t.device).copy_(t)
        return memory_flat(t).view(self.world, self.chunk[key])

    def shard(self, tree: dict) -> dict:
        """This rank's chunks of the sharded keys of a full ``tree`` (new
        tensors, keeping ``requires_grad``), the other keys as they
        are."""
        out = {}
        for k, v in tree.items():
            if k in self.sharded:
                with torch.no_grad():
                    chunk = self._full_view(k, v.detach())[self.rank].clone()
                out[k] = chunk.requires_grad_(v.requires_grad)
            else:
                out[k] = v
        return out

    def gather(self, shards: dict, out: dict) -> None:
        """Fill the full tensors ``out[k]`` (strided as the parameters, of
        any float dtype) of the sharded keys from every rank's chunks in
        ``shards``: one all-gather a bucket, in ``out``'s dtype."""
        with torch.no_grad():
            for keys, size in self.buckets:
                first = out[keys[0][0]]
                inp = torch.empty(size, dtype=first.dtype,
                                  device=first.device)
                torch._foreach_copy_(
                    [inp[o: o + self.chunk[k]] for k, o in keys],
                    [shards[k] for k, _ in keys])
                buf = torch.empty(self.world * size, dtype=first.dtype,
                                  device=first.device)
                distributed.all_gather_flat(buf, inp)
                rows = buf.view(self.world, size)
                for k, o in keys:
                    memory_flat(out[k]).view(self.world, self.chunk[k]) \
                        .copy_(rows[:, o: o + self.chunk[k]])

    def reduce_scatter(self, grads: dict) -> dict:
        """This rank's chunks of the sum over the ranks of the full
        float32 tensors ``grads`` of the sharded keys: one
        reduce-scatter a bucket. The chunks are views of the bucket's
        output."""
        out = {}
        for keys, size in self.buckets:
            first = grads[keys[0][0]]
            inp = torch.empty(self.world, size, dtype=torch.float32,
                              device=first.device)
            for k, o in keys:
                inp[:, o: o + self.chunk[k]].copy_(
                    self._full_view(k, grads[k]))
            res = torch.empty(size, dtype=torch.float32, device=first.device)
            distributed.reduce_scatter_flat(res, inp.view(-1))
            for k, o in keys:
                out[k] = res[o: o + self.chunk[k]]
        return out

    def bytes_per_rank(self) -> int:
        """The JAX package's ``per_device_bytes`` rule for a float32
        train state of this layout (params, EMA and two Adam moments): a
        sharded leaf counts 1/N of its elements."""
        return 4 * 4 * sum(
            self.chunk[k] if k in self.sharded else math.prod(s)
            for k, s in self.shapes.items())


def _trees(state: TrainState) -> dict:
    return {"params": state.params, "ema_params": state.ema_params,
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}


def shard_state(state: TrainState, layout: Layout) -> TrainState:
    """A state whose sharded leaves hold this rank's chunks; the counters
    and the replicated leaves are ``state``'s own."""
    t = {name: layout.shard(tree) for name, tree in _trees(state).items()}
    return TrainState(step=state.step, params=t["params"],
                      ema_params=t["ema_params"],
                      opt_state={"mu": t["mu"], "nu": t["nu"],
                                 "count": state.opt_state["count"]})


def gather_state(state: TrainState, layout: Layout) -> TrainState:
    """The full state of a sharded ``state`` (a collective: every rank
    calls it): new full tensors for the sharded leaves, the replicated
    ones as they are."""
    full = {}
    for name, tree in _trees(state).items():
        out = {k: (layout.empty_full(k, torch.float32, v.device)
                   if layout.is_sharded(k) else v) for k, v in tree.items()}
        layout.gather(tree, out)
        if name == "params":
            for k, v in tree.items():
                out[k].requires_grad_(v.requires_grad)
        full[name] = out
    return TrainState(step=state.step, params=full["params"],
                      ema_params=full["ema_params"],
                      opt_state={"mu": full["mu"], "nu": full["nu"],
                                 "count": state.opt_state["count"]})


def per_device_bytes(state: TrainState) -> int:
    """Bytes of the tensors of ``state`` that this rank holds."""
    return sum(v.numel() * v.element_size()
               for tree in _trees(state).values() for v in tree.values())
