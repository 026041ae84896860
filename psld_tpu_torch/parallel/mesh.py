"""Placement of state and batches across ranks
(``psld_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over its devices: parameters,
Adam moments and EMA replicated, batches sharded on their leading axis.
Here a rank is one process on one card, so replication is a broadcast
from rank 0 and a batch shard is a slice of rows; there is no mesh
object.
"""

from __future__ import annotations

import torch

from psld_tpu_torch.parallel import distributed


def replicate_(state):
    """Make every tensor of the ``TrainState`` ``state`` equal to rank
    0's, in place, after an initialization or a restore; returns
    ``state``. Without a process group it does nothing."""
    if not distributed.initialized():
        return state
    with torch.no_grad():
        for tree in (state.params, state.ema_params, state.opt_state["mu"],
                     state.opt_state["nu"]):
            for v in tree.values():
                distributed.broadcast_(v, 0)
    return state


def shard_batch(x, rank: int | None = None, world: int | None = None):
    """Rank ``rank``'s contiguous rows (of ``world``) of a global tensor
    ``x``; both default to this process's."""
    if rank is None or world is None:
        rank, world = distributed.process_info()
    if x.shape[0] % world:
        raise ValueError(f"batch of {x.shape[0]} rows is not divisible by "
                         f"{world} ranks")
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
