"""Multi-process runtime (``psld_tpu/parallel/distributed.py``).

The reference scales through Lightning DDP on NCCL; the JAX package
joins one process per host with ``jax.distributed.initialize``. Here one
process drives one card, joined by ``torch.distributed``: NCCL when the
run's device is a card, gloo when it is the CPU. A run of one process
with no launcher skips all of it, and every helper below then acts as
the identity.

Launch N ranks on one host with ``torchrun``::

    torchrun --standalone --nproc_per_node=N \\
        -m psld_tpu_torch.cli.train_sde +dataset=...

or start each rank yourself with ``PSLD_MULTIHOST=1`` and the standard
variables ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` (the card a rank takes). Rank r then works on
``cuda:LOCAL_RANK``.

The collectives the training step and the loop use are the functions of
this module (:func:`all_reduce_`, :func:`all_gather_flat`,
:func:`reduce_scatter_flat`, :func:`broadcast_`), called through the
module, so one place holds every call into ``torch.distributed``.
"""

from __future__ import annotations

import atexit
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENV_FLAG = "PSLD_MULTIHOST"
# bytes of one all-reduce of the gradient buffer
BUCKET_BYTES = 2 ** 26
# each tensor of a flat buffer starts at a multiple of this many elements,
# so a view of it is aligned as a tensor of its own is, and the vectorized
# paths of the multi-tensor kernels see the same layout
ALIGN = 64


def multihost_requested() -> bool:
    """True when ``PSLD_MULTIHOST`` is set, or a launcher (``torchrun``)
    started more than one rank."""
    if os.environ.get(_ENV_FLAG, "").strip() not in ("", "0", "false"):
        return True
    return int(os.environ.get("WORLD_SIZE", "1") or 1) > 1


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """The card of this rank on its host (``LOCAL_RANK``, default 0)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def maybe_initialize(device="cuda") -> None:
    """Join the process group when requested (idempotent): NCCL for a run
    on a card, after taking ``cuda:LOCAL_RANK``; gloo for a run on the
    CPU. No-op unless :func:`multihost_requested`."""
    if not multihost_requested() or initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend)
    atexit.register(destroy)  # NCCL wants its group destroyed before exit
    logger.info("multi-process: rank %d/%d on %s (%s)", dist.get_rank(),
                dist.get_world_size(), run_device(device), backend)


def destroy() -> None:
    """Leave the process group, if this process joined one."""
    global _HOST_GROUP
    if initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(local batch, first row) of this rank's contiguous slice of each
    global batch."""
    rank, world = process_info()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"{world} processes")
    local = global_batch // world
    return local, rank * local


def run_device(name) -> torch.device:
    """The device a run named ``name`` (``training.device``,
    ``evaluation.device``) works on: under a process group a bare
    ``cuda`` is this rank's card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(str(name))
    if dev.type == "cuda" and dev.index is None and initialized():
        return torch.device("cuda", local_rank())
    return dev


# -- collectives ---------------------------------------------------------
def all_reduce_(tensor) -> None:
    """In-place sum over the ranks."""
    if initialized():
        dist.all_reduce(tensor)


def all_gather_flat(out, inp) -> None:
    """``out`` (``world * inp.numel()`` elements) <- every rank's ``inp``,
    in rank order."""
    if not initialized():
        out.copy_(inp)
        return
    # torch 2.13 renames all_gather_into_tensor; both take these arguments
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp)


def reduce_scatter_flat(out, inp) -> None:
    """``out`` <- this rank's chunk of the sum of every rank's ``inp``
    (``world * out.numel()`` elements, chunk r for rank r)."""
    if not initialized():
        out.copy_(inp)
        return
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp)


def broadcast_(tensor, src: int = 0) -> None:
    """``tensor`` <- rank ``src``'s, in place."""
    if initialized():
        dist.broadcast(tensor, src)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (any picklable value) on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def global_mean(x):
    """The mean of ``x`` over the elements of every rank's ``x`` (all of
    one size): one all-reduce of its sum."""
    total = x.sum().reshape(1)
    all_reduce_(total)
    return (total / (x.numel() * process_info()[1]))[0]


_HOST_GROUP = None


def _host_group():
    """The group of host-side agreement: the default group where it runs
    on gloo, else a gloo group over the same ranks, made at first use
    (every rank reaches that use at the same point)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any: one all-reduce of
    a host integer over gloo, so no rank waits for its card."""
    if not initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return bool(t.item())


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class GradReducer:
    """The data-parallel gradient all-reduce, done by hand: the training
    step takes its gradients with ``torch.autograd.grad`` on
    ``functional_call``, which no module hook of
    ``DistributedDataParallel`` sees.

    ``reducer(tensors)`` copies the float32 ``tensors`` (the gradients,
    and the loss beside them) into one flat buffer, each at an offset
    aligned to :data:`ALIGN` elements, sums the buffer over the ranks in
    all-reduces of :data:`BUCKET_BYTES`, divides it by the world size
    when ``mean``, and returns views of it shaped and strided as
    ``tensors``. The views are overwritten by the next call. The buffer
    is made at the first call and again when the shapes change."""

    def __init__(self, mean: bool = True):
        self.mean = bool(mean)
        self._key = None
        self.flat = None
        self.views: list = []
        self.buckets: list = []

    def _layout(self, tensors) -> None:
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)
        if key == self._key:
            return
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("GradReducer takes float32 tensors")
        offsets, total = [], 0
        for t in tensors:
            offsets.append(total)
            total += _aligned(t.numel())
        self.flat = torch.zeros(total, dtype=torch.float32,
                                device=tensors[0].device)
        # each view strided as ``empty_like`` strides its tensor (a
        # channels_last gradient stays channels_last), so the reductions
        # over it (the clip's norm) run as over the tensor itself
        self.views = [self.flat.as_strided(
            t.shape, torch.empty_like(t, device="meta").stride(), o)
            for o, t in zip(offsets, tensors)]
        # buckets end on tensor boundaries, each past bucket_bytes at most
        # by its last tensor
        limit = BUCKET_BYTES // 4
        self.buckets, start = [], 0
        for o, t in zip(offsets, tensors):
            end = o + _aligned(t.numel())
            if end - start >= limit:
                self.buckets.append(self.flat[start:end])
                start = end
        if start < total:
            self.buckets.append(self.flat[start:total])
        self._key = key

    def __call__(self, tensors) -> list:
        tensors = list(tensors)
        self._layout(tensors)
        torch._foreach_copy_(self.views, tensors)
        for bucket in self.buckets:
            all_reduce_(bucket)
        if self.mean:
            self.flat.div_(process_info()[1])
        return self.views
