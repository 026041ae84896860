"""Spatial (height) parallelism (``psld_tpu/parallel/spatial.py``).

One image's height is split over the S ranks of a spatial group: rank r
is spatial index ``s = r % S`` of data group ``d = r // S``, and holds
rows ``[s * H / S, (s + 1) * H / S)`` of every image of its data group's
batch rows. The JAX package annotates its batch ``P("data", "spatial")``
over a ``(data, spatial)`` mesh of consecutive devices and lets XLA's
partitioner insert every halo exchange and cross-shard reduction; it
keeps a spatial group inside one process. Here one rank is one card, so
a spatial group spans processes by construction, and what the
partitioner inserts is written out:

- a halo exchange (:func:`halo`) before every convolution and FIR
  resample over the height: ``k`` rows above and below from the
  neighbours, zeros at the group's edges; its backward sends the halo
  rows' gradients back to their owners, which add them;
- GroupNorm's moments and their gradients summed over the group
  (:mod:`psld_tpu_torch.ops.group_norm`, the split entry points);
- attention over every token: the block's input gathered over the height
  (:func:`gather`, whose backward is the owner's slice of the summed
  gradients), the block run whole (its GroupNorm the fused one, on the
  whole map), the rank's rows kept;
- hash dropout at each element's position in the whole image
  (:mod:`psld_tpu_torch.ops.dropout`);
- sums over pixels (the classifier's head, the samplers' norms) over the
  group (:func:`group_sum`).

Transport: every exchange is one ``all_gather`` over the spatial group,
of the edge rows for a halo, on any backend (gloo takes CUDA tensors for
its collectives on torch 2.11, ``chip_smoke.py`` ``[ddp2]``).
Point-to-point sends to the two neighbours would move S / 2 times fewer
bytes; they wait for a machine with more than one card to be measured
on.

Thin shards: a halo wider than a shard's rows (S = 4 on an 8-row input
leaves 1 row a rank at 4 x 4, where the FIR resamples want 2) gathers
that level whole and takes the rows it needs from it.

The layout is process-wide: :func:`configure` (``training.spatial``,
``evaluation.spatial``) turns it on for every later forward of the
process, and :func:`active` tells a layer whether it runs on a shard.
"""

from __future__ import annotations

import torch

from psld_tpu_torch.parallel import distributed


def make_spatial_mesh(spatial: int) -> tuple[int, int]:
    """The port's ``(data, spatial)`` mesh: (data groups, ranks a spatial
    group) of spatial groups of ``spatial`` consecutive ranks; raises
    ValueError (the JAX package's message) unless ``spatial`` divides
    the world size. Makes no process group: see :func:`configure`."""
    world = distributed.process_info()[1]
    if spatial < 1 or world % spatial:
        raise ValueError(
            f"spatial={spatial} must divide the device count {world} "
            "(training.spatial / evaluation.spatial)")
    return world // spatial, spatial


def check_divisible(height: int, spatial: int) -> None:
    """Raise ValueError (the JAX package's message) unless ``height``
    divides by ``spatial``."""
    if height % spatial:
        raise ValueError(
            f"image height {height} is not divisible by the spatial mesh "
            f"factor {spatial}; pick training.spatial from the divisors of "
            f"the input resolution")


def configure(spatial: int, height: int) -> None:
    """Check ``spatial`` against the world size and the input ``height``,
    then run this process's later passes on height shards
    (:func:`distributed.configure_spatial`). Every rank calls it alike."""
    make_spatial_mesh(int(spatial))
    check_divisible(int(height), int(spatial))
    distributed.configure_spatial(int(spatial))


def active() -> bool:
    """Whether this process runs on height shards (S > 1)."""
    return distributed.spatial_group() is not None


def height_slice(x, dim: int = 1):
    """This rank's slice of the height axis ``dim`` of a whole-image
    tensor (a tuple: of each); ``x`` itself without spatial
    parallelism. The counterpart of ``spatial_batch_sharding``'s height
    placement."""
    if isinstance(x, tuple):
        return tuple(height_slice(v, dim) for v in x)
    s, sp, _, _ = distributed.spatial_info()
    if sp == 1:
        return x
    h = x.shape[dim]
    if h % sp:
        check_divisible(h, sp)
    return x.narrow(dim, s * (h // sp), h // sp)


def spatial_batch_slice(x):
    """This rank's part of a global NHWC batch: its data group's rows,
    then its height slice; the counterpart of the JAX package's
    ``spatial_batch_spec`` placement."""
    from psld_tpu_torch.parallel.mesh import shard_batch

    return height_slice(shard_batch(x, *distributed.data_info()), 1)


def _keep_format(t, like):
    """``t`` in ``like``'s memory format (a 4D ``channels_last`` tensor
    stays ``channels_last``)."""
    if t.ndim == 4 and like.ndim == 4 and not like.is_contiguous() \
            and like.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` of the spatial group, stacked on a new leading
    axis; the backward is this rank's slice of the gradients summed over
    the group (one reduce-scatter)."""

    @staticmethod
    def forward(ctx, x):
        _, sp, _, _ = distributed.spatial_info()
        group = distributed.spatial_group()
        ctx.group, ctx.shape = group, tuple(x.shape)
        inp = x.contiguous().view(-1)
        out = inp.new_empty(sp * inp.numel())
        distributed.all_gather_flat(out, inp, group=group)
        return out.view((sp,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        flat = g.contiguous().view(-1)
        out = flat.new_empty(flat.numel() // g.shape[0])
        distributed.reduce_scatter_flat(out, flat, group=ctx.group)
        return out.view(ctx.shape)


def gather(x, dim: int = 2):
    """The whole height: every shard of ``x`` along ``dim`` in rank order,
    differentiable (the backward is the owner's slice of the summed
    gradients). ``x`` itself without spatial parallelism."""
    if not active():
        return x
    parts = _AllGather.apply(x)
    return _keep_format(torch.cat(parts.unbind(0), dim), x)


def halo(x, top: int, bottom: int, dim: int = 2):
    """``x`` with ``top`` rows of the ranks above and ``bottom`` rows of
    the ranks below it on the height axis ``dim``, zeros past the
    group's edges; differentiable (the halo rows' gradients go back to
    their owners, which add them). Without spatial parallelism: ``x``
    padded with zeros."""
    if top == 0 and bottom == 0:
        return x
    s, sp, _, _ = distributed.spatial_info()
    h = x.shape[dim]

    def zeros(n):
        shape = list(x.shape)
        shape[dim] = n
        return x.new_zeros(shape)

    if sp == 1:
        pieces = [zeros(top), x, zeros(bottom)]
    elif top <= h and bottom <= h:
        # each rank's first ``bottom`` rows (its upper neighbour's bottom
        # halo) and last ``top`` rows (its lower neighbour's top halo)
        edges = torch.cat([x.narrow(dim, 0, bottom),
                           x.narrow(dim, h - top, top)], dim)
        got = _AllGather.apply(edges)
        pieces = [got[s - 1].narrow(dim, bottom, top) if s > 0
                  else zeros(top), x,
                  got[s + 1].narrow(dim, 0, bottom) if s < sp - 1
                  else zeros(bottom)]
    else:
        # a halo wider than a shard: gather the level, take the rows
        whole = torch.cat([zeros(top), gather(x, dim), zeros(bottom)], dim)
        return _keep_format(whole.narrow(dim, s * h, h + top + bottom), x)
    return _keep_format(torch.cat(pieces, dim), x)


class _GroupSum(torch.autograd.Function):
    """The sum over the spatial group of every rank's ``x``, the same on
    each; the backward passes the gradient through, as every rank
    carries the same downstream computation."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        distributed.all_reduce_(out, group=distributed.spatial_group())
        return out

    @staticmethod
    def backward(ctx, g):
        return g


def group_sum(x):
    """The sum of ``x`` over the spatial group (``x`` without spatial
    parallelism): a per-sample sum over pixels of the whole image from
    each rank's sum over its rows."""
    if not active():
        return x
    return _GroupSum.apply(x)
