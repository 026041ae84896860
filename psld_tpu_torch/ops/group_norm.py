"""GroupNorm -> activation for Hopper: CUDA C++ forward and backward
kernels, their host planners, and their plain PyTorch versions.

The forward replaces ``psld_tpu/ops/group_norm.py::_gn_kernel`` (launched
by ``_pallas_gn``), the NHWC GroupNorm(G) + affine + act fused into one
VMEM residency per batch element. The backward replaces its custom VJP
``_gn_bwd``, which in the JAX package is no kernel but a pull-back through
the jnp chain; here it is a kernel of its own, because autograd through
the plain chain would re-read and re-write the activation a dozen times,
125 times a training step.

Numerics follow ``gn_bf16`` (:mod:`psld_tpu_torch.knobs`, read on the
host at every call). Off, or for a float32 x, both kernels run the TPU
kernel's f32 chain: single-pass f32 moments, the variance clamped at 0,
``rsqrt(var + eps)``, one rounding to the output dtype. On, a bf16 x runs
the chain of :func:`group_norm_act_plain` (``group_norm_act_reference``
in the JAX package) with its rounding points: mean and rstd rounded to
bf16, then ``x - mean``, ``* rstd``, ``* scale``, ``+ bias`` and the
activation each rounded to bf16; the backward differentiates that chain
and rounds its cotangents where autograd through the plain chain rounds
them (the source note of ``csrc/group_norm_bwd.cu`` says which). This is
a deliberate difference from the JAX package: its TPU kernel
(``fused_gn=true``) ignores ``gn_bf16`` and runs the f32 chain, while its
default path (the jnp chain) and its VJP honour it; here the kernels are
the only path on the card, so they honour it.

The forward kernel, ``csrc/group_norm_fwd.cu``, is bound by device-memory
bytes: one read of x and one write of y, a few f32 operations an element.
A block (or a thread block cluster of 2 to 8 blocks splitting the pixel
rows) owns one work item, a batch element's slice of whole groups, and
stages it in shared memory with 16-byte ``cp.async`` in four commit
groups, adding the f32 channel sums of x and x^2 of each as it lands; it
then folds the sums into groups (over the cluster through distributed
shared memory, in rank order) and normalizes from shared memory with
16-byte stores, so device memory sees each byte of x once.
:func:`plan_forward` picks the slice, the cluster, the threads and the
rows a block holds; past what shared memory holds (maps of 128 x 128 and
up at some widths), the normalize pass re-reads the rest of the rows from
device memory. Maps of up to 64 pixels give a work item to one warp,
which holds it in registers: no barrier, no shared memory. What holds it
back on the H100 (``PERF.md``, section 6): at 32 x 32 a launch is
1.3 waves of three blocks an SM, each of which stages, reduces, then
writes, so loads and stores overlap little; at 16 x 16 and below every
block runs at once and one block's chain of latencies is the time.

The backward kernel, ``csrc/group_norm_bwd.cu``, computes the exact
gradient of the chain the forward ran. With ``xh = (x - mean) * rstd``,
``z = xh * scale + bias``, ``y = act(z)``: ``dz = g * act'(z)``, ``dbias =
sum dz``, ``dscale = sum dz * xh``, ``dxh = dz * scale``, ``dx = rstd *
(dxh - mean_g(dxh) - xh * mean_g(dxh * xh))``. The moments are
recomputed from x, so the autograd Function saves x, scale and bias and
nothing else. It is bound by bytes (read x and g, write dx), and its
design reads each of them from device memory once: a block (or a
thread block cluster) holds one batch element's slice of whole groups in
shared memory and runs its three passes from there (the source note
says how), with the geometry of :func:`plan_backward`. ``dscale`` and
``dbias`` sum over the batch inside the same launch: the kernel writes
(channel, batch element) partials into a (2, C, B) float32 buffer, and
the last block of a slice to finish, counted with integers, adds them in
a fixed order. A per-(device, stream) buffer of those counts is zeroed
once and left at zero by every launch. A group whose variance was
clamped at 0 gets no gradient through the variance. Activation slopes at
the kink follow PyTorch's, as the plain version's autograd takes them:
relu 0 and leaky relu 0.2 at z = 0 (``jax.nn``'s leaky relu takes 1
there; the two differ only where z is exactly 0), elu ``exp(z)`` for
z <= 0.

Both kernels take x, and the backward its cotangent, on 16-byte
boundaries, and launch without a host allocation beyond their outputs (and
the backward's partials), so a CUDA graph can capture them.

Under spatial parallelism a rank holds a slice of each image's height,
and the moments span the slices: :func:`group_norm_act_split` runs the
split entry points of the two kernels (``group_norm_split_stats`` /
``_apply`` in the forward source, ``_partials`` / ``_dx`` in
``csrc/group_norm_split_bwd.cu``; the source notes say how) around one
all-reduce each way, with a plain version beside each.

The ops raise on a shape their kernels do not take. Which shapes those
are is written once, in :func:`group_norm_fits` (the fused kernels) and
:func:`group_norm_split_fits` (the split entries), and the checks raise
on top of them; the model layers ask them before any launch and run the
plain versions where they are False, as the JAX package's dispatcher
runs its jnp chain where its Pallas kernel does not fit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from psld_tpu_torch import knobs
from psld_tpu_torch.kernels import build

_ACTS = {
    "none": lambda x: x,
    "swish": F.silu,
    "silu": F.silu,
    "relu": F.relu,
    "elu": F.elu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.2),
}
_ACT_CODE = {"none": 0, "swish": 1, "silu": 1, "relu": 2, "elu": 3,
             "lrelu": 4}


def group_norm_act_plain(x, scale, bias, num_groups: int, eps: float = 1e-6,
                         act: str = "none"):
    """NHWC GroupNorm (biased variance) + act, with the reference's
    rounding points: under ``gn_bf16`` the normalize+affine+act chain of a
    non-f32 input runs in its dtype; moment sums are f32 always."""
    b, h, w, c = x.shape
    g = num_groups
    cd = x.dtype if (x.dtype != torch.float32 and knobs.gn_bf16()) \
        else torch.float32
    xg = x.reshape(b, h * w, g, c // g)
    x32 = xg.float()
    mean = x32.mean(dim=(1, 3), keepdim=True)
    mean2 = (x32 * x32).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    rs = torch.rsqrt(var + eps)
    y = (xg.to(cd) - mean.to(cd)) * rs.to(cd)
    y = y.reshape(b, h, w, c)
    y = y * scale.to(cd) + bias.to(cd)
    return _ACTS[act](y).to(x.dtype)


# the kernels' blocks (csrc/group_norm_fwd.cu, csrc/group_norm_bwd.cu): the
# shared memory a block may have, the cluster sizes
_SMEM_MAX = 232_448
_CLUSTERS = (1, 2, 4, 8)
# shared memory a block aims at, so that three blocks share an SM
_SMEM_TARGET = _SMEM_MAX // 3
# a slice's row, at most, where whole groups allow: one 128-byte line of
# an NHWC row
_ROW_BYTES = 128
# a block of at most this many elements of x runs 128 threads, else 256:
# the backward's, the forward's
_BWD_SMALL_TILE = 4096
_FWD_SMALL_TILE = 16384
# forward work items (batch elements x slices) below which a narrower
# slice pays: some four blocks for each of the H100's 132 SMs
_FWD_ITEMS = 512
# a forward slice's bytes, at most (a warp's 16-byte pieces); the
# backward's slice is at most 512 channels, never fewer bytes
_FWD_WIDEST = 512
# maps of at most this many pixels take a warp a work item, with at most
# _WARP_PIECES 16-byte pieces a lane (``WP`` in the CUDA source)
_WARP_HW = 64
_WARP_PIECES = 8


def _fwd_smem(resident: int, slice_: int, elem: int, threads: int) -> int:
    """Bytes of shared memory of a forward block of ``threads`` threads
    holding ``resident`` pixel rows of a ``slice_``-channel slice: x, then
    float32 scratch (``smem_bytes`` in the CUDA source computes the
    same)."""
    return resident * slice_ * elem + 4 * (2 * (threads // 32) * slice_
                                           + 8 * slice_)


def _bwd_smem(resident: int, slice_: int, elem: int, threads: int) -> int:
    """Bytes of shared memory of a backward block of ``threads`` threads
    holding ``resident`` pixel rows of a ``slice_``-channel slice: x and
    g, then float32 scratch (``smem_bytes`` in the CUDA source computes
    the same)."""
    rows = threads // (slice_ // 4)
    return 2 * resident * slice_ * elem + 4 * (2 * rows * slice_
                                               + 11 * slice_)


def _slices(c: int, num_groups: int, elem: int, widest: int) -> list:
    """Channels of each slice of whole groups of C that is a multiple of 16
    bytes and at most ``widest`` bytes wide, widest first: the slices a
    GroupNorm block may own."""
    cg = c // num_groups
    return [k * cg for k in range(num_groups, 0, -1)
            if num_groups % k == 0 and k * cg * elem % 16 == 0
            and k * cg * elem <= widest]


def _plan(what: str, smem, staged: int, widest: int, small_tile: int,
          hw: int, c: int, num_groups: int, dtype,
          row_bytes: int = _ROW_BYTES, aligned: int = 1) -> dict:
    """The geometry of a kernel whose block stages ``staged`` tensors of a
    slice and needs ``smem(resident, slice, elem, threads)`` bytes; slices
    are at most ``widest`` bytes wide, and at most ``row_bytes`` where
    whole groups allow; slices a multiple of ``aligned`` bytes wide come
    first, over any cluster; a block of ``small_tile`` elements or fewer
    runs 128 threads. See :func:`plan_forward`."""
    if c % num_groups:
        raise ValueError(f"C={c} is no multiple of G={num_groups}")
    elem = torch.empty((), dtype=dtype).element_size()
    cg = c // num_groups
    slices = _slices(c, num_groups, elem, widest)
    if not slices:
        raise ValueError(
            f"{what} kernel: no slice of whole {cg}-channel groups of C={c} "
            f"is a multiple of 16 bytes and at most {widest} bytes in "
            f"{dtype}")

    def plan(s, cl, resident):
        threads = 128 if resident * s <= small_tile else 256
        return dict(slice=s, cluster=cl, resident=resident, threads=threads,
                    smem=smem(resident, s, elem, threads))

    narrow = [s for s in slices if s * elem <= row_bytes] or slices[-1:]
    for group in ([s for s in narrow if s * elem % aligned == 0],
                  [s for s in narrow if s * elem % aligned]):
        for cl in _CLUSTERS:
            rows = -(-hw // cl)
            for s in group:
                if plan(s, cl, rows)["smem"] <= _SMEM_TARGET:
                    return plan(s, cl, rows)
    s, cl = slices[-1], _CLUSTERS[-1]
    resident = (_SMEM_MAX - smem(0, s, elem, 256)) // (staged * s * elem)
    return plan(s, cl, min(-(-hw // cl), resident))


@functools.lru_cache(maxsize=None)
def plan_forward(hw: int, c: int, num_groups: int, dtype,
                 batch: int | None = None) -> dict:
    """The forward kernel's geometry for (H*W, C, G, dtype): ``slice``
    channels (whole groups, a divisor of C, a multiple of 16 bytes) a
    cluster of ``cluster`` blocks of ``threads`` threads owns, each block
    holding ``resident`` of its pixel rows in shared memory (``smem``
    bytes).

    Slices a multiple of 32 bytes (whole sectors of device memory) come
    first, over any cluster (C = 384 in bf16: 96-byte slices over a
    cluster of 2 blocks, not 48-byte ones); within them the smallest
    cluster (a cluster's barriers cost more than a narrower slice), then
    the widest slice up to one 128-byte line of a row whose pixels fit in
    a third of an SM's shared memory, so that three blocks share an SM.
    Failing that, the narrowest slice over the largest cluster holds what
    fits and the kernel reads the rest of its rows from device memory.
    Given the ``batch``, a slice wider than 64 bytes that leaves fewer
    than ``_FWD_ITEMS`` work items gives way to one of at most 64 bytes
    (more blocks, each with a shorter chain of loads, sums and stores).
    Maps of at most ``_WARP_HW`` pixels take a warp a work item where
    :func:`_warp_plan` finds a slice (``threads`` 32, ``smem`` 0): their
    chain is latency, not bytes. Raises ValueError where no slice of
    whole groups is a multiple of 16 bytes and at most 512 bytes (a
    warp's 16-byte pieces)."""
    args = ("group_norm_act", _fwd_smem, 1, _FWD_WIDEST, _FWD_SMALL_TILE,
            hw, c, num_groups, dtype)
    plan = _plan(*args, aligned=32)
    elem = torch.empty((), dtype=dtype).element_size()
    if hw <= _WARP_HW:
        warp = _warp_plan(hw, c, num_groups, elem)
        if warp is not None:
            return warp
    if batch is not None and plan["slice"] * elem > 64 \
            and batch * c // plan["slice"] < _FWD_ITEMS:
        plan = _plan(*args, row_bytes=64, aligned=32)
    return plan


def _warp_plan(hw: int, c: int, num_groups: int, elem: int):
    """A warp a work item (``threads`` 32, the pieces in registers, no
    shared memory): the widest slice of at most 128 bytes whose pieces fit
    ``_WARP_PIECES`` a lane, where the groups fold within a lane's piece
    or over a power of two of lanes; else None."""
    cg, nv = c // num_groups, 16 // elem
    k = cg // nv
    if not (nv % cg == 0 if cg <= nv else cg % nv == 0 and not k & (k - 1)):
        return None
    for kk in range(num_groups, 0, -1):
        s = kk * cg
        if num_groups % kk or s * elem % 16 or s * elem > 128:
            continue
        lanes = 1 << max(0, (s // nv - 1).bit_length())
        if -(-hw // (32 // lanes)) <= _WARP_PIECES:
            return dict(slice=s, cluster=1, resident=hw, threads=32, smem=0)
    return None


@functools.lru_cache(maxsize=None)
def plan_backward(hw: int, c: int, num_groups: int, dtype) -> dict:
    """The backward kernel's geometry, planned as :func:`plan_forward`
    plans the forward's, for a block that stages x and the cotangent and
    a slice of at most 512 channels."""
    elem = torch.empty((), dtype=dtype).element_size()
    return _plan("group_norm_act_backward", _bwd_smem, 2, 512 * elem,
                 _BWD_SMALL_TILE, hw, c, num_groups, dtype)


# the split stats kernel (``psld_gn_split_stats``): threads a block, pixel
# rows a thread has in flight (``STATS_UNROLL`` in the CUDA source), the
# blocks an SM is counted to hold in a wave and the waves a large shard
# aims at over the H100's SMs, the fewest pixels a block reduces, and the
# bytes a batch element may have and still take one block (no partials)
_STATS_THREADS = 256
_STATS_UNROLL = 8
_STATS_RESIDENT = 4
_STATS_WAVES = 1
_SMS = 132
_STATS_MIN_ROWS = 64
_STATS_ONE_BLOCK = 128 * 1024


def _split_pass(c: int, num_groups: int, dtype, unroll: int):
    """(bytes an element, ``vec`` channels an access, ``step`` rows a
    pass) of a split kernel's block: 16-byte accesses where C is a
    multiple of their channels, else 1 (the scalar path); 256 threads
    over a row's pieces, ``unroll`` rows a thread."""
    if c % num_groups:
        raise ValueError(f"C={c} is no multiple of G={num_groups}")
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem if c % (16 // elem) == 0 else 1
    return elem, vec, _STATS_THREADS // min(c // vec, _STATS_THREADS) * unroll


@functools.lru_cache(maxsize=None)
def plan_split_stats(batch: int, hw: int, c: int, num_groups: int,
                     dtype) -> dict:
    """The split stats kernel's geometry for a (batch, H*W, C) shard:
    ``vec`` channels a load (16 bytes where C is a multiple of them, else
    1, the scalar path), ``rows`` pixels a block reduces, ``chunks`` blocks
    a batch element (the grid is (chunks, batch)), and ``scratch`` floats
    of partials (0 for one chunk, which writes the sums directly).

    A pass of a block covers ``step`` rows: 256 threads over the row's
    pieces, ``_STATS_UNROLL`` rows a thread. A batch element of at
    most ``_STATS_ONE_BLOCK`` bytes is one block's, with no partials to
    fold. Else ``rows`` is a multiple of ``step``, at least
    ``_STATS_MIN_ROWS`` (so the scratch stays within B * ceil(H*W / 64) *
    G * 2 floats), and as few as give ``_STATS_WAVES`` waves of
    ``_STATS_RESIDENT`` blocks on each of ``_SMS`` SMs over the batch: a
    bf16 shard of 32,768 pixels of 128 channels at batch 8 takes 512
    blocks of 512 pixels. Chosen on the card (``PERF.md``, section 6) among
    1 to 8 waves, 2 to 8 rows in flight and at least 64 or 256 pixels a
    block."""
    elem, vec, step = _split_pass(c, num_groups, dtype, _STATS_UNROLL)
    if hw * c * elem <= _STATS_ONE_BLOCK:
        return dict(vec=vec, rows=hw, chunks=1, scratch=0)
    per_row = max(1, _STATS_WAVES * _SMS * _STATS_RESIDENT // batch)
    rows = max(_STATS_MIN_ROWS, -(-hw // per_row))
    rows = -(-rows // step) * step
    chunks = -(-hw // rows)
    return dict(vec=vec, rows=rows, chunks=chunks,
                scratch=batch * chunks * num_groups * 2 if chunks > 1 else 0)


# the split partials kernel (``psld_gn_split_partials``): pixel rows a
# thread has in flight (``PART_UNROLL`` in the CUDA source, whose entry
# refuses a chunk of several that is no multiple of the pass they give;
# each row a load of x and one of the cotangent), the blocks an SM is counted to
# hold in a wave (its registers allow two of 256 threads), the fewest
# pixels a block reduces and the bytes of x a batch element may have and
# still take one block
_PART_UNROLL = 4
_PART_RESIDENT = 2
_PART_MIN_ROWS = _STATS_MIN_ROWS
_PART_ONE_BLOCK = _STATS_ONE_BLOCK


@functools.lru_cache(maxsize=None)
def plan_split_partials(batch: int, hw: int, c: int, num_groups: int,
                        dtype) -> dict:
    """The split partials kernel's geometry for a (batch, H*W, C) shard,
    planned as :func:`plan_split_stats` plans the stats: ``vec`` channels
    a load, ``rows`` pixels a block reduces, ``chunks`` blocks a batch
    element (the grid is (chunks, batch)), and ``scratch`` floats.

    A pass of a block covers ``step`` rows: 256 threads over the row's
    pieces, ``_PART_UNROLL`` rows a thread. A batch element of at most
    ``_PART_ONE_BLOCK`` bytes of x is one block's; else ``rows`` is a
    multiple of ``step``, at least ``_PART_MIN_ROWS``, and as few as give
    ``_STATS_WAVES`` waves of ``_PART_RESIDENT`` blocks on each of
    ``_SMS`` SMs over the batch. The scratch holds, with more than one
    chunk, each chunk's (P1, P2) a group and (dscale, dbias) a channel, B
    * chunks * (G + C) * 2 floats, and with more than one batch element
    each element's (dscale, dbias) row, B * C * 2 floats: at most B *
    (ceil(H*W / ``_PART_MIN_ROWS``) * (G + C) + C) * 2 in all."""
    elem, vec, step = _split_pass(c, num_groups, dtype, _PART_UNROLL)
    if hw * c * elem <= _PART_ONE_BLOCK:
        rows, chunks = hw, 1
    else:
        per_row = max(1, _STATS_WAVES * _SMS * _PART_RESIDENT // batch)
        rows = max(_PART_MIN_ROWS, -(-hw // per_row))
        rows = -(-rows // step) * step
        chunks = -(-hw // rows)
    scratch = (batch * chunks * (num_groups + c) * 2 if chunks > 1 else 0) \
        + (batch * c * 2 if batch > 1 else 0)
    return dict(vec=vec, rows=rows, chunks=chunks, scratch=scratch)


# the split apply kernel (``psld_gn_split_apply``): pixel rows a thread
# has in flight (``APPLY_UNROLL`` in the CUDA source, whose entry refuses
# a tile of several that is no multiple of the pass they give), passes of
# them a thread makes over a tile of a large shard, and the blocks below
# which a shard's tiles shrink (down to one pass) to spread over more SMs
_APPLY_UNROLL = 4
_APPLY_PASSES = 2
_APPLY_BLOCKS = 264


@functools.lru_cache(maxsize=None)
def plan_split_apply(batch: int, hw: int, c: int, num_groups: int,
                     dtype) -> dict:
    """The split apply kernel's geometry for a (batch, H*W, C) shard:
    ``vec`` channels an access (16 bytes where C is a multiple of them,
    else 1, the scalar path), ``rows`` pixels a block normalizes and
    ``tiles`` blocks a batch element (the grid is (tiles, batch)).

    A pass of a block covers ``step`` rows: 256 threads over the row's
    pieces, ``_APPLY_UNROLL`` rows a thread. A tile is ``_APPLY_PASSES``
    passes, or, where that gives fewer than ``_APPLY_BLOCKS`` blocks over
    the batch, the passes that give about that many (at least one); a
    shard that one tile covers is one tile of ``hw`` rows. Else ``rows``
    is a multiple of ``step``. Chosen on the card (``PERF.md``, section 6)
    among 2 to 8 rows in flight, 1 to 16 passes and 132 to 528 blocks."""
    _, vec, step = _split_pass(c, num_groups, dtype, _APPLY_UNROLL)
    rows = step * _APPLY_PASSES
    if -(-hw // rows) * batch < _APPLY_BLOCKS:
        want = -(-hw * batch // _APPLY_BLOCKS)
        rows = -(-want // step) * step
    rows = min(rows, hw)
    return dict(vec=vec, rows=rows, tiles=-(-hw // rows))


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _lib(src: str, fn_name: str, argtypes: list):
    lib = build.load(src)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
# psld_gn_fwd(x, y, scale, scale_bf16, bias, bias_bf16, b, hw, c, cgrp,
# slice, cluster, resident, threads, act, chain, eps, dtype, stream)
_FWD_ARGS = [_P, _P, _P, _I, _P, _I] + [_I] * 10 + [ctypes.c_float, _I, _P]
# psld_gn_bwd(x, g, dx, scale, scale_bf16, bias, bias_bf16, part, done,
# dscale, dbias, b, hw, c, cgrp, slice, cluster, resident, threads, act,
# chain, eps, need_params, dtype, stream)
_BWD_ARGS = [_P] * 4 + [_I, _P, _I] + [_P] * 4 + [_I] * 10 + [
    ctypes.c_float, _I, _I, _P]


# counts of finished blocks, one zeroed buffer per (device, stream), which
# every launch leaves at 0 again, so a CUDA graph may replay launches that
# use it, on that stream: the backward kernel's per slice, the split
# stats' per batch element (at most 65535), the split partials' per batch
# element and one more after them. Launches on one stream run in order,
# so the kernels share it
_DONE: dict = {}
_DONE_SIZE = 65536


def _done_counts(device, what: str):
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    if key not in _DONE:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{what}: call it once on this stream before capturing it "
                "into a CUDA graph")
        _DONE[key] = torch.zeros(_DONE_SIZE, dtype=torch.int32,
                                 device=device)
    return _DONE[key]


_MAX_C = 1024
_MAX_BATCH = 65535  # the split entries' grid rows


def _refusal(shape, dtype, num_groups: int):
    """Why every GroupNorm kernel refuses an x of ``shape`` and ``dtype``
    (the words after the kernel's name), or None."""
    if len(shape) != 4 or dtype not in _KERNEL_DTYPES:
        return f" takes a 4D f32/bf16 tensor, got {tuple(shape)} {dtype}"
    c = shape[-1]
    if c % num_groups or c > _MAX_C:
        return f": C={c} with G={num_groups} unsupported"
    return None


def group_norm_fits(shape, dtype, num_groups: int) -> bool:
    """Whether the fused GroupNorm kernels (:func:`group_norm_act` and its
    backward) take an NHWC x of ``shape`` and ``dtype``: 4D f32 or bf16, C
    at most 1024 and a multiple of G, and a slice of whole groups a
    multiple of 16 bytes and at most ``_FWD_WIDEST`` bytes wide (the
    planners' rule; bf16 at C = 4 or 12 has none). Contiguity and 16-byte
    alignment are the caller's: the ops raise on them. The model layers
    run :func:`group_norm_act_plain` where this is False, as the JAX
    package's ``fused_group_norm_act`` runs its jnp chain where its Pallas
    kernel does not fit."""
    if _refusal(shape, dtype, num_groups) is not None:
        return False
    elem = torch.empty((), dtype=dtype).element_size()
    return bool(_slices(shape[-1], num_groups, elem, _FWD_WIDEST))


def group_norm_split_fits(shape, dtype, num_groups: int) -> bool:
    """Whether the split entries (stats, apply, partials, dx) take a shard
    of ``shape`` and ``dtype``: the fused kernels' rule without the slice
    (they load whole 16-byte pieces or single channels), and at most
    65,535 batch elements. :func:`group_norm_act_split` runs their plain
    versions where this is False."""
    return _refusal(shape, dtype, num_groups) is None \
        and shape[0] <= _MAX_BATCH


def _check_kernel_args(what: str, x, scale, bias, num_groups: int) -> None:
    why = _refusal(x.shape, x.dtype, num_groups)
    if why is not None:
        raise ValueError(f"{what} kernel{why}")
    c = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs x on a 16-byte boundary")
    for p in (scale, bias):
        if p is None:  # the split stats take no parameters
            continue
        if p.shape != (c,) or not p.is_contiguous() or p.device != x.device \
                or p.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"{what} kernel: scale/bias must be contiguous "
                             "f32 or bf16 (C,) on the input's device")


def _chain(x) -> bool:
    """Whether the kernels run the ``gn_bf16`` chain for ``x``: read at
    every call, as the plain version reads it."""
    return x.dtype == torch.bfloat16 and knobs.gn_bf16()


def _forward(x, scale, bias, num_groups: int, eps: float, act: str,
             chain: bool):
    b, h, w, c = x.shape
    plan = plan_forward(h * w, c, num_groups, x.dtype, b)
    y = torch.empty_like(x)
    lib = _lib("group_norm_fwd.cu", "psld_gn_fwd", _FWD_ARGS)
    with torch.cuda.device(x.device):
        err = lib.psld_gn_fwd(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), _BF16[scale.dtype],
            bias.data_ptr(), _BF16[bias.dtype], b, h * w, c,
            c // num_groups, plan["slice"], plan["cluster"],
            plan["resident"], plan["threads"], _ACT_CODE[act], int(chain),
            float(eps), _BF16[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_act kernel launch")
    group_norm_act.launches += 1
    return y


def _backward(x, scale, bias, g, num_groups: int, eps: float, act: str,
              need_params: bool, chain: bool):
    if g.data_ptr() % 16:
        raise ValueError("group_norm_act_backward kernel needs the "
                         "cotangent on a 16-byte boundary")
    b, h, w, c = x.shape
    plan = plan_backward(h * w, c, num_groups, x.dtype)
    dx = torch.empty_like(x)
    if need_params:
        part = torch.empty((2, c, b), dtype=torch.float32, device=x.device)
        dscale = torch.empty_like(scale)
        dbias = torch.empty_like(bias)
        done = _done_counts(x.device, "group_norm_act_backward")
    lib = _lib("group_norm_bwd.cu", "psld_gn_bwd", _BWD_ARGS)
    with torch.cuda.device(x.device):
        err = lib.psld_gn_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), scale.data_ptr(),
            _BF16[scale.dtype], bias.data_ptr(), _BF16[bias.dtype],
            *((part.data_ptr(), done.data_ptr(), dscale.data_ptr(),
               dbias.data_ptr()) if need_params else (None,) * 4),
            b, h * w, c, c // num_groups, plan["slice"], plan["cluster"],
            plan["resident"], plan["threads"], _ACT_CODE[act], int(chain),
            float(eps), int(need_params), _BF16[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_act_backward kernel launch")
    group_norm_act_backward.launches += 1
    if not need_params:
        return dx, None, None
    return dx, dscale, dbias


def group_norm_act_backward_plain(x, scale, bias, g, num_groups: int,
                                  eps: float = 1e-6, act: str = "none"):
    """(dx, dscale, dbias): autograd through :func:`group_norm_act_plain`.
    Under ``gn_bf16`` that differentiates the bf16-rounded chain."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        y = group_norm_act_plain(*leaves, num_groups, eps, act)
        return torch.autograd.grad(y, leaves, g)


def group_norm_act_backward(x, scale, bias, g, num_groups: int,
                            eps: float = 1e-6, act: str = "none",
                            need_params: bool = True):
    """The cotangent ``g`` of ``group_norm_act(x, scale, bias)`` pulled
    back to (dx, dscale, dbias), in the dtypes of x, scale and bias;
    ``need_params=False`` (a gradient into the input alone, as classifier
    guidance takes) gives (dx, None, None) and skips the sum over the
    batch. Under ``gn_bf16`` a bf16 x takes the gradient of the bf16
    chain.

    A CPU tensor runs :func:`group_norm_act_backward_plain`. A CUDA tensor
    launches the CUDA C++ backward kernel
    (``group_norm_act_backward.launches`` counts the launches) or raises on
    what the kernel does not take."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        dx, dscale, dbias = group_norm_act_backward_plain(
            x, scale, bias, g, num_groups, eps, act)
        return (dx, dscale, dbias) if need_params else (dx, None, None)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act_backward: no path for device "
                         f"{x.device}")
    _check_kernel_args("group_norm_act_backward", x, scale, bias,
                       num_groups)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError("group_norm_act_backward kernel: the cotangent "
                         "must be contiguous NHWC of x's shape, dtype and "
                         "device")
    return _backward(x, scale, bias, g, num_groups, eps, act, need_params,
                     _chain(x))


group_norm_act_backward.launches = 0


class _GroupNormAct(torch.autograd.Function):
    """Forward and backward kernels; saves x, scale and bias only. The
    backward differentiates the chain the forward ran."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, act)
        ctx.chain = _chain(x)
        return _forward(x, scale, bias, num_groups, eps, act, ctx.chain)

    @staticmethod
    def backward(ctx, g):
        grads = _backward(*ctx.saved_tensors, g.contiguous(), *ctx.args,
                          any(ctx.needs_input_grad[1:3]), ctx.chain)
        return (*grads, None, None, None)


def group_norm_act(x, scale, bias, num_groups: int, eps: float = 1e-6,
                   act: str = "none"):
    """NHWC (B, H, W, C) GroupNorm + act, differentiable in x, scale and
    bias; under ``gn_bf16`` a bf16 x runs the bf16 chain of
    :func:`group_norm_act_plain`.

    A CPU tensor runs :func:`group_norm_act_plain`. A CUDA tensor launches
    the CUDA C++ forward kernel (``group_norm_act.launches`` counts the
    launches), and its gradient the backward kernel, or raises on what the
    kernels do not take."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, scale, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: no path for device {x.device}")
    _check_kernel_args("group_norm_act", x, scale, bias, num_groups)
    return _GroupNormAct.apply(x, scale, bias, num_groups, eps, act)


group_norm_act.launches = 0


# -- split GroupNorm: moments over the height shards of a spatial group ---
def _split_moments(sums, count: float, eps: float):
    """(mean, rstd, variance before the clamp) of each (n, group), f32
    (N, 1, G, 1), from the global sums of x and x^2 over ``count``
    elements a group; the mean is the sum times 1 / n, as PyTorch's mean
    takes it."""
    inv = 1.0 / float(count)
    mean = sums[..., 0] * inv
    raw = sums[..., 1] * inv - mean * mean
    rs = torch.rsqrt(torch.clamp_min(raw, 0.0) + eps)
    shape = (sums.shape[0], 1, sums.shape[1], 1)
    return mean.reshape(shape), rs.reshape(shape), raw.reshape(shape)


def group_norm_split_stats_plain(x, num_groups: int):
    """(N, G, 2) float32: each (batch element, group)'s sums of x and x^2
    over the pixels of ``x`` (NHWC, this rank's rows)."""
    b, h, w, c = x.shape
    x32 = x.reshape(b, h * w, num_groups, c // num_groups).float()
    return torch.stack([x32.sum(dim=(1, 3)), (x32 * x32).sum(dim=(1, 3))],
                       dim=-1)


def group_norm_split_apply_plain(x, scale, bias, sums, count: float,
                                 num_groups: int, eps: float = 1e-6,
                                 act: str = "none"):
    """:func:`group_norm_act_plain`'s chain on ``x`` (this rank's rows)
    with the moments of the global ``sums`` over ``count`` elements a
    group."""
    b, h, w, c = x.shape
    cd = x.dtype if (x.dtype != torch.float32 and knobs.gn_bf16()) \
        else torch.float32
    mean, rs, _ = _split_moments(sums, count, eps)
    xg = x.reshape(b, h * w, num_groups, c // num_groups)
    y = ((xg.to(cd) - mean.to(cd)) * rs.to(cd)).reshape(b, h, w, c)
    y = y * scale.to(cd) + bias.to(cd)
    return _ACTS[act](y).to(x.dtype)


def _split_chain(x, g, scale, bias, sums, count, num_groups, eps, act):
    """The backward chain of one shard, grouped (B, HW, G, C/G): d = x -
    mean, xh, dz, dxh = dz * scale, dd = dxh * rstd (the gn_bf16 roundings
    of each for a bf16 x under the knob), and the moments."""
    b, h, w, c = x.shape
    chain = x.dtype != torch.float32 and knobs.gn_bf16()
    cd = x.dtype if chain else torch.float32
    mean, rs, raw = _split_moments(sums, count, eps)
    grp = (b, h * w, num_groups, c // num_groups)
    sc = scale.to(cd).reshape(1, 1, num_groups, -1)
    bi = bias.to(cd).reshape(1, 1, num_groups, -1)
    d = x.reshape(grp).to(cd) - mean.to(cd)
    xh = d * rs.to(cd)
    with torch.enable_grad():
        z = (xh * sc + bi).detach().requires_grad_()
        dz, = torch.autograd.grad(_ACTS[act](z), z, g.reshape(grp).to(cd))
    dxh = dz * sc
    dd = dxh * rs.to(cd)
    return d, xh, dz, dxh, dd, mean, rs, raw, cd


def group_norm_split_partials_plain(x, g, scale, bias, sums, count: float,
                                    num_groups: int, eps: float = 1e-6,
                                    act: str = "none"):
    """(p, dscale, dbias): p (N, G, 2) float32 holds each (batch element,
    group)'s P1 = sum(dd) and P2 = sum(dxh * d) over this rank's pixels
    (the terms the moments' gradient sums over the group), dscale and
    dbias the parameters' gradients over them, in the parameters'
    dtypes."""
    d, xh, dz, dxh, dd, *_ = _split_chain(x, g, scale, bias, sums, count,
                                          num_groups, eps, act)
    c = x.shape[-1]
    p = torch.stack([dd.float().sum(dim=(1, 3)),
                     (dxh.float() * d.float()).sum(dim=(1, 3))], dim=-1)
    dscale = (dz * xh).float().sum(dim=(0, 1)).reshape(c)
    dbias = dz.float().sum(dim=(0, 1)).reshape(c)
    return p, dscale.to(scale.dtype), dbias.to(bias.dtype)


def group_norm_split_dx_plain(x, g, scale, bias, sums, p, count: float,
                              num_groups: int, eps: float = 1e-6,
                              act: str = "none"):
    """dx of this rank's rows from the global ``sums`` and the global
    (P1, P2) ``p``: ``dd + (-P1 + 2 (x - mean) dvar) / n`` with ``dvar =
    -rstd^3 P2 / 2`` (0 where the variance was clamped); under gn_bf16 a
    bf16 x takes ``bf16(dd + bf16(that f32 term))``, as autograd through
    the plain chain rounds it."""
    d, xh, dz, dxh, dd, mean, rs, raw, cd = _split_chain(
        x, g, scale, bias, sums, count, num_groups, eps, act)
    pp = p.reshape(p.shape[0], 1, p.shape[1], 2)
    dvar = torch.where(raw >= 0, -0.5 * rs * rs * rs, torch.zeros_like(rs)) \
        * pp[..., 1:]
    x32 = x.reshape(dd.shape).float()
    corr = (2.0 * (x32 - mean) * dvar - pp[..., :1]) * (1.0 / float(count))
    return (dd + corr.to(cd)).reshape(x.shape).to(x.dtype)


def _split_count(x, num_groups: int) -> float:
    """Elements a group over the whole image of the spatial group."""
    from psld_tpu_torch.parallel import distributed

    b, h, w, c = x.shape
    return float(h * distributed.spatial_info()[1] * w * (c // num_groups))


_SPLIT_STATS_ARGS = [_P] * 4 + [_I] * 7 + [_P]
_SPLIT_APPLY_ARGS = [_P, _P, _P, _P, _I, _P, _I] + [_I] * 4 + [
    ctypes.c_float, _I, _I, ctypes.c_float, _I, _I, _I, _P]
_SPLIT_PART_ARGS = [_P, _P, _P, _P, _I, _P, _I] + [_P] * 5 + [_I] * 4 + [
    ctypes.c_float, _I, _I, ctypes.c_float, _I, _I, _I, _P]
_SPLIT_DX_ARGS = [_P] * 6 + [_I, _P, _I] + [_I] * 4 + [
    ctypes.c_float, _I, _I, ctypes.c_float, _I, _P]


def _split_kernel_args(what: str, x, scale, bias, num_groups: int):
    _check_kernel_args(what, x, scale, bias, num_groups)
    if not group_norm_split_fits(x.shape, x.dtype, num_groups):
        raise ValueError(f"{what} kernel takes at most 65535 batch rows")


def group_norm_split_stats(x, num_groups: int):
    """:func:`group_norm_split_stats_plain` on a CPU tensor; on a CUDA
    tensor the ``psld_gn_split_stats`` entry of ``csrc/group_norm_fwd.cu``
    (``group_norm_split_stats.launches`` counts the launches)."""
    if x.device.type == "cpu":
        return group_norm_split_stats_plain(x, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_split_stats: no path for {x.device}")
    b, h, w, c = x.shape
    _split_kernel_args("group_norm_split_stats", x, None, None, num_groups)
    plan = plan_split_stats(b, h * w, c, num_groups, x.dtype)
    part = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    done = None if plan["chunks"] == 1 else _done_counts(
        x.device, "group_norm_split_stats").data_ptr()
    out = torch.empty((b, num_groups, 2), dtype=torch.float32,
                      device=x.device)
    lib = _lib("group_norm_fwd.cu", "psld_gn_split_stats", _SPLIT_STATS_ARGS)
    with torch.cuda.device(x.device):
        err = lib.psld_gn_split_stats(
            x.data_ptr(), part.data_ptr() or None, out.data_ptr(), done, b,
            h * w, c, c // num_groups, plan["rows"], plan["vec"],
            _BF16[x.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_split_stats kernel launch")
    group_norm_split_stats.launches += 1
    return out


group_norm_split_stats.launches = 0


def group_norm_split_apply(x, scale, bias, sums, count: float,
                           num_groups: int, eps: float = 1e-6,
                           act: str = "none"):
    """:func:`group_norm_split_apply_plain` on a CPU tensor; on a CUDA
    tensor the ``psld_gn_split_apply`` entry of
    ``csrc/group_norm_fwd.cu`` (``group_norm_split_apply.launches``),
    with the geometry of :func:`plan_split_apply`: one launch."""
    if x.device.type == "cpu":
        return group_norm_split_apply_plain(x, scale, bias, sums, count,
                                            num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_split_apply: no path for {x.device}")
    _split_kernel_args("group_norm_split_apply", x, scale, bias, num_groups)
    b, h, w, c = x.shape
    plan = plan_split_apply(b, h * w, c, num_groups, x.dtype)
    y = torch.empty_like(x)
    sums = sums.contiguous()
    lib = _lib("group_norm_fwd.cu", "psld_gn_split_apply", _SPLIT_APPLY_ARGS)
    with torch.cuda.device(x.device):
        err = lib.psld_gn_split_apply(
            x.data_ptr(), y.data_ptr(), sums.data_ptr(), scale.data_ptr(),
            _BF16[scale.dtype], bias.data_ptr(), _BF16[bias.dtype], b,
            h * w, c, c // num_groups, float(count), _ACT_CODE[act],
            int(_chain(x)), float(eps), plan["rows"], plan["vec"],
            _BF16[x.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_split_apply kernel launch")
    group_norm_split_apply.launches += 1
    return y


group_norm_split_apply.launches = 0


def group_norm_split_partials(x, g, scale, bias, sums, count: float,
                              num_groups: int, eps: float = 1e-6,
                              act: str = "none"):
    """:func:`group_norm_split_partials_plain` on a CPU tensor; on a CUDA
    tensor the ``psld_gn_split_partials`` entry of
    ``csrc/group_norm_split_bwd.cu`` (``group_norm_split_partials.launches``),
    with the geometry of :func:`plan_split_partials`: one launch."""
    if x.device.type == "cpu":
        return group_norm_split_partials_plain(x, g, scale, bias, sums,
                                               count, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_split_partials: no path for "
                         f"{x.device}")
    _split_kernel_args("group_norm_split_partials", x, scale, bias,
                       num_groups)
    _check_cotangent("group_norm_split_partials", x, g)
    b, h, w, c = x.shape
    plan = plan_split_partials(b, h * w, c, num_groups, x.dtype)
    part = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    done = None if plan["chunks"] == 1 and b == 1 else _done_counts(
        x.device, "group_norm_split_partials").data_ptr()
    p = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(bias)
    sums = sums.contiguous()
    lib = _lib("group_norm_split_bwd.cu", "psld_gn_split_partials",
               _SPLIT_PART_ARGS)
    with torch.cuda.device(x.device):
        err = lib.psld_gn_split_partials(
            x.data_ptr(), g.data_ptr(), sums.data_ptr(), scale.data_ptr(),
            _BF16[scale.dtype], bias.data_ptr(), _BF16[bias.dtype],
            part.data_ptr() or None, done, p.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), b, h * w, c, c // num_groups, float(count),
            _ACT_CODE[act], int(_chain(x)), float(eps), plan["rows"],
            plan["vec"], _BF16[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_split_partials kernel launch")
    group_norm_split_partials.launches += 1
    return p, dscale, dbias


group_norm_split_partials.launches = 0


def group_norm_split_dx(x, g, scale, bias, sums, p, count: float,
                        num_groups: int, eps: float = 1e-6,
                        act: str = "none"):
    """:func:`group_norm_split_dx_plain` on a CPU tensor; on a CUDA
    tensor the ``psld_gn_split_dx`` entry of
    ``csrc/group_norm_split_bwd.cu`` (``group_norm_split_dx.launches``)."""
    if x.device.type == "cpu":
        return group_norm_split_dx_plain(x, g, scale, bias, sums, p, count,
                                         num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_split_dx: no path for {x.device}")
    _split_kernel_args("group_norm_split_dx", x, scale, bias, num_groups)
    _check_cotangent("group_norm_split_dx", x, g)
    b, h, w, c = x.shape
    dx = torch.empty_like(x)
    sums, p = sums.contiguous(), p.contiguous()
    lib = _lib("group_norm_split_bwd.cu", "psld_gn_split_dx",
               _SPLIT_DX_ARGS)
    with torch.cuda.device(x.device):
        err = lib.psld_gn_split_dx(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), sums.data_ptr(),
            p.data_ptr(), scale.data_ptr(), _BF16[scale.dtype],
            bias.data_ptr(), _BF16[bias.dtype], b, h * w, c,
            c // num_groups, float(count), _ACT_CODE[act], int(_chain(x)),
            float(eps), _BF16[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_split_dx kernel launch")
    group_norm_split_dx.launches += 1
    return dx


group_norm_split_dx.launches = 0


def _check_cotangent(what: str, x, g) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError(f"{what} kernel: the cotangent must be contiguous "
                         "NHWC of x's shape, dtype and device")
    if g.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs the cotangent on a 16-byte "
                         "boundary")


class _SplitGroupNormAct(torch.autograd.Function):
    """GroupNorm over the height shards of a spatial group: local sums,
    one all-reduce of the (N, G, 2) sums, then the normalization; the
    backward's local (P1, P2), one all-reduce, then dx. Saves x, scale,
    bias and the global sums. ``kernels`` False runs the plain pieces on
    any device, with the same all-reduces."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, kernels):
        from psld_tpu_torch.parallel import distributed

        count = _split_count(x, num_groups)
        stats, apply = (group_norm_split_stats, group_norm_split_apply) \
            if kernels else (group_norm_split_stats_plain,
                             group_norm_split_apply_plain)
        sums = stats(x, num_groups)
        distributed.all_reduce_(sums, group=distributed.spatial_group())
        ctx.save_for_backward(x, scale, bias, sums)
        ctx.args = (count, num_groups, eps, act)
        ctx.kernels = kernels
        return apply(x, scale, bias, sums, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        from psld_tpu_torch.parallel import distributed

        x, scale, bias, sums = ctx.saved_tensors
        partials, dx_of = (group_norm_split_partials, group_norm_split_dx) \
            if ctx.kernels else (group_norm_split_partials_plain,
                                 group_norm_split_dx_plain)
        g = g.contiguous()
        p, dscale, dbias = partials(x, g, scale, bias, sums, *ctx.args)
        distributed.all_reduce_(p, group=distributed.spatial_group())
        dx = dx_of(x, g, scale, bias, sums, p, *ctx.args)
        return dx, dscale, dbias, None, None, None, None


def group_norm_act_split(x, scale, bias, num_groups: int, eps: float = 1e-6,
                         act: str = "none"):
    """NHWC GroupNorm + act of this rank's rows of an image whose height is
    split over the spatial group (:mod:`psld_tpu_torch.parallel.spatial`):
    the moments, and their gradients, span every shard. A CPU tensor
    runs the plain pieces, a CUDA tensor the split entry points of the
    two GroupNorm kernels where :func:`group_norm_split_fits` takes its
    shape (C > 1024 runs the plain pieces on the card, chosen before any
    launch); each raises on what else it does not take."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return _SplitGroupNormAct.apply(
        x.contiguous(), scale, bias, num_groups, eps, act,
        group_norm_split_fits(x.shape, x.dtype, num_groups))
