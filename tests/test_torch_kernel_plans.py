"""The host side of four kernels, on the CPU: the grid that the split
GroupNorm stats, partials and apply kernels (``plan_split_stats``,
``plan_split_partials``, ``plan_split_apply``) and the strided hash
dropout (``dropout._grid``) launch. The kernels run only on the card
(``tests/test_torch_kernels.py``); here each grid is walked in plain
PyTorch as the kernel's blocks or programs walk it, so a shape that a
plan leaves uncovered, covers twice or over-runs its scratch fails
without a card.

- The stats: block (chunk, n) reduces pixels [chunk * rows, +rows) of
  batch element n, a thread the rows ``ry`` apart; every pixel of every
  CelebA-HQ 256 shard shape (and of ragged edge shapes) is read once, the
  grid stays within CUDA's limits and the partials within the scratch the
  wrapper allocates, at most B * ceil(H*W / 64) * G * 2 floats.
- The partials: the same walk over two tensors, at batch 1, 8 and 64;
  the scratch holds each chunk's (P1, P2) and (dscale, dbias) and each
  batch element's (dscale, dbias) row, at most B * (ceil(H*W /
  _PART_MIN_ROWS) * (G + C) + C) * 2 floats, and the channel sums' slots
  fit shared memory.
- The apply: block (tile, n) normalizes pixels [tile * rows, +rows) of
  batch element n, a thread the rows ``ry`` apart and its pieces; every
  pixel and channel of every shard is written once, a tile of several is
  a multiple of the pass, and a shard with few tiles over its batch gets
  smaller ones.
- The dropout: program (t, q) of a strided launch takes image q's run of
  L elements, whose positions start at p0 = elem_off + q * Gi (mod
  2**32), in rows of 128 positions from p0's row; the element it reaches
  at memory q * L + (position - p0) must hash the position that
  ``_positions`` gives, each element once, for ragged (L, Gi, elem_off).
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import pytest
import torch

import chip_smoke
from psld_tpu_torch.ops import dropout
from psld_tpu_torch.ops import group_norm
from psld_tpu_torch.ops.group_norm import (plan_split_apply,
                                           plan_split_partials,
                                           plan_split_stats)

_THREADS = 256
_GRID_Y = 65535
_GRID_X = 2 ** 31 - 1

# (H*W of a shard, C): CelebA-HQ 256's split GroupNorms on one shard of
# two, then edges: one pixel, ragged counts, widths without whole 16-byte
# pieces, C at its limit, a batch element past one block's bytes
STATS_SHAPES = sorted({(hw // chip_smoke.SPATIAL, c)
                       for hw, c, _ in chip_smoke.HQ_SPLIT_GN_CALLS}) + [
    (1, 3), (7, 12), (100, 129), (130, 96), (4099, 40), (32768, 1024),
    (65536, 3)]


def _groups(c):
    return next(g for g in (32, 16, 8, 4, 3, 2, 1) if c % g == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("hw,c", STATS_SHAPES,
                         ids=[f"{hw}x{c}" for hw, c in STATS_SHAPES])
def test_split_stats_plan_covers_every_pixel_once(hw, c, batch, dtype):
    groups = _groups(c)
    plan = plan_split_stats(batch, hw, c, groups, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    vec, rows, chunks = plan["vec"], plan["rows"], plan["chunks"]
    assert vec in (1, 16 // elem) and c % vec == 0
    assert vec == 1 or (c * elem) % 16 == 0
    assert 1 <= chunks <= _GRID_X and batch <= _GRID_Y
    assert chunks == -(-hw // rows)
    assert plan["scratch"] == (0 if chunks == 1
                               else batch * chunks * groups * 2)
    assert plan["scratch"] <= batch * -(-hw // 64) * groups * 2
    # the kernel's walk: a thread owns piece tx of a row and the rows ty,
    # ty + ry, ... of its block's chunk
    pieces = c // vec
    tx_n = min(pieces, _THREADS)
    ry = _THREADS // tx_n
    assert tx_n * ((pieces + tx_n - 1) // tx_n) >= pieces
    assert (pieces + tx_n - 1) // tx_n <= (1024 // _THREADS if vec == 1
                                           else 1)
    seen = torch.zeros(hw, dtype=torch.int64)
    for chunk in range(chunks):
        p0, p1 = chunk * rows, min(hw, chunk * rows + rows)
        for ty in range(ry):
            seen[p0 + ty:p1:ry] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("hw,c", STATS_SHAPES,
                         ids=[f"{hw}x{c}" for hw, c in STATS_SHAPES])
def test_split_partials_plan_covers_every_pixel_once(hw, c, batch, dtype):
    """The partials planner: the stats' rules for ``vec``, a pass of
    ``_THREADS // tx * _PART_UNROLL`` rows, ``rows`` a multiple of it and
    at least ``_PART_MIN_ROWS`` past one block, chunks that cover H*W, one
    block for a batch element of at most ``_PART_ONE_BLOCK`` bytes of x,
    and the scratch the kernel's layout takes, within B * (ceil(H*W /
    _PART_MIN_ROWS) * (G + C) + C) * 2 floats; the kernel's walk reads
    every pixel once."""
    groups = _groups(c)
    plan = plan_split_partials(batch, hw, c, groups, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    vec, rows, chunks = plan["vec"], plan["rows"], plan["chunks"]
    assert vec == plan_split_stats(batch, hw, c, groups, dtype)["vec"]
    pieces = c // vec
    tx_n = min(pieces, _THREADS)
    ry = _THREADS // tx_n
    assert 1 <= chunks <= _GRID_X and batch <= _GRID_Y
    assert chunks == -(-hw // rows)
    if hw * c * elem <= group_norm._PART_ONE_BLOCK:
        assert (rows, chunks) == (hw, 1)
    else:
        assert rows % (ry * group_norm._PART_UNROLL) == 0
        assert rows >= group_norm._PART_MIN_ROWS
    assert plan["scratch"] == (
        (batch * chunks * (groups + c) * 2 if chunks > 1 else 0)
        + (batch * c * 2 if batch > 1 else 0))
    assert plan["scratch"] <= batch * (
        -(-hw // group_norm._PART_MIN_ROWS) * (groups + c) + c) * 2
    # the channel sums' slots in shared memory (PART_SLOTS floats each)
    shuffle = tx_n < 32 and 32 % tx_n == 0
    assert (_THREADS // 32 if shuffle else ry) * c <= 2048
    seen = torch.zeros(hw, dtype=torch.int64)
    for chunk in range(chunks):
        p0, p1 = chunk * rows, min(hw, chunk * rows + rows)
        for ty in range(ry):
            seen[p0 + ty:p1:ry] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8, 300])
@pytest.mark.parametrize("hw,c", STATS_SHAPES + [(16, 128), (3001, 129)],
                         ids=[f"{hw}x{c}" for hw, c in STATS_SHAPES]
                         + ["16x128", "3001x129"])
def test_split_apply_plan_covers_every_pixel_once(hw, c, batch, dtype):
    """The apply planner: the stats' rules for ``vec`` (at most four
    scalar pieces a thread), tiles that cover H*W, ``rows`` a multiple of
    the pass of ``_THREADS // tx * _APPLY_UNROLL`` rows where a batch
    element has several tiles, ``_APPLY_PASSES`` passes a tile unless
    that leaves fewer than ``_APPLY_BLOCKS`` blocks; the kernel's walk
    writes every pixel and channel once."""
    groups = _groups(c)
    plan = plan_split_apply(batch, hw, c, groups, dtype)
    vec, rows, tiles = plan["vec"], plan["rows"], plan["tiles"]
    assert vec == plan_split_stats(batch, hw, c, groups, dtype)["vec"]
    pieces = c // vec
    tx_n = min(pieces, _THREADS)
    ry = _THREADS // tx_n
    kp = -(-pieces // tx_n)
    assert kp <= (1024 // _THREADS if vec == 1 else 1)
    step = ry * group_norm._APPLY_UNROLL
    assert 1 <= tiles <= _GRID_X and batch <= _GRID_Y
    assert 1 <= rows <= hw and tiles == -(-hw // rows)
    if tiles > 1:
        assert rows % step == 0
    full = step * group_norm._APPLY_PASSES
    if -(-hw // full) * batch >= group_norm._APPLY_BLOCKS:
        assert rows == min(hw, full)
    else:  # the fewest passes that give each block a share of the batch's
        want = -(-hw * batch // group_norm._APPLY_BLOCKS)
        assert rows == min(hw, -(-want // step) * step) <= min(hw, full)
    seen = torch.zeros(hw, pieces, dtype=torch.int64)
    for tile in range(tiles):
        p0, p1 = tile * rows, min(hw, tile * rows + rows)
        for ty in range(ry):
            for k in range(kp):
                cols = torch.arange(k * tx_n, min(pieces, (k + 1) * tx_n))
                seen[p0 + ty:p1:ry, cols] += 1
    assert bool((seen == 1).all())


# (elements of a rank's slice of an image L, of a whole image Gi,
# elem_off): whole rows, ragged, shorter than a row, one position,
# wrapping past 2**32, and AFHQv2 128's half-height slices
DROPOUT_CASES = [
    (384, 1024, 0), (300, 1000, 1), (500, 1024, 127 + 128 * 9),
    (50, 333, 17), (100, 256, 64 + 384), (1, 7, 5), (2000, 4096, 1005),
    (300, 512, 2 ** 32 - 1400), (129, 4 * 129, 2 ** 32 - 1),
    (64 * 128 * 128, 2 * 64 * 128 * 128, 64 * 128 * 128),
]


@pytest.mark.parametrize("images", [1, 3])
@pytest.mark.parametrize("local,whole,off", DROPOUT_CASES,
                         ids=[f"{a}_{b}_{c}" for a, b, c in DROPOUT_CASES])
def test_strided_dropout_tiling_gives_the_positions(local, whole, off,
                                                    images):
    n = images * local
    tiles, runs = dropout._grid(n, off, (local, whole))
    assert runs == images
    rows = dropout._ROWS
    want = dropout._positions(n, off, (local, whole), "cpu")
    got = torch.full((n,), -1, dtype=torch.int64)
    lane = torch.arange(128, dtype=torch.int64)
    for q in range(runs):
        # program (t, q): the run's first position, its lead within its
        # row, and rows of 128 positions from that row
        p0 = (off + q * whole) & 0xFFFFFFFF
        lead = p0 & 127
        local_rows = torch.arange(tiles * rows, dtype=torch.int64)
        i = local_rows[:, None] * 128 + lane[None, :] - lead
        mask = (i >= 0) & (i < local)
        row = ((p0 >> 7) + local_rows) & 0x1FFFFFF
        pos = row[:, None] * 128 + lane[None, :]
        addr = q * local + i[mask]
        assert bool((got[addr] == -1).all())  # each element once
        got[addr] = pos[mask]
    assert torch.equal(got, want)
    # no more tiles than the longest lead the runs may have needs
    lead = off & 127 if whole % 128 == 0 else 127
    assert (tiles - 1) * rows * 128 < local + lead


def test_strided_dropout_grid_refuses_too_many_images():
    with pytest.raises(ValueError, match="65535"):
        dropout._grid(65536 * 4, 0, (4, 8))
    assert dropout._grid(65535 * 4, 0, (4, 8)) == (1, 65535)
