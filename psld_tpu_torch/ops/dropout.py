"""Counter-hash dropout: a Triton kernel for Hopper and its plain PyTorch
version.

Replaces ``psld_tpu/ops/dropout.py::_mask_kernel`` (launched by
``_mask_apply``) and the custom VJP of ``hw_dropout``. The keep-mask is a
pure function of (seed words, position of the element): element ``flat``
is kept iff ::

    fmix32(fmix32(s0 ^ r * 0x9E3779B1) ^ s1 ^ l * 0x27D4EB2F) >= threshold

with ``r = flat >> 7``, ``l = flat & 127``, ``threshold = round(rate *
2**32)`` and ``fmix32`` the murmur3 finalizer, all in uint32 with
wrap-around. A kept element becomes ``x * 1/(1 - rate)``. The backward
pass runs the same function on the cotangent, so nothing but the seed is
saved: no mask and no activation.

``flat`` is the element's position in NHWC order, as in the JAX package.
The port's activations are NCHW-logical tensors in ``channels_last``
memory, whose memory order is NHWC, so the op hashes the memory offset;
it takes a tensor that is contiguous or channels_last-contiguous and
raises on any other layout. ``elem_off`` is added to every position (mod
2**32): a rank that holds a slice of a larger tensor passes the slice's
offset and draws the same mask as the whole tensor would. A rank that
holds a slice of every image's height (spatial parallelism) passes
``image = (L, Gi)`` too, the elements of one image it holds and of one
whole image: element ``i`` then hashes position ``elem_off + (i // L) *
Gi + i % L``. This is the port's design, one launch a site; the JAX
package gathers the whole tensor around each dropout site instead.

What bounds the kernel on the H100: device-memory bytes, one read and one
write of the tensor, with the integer pipes close behind: hashed element
by element (two finalizers of 8 operations each, plus the counters) the
kernel ran at 0.9 TB/s. The design is one fused pass with no shared
memory and no reduction, in which a program owns whole rows of 128
positions: ``fmix32(s0 ^ r * 0x9E3779B1)`` depends on the row alone and
``s1 ^ l * 0x27D4EB2F`` on the lane alone, so each is computed once a row
or lane and only the second finalizer runs per element (1.9 TB/s at
(128, 32, 32, 256) bf16). Forward and backward launch the same kernel.
The seed words, the offset and the threshold are 32-bit scalar arguments
(bit patterns passed as int32), so no launch waits for a copy from the
host.

Under ``image`` the tensor is a row of runs: image ``q``'s L elements lie
at memory ``q * L`` and hash the consecutive positions from ``p0 = elem_off
+ q * Gi`` (mod 2**32), which need not start on a row of 128. The
launch (``STRIDED``) is a 2D grid of (tiles, images): program ``(t, q)``
computes its image's ``p0`` once and then runs the unstrided tile on that
run, rows of 128 positions from ``p0``'s row, masked to ``[p0, p0 + L)``,
so no element takes a division or a second finalizer, for any L, Gi and
offset. A launch takes at most 65,535 images (the grid's second axis).
On an NVIDIA H100 80GB HBM3 at 700 W, over one AFHQv2 128 training step
of a rank of two (bf16, 140 launches) it runs level with the unstrided
launch on the same elements and at 56% of its bytes bound.

The scale is rounded to the tensor's dtype before the multiply, as JAX
rounds a Python float that meets a bf16 array: a bf16 ``x`` times the
bf16 value of 1/(1 - rate), rounded once.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

_LANES = 128
_MASK32 = 0xFFFFFFFF
_R_MUL = 0x9E3779B1  # odd Weyl constants decorrelating the two counters
_L_MUL = 0x27D4EB2F
_C1 = 0x85EBCA6B     # murmur3 finalizer multipliers
_C2 = 0xC2B2AE35
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# rows of 128 positions a program owns
_ROWS = 8
# runs (images) of a strided launch: the grid's second axis
_MAX_RUNS = 65535


def threshold(rate: float) -> int:
    """uint32 threshold with P(bits >= threshold) = 1 - rate (to 2^-32)."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def fold_seed(seed: Sequence[int]) -> tuple[int, int]:
    """Fold an n-word uint32 key (2 or 4 words) into two words on the
    host; extra words xor in alternately so distinct keys stay distinct."""
    if isinstance(seed, torch.Tensor):
        if seed.device.type != "cpu":
            raise ValueError("dropout seed words live on the host")
        seed = seed.reshape(-1).tolist()
    words = [int(w) for w in seed]
    if not words or any(not 0 <= w <= _MASK32 for w in words):
        raise ValueError(f"dropout seed must be uint32 words, got {words}")
    s0 = words[0]
    s1 = words[1] if len(words) > 1 else 0x9E3779B9
    for i in range(2, len(words)):
        if i % 2 == 0:
            s0 ^= words[i]
        else:
            s1 ^= words[i]
    return s0, s1


def _mul32(h, c: int):
    """(h * c) mod 2**32 for int64 ``h`` < 2**32, without overflowing
    int64: the constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_bits(s0: int, s1: int, flat):
    """The uint32 stream at positions ``flat`` (int64 tensor, values <
    2**32) under key (s0, s1), as int64 values < 2**32."""
    h = _fmix32(s0 ^ _mul32(flat >> 7, _R_MUL))
    return _fmix32(h ^ s1 ^ _mul32(flat & (_LANES - 1), _L_MUL))


def _memory_order(x):
    """``x`` as a flat view in memory order, or raise."""
    if x.is_contiguous():
        return x.view(-1)
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.permute(0, 2, 3, 1).view(-1)
    raise ValueError("hash_dropout takes a tensor that is dense in NHWC "
                     "order: contiguous, or 4D channels_last; got strides "
                     f"{tuple(x.stride())} for shape {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _rounded_scale(rate: float, dtype) -> float:
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _positions(n: int, elem_off: int, image, device):
    """The int64 positions (mod 2**32) of ``n`` elements in memory order:
    ``elem_off + i``, or under ``image = (L, Gi)`` ``elem_off + (i // L)
    * Gi + i % L``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    if image is not None:
        local, whole = (int(v) for v in image)
        i = torch.div(i, local, rounding_mode="floor") * whole + i % local
    return (i + int(elem_off)) & _MASK32


def hash_dropout_plain(x, seed, rate: float, elem_off: int = 0, image=None):
    """The same function in plain PyTorch (int64 arithmetic masked to 32
    bits): the CPU path, and what the kernel is held against."""
    s0, s1 = fold_seed(seed)
    flat_x = _memory_order(x)
    idx = _positions(flat_x.numel(), elem_off, image, x.device)
    keep = hash_bits(s0, s1, idx) >= threshold(rate)
    out = torch.empty_like(x)  # keeps x's memory format
    _memory_order(out).copy_(torch.where(
        keep, flat_x * _rounded_scale(rate, x.dtype),
        torch.zeros((), dtype=x.dtype, device=x.device)))
    return out


_KERNEL = None


def _kernel():
    """Define the Triton kernel at first launch: ``triton`` exists only
    where there is a card."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _fmix(h):
        h = h ^ (h >> 16)
        h = h * 0x85EBCA6B
        h = h ^ (h >> 13)
        h = h * 0xC2B2AE35
        return h ^ (h >> 16)

    @triton.jit(do_not_specialize=["n", "off", "s0", "s1", "thr", "loc",
                                   "whole"])
    def _hash_dropout(x_ptr, o_ptr, n, off, s0, s1, thr, scale, loc, whole,
                      ROWS: tl.constexpr, STRIDED: tl.constexpr):
        # off, s0, s1, thr, whole: uint32 bit patterns passed as int32. A
        # tile is ROWS rows of 128 positions from the run's first one: the
        # row's half of the hash is computed once a row, the lane's once a
        # lane. STRIDED (a slice of each image's height): program (t, q)
        # takes image q's run of loc elements at memory q * loc, whose
        # positions start at off + q * whole
        offu = off.to(tl.uint32, bitcast=True)
        if STRIDED:
            q = tl.program_id(1)
            offu = offu + q.to(tl.uint32) * whole.to(tl.uint32, bitcast=True)
            x_ptr = x_ptr + q.to(tl.int64) * loc
            o_ptr = o_ptr + q.to(tl.int64) * loc
            n = loc
        k0 = s0.to(tl.uint32, bitcast=True)
        k1 = s1.to(tl.uint32, bitcast=True)
        lane = tl.arange(0, 128)
        local = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        i = local[:, None] * 128 + lane[None, :] - (offu & 127).to(tl.int64)
        mask = (i >= 0) & (i < n)
        r = ((offu >> 7) + local.to(tl.uint32)) & 0x1FFFFFF
        rh = _fmix(k0 ^ (r * 0x9E3779B1))
        lm = k1 ^ (lane.to(tl.uint32) * 0x27D4EB2F)
        bits = _fmix(rh[:, None] ^ lm[None, :])
        keep = bits >= thr.to(tl.uint32, bitcast=True)
        x = tl.load(x_ptr + i, mask=mask, other=0.0).to(tl.float32)
        y = tl.where(keep, x * scale, 0.0)
        tl.store(o_ptr + i, y.to(o_ptr.dtype.element_ty), mask=mask)

    _KERNEL = _hash_dropout
    return _KERNEL


def _i32(word: int) -> int:
    """A uint32 bit pattern as the int32 of the same bits."""
    return word - (1 << 32) if word >= (1 << 31) else word


def _grid(n: int, elem_off: int, image) -> tuple[int, int]:
    """The kernel's grid: (tiles of ``_ROWS`` rows of 128 positions over
    one run, runs). A run is the whole tensor, or under ``image = (L,
    Gi)`` one image's L elements; a run's first row may start mid-row, by
    ``elem_off % 128`` positions when every run starts there (Gi a
    multiple of 128), else by at most 127. Raises where the runs exceed
    the grid's second axis."""
    local, runs = (n, 1) if image is None else (image[0], n // image[0])
    if runs > _MAX_RUNS:
        raise ValueError(f"hash_dropout: {runs} images exceed the kernel "
                         f"grid's {_MAX_RUNS}")
    same = image is None or image[1] % _LANES == 0
    lead = int(elem_off) & (_LANES - 1) if same else _LANES - 1
    return -(-(local + lead) // (_ROWS * _LANES)), runs


def _launch(x, s0: int, s1: int, rate: float, elem_off: int, image):
    flat_x = _memory_order(x)
    out = torch.empty_like(x)
    n = flat_x.numel()
    loc, whole = (1, 0) if image is None else image
    with torch.cuda.device(x.device):
        _kernel()[_grid(n, elem_off, image)](
            flat_x, _memory_order(out), n, _i32(int(elem_off) & _MASK32),
            _i32(s0), _i32(s1), _i32(threshold(rate)),
            _rounded_scale(rate, x.dtype), loc, _i32(whole), ROWS=_ROWS,
            STRIDED=image is not None, num_warps=4)
    hash_dropout.launches += 1
    return out


def _apply(x, s0: int, s1: int, rate: float, elem_off: int, image=None):
    if x.device.type == "cpu":
        return hash_dropout_plain(x, (s0, s1), rate, elem_off, image)
    if x.device.type != "cuda":
        raise ValueError(f"hash_dropout: no path for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"hash_dropout kernel takes f32/bf16, got {x.dtype}")
    return _launch(x, s0, s1, rate, elem_off, image)


class _HashDropout(torch.autograd.Function):
    """Saves only the folded seed; the backward re-masks the cotangent."""

    @staticmethod
    def forward(ctx, x, s0, s1, rate, elem_off, image):
        ctx.args = (s0, s1, rate, elem_off, image)
        ctx.x_format = (tuple(x.shape), tuple(x.stride()))
        return _apply(x, s0, s1, rate, elem_off, image)

    @staticmethod
    def backward(ctx, g):
        shape, stride = ctx.x_format
        if (tuple(g.shape), tuple(g.stride())) != (shape, stride):
            # the mask is a function of the memory offset: bring the
            # cotangent into the input's layout first
            g = torch.empty_strided(shape, stride, dtype=g.dtype,
                                    device=g.device).copy_(g)
        return _apply(g, *ctx.args), None, None, None, None, None


def hash_dropout(x, seed, rate: float, elem_off: int = 0, image=None):
    """Dropout(x) with the keep-mask derived from ``seed`` (2 or 4 uint32
    words, on the host) and each element's NHWC position + ``elem_off``
    (under ``image = (L, Gi)``: ``elem_off + (i // L) * Gi + i % L``, see
    the module's docstring).

    ``rate`` 0 returns ``x``, 1 returns zeros, outside [0, 1] raises. A
    CPU tensor runs :func:`hash_dropout_plain`. A CUDA tensor launches the
    Triton kernel (``hash_dropout.launches`` counts the launches, forward
    and backward alike) or raises on what the kernel does not take."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        if rate == 1.0:
            return torch.zeros_like(x)
        raise ValueError(f"dropout rate must be in [0, 1]; got {rate}")
    if rate == 0.0:
        return x
    if x.numel() >= 2 ** 32:
        raise ValueError("hash_dropout counts positions in 32 bits: "
                         f"{x.numel()} elements are too many")
    if not 0 <= int(elem_off) <= _MASK32:
        raise ValueError(f"elem_off must be a uint32, got {elem_off}")
    if image is not None:
        image = tuple(int(v) for v in image)
        if not 0 < image[0] <= image[1] or x.numel() % image[0]:
            raise ValueError(f"image (L, Gi) = {image} does not tile "
                             f"{x.numel()} elements")
        if image[0] == image[1]:
            image = None  # the whole image: positions are consecutive
    if x.numel() == 0:
        return x
    s0, s1 = fold_seed(seed)
    _memory_order(x)  # raises on a layout the op does not take
    return _HashDropout.apply(x, s0, s1, rate, int(elem_off), image)


hash_dropout.launches = 0
