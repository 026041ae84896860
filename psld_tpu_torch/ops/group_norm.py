"""GroupNorm -> activation: a Triton kernel for Hopper and its plain
PyTorch version.

Replaces ``psld_tpu/ops/group_norm.py::_gn_kernel`` (launched by
``_pallas_gn``), the NHWC GroupNorm(G) + affine + act fused into one VMEM
residency per batch element.

What bounds it on the H100: device-memory bytes, and at the small
flagship shapes the host's cost of a launch. There is no matrix work; per
element it is a few FLOPs against one read for the moments, one read and
one write for the normalize pass. The design:

- Grid: the TPU kernel walks one batch element per grid step, which would
  give 64 blocks for 132 SMs, and a 32x32x512 bf16 slice (1 MB) fits no
  SM's shared memory. Groups are independent, so one program owns one
  batch element's slice of whole groups (about 32 channels) and walks all
  its pixels twice: a moment pass, then a normalize + affine + act pass
  that finds the slice in L2. At batch 64 that is 256 to 1024 programs,
  in one launch, with no scratch buffer and no second reduction.
- Coalescing: in NHWC a group is C/G contiguous channels, only 4 (8 bytes)
  at C=128. A tile is many pixel rows of the whole slice, so each row is
  one contiguous run of the slice's channels; the per-channel sums fold
  into groups once, at the end of the moment pass.
- Numerics are the TPU kernel's: single-pass f32 moments, variance clamped
  at 0, ``rsqrt(var + eps)``, the whole chain in f32, one rounding to the
  output dtype. Like the TPU kernel, it does not read ``gn_bf16``; only
  the plain version follows ``group_norm_act_reference`` with its bf16
  rounding points.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from psld_tpu_torch import knobs

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


_KERNEL = None


def _kernel():
    """Define the Triton kernel at first launch: ``triton`` exists only
    where there is a card."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl
    import triton.language.extra.libdevice as tld

    @triton.jit
    def _gn_fwd(x_ptr, y_ptr, scale_ptr, bias_ptr, HW, C, n, eps,
                CG: tl.constexpr, SLICE: tl.constexpr, ACT: tl.constexpr,
                BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr,
                BLOCK_G: tl.constexpr):
        # program (s, b): channels [s * SLICE, (s + 1) * SLICE) of batch b,
        # SLICE a whole number of groups of CG channels
        lc = tl.arange(0, BLOCK_C)
        cmask = lc < SLICE
        cols = tl.program_id(0) * SLICE + lc
        base = tl.program_id(1).to(tl.int64) * HW * C
        hw_ar = tl.arange(0, BLOCK_HW)
        acc1 = tl.zeros((BLOCK_HW, BLOCK_C), tl.float32)
        acc2 = tl.zeros((BLOCK_HW, BLOCK_C), tl.float32)
        for r0 in range(0, HW, BLOCK_HW):
            rows = r0 + hw_ar
            mask = (rows[:, None] < HW) & cmask[None, :]
            x = tl.load(x_ptr + base + rows[:, None] * C + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            acc1 += x
            acc2 += x * x
        s1 = tl.sum(acc1, axis=0)
        s2 = tl.sum(acc2, axis=0)
        # fold channel sums into the slice's groups and back
        sel = ((lc[None, :] // CG) == tl.arange(0, BLOCK_G)[:, None]) \
            & cmask[None, :]
        mean_g = tl.sum(tl.where(sel, s1[None, :], 0.0), axis=1) / n
        var_g = tl.maximum(
            tl.sum(tl.where(sel, s2[None, :], 0.0), axis=1) / n
            - mean_g * mean_g, 0.0)
        rstd_g = 1.0 / tl.sqrt_rn(var_g + eps)
        mean = tl.sum(tl.where(sel, mean_g[:, None], 0.0), axis=0)
        rstd = tl.sum(tl.where(sel, rstd_g[:, None], 0.0), axis=0)
        scale = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(
            tl.float32)
        bias = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(
            tl.float32)
        for r0 in range(0, HW, BLOCK_HW):
            rows = r0 + hw_ar
            mask = (rows[:, None] < HW) & cmask[None, :]
            offs = base + rows[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = (x - mean[None, :]) * rstd[None, :]
            y = y * scale[None, :] + bias[None, :]
            if ACT == 1:
                y = y / (1.0 + tl.exp(-y))
            elif ACT == 2:
                y = tl.maximum(y, 0.0)
            elif ACT == 3:
                y = tl.where(y > 0, y, tld.expm1(y))
            elif ACT == 4:
                y = tl.where(y >= 0, y, 0.2 * y)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    _KERNEL = _gn_fwd
    return _KERNEL


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# channels a program owns, at most: 64 contiguous bytes of a bf16 row
_SLICE_CHANNELS = 32
# elements of one (pixels x channels) tile
_TILE = 4096


@functools.lru_cache(maxsize=None)
def _geometry(hw: int, c: int, num_groups: int) -> dict:
    """Grid and block sizes: a program owns the most whole groups that
    fit ``_SLICE_CHANNELS`` channels and divide G."""
    cg = c // num_groups
    gpp = max([d for d in range(1, num_groups + 1) if num_groups % d == 0
               and d * cg <= _SLICE_CHANNELS] or [1])
    block_c = _pow2(gpp * cg)
    return dict(slices=num_groups // gpp, CG=cg, SLICE=gpp * cg,
                BLOCK_HW=min(_pow2(hw), max(1, _TILE // block_c)),
                BLOCK_C=block_c, BLOCK_G=_pow2(gpp))


def _launch(x, scale, bias, num_groups: int, eps: float, act: str):
    b, h, w, c = x.shape
    geo = dict(_geometry(h * w, c, num_groups))
    y = torch.empty_like(x)
    _kernel()[(geo.pop("slices"), b)](
        x, y, scale, bias, h * w, c, float(h * w * geo["CG"]), float(eps),
        ACT=_ACT_CODE[act], num_warps=4, **geo)
    return y


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def group_norm_act(x, scale, bias, num_groups: int, eps: float = 1e-6,
                   act: str = "none"):
    """NHWC (B, H, W, C) GroupNorm + act.

    A CPU tensor runs :func:`group_norm_act_plain`. A CUDA tensor launches
    the Triton kernel (``group_norm_act.launches`` counts the calls) or
    raises on what the kernel does not take."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, scale, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: no path for device {x.device}")
    if x.ndim != 4 or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"group_norm_act kernel takes a 4D f32/bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    c = x.shape[-1]
    if c % num_groups or c > 1024:
        raise ValueError(f"group_norm_act kernel: C={c} with "
                         f"G={num_groups} unsupported")
    if not x.is_contiguous():
        raise ValueError("group_norm_act kernel needs contiguous NHWC")
    for p in (scale, bias):
        if p.shape != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError("group_norm_act kernel: scale/bias must be "
                             "contiguous (C,) on the input's device")
    y = _launch(x, scale, bias, num_groups, eps, act)
    group_norm_act.launches += 1
    return y


group_norm_act.launches = 0
