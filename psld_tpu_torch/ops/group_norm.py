"""GroupNorm -> activation: Triton kernels for Hopper, forward and
backward, and their plain PyTorch versions.

The forward replaces ``psld_tpu/ops/group_norm.py::_gn_kernel`` (launched
by ``_pallas_gn``), the NHWC GroupNorm(G) + affine + act fused into one
VMEM residency per batch element. The backward replaces its custom VJP
``_gn_bwd``, which in the JAX package is no kernel but a pull-back through
the jnp chain; here it is a kernel of its own, because autograd through
the plain chain would re-read and re-write the activation a dozen times,
125 times a training step.

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

The backward kernel computes the exact gradient of that f32 chain. With
``xh = (x - mean) * rstd``, ``z = xh * scale + bias``, ``y = act(z)``:
``dz = g * act'(z)``, ``dbias = sum dz``, ``dscale = sum dz * xh``,
``dxh = dz * scale``, ``dx = rstd * (dxh - mean_g(dxh) - xh *
mean_g(dxh * xh))``. It is bound by bytes too (read x and g, write dx)
and reuses the forward's geometry: one program per batch element and
slice of whole groups, which walks its pixels three times: moments (they
are recomputed, so the autograd Function saves x, scale and bias and
nothing else), then the per-channel sums of dz and dz * xh, which give
both the parameter gradients and the two group means, then dx. The
second and third walks find the slice in L2. ``dscale`` and ``dbias`` sum
over the batch, across programs: each program writes its (batch element,
channel) partials into a (2, B, C) float32 buffer, and one small sum over
B follows, so the order of that sum is fixed. A group whose variance was
clamped at 0 gets no gradient through the variance. Activation slopes at
the kink follow ``jax.nn``: relu 0 at 0, leaky relu 1 at 0, elu
``exp(z)`` for z <= 0.
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
    """Define the Triton kernels (forward, backward) at first launch:
    ``triton`` exists only where there is a card."""
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

    @triton.jit
    def _dz(g, z, ACT: tl.constexpr):
        # g * act'(z)
        if ACT == 1:
            sig = 1.0 / (1.0 + tl.exp(-z))
            g = g * (sig * (1.0 + z * (1.0 - sig)))
        elif ACT == 2:
            g = tl.where(z > 0, g, 0.0)
        elif ACT == 3:
            g = tl.where(z > 0, g, g * tl.exp(z))
        elif ACT == 4:
            g = tl.where(z >= 0, g, 0.2 * g)
        return g

    @triton.jit
    def _gn_bwd(x_ptr, g_ptr, dx_ptr, scale_ptr, bias_ptr, part_ptr, BC,
                HW, C, n, eps,
                CG: tl.constexpr, SLICE: tl.constexpr, ACT: tl.constexpr,
                BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr,
                BLOCK_G: tl.constexpr):
        # program (s, b) as in the forward
        lc = tl.arange(0, BLOCK_C)
        cmask = lc < SLICE
        cols = tl.program_id(0) * SLICE + lc
        b = tl.program_id(1)
        base = b.to(tl.int64) * HW * C
        hw_ar = tl.arange(0, BLOCK_HW)
        # walk 1: the forward's moments
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
        sel = ((lc[None, :] // CG) == tl.arange(0, BLOCK_G)[:, None]) \
            & cmask[None, :]
        mean_g = tl.sum(tl.where(sel, s1[None, :], 0.0), axis=1) / n
        raw_g = tl.sum(tl.where(sel, s2[None, :], 0.0), axis=1) / n \
            - mean_g * mean_g
        rstd_g = 1.0 / tl.sqrt_rn(tl.maximum(raw_g, 0.0) + eps)
        # 0 where the variance was clamped: no gradient through it
        live_g = tl.where(raw_g >= 0.0, 1.0, 0.0)
        mean = tl.sum(tl.where(sel, mean_g[:, None], 0.0), axis=0)
        rstd = tl.sum(tl.where(sel, rstd_g[:, None], 0.0), axis=0)
        scale = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(
            tl.float32)
        bias = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(
            tl.float32)
        # walk 2: per-channel sums of dz and dz * xh
        acc1 = tl.zeros((BLOCK_HW, BLOCK_C), tl.float32)
        acc2 = tl.zeros((BLOCK_HW, BLOCK_C), tl.float32)
        for r0 in range(0, HW, BLOCK_HW):
            rows = r0 + hw_ar
            mask = (rows[:, None] < HW) & cmask[None, :]
            offs = base + rows[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            xh = (x - mean[None, :]) * rstd[None, :]
            dz = _dz(g, xh * scale[None, :] + bias[None, :], ACT)
            acc1 += dz
            acc2 += dz * xh
        dbias = tl.sum(acc1, axis=0)
        dscale = tl.sum(acc2, axis=0)
        # partials (2, B, C): dscale, then dbias
        tl.store(part_ptr + b * C + cols, dscale, mask=cmask)
        tl.store(part_ptr + BC + b * C + cols, dbias, mask=cmask)
        # group means of dxh and dxh * xh, back on the channels
        m1_g = tl.sum(tl.where(sel, (dbias * scale)[None, :], 0.0),
                      axis=1) / n
        m2_g = tl.sum(tl.where(sel, (dscale * scale)[None, :], 0.0),
                      axis=1) / n * live_g
        m1 = tl.sum(tl.where(sel, m1_g[:, None], 0.0), axis=0)
        m2 = tl.sum(tl.where(sel, m2_g[:, None], 0.0), axis=0)
        # walk 3: dx
        for r0 in range(0, HW, BLOCK_HW):
            rows = r0 + hw_ar
            mask = (rows[:, None] < HW) & cmask[None, :]
            offs = base + rows[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            xh = (x - mean[None, :]) * rstd[None, :]
            dz = _dz(g, xh * scale[None, :] + bias[None, :], ACT)
            dx = rstd[None, :] * (dz * scale[None, :] - m1[None, :]
                                  - xh * m2[None, :])
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)

    _KERNEL = (_gn_fwd, _gn_bwd)
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
    _kernel()[0][(geo.pop("slices"), b)](
        x, y, scale, bias, h * w, c, float(h * w * geo["CG"]), float(eps),
        ACT=_ACT_CODE[act], num_warps=4, **geo)
    return y


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_args(what: str, x, scale, bias, num_groups: int) -> None:
    if x.ndim != 4 or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes a 4D f32/bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[-1]
    if c % num_groups or c > 1024:
        raise ValueError(f"{what} kernel: C={c} with G={num_groups} "
                         "unsupported")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs contiguous NHWC")
    for p in (scale, bias):
        if p.shape != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"{what} kernel: scale/bias must be contiguous "
                             "(C,) on the input's device")


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
    batch.

    A CPU tensor runs :func:`group_norm_act_backward_plain`. A CUDA tensor
    launches the Triton backward kernel
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
    b, h, w, c = x.shape
    geo = dict(_geometry(h * w, c, num_groups))
    dx = torch.empty_like(x)
    part = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # 8 warps hide the three walks' latency at 1,024 pixels; at 256
        # and fewer a program's tile is too small to feed them
        _kernel()[1][(geo.pop("slices"), b)](
            x, g, dx, scale, bias, part, b * c, h * w, c,
            float(h * w * geo["CG"]), float(eps), ACT=_ACT_CODE[act],
            num_warps=8 if h * w >= 1024 else 4, **geo)
    group_norm_act_backward.launches += 1
    if not need_params:
        return dx, None, None
    dscale, dbias = part.sum(1)
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


group_norm_act_backward.launches = 0


class _GroupNormAct(torch.autograd.Function):
    """Forward and backward kernels; saves x, scale and bias only."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, act)
        y = _launch(x, scale, bias, num_groups, eps, act)
        group_norm_act.launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        grads = group_norm_act_backward(
            *ctx.saved_tensors, g.contiguous(), *ctx.args,
            need_params=any(ctx.needs_input_grad[1:3]))
        return (*grads, None, None, None)


def group_norm_act(x, scale, bias, num_groups: int, eps: float = 1e-6,
                   act: str = "none"):
    """NHWC (B, H, W, C) GroupNorm + act, differentiable in x, scale and
    bias.

    A CPU tensor runs :func:`group_norm_act_plain`. A CUDA tensor launches
    the Triton kernel (``group_norm_act.launches`` counts the calls), and
    its gradient the backward kernel, or raises on what the kernels do not
    take."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, scale, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: no path for device {x.device}")
    _check_kernel_args("group_norm_act", x, scale, bias, num_groups)
    return _GroupNormAct.apply(x, scale, bias, num_groups, eps, act)


group_norm_act.launches = 0
