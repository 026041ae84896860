"""GroupNorm -> activation for Hopper: a Triton forward kernel, a CUDA
C++ backward kernel, and their plain PyTorch versions.

The forward replaces ``psld_tpu/ops/group_norm.py::_gn_kernel`` (launched
by ``_pallas_gn``), the NHWC GroupNorm(G) + affine + act fused into one
VMEM residency per batch element. The backward replaces its custom VJP
``_gn_bwd``, which in the JAX package is no kernel but a pull-back through
the jnp chain; here it is a kernel of its own, because autograd through
the plain chain would re-read and re-write the activation a dozen times,
125 times a training step.

What bounds the forward on the H100: device-memory bytes, and at the
small flagship shapes the host's cost of a launch. There is no matrix
work; per element it is a few FLOPs against one read for the moments,
one read and one write for the normalize pass. The design:

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

The backward is a CUDA C++ kernel, ``csrc/group_norm_bwd.cu``, which
computes the exact gradient of that f32 chain. With ``xh = (x - mean) *
rstd``, ``z = xh * scale + bias``, ``y = act(z)``: ``dz = g * act'(z)``,
``dbias = sum dz``, ``dscale = sum dz * xh``, ``dxh = dz * scale``, ``dx =
rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh))``. The moments are
recomputed from x, so the autograd Function saves x, scale and bias and
nothing else. It is bound by bytes (read x and g, write dx), and its
design reads each of them from device memory once: a block (or a
thread block cluster) holds one batch element's slice of whole groups in
shared memory and runs its three passes from there (the source note
says how). The slice, the cluster, the threads and the rows a block
holds come from :func:`plan_backward`, on the host. ``dscale`` and
``dbias`` sum over the batch inside the same launch: the kernel writes
(channel, batch element) partials into a (2, C, B) float32 buffer, and
the last block of a slice to finish, counted with integers, adds them in
a fixed order. A per-(device, stream) buffer of those counts is zeroed
once and left at zero by every launch. A group whose variance was
clamped at 0 gets no gradient through the variance. Activation slopes at
the kink follow ``jax.nn``: relu 0 at 0, leaky relu 1 at 0, elu
``exp(z)`` for z <= 0.
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


_KERNEL = None


def _kernel():
    """Define the Triton forward kernel at first launch: ``triton``
    exists only where there is a card."""
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


# the backward kernel's blocks (csrc/group_norm_bwd.cu): the shared
# memory a block may have, the most blocks of a cluster
_BWD_SMEM_MAX = 232_448
_BWD_CLUSTERS = (1, 2, 4, 8)
# shared memory a block aims at, so that three blocks share an SM
_BWD_SMEM_TARGET = _BWD_SMEM_MAX // 3
# a slice's row, at most: one 128-byte line of an NHWC row
_BWD_ROW_BYTES = 128
# a block of at most this many elements of x runs 128 threads, else 256
_BWD_SMALL_TILE = 4096


def _bwd_smem(resident: int, slice_: int, elem: int, threads: int) -> int:
    """Bytes of shared memory of a backward block of ``threads`` threads
    holding ``resident`` pixel rows of a ``slice_``-channel slice: x and
    g, then float32 scratch (``smem_bytes`` in the CUDA source computes
    the same)."""
    rows = threads // (slice_ // 4)
    return 2 * resident * slice_ * elem + 4 * (2 * rows * slice_
                                               + 11 * slice_)


@functools.lru_cache(maxsize=None)
def plan_backward(hw: int, c: int, num_groups: int, dtype) -> dict:
    """The backward kernel's geometry for (H*W, C, G, dtype): ``slice``
    channels (whole groups, a divisor of C, a multiple of 16 bytes) a
    cluster of ``cluster`` blocks of ``threads`` threads owns, each block
    holding ``resident`` of its pixel rows in shared memory (``smem``
    bytes).

    The smallest cluster comes first (a cluster's barriers cost more than
    a narrower slice), then the widest slice up to one 128-byte line of a
    row whose pixels fit in a third of an SM's shared memory; failing
    that, the narrowest slice over the largest cluster holds what fits
    and the kernel reads the rest of its rows from device memory. Raises
    ValueError where no slice of whole groups is a multiple of 16
    bytes."""
    if c % num_groups:
        raise ValueError(f"C={c} is no multiple of G={num_groups}")
    elem = torch.empty((), dtype=dtype).element_size()
    cg = c // num_groups
    slices = [k * cg for k in range(num_groups, 0, -1)
              if num_groups % k == 0 and k * cg * elem % 16 == 0
              and k * cg <= 512]
    if not slices:
        raise ValueError(
            f"group_norm_act_backward kernel: no slice of whole "
            f"{cg}-channel groups of C={c} is a multiple of 16 bytes in "
            f"{dtype}")

    def plan(s, cl, resident):
        threads = 128 if resident * s <= _BWD_SMALL_TILE else 256
        return dict(slice=s, cluster=cl, resident=resident, threads=threads,
                    smem=_bwd_smem(resident, s, elem, threads))

    narrow = [s for s in slices if s * elem <= _BWD_ROW_BYTES] or slices[-1:]
    for cl in _BWD_CLUSTERS:
        rows = -(-hw // cl)
        for s in narrow:
            if plan(s, cl, rows)["smem"] <= _BWD_SMEM_TARGET:
                return plan(s, cl, rows)
    s, cl = slices[-1], _BWD_CLUSTERS[-1]
    resident = (_BWD_SMEM_MAX - _bwd_smem(0, s, elem, 256)) // (2 * s * elem)
    return plan(s, cl, min(-(-hw // cl), resident))


def _launch(x, scale, bias, num_groups: int, eps: float, act: str):
    b, h, w, c = x.shape
    geo = dict(_geometry(h * w, c, num_groups))
    y = torch.empty_like(x)
    _kernel()[(geo.pop("slices"), b)](
        x, y, scale, bias, h * w, c, float(h * w * geo["CG"]), float(eps),
        ACT=_ACT_CODE[act], num_warps=4, **geo)
    return y


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _bwd_lib():
    lib = build.load("group_norm_bwd.cu")
    fn = lib.psld_gn_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


# the backward kernel's per-slice counts of finished batch elements, one
# zeroed buffer per (device, stream): every launch leaves it at 0 again,
# so a CUDA graph may replay launches that use it, on that stream
_DONE: dict = {}


def _done_counts(device):
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    if key not in _DONE:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "group_norm_act_backward: call it once on this stream "
                "before capturing it into a CUDA graph")
        _DONE[key] = torch.zeros(256, dtype=torch.int32, device=device)
    return _DONE[key]


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
    for p in (scale, bias):
        if p.dtype not in _KERNEL_DTYPES:
            raise ValueError("group_norm_act_backward kernel: scale and bias "
                             "must be f32 or bf16")
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("group_norm_act_backward kernel needs x and the "
                         "cotangent on 16-byte boundaries")
    b, h, w, c = x.shape
    plan = plan_backward(h * w, c, num_groups, x.dtype)
    dx = torch.empty_like(x)
    if need_params:
        part = torch.empty((2, c, b), dtype=torch.float32, device=x.device)
        dscale = torch.empty_like(scale)
        dbias = torch.empty_like(bias)
        done = _done_counts(x.device)
    lib = _bwd_lib()
    with torch.cuda.device(x.device):
        err = lib.psld_gn_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), scale.data_ptr(),
            _BF16[scale.dtype], bias.data_ptr(), _BF16[bias.dtype],
            *((part.data_ptr(), done.data_ptr(), dscale.data_ptr(),
               dbias.data_ptr()) if need_params else (None,) * 4),
            b, h * w, c, c // num_groups, plan["slice"], plan["cluster"],
            plan["resident"], plan["threads"], _ACT_CODE[act], float(eps),
            int(need_params), _BF16[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "group_norm_act_backward kernel launch")
    group_norm_act_backward.launches += 1
    if not need_params:
        return dx, None, None
    return dx, dscale, dbias


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
