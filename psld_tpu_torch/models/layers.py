"""NCSN++ layers (``psld_tpu/models/layers.py``).

Activations are NCHW-logical tensors in ``channels_last`` memory; the NHWC
view that GroupNorm, NIN and attention take is a free permute. Each
module names its submodules and parameters as flax names the JAX
module's (``GroupNormAct_0``, ``Conv_1``, ``NIN_2.Dense_0``, ``scale``,
``W``), so :mod:`psld_tpu_torch.interop.from_flax` maps a param tree by
path. Convs and Denses compute in the promoted dtype of input and
weight, as flax does: f32 inputs with bf16 weights run in f32.

Dropout is the identity in eval mode. In train mode each resblock drops
at one site, between its second GroupNorm and its second conv; the sites
of a forward are numbered in call order, and :class:`DropoutSites` hands
site ``i`` its seed words (``hw``, ``hw_inline``) or the step's generator
(``save_mask``, ``remat``).

Under spatial parallelism (:mod:`psld_tpu_torch.parallel.spatial`) each
layer runs on this rank's rows of the height: a convolution takes a halo
of its kernel's reach and pads only the width, an FIR resample the
halo of its taps, GroupNorm sums its moments over the spatial group, an
attention block gathers its input, runs whole and keeps its rows of the
output, and dropout hashes positions in the whole image. A 1x1
convolution, a Dense and the time embedding need nothing.

Initialization is the JAX package's ``default_init`` (variance scaling,
fan_avg, uniform): each Conv, Dense and FIRConv2d carries the
``init_scale`` its JAX counterpart is built with, and
:func:`init_parameters` draws every weight from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from psld_tpu_torch.ops import (attention, attention_fits, attention_plain,
                                group_norm_act, group_norm_act_plain,
                                group_norm_fits, hash_dropout)
from psld_tpu_torch.ops.group_norm import group_norm_act_split
from psld_tpu_torch.ops.upfirdn import (conv_downsample_2d_nchw,
                                        downsample_2d_nchw, shard_halo,
                                        upsample_2d_nchw,
                                        upsample_conv_2d_nchw)
from psld_tpu_torch.parallel import distributed, spatial

SQRT2 = math.sqrt(2.0)

_ACT_FNS = {
    "elu": F.elu,
    "relu": F.relu,
    "lrelu": partial(F.leaky_relu, negative_slope=0.2),
    "swish": F.silu,
}


def get_act(name: str) -> Callable:
    """Activation by name (``elu``, ``relu``, ``lrelu``, ``swish``)."""
    name = name.lower()
    if name not in _ACT_FNS:
        raise NotImplementedError(f"activation function {name} does not "
                                  "exist!")
    return _ACT_FNS[name]


# the JAX package's four names for ``model.score_fn.dropout_impl`` select
# two behaviours here: True = the counter-hash op, False = a saved mask
DROPOUT_IMPLS = {"save_mask": False, "hw": True, "hw_inline": True,
                 "remat": False}


def resolve_dropout_impl(impl: str = "save_mask") -> str:
    """``impl`` (``model.score_fn.dropout_impl``) if it is one of the JAX
    package's names, else an error. The config key alone decides: the
    JAX package's env overrides switch its Pallas kernel and its
    compiler's recompute, neither of which exists here."""
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"dropout_impl must be one of "
                         f"{tuple(DROPOUT_IMPLS)}; got {impl!r}")
    return impl


def dropout_is_hashed(impl: str) -> bool:
    """Whether ``impl`` drops through the counter-hash op."""
    return DROPOUT_IMPLS[resolve_dropout_impl(impl)]


class DropoutSites:
    """The dropout of one train-mode forward: call it at each site, in
    order.

    - ``hw`` and ``hw_inline``: the counter-hash op of
      :mod:`psld_tpu_torch.ops.dropout` with ``seeds[i]`` (2 or 4 uint32
      words) at site ``i``. One op serves both names: ``hw_inline`` is
      the JAX package's way of lowering the same mask without a kernel
      boundary, and has no counterpart here.
    - ``save_mask`` and ``remat``: a Bernoulli mask drawn from
      ``generator`` and saved for the backward (``remat`` recomputes the
      same mask in the JAX package, a memory lever of its compiler).

    ``batch_shard = (index, count)`` says that the forward runs on rows
    ``index * B`` to ``(index + 1) * B`` of a global batch of ``count *
    B`` (B the local batch; a rank's share under data parallelism): each
    site then drops as the global batch's forward would drop these rows.
    The hash implementations add the rows' flat NHWC offset
    (``elem_off``), the saved masks draw the global batch's mask and keep
    the rows. Under spatial parallelism ``index`` is the data group, and
    each image holds this rank's slice of the height: the hash takes
    every element's position in the whole image (``image``), the saved
    masks keep the slice of the whole image's mask.

    ``close()`` raises unless every seed was used: a seed list of the
    wrong length means the sites were numbered differently."""

    def __init__(self, rate: float, impl: str = "save_mask", seeds=None,
                 generator=None, batch_shard=(0, 1)):
        self.rate = float(rate)
        self.impl = resolve_dropout_impl(impl)
        self.seeds = seeds
        self.generator = generator
        self.batch_shard = tuple(int(v) for v in batch_shard)
        self.site = 0
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1]; got {rate}")
        if self.hashed and 0.0 < self.rate < 1.0 and seeds is None:
            raise ValueError(
                f"dropout_impl={self.impl} in train mode needs "
                "dropout_seeds: one tuple of uint32 words per site")

    @property
    def hashed(self) -> bool:
        return dropout_is_hashed(self.impl)

    def __call__(self, h):
        i, self.site = self.site, self.site + 1
        index, count = self.batch_shard
        if self.rate == 0.0:
            return h
        if self.rate == 1.0:
            return torch.zeros_like(h)
        s, sp, _, _ = distributed.spatial_info()
        b = h.shape[0]
        if self.hashed:
            if i >= len(self.seeds):
                raise ValueError(f"dropout site {i}: only "
                                 f"{len(self.seeds)} seeds were given")
            # the shard's first element in the global tensor, mod 2**32
            # as the JAX package's uint32 offset
            local = h.numel() // b
            off = (index * b * local * sp + s * local) & 0xFFFFFFFF
            return hash_dropout(h, self.seeds[i], self.rate, elem_off=off,
                                image=None if sp == 1
                                else (local, local * sp))
        keep = 1.0 - self.rate
        shape = list(h.shape)
        shape[0], shape[2] = b * count, shape[2] * sp
        draw = torch.rand(shape, generator=self.generator, device=h.device)
        draw = draw[index * b:(index + 1) * b] if count > 1 else draw
        mask = spatial.height_slice(draw, 2) < keep
        return torch.where(mask, h / keep, torch.zeros_like(h))

    def replay_point(self):
        """Where the next site's draw starts: its index and, for the
        saved-mask implementations, its generator's state."""
        gen = self.generator
        return self.site, (None if gen is None else gen.get_state())

    def replay(self, point) -> "DropoutSites":
        """Sites that draw, from ``point`` (:meth:`replay_point`) on, the
        masks this one drew from there: a recompute's dropout."""
        site, state = point
        gen = None
        if state is not None:
            gen = torch.Generator(device=self.generator.device)
            gen.set_state(state)
        out = DropoutSites(self.rate, self.impl, self.seeds, gen,
                           self.batch_shard)
        out.site = site
        return out

    def close(self) -> None:
        if self.hashed and self.seeds is not None \
                and 0.0 < self.rate < 1.0 and self.site != len(self.seeds):
            raise ValueError(f"{len(self.seeds)} dropout seeds for "
                             f"{self.site} sites")


def variance_scaling_(weight, scale: float, fan_in: int, fan_out: int,
                      generator=None):
    """``default_init(scale)`` in place: uniform with variance
    ``scale / fan_avg`` (``scale`` 0 becomes 1e-10)."""
    scale = 1e-10 if scale == 0 else scale
    lim = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        return weight.uniform_(-lim, lim, generator=generator)


def init_parameters(net: nn.Module, generator=None) -> nn.Module:
    """Initialize ``net`` in place as the JAX package's modules do:
    weights by :func:`variance_scaling_` with each layer's ``init_scale``,
    biases 0, GroupNorm scale 1 and bias 0, Fourier ``W`` normal times its
    scale. Draws come from ``generator`` in module order."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (Conv, FIRConv2d)):
                o, i, kh, kw = m.weight.shape
                variance_scaling_(m.weight, m.init_scale, i * kh * kw,
                                  o * kh * kw, generator)
            elif isinstance(m, Dense):
                o, i = m.weight.shape
                variance_scaling_(m.weight, m.init_scale, i, o, generator)
            elif isinstance(m, GroupNormAct):
                m.scale.fill_(1.0)
            elif isinstance(m, GaussianFourierProjection):
                m.W.normal_(generator=generator).mul_(m.scale)
            if isinstance(m, (Conv, FIRConv2d, Dense, GroupNormAct)) \
                    and m.bias is not None:
                m.bias.zero_()
    return net


def _promote(x, *params):
    """Cast input and params to their promoted dtype (flax's rule)."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return (x.to(dt),) + tuple(None if p is None else p.to(dt)
                               for p in params)


def _nhwc(x):
    """NHWC view of an NCHW-logical tensor, made contiguous if the
    activation is not ``channels_last``."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """flax ``nn.Conv``: stride ``stride``, symmetric int ``padding`` or
    explicit ((top, bottom), (left, right)) padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding=1, bias: bool = True,
                 init_scale: float = 1.0):
        self.init_scale = init_scale
        self._pad = None
        if not isinstance(padding, int):
            (t, b), (l_, r) = padding
            self._pad = (l_, r, t, b)
            padding = 0
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=bias)

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        if spatial.active():
            return _conv_on_shard(x, w, b, self.stride[0], self._pad or (
                self.padding[1],) * 2 + (self.padding[0],) * 2)
        if self._pad is not None:
            x = F.pad(x, self._pad)
        return F.conv2d(x, w, b, self.stride, self.padding)


def _conv_on_shard(x, w, b, stride: int, pad):
    """A convolution of this rank's rows: the halo of rows its output
    rows read from the ranks above and below (``pad`` (left, right, top,
    bottom) of the whole image), then the width's pad alone."""
    kh = w.shape[-2]
    top = pad[2]
    x = spatial.halo(x, top, max(0, kh - stride - top))
    return F.conv2d(F.pad(x, (pad[0], pad[1], 0, 0)), w, b, stride)


_FIR_OPS = {"up": upsample_2d_nchw, "down": downsample_2d_nchw,
            "up_conv": upsample_conv_2d_nchw,
            "conv_down": conv_downsample_2d_nchw}


def _fir(op: str, x, k, w=None):
    """The FIR resample ``op`` by 2 (:func:`shard_halo`'s names; ``w`` the
    weight of the fused convolution); on this rank's rows, of the rows
    with the halo its output rows read, cut to the output rows it owns,
    as :func:`_conv_on_shard` does for a convolution."""
    fn = partial(_FIR_OPS[op], k=k, factor=2)
    if w is not None:
        fn = partial(fn, w=w)
    if not spatial.active():
        return fn(x)
    top, bottom = shard_halo(op, k, 2, 1 if w is None else w.shape[-1])
    up, down = (2, 1) if op.startswith("up") else (1, 2)
    y = fn(spatial.halo(x, top, bottom))
    return y.narrow(2, top * up // down, x.shape[2] * up // down)


class Dense(nn.Linear):
    """flax ``nn.Dense`` on the last axis, with dtype promotion."""

    def __init__(self, in_features: int, out_features: int,
                 init_scale: float = 1.0, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.init_scale = init_scale

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        return F.linear(x, w, b)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, bias: bool = True,
            padding=1, init_scale: float = 1.0) -> Conv:
    return Conv(in_ch, out_ch, 3, stride=stride, padding=padding, bias=bias,
                init_scale=init_scale)


def conv1x1(in_ch: int, out_ch: int, bias: bool = True,
            init_scale: float = 1.0) -> Conv:
    return Conv(in_ch, out_ch, 1, padding=0, bias=bias,
                init_scale=init_scale)


class GroupNormAct(nn.Module):
    """GroupNorm(min(C//4, 32)) fused with the following activation; on
    CUDA it runs the CUDA C++ kernels of :mod:`psld_tpu_torch.ops.group_norm`
    (``csrc/group_norm_fwd.cu`` forward, ``csrc/group_norm_bwd.cu``
    backward), which follow ``gn_bf16`` as the plain version does, where
    the JAX package's TPU kernel (``fused_gn``) runs f32 whatever it says.
    A shape the kernels do not take (``ops.group_norm_fits``: C > 1024,
    or bf16 with no slice of whole groups a multiple of 16 bytes) runs the
    plain version, chosen by shape before any launch, as the JAX
    package's ``fused_group_norm_act`` runs its jnp chain; under spatial
    parallelism ``group_norm_act_split`` routes its own.
    """

    def __init__(self, ch: int, act: str = "none", eps: float = 1e-6):
        super().__init__()
        self.act = act
        self.eps = eps
        self.num_groups = min(ch // 4, 32)
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward_nhwc(self, x):
        if spatial.active():
            return group_norm_act_split(x, self.scale, self.bias,
                                        self.num_groups, self.eps, self.act)
        return self.forward_whole(x)

    def forward_whole(self, x):
        """:meth:`forward_nhwc` of a map every rank holds whole (no sum
        over the spatial group)."""
        fn = group_norm_act if group_norm_fits(
            x.shape, x.dtype, self.num_groups) else group_norm_act_plain
        return fn(x, self.scale, self.bias, self.num_groups, self.eps,
                  self.act)

    def forward(self, x):
        return _nchw(self.forward_nhwc(_nhwc(x)))


def get_timestep_embedding(timesteps, embedding_dim: int,
                           max_positions: int = 10_000):
    """DDPM sinusoidal embedding, f32."""
    if timesteps.ndim != 1:
        raise ValueError("timesteps must be a vector")
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Random Fourier features of the noise level; ``W`` is fixed."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.randn(embedding_size) * scale,
                              requires_grad=False)

    def forward(self, x):
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class NIN(nn.Module):
    """1x1 projection over channels: a Dense on the last (NHWC) axis."""

    def __init__(self, in_ch: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.Dense_0 = Dense(in_ch, num_units, init_scale=init_scale)

    def forward(self, x):
        return self.Dense_0(x)


class Combine(nn.Module):
    """Combine a progressive-input pyramid branch with the trunk."""

    def __init__(self, in_ch: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = conv1x1(in_ch, dim2)

    def forward(self, x, y):
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=1)
        return h + y


class AttnBlock(nn.Module):
    """Full-spatial single-head self-attention; on CUDA the score/softmax/
    value chain is the kernel of :mod:`psld_tpu_torch.ops.attention`
    where ``ops.attention_fits`` takes the tokens (N <= 256, C <= 512),
    else the plain einsum chain with f32 scores, as the JAX package's
    ``fused_attention`` falls back.
    Under spatial parallelism the block gathers its input's height, runs
    whole on every rank of the group (the unchanged kernel over every
    token) and keeps this rank's rows; the gather's backward carries the
    gradient back to the rows' owners. Its GroupNorm is the fused one on
    the whole map, with no sum over the group: its backward is linear in
    the cotangent, so the gather's reduce-scatter adds the ranks' input
    gradients and the gradient reduction their dscale and dbias."""

    def __init__(self, ch: int, skip_rescale: bool = False,
                 init_scale: float = 0.0):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNormAct_0 = GroupNormAct(ch)
        self.NIN_0 = NIN(ch, ch)
        self.NIN_1 = NIN(ch, ch)
        self.NIN_2 = NIN(ch, ch)
        self.NIN_3 = NIN(ch, ch, init_scale=init_scale)

    def forward(self, x):
        if spatial.active():
            return spatial.height_slice(self._whole(spatial.gather(x)), 2)
        return self._whole(x)

    def _whole(self, x):
        b, c, hh, ww = x.shape
        xh = _nhwc(x)
        h = self.GroupNormAct_0.forward_whole(xh)
        q = self.NIN_0(h).reshape(b, hh * ww, c)
        k = self.NIN_1(h).reshape(b, hh * ww, c)
        v = self.NIN_2(h).reshape(b, hh * ww, c)
        attn = attention if attention_fits(q.shape, q.dtype) \
            else attention_plain
        h = attn(q, k, v, float(c) ** -0.5)
        h = self.NIN_3(h.reshape(b, hh, ww, c).to(x.dtype))
        out = xh + h
        if self.skip_rescale:
            out = out / SQRT2
        return _nchw(out)


class FIRConv2d(nn.Module):
    """Conv2d fused with FIR resampling (StyleGAN2). ``weight`` is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 up: bool = False, down: bool = False,
                 resample_kernel: Sequence[float] = (1, 3, 3, 1),
                 use_bias: bool = True):
        super().__init__()
        if up and down:
            raise ValueError("FIRConv2d: up and down are exclusive")
        if kernel < 1 or kernel % 2 != 1:
            raise ValueError("FIRConv2d: kernel must be odd")
        self.up, self.down = up, down
        self.init_scale = 1.0
        self.resample_kernel = list(resample_kernel)
        self.weight = nn.Parameter(
            torch.randn(out_ch, in_ch, kernel, kernel)
            / math.sqrt(in_ch * kernel * kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.up:
            x = _fir("up_conv", x, self.resample_kernel, w)
        elif self.down:
            x = _fir("conv_down", x, self.resample_kernel, w)
        elif spatial.active():
            p = w.shape[-1] // 2
            x = _conv_on_shard(x, w, None, 1, (p, p, p, p))
        else:
            x = F.conv2d(x, w, padding=w.shape[-1] // 2)
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)[None, :, None, None]
        return x


class Upsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = list(fir_kernel)
        if with_conv and fir:
            self.FIRConv2d_0 = FIRConv2d(in_ch, out_ch, 3, up=True,
                                         resample_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = conv3x3(in_ch, out_ch)

    def forward(self, x):
        if not self.fir:
            y = F.interpolate(x, scale_factor=2, mode="nearest")
            return self.Conv_0(y) if self.with_conv else y
        if not self.with_conv:
            return _fir("up", x, self.fir_kernel)
        return self.FIRConv2d_0(x)


class Downsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = list(fir_kernel)
        if with_conv and fir:
            self.FIRConv2d_0 = FIRConv2d(in_ch, out_ch, 3, down=True,
                                         resample_kernel=fir_kernel)
        elif with_conv:
            # asymmetric (0, 1) pad + VALID stride-2 conv
            self.Conv_0 = conv3x3(in_ch, out_ch, stride=2,
                                  padding=((0, 1), (0, 1)))

    def forward(self, x):
        if not self.fir:
            return self.Conv_0(x) if self.with_conv else F.avg_pool2d(x, 2)
        if not self.with_conv:
            return _fir("down", x, self.fir_kernel)
        return self.FIRConv2d_0(x)


def _temb_bias(dense, act, temb):
    return dense(act(temb))[:, :, None, None]


class ResnetBlockDDPM(nn.Module):
    """DDPM-style residual block."""

    def __init__(self, act: str, in_ch: int, out_ch: int | None = None,
                 conv_shortcut: bool = False, skip_rescale: bool = False,
                 temb_dim: int | None = None, init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = get_act(act)
        self.skip_rescale = skip_rescale
        self.in_ch, self.out_ch = in_ch, out_ch
        self.GroupNormAct_0 = GroupNormAct(in_ch, act)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNormAct_1 = GroupNormAct(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        self.shortcut = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
                self.shortcut = "conv"
            else:
                self.NIN_0 = NIN(in_ch, out_ch)
                self.shortcut = "nin"

    def forward(self, x, temb=None, dropout: DropoutSites | None = None):
        """``dropout``: the train-mode forward's sites, None in eval."""
        h = self.Conv_0(self.GroupNormAct_0(x))
        if temb is not None:
            h = h + _temb_bias(self.Dense_0, self.act, temb)
        h = self.GroupNormAct_1(h)
        if dropout is not None:
            h = dropout(h)
        h = self.Conv_1(h)
        if self.shortcut == "conv":
            x = self.Conv_2(x)
        elif self.shortcut == "nin":
            x = _nchw(self.NIN_0(_nhwc(x)))
        if not self.skip_rescale:
            return x + h
        return (x + h) / SQRT2


class ResnetBlockBigGAN(nn.Module):
    """BigGAN-style residual block with in-block resampling."""

    def __init__(self, act: str, in_ch: int, out_ch: int | None = None,
                 up: bool = False, down: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1),
                 skip_rescale: bool = True, temb_dim: int | None = None,
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = get_act(act)
        self.up, self.down, self.fir = up, down, fir
        self.fir_kernel = list(fir_kernel)
        self.skip_rescale = skip_rescale
        self.GroupNormAct_0 = GroupNormAct(in_ch, act)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNormAct_1 = GroupNormAct(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        self.has_shortcut = in_ch != out_ch or up or down
        if self.has_shortcut:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def _resample(self, x):
        if self.up:
            if self.fir:
                return _fir("up", x, self.fir_kernel)
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            if self.fir:
                return _fir("down", x, self.fir_kernel)
            return F.avg_pool2d(x, 2)
        return x

    def forward(self, x, temb=None, dropout: DropoutSites | None = None):
        """``dropout``: the train-mode forward's sites, None in eval."""
        h = self.GroupNormAct_0(x)
        h, x = self._resample(h), self._resample(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + _temb_bias(self.Dense_0, self.act, temb)
        h = self.GroupNormAct_1(h)
        if dropout is not None:
            h = dropout(h)
        h = self.Conv_1(h)
        if self.has_shortcut:
            x = self.Conv_2(x)
        if not self.skip_rescale:
            return x + h
        return (x + h) / SQRT2
