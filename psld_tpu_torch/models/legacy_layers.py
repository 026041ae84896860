"""The NCSNv1/v2 layer zoo (``psld_tpu/models/legacy_layers.py``):
RefineNet-style blocks and the NCSNv2 residual blocks.

Activations are NCHW-logical tensors (``channels_last`` memory where the
caller gives it), as in :mod:`psld_tpu_torch.models.layers`. Conditional
blocks take class labels ``y`` and a normalizer factory from
:mod:`psld_tpu_torch.models.normalization`.

Flax infers each layer's input width when the block is first called;
PyTorch needs every width when the block is built. So the blocks whose
JAX counterparts read a width off their input take it as a constructor
argument: ``in_chs`` (one width an input) for :class:`MSFBlock`,
:class:`CondMSFBlock`, :class:`RefineBlock` and :class:`CondRefineBlock`,
and ``in_ch`` for :class:`ResidualBlock`, :class:`ConditionalResidualBlock`,
:class:`ConvMeanPool`, :class:`MeanPoolConv` and :class:`UpsampleConv`.
The residual units (:class:`CRPBlock`, :class:`RCUBlock` and their
conditional forms) add their input to their output, so their input has
``features`` channels.

Every submodule is named as flax auto-names it, by its class and its
place in call order among those of its class (``Conv_0``,
``RCUBlock_1``, ``ConditionalInstanceNorm2dPlus_0``, ``GroupNorm_0``),
so :func:`psld_tpu_torch.interop.from_flax.flax_to_state_dict` maps a
flax tree by path. Convolutions are initialized as flax's
``lecun_normal`` (truncated normal, fan-in) times ``init_scale``, biases
0.

All of it is plain PyTorch: the JAX package computes these blocks in
``jnp`` and XLA, outside any Pallas kernel. The one hand-written kernel
they reach is GroupNorm's, through the ``GroupNorm`` normalizer.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from psld_tpu_torch.models.layers import _promote
from psld_tpu_torch.models.normalization import (
    ConditionalInstanceNorm2dPlus,
    InstanceNorm2d,
)

# flax's truncated normal: the standard deviation of N(0, 1) cut at +-2
_TRUNC_STD = 0.87962566103423978


class NCSNConv(nn.Conv2d):
    """flax ``nn.Conv`` with symmetric padding ``padding`` and
    ``dilation``; weights ``lecun_normal`` times ``init_scale`` (0 becomes
    1e-10), in the promoted dtype of input and weight."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 init_scale: float = 1.0):
        self.init_scale = 1e-10 if init_scale == 0 else init_scale
        super().__init__(in_ch, out_ch, kernel, padding=padding,
                         dilation=dilation, bias=bias)

    def reset_parameters(self):
        o, i, kh, kw = self.weight.shape
        std = math.sqrt(1.0 / (i * kh * kw)) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std)
            self.weight.mul_(self.init_scale)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        return F.conv2d(x, w, b, 1, self.padding, self.dilation)


def ncsn_conv3x3(in_ch: int, out_ch: int, *, bias: bool = True,
                 dilation: int = 1, init_scale: float = 1.0) -> NCSNConv:
    return NCSNConv(in_ch, out_ch, 3, dilation, dilation, bias, init_scale)


def ncsn_conv1x1(in_ch: int, out_ch: int, *, bias: bool = True) -> NCSNConv:
    return NCSNConv(in_ch, out_ch, 1, bias=bias)


def _pool5(x, kind: str):
    """5x5 stride-1 pad-2 pooling (the CRP's): max pools over -inf pads,
    average divides by 25, the padded zeros counted."""
    if kind == "max":
        return F.max_pool2d(x, 5, 1, 2)
    # pooled in NCHW memory: PyTorch's CUDA average pooling (2.11) pulls a
    # wrong gradient back into a channels_last input where its windows
    # overlap (its forward is right)
    return F.avg_pool2d(x.contiguous(), 5, 1, 2, count_include_pad=True)


class _FlaxNamed(nn.Module):
    """A block that registers its submodules under flax's auto-names:
    ``<kind>_<i>``, ``i`` counting the submodules of that kind in the
    order the JAX block calls them. The kind is flax's class name:
    ``Conv`` for a convolution, else the submodule's class name."""

    def __init__(self):
        super().__init__()
        self._flax_counts = {}

    def add(self, mod: nn.Module, attr: str | None = None) -> nn.Module:
        """Register ``mod`` under its flax name and return it; ``attr``
        names a second handle on it that stays out of the module tree
        (and so out of the ``state_dict``)."""
        kind = "Conv" if isinstance(mod, NCSNConv) else type(mod).__name__
        i = self._flax_counts.get(kind, 0)
        self._flax_counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", mod)
        if attr is not None:
            object.__setattr__(self, attr, mod)
        return mod


class CRPBlock(_FlaxNamed):
    """Chained residual pooling: ``n_stages`` of pool, conv, add."""

    def __init__(self, features: int, n_stages: int,
                 act: Callable = F.relu, maxpool: bool = True):
        super().__init__()
        self.act, self.kind = act, "max" if maxpool else "avg"
        self.convs = [self.add(ncsn_conv3x3(features, features, bias=False))
                      for _ in range(n_stages)]

    def forward(self, x):
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.kind))
            x = path + x
        return x


class CondCRPBlock(_FlaxNamed):
    """Conditional CRP: each stage normalizes, average-pools, convolves."""

    def __init__(self, features: int, n_stages: int, num_classes: int,
                 normalizer: Callable = ConditionalInstanceNorm2dPlus,
                 act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.stages = []
        for _ in range(n_stages):
            norm = self.add(normalizer(features=features,
                                       num_classes=num_classes))
            conv = self.add(ncsn_conv3x3(features, features, bias=False))
            self.stages.append((norm, conv))

    def forward(self, x, y):
        x = self.act(x)
        path = x
        for norm, conv in self.stages:
            path = conv(_pool5(norm(path, y), "avg"))
            x = path + x
        return x


class RCUBlock(_FlaxNamed):
    """Residual conv unit: ``n_blocks`` of ``n_stages`` (act, conv) with a
    residual add each."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.blocks = [[self.add(ncsn_conv3x3(features, features, bias=False))
                        for _ in range(n_stages)] for _ in range(n_blocks)]

    def forward(self, x):
        for convs in self.blocks:
            residual = x
            for conv in convs:
                x = conv(self.act(x))
            x = x + residual
        return x


class CondRCUBlock(_FlaxNamed):
    """Conditional RCU: each stage normalizes, then (act, conv)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 num_classes: int,
                 normalizer: Callable = ConditionalInstanceNorm2dPlus,
                 act: Callable = F.relu):
        super().__init__()
        self.act = act
        self.blocks = [[(self.add(normalizer(features=features,
                                             num_classes=num_classes)),
                         self.add(ncsn_conv3x3(features, features,
                                               bias=False)))
                        for _ in range(n_stages)] for _ in range(n_blocks)]

    def forward(self, x, y):
        for stages in self.blocks:
            residual = x
            for norm, conv in stages:
                x = conv(self.act(norm(x, y)))
            x = x + residual
        return x


def _resize_bilinear_align_corners(x, shape):
    """Bilinear resize of NCHW ``x`` to ``shape`` (H, W) with
    ``align_corners=True``; the identity at its own size."""
    if tuple(x.shape[2:]) == tuple(shape):
        return x
    return F.interpolate(x, size=tuple(shape), mode="bilinear",
                         align_corners=True)


class MSFBlock(_FlaxNamed):
    """Multi-scale fusion: a biased conv of each input to ``features``,
    resized to ``shape`` and summed. ``in_chs`` holds each input's
    width."""

    def __init__(self, in_chs: Sequence[int], features: int):
        super().__init__()
        self.features = features
        self.convs = [self.add(ncsn_conv3x3(c, features, bias=True))
                      for c in in_chs]

    def forward(self, xs, shape):
        total = xs[0].new_zeros((xs[0].shape[0], self.features, *shape))
        for x, conv in zip(xs, self.convs, strict=True):
            total = total + _resize_bilinear_align_corners(conv(x), shape)
        return total


class CondMSFBlock(_FlaxNamed):
    """Conditional MSF: each input normalized at its own width first."""

    def __init__(self, in_chs: Sequence[int], features: int,
                 num_classes: int,
                 normalizer: Callable = ConditionalInstanceNorm2dPlus):
        super().__init__()
        self.features = features
        self.paths = [(self.add(normalizer(features=c,
                                           num_classes=num_classes)),
                       self.add(ncsn_conv3x3(c, features, bias=True)))
                      for c in in_chs]

    def forward(self, xs, y, shape):
        total = xs[0].new_zeros((xs[0].shape[0], self.features, *shape))
        for x, (norm, conv) in zip(xs, self.paths, strict=True):
            total = total + _resize_bilinear_align_corners(conv(norm(x, y)),
                                                           shape)
        return total


class RefineBlock(_FlaxNamed):
    """RefineNet block: an RCU (2 x 2) on each input at its own width
    (``in_chs``), MSF to ``features`` where there are several, CRP, and
    an output RCU (3 blocks at the ``end``, else 1). ``start`` is taken
    for the reference's signature and changes nothing."""

    def __init__(self, in_chs: Sequence[int], features: int,
                 act: Callable = F.relu, start: bool = False,
                 end: bool = False, maxpool: bool = True):
        super().__init__()
        self.rcus = [self.add(RCUBlock(c, 2, 2, act)) for c in in_chs]
        self.msf = None
        if len(in_chs) > 1:
            self.add(MSFBlock(in_chs, features), "msf")
        self.add(CRPBlock(features, 2, act, maxpool=maxpool), "crp")
        self.add(RCUBlock(features, 3 if end else 1, 2, act), "out")

    def forward(self, xs, output_shape):
        hs = [rcu(x) for rcu, x in zip(self.rcus, xs, strict=True)]
        h = hs[0] if self.msf is None else self.msf(hs, output_shape)
        return self.out(self.crp(h))


class CondRefineBlock(_FlaxNamed):
    """Conditional RefineNet block (see :class:`RefineBlock`)."""

    def __init__(self, in_chs: Sequence[int], features: int,
                 num_classes: int,
                 normalizer: Callable = ConditionalInstanceNorm2dPlus,
                 act: Callable = F.relu, start: bool = False,
                 end: bool = False):
        super().__init__()
        self.rcus = [self.add(CondRCUBlock(c, 2, 2, num_classes, normalizer,
                                           act)) for c in in_chs]
        self.msf = None
        if len(in_chs) > 1:
            self.add(CondMSFBlock(in_chs, features, num_classes, normalizer),
                     "msf")
        self.add(CondCRPBlock(features, 2, num_classes, normalizer, act),
                 "crp")
        self.add(CondRCUBlock(features, 3 if end else 1, 2, num_classes,
                              normalizer, act), "out")

    def forward(self, xs, y, output_shape):
        hs = [rcu(x, y) for rcu, x in zip(self.rcus, xs, strict=True)]
        h = hs[0] if self.msf is None else self.msf(hs, y, output_shape)
        return self.out(self.crp(h, y), y)


def _mean_pool_2x2(x):
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2]
            + x[:, :, 1::2, 1::2]) / 4.0


class ConvMeanPool(_FlaxNamed):
    """A conv, then a 2x2 mean pool; ``adjust_padding`` first pads one
    row on top and one column on the left."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 biases: bool = True, adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.add(NCSNConv(in_ch, out_ch, kernel_size, kernel_size // 2,
                          bias=biases), "conv")

    def forward(self, x):
        if self.adjust_padding:
            x = F.pad(x, (1, 0, 1, 0))
        return _mean_pool_2x2(self.conv(x))


class MeanPoolConv(_FlaxNamed):
    """A 2x2 mean pool, then a conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.add(NCSNConv(in_ch, out_ch, kernel_size, kernel_size // 2,
                          bias=biases), "conv")

    def forward(self, x):
        return self.conv(_mean_pool_2x2(x))


class UpsampleConv(_FlaxNamed):
    """The reference's upsample: ``cat([x] * 4)`` and a pixel shuffle by
    2, then a conv. For C > 1 the shuffle scrambles the channels (output
    channel k of a 2x2 cell reads input channel (4k + 2di + dj) mod C), a
    quirk of the reference that this reproduces exactly."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.add(NCSNConv(in_ch, out_ch, kernel_size, kernel_size // 2,
                          bias=biases), "conv")

    def forward(self, x):
        return self.conv(F.pixel_shuffle(torch.cat([x] * 4, dim=1), 2))


class _Residual(_FlaxNamed):
    """The NCSNv2 residual block's layers, built for ``norm(width)``
    normalizers; :class:`ResidualBlock` and
    :class:`ConditionalResidualBlock` differ in how they call them."""

    def __init__(self, in_ch: int, out_ch: int, resample, act: Callable,
                 dilation: int, adjust_padding: bool, norm: Callable):
        super().__init__()
        self.act = act
        if resample not in ("down", None):
            raise ValueError("invalid resample value")
        d = dilation
        if resample == "down":
            self.norms = [self.add(norm(in_ch)), self.add(norm(in_ch))]
            if d > 1:
                self.convs = [self.add(ncsn_conv3x3(in_ch, in_ch, dilation=d)),
                              self.add(ncsn_conv3x3(in_ch, out_ch,
                                                    dilation=d))]
                self.add(ncsn_conv3x3(in_ch, out_ch, dilation=d), "shortcut")
            else:
                self.convs = [self.add(ncsn_conv3x3(in_ch, in_ch)),
                              self.add(ConvMeanPool(
                                  in_ch, out_ch, 3,
                                  adjust_padding=adjust_padding))]
                self.add(ConvMeanPool(in_ch, out_ch, 1,
                                      adjust_padding=adjust_padding),
                         "shortcut")
        else:
            self.norms = [self.add(norm(in_ch)), self.add(norm(out_ch))]
            self.convs = [self.add(ncsn_conv3x3(in_ch, out_ch, dilation=d)),
                          self.add(ncsn_conv3x3(out_ch, out_ch, dilation=d))]
            if out_ch == in_ch:
                self.shortcut = None
            elif d > 1:
                self.add(ncsn_conv3x3(in_ch, out_ch, dilation=d), "shortcut")
            else:
                self.add(ncsn_conv1x1(in_ch, out_ch), "shortcut")

    def run(self, x, norm):
        """The block on ``x``, with ``norm(module, h)`` applying a
        normalizer."""
        h = self.act(norm(self.norms[0], x))
        h = self.convs[0](h)
        h = self.act(norm(self.norms[1], h))
        h = self.convs[1](h)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + h


class ResidualBlock(_Residual):
    """NCSNv2 residual block (ELU) from ``in_ch`` to ``out_ch`` channels;
    ``resample`` is ``None`` or ``"down"``. ``normalization`` is a
    factory called with the channel count (``features=``), as the
    reference calls it."""

    def __init__(self, in_ch: int, out_ch: int, resample: str | None = None,
                 act: Callable = F.elu, dilation: int = 1,
                 adjust_padding: bool = False,
                 normalization: Callable = InstanceNorm2d):
        super().__init__(in_ch, out_ch, resample, act, dilation,
                         adjust_padding,
                         lambda c: normalization(features=c))

    def forward(self, x):
        return self.run(x, lambda norm, h: norm(h))


class ConditionalResidualBlock(_Residual):
    """The conditional residual block: its normalizers take the labels
    ``y``; ``normalization`` is called with ``features=`` and
    ``num_classes=``."""

    def __init__(self, in_ch: int, out_ch: int, num_classes: int,
                 resample: str | None = None, act: Callable = F.elu,
                 dilation: int = 1, adjust_padding: bool = False,
                 normalization: Callable = ConditionalInstanceNorm2dPlus):
        super().__init__(in_ch, out_ch, resample, act, dilation,
                         adjust_padding,
                         lambda c: normalization(features=c,
                                                 num_classes=num_classes))

    def forward(self, x, y):
        return self.run(x, lambda norm, h: norm(h, y))
