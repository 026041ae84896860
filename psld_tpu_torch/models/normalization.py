"""Normalization variants of the NCSNv1/v2 era
(``psld_tpu/models/normalization.py``), on NCHW-logical tensors.

NCSN++ uses plain GroupNorm (:class:`~psld_tpu_torch.models.layers.
GroupNormAct`); these conditional and instance variants serve the legacy
blocks of :mod:`psld_tpu_torch.models.legacy_layers`. Instance and
variance statistics reduce over the spatial axes (2, 3). Each module
names its parameters as the JAX one does (``alpha``, ``gamma``, ``beta``,
``_ClassEmbed_0.embedding``), so
:func:`psld_tpu_torch.interop.from_flax.flax_to_state_dict` maps a flax
tree by path. Initial values follow the JAX inits in distribution.

All of it is plain PyTorch (the JAX package computes it in ``jnp``,
outside any Pallas kernel), apart from the ``GroupNorm`` variant of
:func:`get_normalization`, which runs the hand-written GroupNorm kernels
on CUDA.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn

from psld_tpu_torch.models.layers import GroupNormAct

_EPS = 1e-5


def _instance_norm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + _EPS)


def _normal_(t, mean: float = 1.0, std: float = 0.02):
    with torch.no_grad():
        return t.normal_(mean, std)


def _plus_stats(x):
    """Cross-channel normalization of per-(sample, channel) means (the
    'InstanceNorm++' correction), [B, C]; unbiased variance, as the
    reference's ``torch.var`` default."""
    means = x.mean(dim=(2, 3))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    return (means - m) * torch.rsqrt(v + _EPS)


def _per_channel(v):
    """A [B, C] or [C] per-channel value broadcast over NCHW."""
    return v[..., None, None]


class InstanceNorm2d(nn.Module):
    """Plain instance norm, no affine. ``features`` is taken for the
    factory signature the other variants share."""

    def __init__(self, features: int = 0):
        super().__init__()
        self.features = features

    def forward(self, x):
        return _instance_norm(x)


class VarianceNorm2d(nn.Module):
    """x over its spatial std (unbiased) with a learned scale ~ N(1, 0.02)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(_normal_(torch.empty(features)))

    def forward(self, x):
        var = x.var(dim=(2, 3), keepdim=True, unbiased=True)
        return _per_channel(self.alpha) * x * torch.rsqrt(var + _EPS)


class NoneNorm2d(nn.Module):
    """The identity."""

    def __init__(self, features: int = 0):
        super().__init__()
        self.features = features

    def forward(self, x):
        return x


class InstanceNorm2dPlus(nn.Module):
    """Instance norm plus the cross-channel mean correction; ``alpha``
    and ``gamma`` ~ N(1, 0.02), ``beta`` 0."""

    def __init__(self, features: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(_normal_(torch.empty(features)))
        self.gamma = nn.Parameter(_normal_(torch.empty(features)))
        self.beta = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        means = _per_channel(_plus_stats(x))
        h = _instance_norm(x) + means * _per_channel(self.alpha)
        out = _per_channel(self.gamma) * h
        if self.beta is not None:
            out = out + _per_channel(self.beta)
        return out


class _ClassEmbed(nn.Module):
    """A per-class table of (gain, bias, ...) rows, indexed by the labels:
    a parameter named ``embedding`` (the flax leaf's name), not an
    ``nn.Embedding``."""

    def __init__(self, num_classes: int, width: int, init):
        super().__init__()
        self.embedding = nn.Parameter(init(num_classes, width))

    def forward(self, y):
        return self.embedding[y]


def _normal_table(num_classes: int, width: int):
    return _normal_(torch.empty(num_classes, width))


def _affine_table(features: int, bias: bool):
    """The init of :func:`_class_affine`'s table: gains uniform in [0, 1),
    then (with ``bias``) zero biases."""
    def init(num_classes: int, width: int):
        gain = torch.rand(num_classes, features)
        if not bias:
            return gain
        return torch.cat([gain, torch.zeros(num_classes, features)], dim=-1)
    return init


def _class_affine(features: int, num_classes: int, bias: bool) -> _ClassEmbed:
    return _ClassEmbed(num_classes, (2 if bias else 1) * features,
                       _affine_table(features, bias))


def _apply_class_affine(embed: _ClassEmbed, h, y, bias: bool):
    if bias:
        gamma, beta = embed(y).chunk(2, dim=-1)
        return _per_channel(gamma) * h + _per_channel(beta)
    return _per_channel(embed(y)) * h


class ConditionalBatchNorm2d(nn.Module):
    """Batch statistics (biased) on every call, no running statistics,
    then a per-class affine."""

    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self._ClassEmbed_0 = _class_affine(features, num_classes, bias)

    def forward(self, x, y):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
        h = (x - mean) * torch.rsqrt(var + _EPS)
        return _apply_class_affine(self._ClassEmbed_0, h, y, self.bias)


class ConditionalInstanceNorm2d(nn.Module):
    """Instance norm, then a per-class affine."""

    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self._ClassEmbed_0 = _class_affine(features, num_classes, bias)

    def forward(self, x, y):
        return _apply_class_affine(self._ClassEmbed_0, _instance_norm(x), y,
                                   self.bias)


class ConditionalVarianceNorm2d(nn.Module):
    """x over its spatial std (unbiased) times a per-class gain
    ~ N(1, 0.02)."""

    def __init__(self, features: int, num_classes: int):
        super().__init__()
        self._ClassEmbed_0 = _ClassEmbed(num_classes, features,
                                         _normal_table)

    def forward(self, x, y):
        var = x.var(dim=(2, 3), keepdim=True, unbiased=True)
        h = x * torch.rsqrt(var + _EPS)
        return _per_channel(self._ClassEmbed_0(y)) * h


class ConditionalNoneNorm2d(nn.Module):
    """A per-class affine alone."""

    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias
        self._ClassEmbed_0 = _class_affine(features, num_classes, bias)

    def forward(self, x, y):
        return _apply_class_affine(self._ClassEmbed_0, x, y, self.bias)


class ConditionalInstanceNorm2dPlus(nn.Module):
    """InstanceNorm++ with per-class (gamma, alpha[, beta]): gamma and
    alpha ~ N(1, 0.02), beta 0."""

    def __init__(self, features: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias = bias

        def init(n: int, width: int):
            ga = _normal_table(n, 2 * features)
            return torch.cat([ga, torch.zeros(n, features)], dim=-1) \
                if bias else ga

        self._ClassEmbed_0 = _ClassEmbed(num_classes,
                                         (3 if bias else 2) * features, init)

    def forward(self, x, y):
        means = _per_channel(_plus_stats(x))
        h = _instance_norm(x)
        parts = self._ClassEmbed_0(y).chunk(3 if self.bias else 2, dim=-1)
        gamma, alpha = parts[0], parts[1]
        h = h + means * _per_channel(alpha)
        out = _per_channel(gamma) * h
        if self.bias:
            out = out + _per_channel(parts[2])
        return out


class GroupNorm(GroupNormAct):
    """The ``GroupNorm`` variant: flax ``nn.GroupNorm(min(C // 4, 32),
    epsilon=1e-6)``, which is :class:`GroupNormAct` with no activation
    (``scale`` 1, ``bias`` 0). Its class name is flax's, so a block names
    it ``GroupNorm_<i>`` as flax does.

    On a CUDA tensor it launches the hand-written GroupNorm kernels
    (``csrc/group_norm_fwd.cu``, and ``csrc/group_norm_bwd.cu`` for its
    gradient) where they take the shape (``ops.group_norm_fits``: C <=
    1024 with C a multiple of the group count and a slice of whole groups
    that is a multiple of 16 bytes); elsewhere (C > 1024, or bf16 at C =
    4 or 12, which has no such slice) it runs the plain version, chosen by
    shape before any launch, as the JAX package's GroupNorm runs its jnp
    chain. A CPU tensor runs the plain version."""

    def __init__(self, features: int):
        super().__init__(features, "none", 1e-6)


def get_normalization(config, conditional: bool = False):
    """The factory of ``config.model.normalization``; each takes the
    channel count (``features``), as the JAX package's do."""
    norm = config.model.normalization
    if conditional:
        if norm == "InstanceNorm++":
            return partial(ConditionalInstanceNorm2dPlus,
                           num_classes=config.model.num_classes)
        raise NotImplementedError(f"{norm} not implemented yet.")
    if norm == "InstanceNorm":
        return InstanceNorm2d
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        return GroupNorm
    raise ValueError(f"Unknown normalization: {norm}")
