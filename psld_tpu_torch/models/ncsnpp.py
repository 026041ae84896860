"""NCSN++ score U-Net and its noise-conditional classifier
(``psld_tpu/models/ncsnpp.py::NCSNpp``, ``NCSNppClassifier``).

``forward`` takes NHWC ``x`` and returns NHWC, as the JAX module does;
inside, activations are NCHW-logical in ``channels_last`` memory, so both
ends are free permutes. For PSLD, in_ch = out_ch = 2 * num_channels
(x || m on the channel axis).

Submodules carry flax's auto-names: the k-th submodule of class ``Cls``
created in a parent is ``Cls_k``. ``__init__`` creates them in the order
the flax ``__call__`` does, and ``forward`` walks the same order, taking
the next module of each class; that is what lets a flax param tree map
onto this module by path (:mod:`psld_tpu_torch.interop.from_flax`).

``remat=True`` recomputes each resblock's activations in the backward
pass (``torch.utils.checkpoint``, one block at a time, as the JAX
package's per-resblock ``nn.remat``): a memory lever that leaves the
loss and the gradients as they are. The recompute runs on the tensors
the first call ran on and draws the same dropout mask: the hash
implementations take the same site's seed words, ``save_mask`` replays
its generator from the state it had (the default generators, where no
generator is given, through ``preserve_rng_state``). ``scan_blocks`` is
accepted and ignored: it changes only how XLA compiles the JAX model,
not what it computes.

``forward(..., train=True)`` drops with rate ``dropout`` once in every
resblock (``dropout_impl``: see :class:`layers.DropoutSites`). The sites
are numbered in call order, ``dropout_sites`` in all; with the hash
implementations site ``i`` takes ``dropout_seeds[i]``. Eval-mode dropout
is the identity.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from psld_tpu_torch import knobs
from psld_tpu_torch.models import layers
from psld_tpu_torch.parallel import distributed, spatial
from psld_tpu_torch.registry import register_module

SQRT2 = layers.SQRT2


def _kwargs_of(fn, image_size: int) -> dict:
    """Constructor kwargs of the shared trunk from a ``score_fn`` or
    ``clf_fn`` config node."""
    return dict(
        image_size=int(image_size),
        in_ch=int(fn.in_ch),
        nonlinearity=str(fn.nonlinearity),
        nf=int(fn.nf),
        ch_mult=tuple(fn.ch_mult),
        num_res_blocks=int(fn.num_res_blocks),
        attn_resolutions=tuple(fn.attn_resolutions),
        dropout=float(fn.dropout),
        resamp_with_conv=bool(fn.resamp_with_conv),
        noise_cond=bool(fn.noise_cond),
        fir=bool(fn.fir),
        fir_kernel=tuple(fn.fir_kernel),
        skip_rescale=bool(fn.skip_rescale),
        resblock_type=str(fn.resblock_type).lower(),
        progressive=str(fn.progressive).lower(),
        progressive_input=str(fn.progressive_input).lower(),
        progressive_combine=str(fn.progressive_combine).lower(),
        embedding_type=str(fn.embedding_type).lower(),
        init_scale=float(fn.init_scale),
        fourier_scale=float(fn.fourier_scale),
        remat=bool(fn.get("remat", False)),
        scan_blocks=bool(fn.get("scan_blocks", False)),
        dropout_impl=str(fn.get("dropout_impl", "save_mask")),
    )


def _model_kwargs(config) -> dict:
    """Constructor kwargs from a diffusion config tree
    (``model.score_fn`` + ``data.image_size``); also latches the knobs."""
    knobs.configure(config)
    sf = config.model.score_fn
    kwargs = _kwargs_of(sf, config.data.image_size)
    kwargs["out_ch"] = int(sf.get("out_ch", sf.in_ch))
    return kwargs


def _model_kwargs_clf(config) -> dict:
    """Constructor kwargs from a classifier config tree (``model.clf_fn``
    + ``data.image_size``); also latches the knobs. ``n_cls: ???`` raises
    until it is set."""
    knobs.configure(config)
    cf = config.model.clf_fn
    kwargs = _kwargs_of(cf, config.data.image_size)
    kwargs["out_ch"] = int(cf.in_ch)
    kwargs["n_cls"] = int(cf.n_cls)
    return kwargs


class _Next:
    """Hands out a parent's submodules in creation order, per class."""

    def __init__(self, parent: nn.Module):
        self.parent = parent
        self.counts: Counter = Counter()

    def __call__(self, kind: str) -> nn.Module:
        i = self.counts[kind]
        self.counts[kind] += 1
        return getattr(self.parent, f"{kind}_{i}")


class _NCSNBase(nn.Module):
    """Shared configuration, time embedding and encoder trunk."""

    def __init__(self, image_size: int = 32, in_ch: int = 6, out_ch: int = 6,
                 nonlinearity: str = "swish", nf: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 4,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.1, resamp_with_conv: bool = True,
                 noise_cond: bool = True, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1),
                 skip_rescale: bool = True, resblock_type: str = "biggan",
                 progressive: str = "none", progressive_input: str = "none",
                 progressive_combine: str = "sum",
                 embedding_type: str = "positional", init_scale: float = 0.0,
                 fourier_scale: float = 16.0, remat: bool = False,
                 scan_blocks: bool = False, dropout_impl: str = "save_mask"):
        super().__init__()
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive {progressive!r}")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input {progressive_input!r}")
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"embedding_type {embedding_type!r}")
        if resblock_type not in ("ddpm", "biggan"):
            raise ValueError(f"resblock_type {resblock_type!r}")
        del scan_blocks
        self.remat = bool(remat)
        self.dropout = float(dropout)
        self.dropout_impl = layers.resolve_dropout_impl(dropout_impl)
        self.init_scale = init_scale
        self.image_size, self.in_ch, self.out_ch = image_size, in_ch, out_ch
        self.act_name = nonlinearity.lower()
        self.act = layers.get_act(self.act_name)
        self.nf = nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.resamp_with_conv = resamp_with_conv
        self.noise_cond = noise_cond
        self.fir = fir
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.ddpm = resblock_type == "ddpm"
        self.block_kind = "ResnetBlockDDPM" if self.ddpm \
            else "ResnetBlockBigGAN"
        self.progressive = progressive
        self.progressive_input = progressive_input
        self.progressive_combine = progressive_combine
        self.embedding_type = embedding_type
        self.fourier_scale = fourier_scale
        self._counts: Counter = Counter()

    @property
    def dropout_sites(self) -> int:
        """Dropout sites of one train-mode forward: one per resblock."""
        return sum(1 for name, _ in self.named_children()
                   if name.startswith(self.block_kind + "_"))

    def _dropout(self, train, dropout_seeds, generator, batch_shard):
        return layers.DropoutSites(self.dropout, self.dropout_impl,
                                   dropout_seeds, generator, batch_shard) \
            if train else None

    def _resblock(self, blk, h, temb, drop):
        """``blk(h, temb, drop)``; under ``remat``, with grad enabled, its
        activations are recomputed in the backward pass instead of kept:
        the recompute runs on the parameters of this call (a
        ``functional_call`` swaps in bf16 copies) and replays its
        dropout."""
        if not (self.remat and torch.is_grad_enabled()):
            return blk(h, temb, drop)
        params = dict(blk.named_parameters())
        point = None if drop is None else drop.replay_point()
        calls = []

        def run(h_, temb_):
            d = drop if not calls or drop is None else drop.replay(point)
            calls.append(1)
            return torch.func.functional_call(blk, params, (h_, temb_, d))

        return torch.utils.checkpoint.checkpoint(
            run, h, temb, use_reentrant=False, preserve_rng_state=True)

    @property
    def all_resolutions(self):
        return [self.image_size // (2**i) for i in range(len(self.ch_mult))]

    # -- construction, in flax's creation order ------------------------------
    def _add(self, module: nn.Module) -> None:
        kind = type(module).__name__
        self.add_module(f"{kind}_{self._counts[kind]}", module)
        self._counts[kind] += 1

    def _block(self, in_ch: int, out_ch: int | None = None,
               up: bool = False, down: bool = False) -> int:
        out_ch = out_ch or in_ch
        temb_dim = 4 * self.nf if self.noise_cond else None
        if self.ddpm:
            blk = layers.ResnetBlockDDPM(
                self.act_name, in_ch, out_ch,
                skip_rescale=self.skip_rescale, temb_dim=temb_dim,
                init_scale=self.init_scale)
        else:
            blk = layers.ResnetBlockBigGAN(
                self.act_name, in_ch, out_ch, up=up, down=down, fir=self.fir,
                fir_kernel=self.fir_kernel, skip_rescale=self.skip_rescale,
                temb_dim=temb_dim, init_scale=self.init_scale)
        self._add(blk)
        return out_ch

    def _attn(self, ch: int) -> None:
        self._add(layers.AttnBlock(ch, skip_rescale=self.skip_rescale,
                                   init_scale=self.init_scale))

    def _build_time_embedding(self) -> None:
        emb_dim = self.nf
        if self.embedding_type == "fourier":
            self._add(layers.GaussianFourierProjection(
                embedding_size=self.nf, scale=self.fourier_scale))
            emb_dim = 2 * self.nf
        if self.noise_cond:
            self._add(layers.Dense(emb_dim, 4 * self.nf))
            self._add(layers.Dense(4 * self.nf, 4 * self.nf))

    def _build_encoder(self) -> list[int]:
        """Creates the down path + middle; returns the skip widths."""
        n_levels = len(self.ch_mult)
        self._add(layers.conv3x3(self.in_ch, self.nf))
        hs_c = [self.nf]
        pyr_c = self.in_ch
        for i_level in range(n_levels):
            out_ch = self.nf * self.ch_mult[i_level]
            with_attn = self.all_resolutions[i_level] in self.attn_resolutions
            for _ in range(self.num_res_blocks):
                self._block(hs_c[-1], out_ch)
                if with_attn:
                    self._attn(out_ch)
                hs_c.append(out_ch)
            if i_level == n_levels - 1:
                continue
            c = hs_c[-1]
            if self.ddpm:
                self._add(layers.Downsample(
                    c, with_conv=self.resamp_with_conv, fir=self.fir,
                    fir_kernel=self.fir_kernel))
            else:
                self._block(c, down=True)
            if self.progressive_input == "input_skip":
                self._add(layers.Downsample(pyr_c, fir=self.fir,
                                            fir_kernel=self.fir_kernel))
                self._add(layers.Combine(pyr_c, c,
                                         method=self.progressive_combine))
                if self.progressive_combine == "cat":
                    c = 2 * c
            elif self.progressive_input == "residual":
                self._add(layers.Downsample(pyr_c, c, with_conv=True,
                                            fir=self.fir,
                                            fir_kernel=self.fir_kernel))
                pyr_c = c
            hs_c.append(c)
        c = hs_c[-1]
        self._block(c)
        self._attn(c)
        self._block(c)
        return hs_c

    # -- forward --------------------------------------------------------------
    def _time_embedding(self, time_cond, nxt):
        if self.embedding_type == "fourier":
            temb = nxt("GaussianFourierProjection")(torch.log(time_cond))
        else:
            temb = layers.get_timestep_embedding(time_cond, self.nf)
        if not self.noise_cond:
            return None
        temb = nxt("Dense")(temb)
        return nxt("Dense")(self.act(temb))

    def _encoder(self, x, temb, nxt, drop=None):
        n_levels = len(self.ch_mult)
        input_pyramid = x
        hs = [nxt("Conv")(x)]
        for i_level in range(n_levels):
            with_attn = self.all_resolutions[i_level] in self.attn_resolutions
            for _ in range(self.num_res_blocks):
                h = self._resblock(nxt(self.block_kind), hs[-1], temb,
                                   drop)
                if with_attn:
                    h = nxt("AttnBlock")(h)
                hs.append(h)
            if i_level == n_levels - 1:
                continue
            if self.ddpm:
                h = nxt("Downsample")(hs[-1])
            else:
                h = self._resblock(nxt(self.block_kind), hs[-1], temb, drop)
            if self.progressive_input == "input_skip":
                input_pyramid = nxt("Downsample")(input_pyramid)
                h = nxt("Combine")(input_pyramid, h)
            elif self.progressive_input == "residual":
                input_pyramid = nxt("Downsample")(input_pyramid)
                input_pyramid = (input_pyramid + h) / SQRT2 \
                    if self.skip_rescale else input_pyramid + h
                h = input_pyramid
            hs.append(h)
        h = self._resblock(nxt(self.block_kind), hs[-1], temb, drop)
        h = nxt("AttnBlock")(h)
        h = self._resblock(nxt(self.block_kind), h, temb, drop)
        return h, hs


@register_module(category="score_fn", name="ncsnpp")
class NCSNpp(_NCSNBase):
    """NCSN++ score network (reference song_sde/ncsnpp.py:35-438)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._build_time_embedding()
        hs_c = self._build_encoder()
        n_levels = len(self.ch_mult)
        h_c = hs_c[-1]
        pyr_c = None
        for i_level in reversed(range(n_levels)):
            out_ch = self.nf * self.ch_mult[i_level]
            for _ in range(self.num_res_blocks + 1):
                h_c = self._block(h_c + hs_c.pop(), out_ch)
            if self.all_resolutions[i_level] in self.attn_resolutions:
                self._attn(h_c)
            if self.progressive != "none":
                skip = self.progressive == "output_skip"
                if i_level == n_levels - 1:
                    self._add(layers.GroupNormAct(h_c, self.act_name))
                    pyr_c = self.out_ch if skip else h_c
                    self._add(layers.conv3x3(
                        h_c, pyr_c,
                        init_scale=self.init_scale if skip else 1.0))
                elif skip:
                    self._add(layers.Upsample(pyr_c, fir=self.fir,
                                              fir_kernel=self.fir_kernel))
                    self._add(layers.GroupNormAct(h_c, self.act_name))
                    self._add(layers.conv3x3(h_c, self.out_ch,
                                             init_scale=self.init_scale))
                else:
                    self._add(layers.Upsample(pyr_c, h_c, with_conv=True,
                                              fir=self.fir,
                                              fir_kernel=self.fir_kernel))
                    pyr_c = h_c
            if i_level != 0:
                if self.ddpm:
                    self._add(layers.Upsample(
                        h_c, with_conv=self.resamp_with_conv, fir=self.fir,
                        fir_kernel=self.fir_kernel))
                else:
                    self._block(h_c, up=True)
        assert not hs_c
        if self.progressive != "output_skip":
            self._add(layers.GroupNormAct(h_c, self.act_name))
            self._add(layers.conv3x3(h_c, self.out_ch,
                                     init_scale=self.init_scale))
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, config) -> "NCSNpp":
        return cls(**_model_kwargs(config))

    def forward(self, x, time_cond, train: bool = False, dropout_seeds=None,
                generator=None, batch_shard=(0, 1)):
        """NHWC ``x`` (B, H, W, in_ch), noise level ``time_cond`` (B,) ->
        NHWC (B, H, W, out_ch). ``train=True`` turns dropout on:
        ``dropout_seeds`` holds one tuple of uint32 words per site for the
        hash implementations, ``generator`` draws the masks of the
        others; ``batch_shard`` (index, count) places ``x`` in a global
        batch (:class:`layers.DropoutSites`)."""
        drop = self._dropout(train, dropout_seeds, generator, batch_shard)
        nxt = _Next(self)
        n_levels = len(self.ch_mult)
        h = x.permute(0, 3, 1, 2)
        temb = self._time_embedding(time_cond, nxt)
        if temb is not None and temb.dtype != h.dtype:
            temb = temb.to(h.dtype)
        h, hs = self._encoder(h, temb, nxt, drop)

        pyramid = None
        for i_level in reversed(range(n_levels)):
            for _ in range(self.num_res_blocks + 1):
                h = self._resblock(nxt(self.block_kind),
                                   torch.cat([h, hs.pop()], dim=1), temb,
                                   drop)
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = nxt("AttnBlock")(h)
            if self.progressive != "none":
                if i_level == n_levels - 1:
                    conv = nxt("Conv")
                    pyramid = conv(nxt("GroupNormAct")(h))
                elif self.progressive == "output_skip":
                    pyramid = nxt("Upsample")(pyramid)
                    conv = nxt("Conv")
                    pyramid = pyramid + conv(nxt("GroupNormAct")(h))
                else:
                    pyramid = nxt("Upsample")(pyramid)
                    pyramid = (pyramid + h) / SQRT2 if self.skip_rescale \
                        else pyramid + h
                    h = pyramid
            if i_level != 0:
                h = nxt("Upsample")(h) if self.ddpm else self._resblock(
                    nxt(self.block_kind), h, temb, drop)
        assert not hs
        if drop is not None:
            drop.close()
        if self.progressive == "output_skip":
            h = pyramid
        else:
            conv = nxt("Conv")
            h = conv(nxt("GroupNormAct")(h))
        return h.permute(0, 2, 3, 1)


@register_module(category="clf_fn", name="ncsnpp_clf")
class NCSNppClassifier(_NCSNBase):
    """Noise-conditional classifier: the NCSN++ encoder trunk with its
    middle block, flattened, then a bias-free ``Dense(n_cls)``.

    The flatten is NHWC's, as in the JAX package (features ordered H, W,
    C), so the NCHW-logical activation is permuted before it: flattening
    it as it stands would order them C, H, W and scramble a converted
    head. Under spatial parallelism a rank's rows meet their columns of
    the head and the logits are summed over the spatial group. ``forward`` returns float logits (B, n_cls)."""

    def __init__(self, n_cls: int = 10, **kwargs):
        super().__init__(**kwargs)
        self.n_cls = int(n_cls)
        self._build_time_embedding()
        hs_c = self._build_encoder()
        res = self.all_resolutions[-1]
        self._add(layers.Dense(hs_c[-1] * res * res, self.n_cls, bias=False))
        self.to(memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, config) -> "NCSNppClassifier":
        return cls(**_model_kwargs_clf(config))

    def forward(self, x, time_cond, train: bool = False, dropout_seeds=None,
                generator=None, batch_shard=(0, 1)):
        """NHWC ``x`` (B, H, W, in_ch), noise level ``time_cond`` (B,) ->
        logits (B, n_cls); ``train`` and the dropout arguments as for
        :class:`NCSNpp`."""
        drop = self._dropout(train, dropout_seeds, generator, batch_shard)
        nxt = _Next(self)
        h = x.permute(0, 3, 1, 2)
        temb = self._time_embedding(time_cond, nxt)
        if temb is not None and temb.dtype != h.dtype:
            temb = temb.to(h.dtype)
        h, _ = self._encoder(h, temb, nxt, drop)
        if drop is not None:
            drop.close()
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        dense = nxt("Dense")
        if not spatial.active():
            return dense(h)
        # this rank's rows of the flattened (H, W, C) features meet their
        # columns of the head; the products sum over the group
        s, sp, _, _ = distributed.spatial_info()
        n = h.shape[1]
        h, w = layers._promote(h, dense.weight)[:2]
        return spatial.group_sum(F.linear(h, w[:, s * n:(s + 1) * n]))
