"""NCSN++ score network, plain float32 (Song et al., "Score-Based
Generative Modeling through Stochastic Differential Equations", ICLR 2021;
``models/ncsnpp.py`` and ``models/layerspp.py`` of yang-song/score_sde),
written as one function of a flat parameter dict.

Only the BigGAN residual block is written: every configuration of the
benchmark uses it. Parameters are named as the flax module tree names
them (the k-th module of class ``Cls`` created in a parent is ``Cls_k``),
convolutions OIHW, dense layers (out, in), so that one dict of seeded
weights fits this network and the program's. Activations are NCHW here;
the network takes and returns NHWC, as the published model does.

The FIR resamplers are StyleGAN2's ``upfirdn2d``: zero-stuff by ``up``
(trailing zeros kept), pad, true convolution with the kernel, keep every
``down``-th sample. A transposed convolution is written as the
cross-correlation of the zero-stuffed input padded by the kernel's
reach.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.ops import Float32, stuff as _stuff

SQRT2 = math.sqrt(2.0)


def _fir_kernel(taps) -> np.ndarray:
    k = np.asarray(taps, dtype=np.float64)
    k = np.outer(k, k)
    return k / k.sum()


def _pad(x, p0: int, p1: int):
    return F.pad(x, (p0, p1, p0, p1))


class NCSNpp:
    """The network of a configuration's ``model`` block (the keys of the
    published config: ``nf``, ``ch_mult``, ``num_res_blocks``, ...) at
    ``image_size``. ``shapes`` lists every parameter in creation order."""

    def __init__(self, model: dict, image_size: int):
        if str(model["resblock_type"]).lower() != "biggan":
            raise NotImplementedError("the reference writes the BigGAN block")
        self.image_size = int(image_size)
        self.in_ch = int(model["in_ch"])
        self.out_ch = int(model.get("out_ch", model["in_ch"]))
        self.nf = int(model["nf"])
        self.ch_mult = [int(v) for v in model["ch_mult"]]
        self.num_res_blocks = int(model["num_res_blocks"])
        self.attn_resolutions = [int(v) for v in model["attn_resolutions"]]
        self.fir = bool(model["fir"])
        self.fir_taps = [float(v) for v in model["fir_kernel"]]
        self.skip_rescale = bool(model["skip_rescale"])
        self.progressive = str(model["progressive"]).lower()
        self.progressive_input = str(model["progressive_input"]).lower()
        self.combine = str(model["progressive_combine"]).lower()
        self.embedding_type = str(model["embedding_type"]).lower()
        self.noise_cond = bool(model["noise_cond"])
        if str(model["nonlinearity"]).lower() != "swish":
            raise NotImplementedError("the reference writes swish")
        if not self.fir or not bool(model["resamp_with_conv"]):
            raise NotImplementedError("the reference writes FIR resampling")
        if self.combine != "sum" and self.progressive_input == "input_skip":
            raise NotImplementedError("the reference writes combine=sum")
        self.levels = len(self.ch_mult)
        self.resolutions = [self.image_size // 2 ** i
                            for i in range(self.levels)]
        self.shapes: dict[str, tuple] = {}
        self._n = Counter()
        self._build()

    # -- parameters, in the published model's creation order ---------------
    def _module(self, kind: str, params: dict) -> None:
        name = f"{kind}_{self._n[kind]}"
        self._n[kind] += 1
        for key, shape in params.items():
            self.shapes[f"{name}.{key}"] = tuple(shape)

    @staticmethod
    def _conv(i, o, k):
        return {"weight": (o, i, k, k), "bias": (o,)}

    def _block(self, i, o=None, updown=False):
        o = o or i
        p = {"GroupNormAct_0.scale": (i,), "GroupNormAct_0.bias": (i,)}
        p.update({f"Conv_0.{k}": s for k, s in self._conv(i, o, 3).items()})
        if self.noise_cond:
            p.update({"Dense_0.weight": (o, 4 * self.nf),
                      "Dense_0.bias": (o,)})
        p.update({"GroupNormAct_1.scale": (o,), "GroupNormAct_1.bias": (o,)})
        p.update({f"Conv_1.{k}": s for k, s in self._conv(o, o, 3).items()})
        if i != o or updown:
            p.update({f"Conv_2.{k}": s
                      for k, s in self._conv(i, o, 1).items()})
        self._module("ResnetBlockBigGAN", p)
        return o

    def _attn(self, c):
        p = {"GroupNormAct_0.scale": (c,), "GroupNormAct_0.bias": (c,)}
        for j in range(4):
            p[f"NIN_{j}.Dense_0.weight"] = (c, c)
            p[f"NIN_{j}.Dense_0.bias"] = (c,)
        self._module("AttnBlock", p)

    def _build(self):
        nf = self.nf
        if self.embedding_type == "fourier":
            self._module("GaussianFourierProjection", {"W": (nf,)})
            emb = 2 * nf
        else:
            emb = nf
        if self.noise_cond:
            self._module("Dense", {"weight": (4 * nf, emb), "bias": (4 * nf,)})
            self._module("Dense", {"weight": (4 * nf, 4 * nf),
                                   "bias": (4 * nf,)})
        self._module("Conv", self._conv(self.in_ch, nf, 3))
        hs_c, pyr_c = [nf], self.in_ch
        for lvl in range(self.levels):
            out = nf * self.ch_mult[lvl]
            for _ in range(self.num_res_blocks):
                self._block(hs_c[-1], out)
                if self.resolutions[lvl] in self.attn_resolutions:
                    self._attn(out)
                hs_c.append(out)
            if lvl == self.levels - 1:
                continue
            c = hs_c[-1]
            self._block(c, updown=True)
            if self.progressive_input == "input_skip":
                self._module("Downsample", {})
                self._module("Combine", {f"Conv_0.{k}": s for k, s in
                                         self._conv(pyr_c, c, 1).items()})
            elif self.progressive_input == "residual":
                self._module("Downsample", {f"FIRConv2d_0.{k}": s for k, s in
                                            self._conv(pyr_c, c, 3).items()})
                pyr_c = c
            hs_c.append(c)
        c = hs_c[-1]
        self._block(c)
        self._attn(c)
        self._block(c)
        h_c, pyr_c = c, None
        for lvl in reversed(range(self.levels)):
            out = nf * self.ch_mult[lvl]
            for _ in range(self.num_res_blocks + 1):
                h_c = self._block(h_c + hs_c.pop(), out)
            if self.resolutions[lvl] in self.attn_resolutions:
                self._attn(h_c)
            if self.progressive != "none":
                gn = {"scale": (h_c,), "bias": (h_c,)}
                if lvl == self.levels - 1:
                    self._module("GroupNormAct", gn)
                    pyr_c = self.out_ch if self.progressive == "output_skip" \
                        else h_c
                    self._module("Conv", self._conv(h_c, pyr_c, 3))
                elif self.progressive == "output_skip":
                    self._module("Upsample", {})
                    self._module("GroupNormAct", gn)
                    self._module("Conv", self._conv(h_c, self.out_ch, 3))
                else:
                    self._module("Upsample", {
                        f"FIRConv2d_0.{k}": s
                        for k, s in self._conv(pyr_c, h_c, 3).items()})
                    pyr_c = h_c
            if lvl != 0:
                self._block(h_c, updown=True)
        if self.progressive != "output_skip":
            self._module("GroupNormAct", {"scale": (h_c,), "bias": (h_c,)})
            self._module("Conv", self._conv(h_c, self.out_ch, 3))

    # -- forward -------------------------------------------------------------
    def __call__(self, p: dict, x, t, ops=None):
        """NHWC ``x`` (B, H, W, in_ch), noise level ``t`` (B,) -> NHWC
        (B, H, W, out_ch), all float32 (``ops`` picks the arithmetic)."""
        return _Forward(self, p, ops or Float32())(x, t)


class _Forward:
    def __init__(self, net: NCSNpp, p: dict, ops):
        self.net, self.p, self.ops = net, p, ops
        self.n = Counter()
        k = _fir_kernel(net.fir_taps)
        dev = next(iter(p.values())).device
        # upfirdn takes the kernel flipped for its true convolution
        self.k_down = torch.tensor(k[::-1, ::-1].copy(), dtype=torch.float32,
                                   device=dev)
        self.k_up = self.k_down * 4.0

    def name(self, kind):
        i = self.n[kind]
        self.n[kind] += 1
        return f"{kind}_{i}"

    def w(self, name):
        return self.p[name]

    # layers
    def conv(self, name, x, stride=1, padding=1, first=False):
        return self.ops.conv2d(x, self.w(name + ".weight"),
                               self.w(name + ".bias"), stride, padding, first)

    def dense(self, name, x):
        return self.ops.linear(x, self.w(name + ".weight"),
                               self.w(name + ".bias"))

    def gn(self, name, x, act=True):
        c = x.shape[1]
        y = self.ops.group_norm(x, self.w(name + ".scale"),
                                self.w(name + ".bias"), min(c // 4, 32), 1e-6)
        return F.silu(y) if act else y

    def up(self, x):
        """upfirdn2d(up=2, pad=(2, 1)) with the kernel times 4."""
        return self.ops.depthwise(_pad(_stuff(x, 2), 2, 1), self.k_up, up=2)

    def down(self, x):
        """upfirdn2d(down=2, pad=(1, 1))."""
        return self.ops.depthwise(_pad(x, 1, 1), self.k_down, stride=2)

    def conv_down(self, name, x):
        """FIR (pad (2, 2)), then a stride-2 VALID 3x3 convolution."""
        y = self.ops.depthwise(_pad(x, 2, 2), self.k_down)
        return self.conv(name, y, stride=2, padding=0)

    def up_conv(self, name, x):
        """Stride-2 transposed 3x3 convolution, then FIR (pad (1, 1))."""
        y = self.ops.conv_transpose2x(x, self.w(name + ".weight"))
        y = self.ops.depthwise(_pad(y, 1, 1), self.k_up)
        return y + self.w(name + ".bias")[None, :, None, None]

    def block(self, x, temb, up=False, down=False):
        name = self.name("ResnetBlockBigGAN")
        h = self.gn(name + ".GroupNormAct_0", x)
        if up:
            h, x = self.up(h), self.up(x)
        elif down:
            h, x = self.down(h), self.down(x)
        h = self.conv(name + ".Conv_0", h)
        if temb is not None:
            h = h + self.dense(name + ".Dense_0", F.silu(temb))[:, :, None,
                                                                 None]
        h = self.gn(name + ".GroupNormAct_1", h)
        h = self.conv(name + ".Conv_1", h)
        if name + ".Conv_2.weight" in self.p:
            x = self.conv(name + ".Conv_2", x, padding=0)
        out = x + h
        return out / SQRT2 if self.net.skip_rescale else out

    def attn(self, x):
        name = self.name("AttnBlock")
        b, c, hh, ww = x.shape
        h = self.gn(name + ".GroupNormAct_0", x, act=False)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = (self.dense(f"{name}.NIN_{j}.Dense_0", h) for j in range(3))
        s = self.ops.bmm(q, k.transpose(1, 2)) * (float(c) ** -0.5)
        o = self.ops.bmm(torch.softmax(s, dim=-1), v)
        o = self.dense(f"{name}.NIN_3.Dense_0", o)
        o = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        out = x + o
        return out / SQRT2 if self.net.skip_rescale else out

    def temb(self, t):
        net = self.net
        if net.embedding_type == "fourier":
            w = self.w(self.name("GaussianFourierProjection") + ".W")
            proj = torch.log(t)[:, None] * w[None, :] * (2 * math.pi)
            emb = torch.cat([torch.sin(proj), torch.cos(proj)], dim=1)
        else:
            half = net.nf // 2
            freq = torch.exp(torch.arange(half, dtype=torch.float32,
                                          device=t.device)
                             * -(math.log(10_000) / (half - 1)))
            arg = t.float()[:, None] * freq[None, :]
            emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)
        if not net.noise_cond:
            return None
        emb = self.dense(self.name("Dense"), emb)
        return self.dense(self.name("Dense"), F.silu(emb))

    def __call__(self, x, t):
        net = self.net
        x = x.permute(0, 3, 1, 2)
        temb = self.temb(t)
        pyramid = x
        hs = [self.conv(self.name("Conv"), x, first=True)]
        for lvl in range(net.levels):
            for _ in range(net.num_res_blocks):
                h = self.block(hs[-1], temb)
                if net.resolutions[lvl] in net.attn_resolutions:
                    h = self.attn(h)
                hs.append(h)
            if lvl == net.levels - 1:
                continue
            h = self.block(hs[-1], temb, down=True)
            if net.progressive_input == "input_skip":
                self.name("Downsample")
                pyramid = self.down(pyramid)
                h = self.conv(self.name("Combine") + ".Conv_0", pyramid,
                              padding=0) + h
            elif net.progressive_input == "residual":
                pyramid = self.conv_down(self.name("Downsample")
                                         + ".FIRConv2d_0", pyramid)
                pyramid = (pyramid + h) / SQRT2 if net.skip_rescale \
                    else pyramid + h
                h = pyramid
            hs.append(h)
        h = self.block(hs[-1], temb)
        h = self.attn(h)
        h = self.block(h, temb)
        pyramid = None
        for lvl in reversed(range(net.levels)):
            for _ in range(net.num_res_blocks + 1):
                h = self.block(torch.cat([h, hs.pop()], dim=1), temb)
            if net.resolutions[lvl] in net.attn_resolutions:
                h = self.attn(h)
            if net.progressive != "none":
                if lvl == net.levels - 1:
                    g = self.gn(self.name("GroupNormAct"), h)
                    pyramid = self.conv(self.name("Conv"), g)
                elif net.progressive == "output_skip":
                    self.name("Upsample")
                    pyramid = self.up(pyramid)
                    g = self.gn(self.name("GroupNormAct"), h)
                    pyramid = pyramid + self.conv(self.name("Conv"), g)
                else:
                    pyramid = self.up_conv(self.name("Upsample")
                                           + ".FIRConv2d_0", pyramid)
                    pyramid = (pyramid + h) / SQRT2 if net.skip_rescale \
                        else pyramid + h
                    h = pyramid
            if lvl != 0:
                h = self.block(h, temb, up=True)
        if net.progressive == "output_skip":
            h = pyramid
        else:
            g = self.gn(self.name("GroupNormAct"), h)
            h = self.conv(self.name("Conv"), g)
        return h.permute(0, 2, 3, 1)
