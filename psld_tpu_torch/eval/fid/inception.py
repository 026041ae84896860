"""InceptionV3, the FID variant, as an ``nn.Module``
(``psld_tpu/eval/fid/inception.py``).

The pool3-feature graph of pytorch-fid / torch-fidelity (the TF-ported
``pt_inception-2015-12-05`` network): torchvision's InceptionV3 wiring
with the FID changes, average pools that exclude the padding
(``count_include_pad=False``) and a max pool in the pool branch of the
last block (Mixed_7c). BatchNorm (eps 1e-3) is folded into each
convolution's weight and bias when a checkpoint loads, so the forward is
convolution + bias + ReLU, in float32 and NCHW.

Parameters are a state_dict: ``<name>.weight`` (O, I, kh, kw) and
``<name>.bias`` for every convolution of :func:`all_conv_specs`, named as
in the torch checkpoint without its ``.conv``, and ``fc.weight`` (1008,
2048) and ``fc.bias`` for the logits head the Inception Score reads.
They come from the checkpoint (:func:`load_torch_checkpoint`), from a
generator (:func:`random_params`: the pipeline's smoke, whose values mean
nothing) or from the JAX package's params
(``psld_tpu_torch.interop.from_flax.inception_state_dict``).

Convolutions on the card run with TF32 off (``cudnn.flags``, scoped to
the feature extractor): the JAX package's features are float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FID_DIM = 2048
N_LOGITS = 1008  # the TF-ported head: 1000 classes + 8 legacy units
BN_EPS = 1e-3


# every convolution: name -> (in_ch, out_ch, (kh, kw), stride, padding)

def _stem_spec():
    return {
        "Conv2d_1a_3x3": (3, 32, (3, 3), 2, (0, 0)),
        "Conv2d_2a_3x3": (32, 32, (3, 3), 1, (0, 0)),
        "Conv2d_2b_3x3": (32, 64, (3, 3), 1, (1, 1)),
        "Conv2d_3b_1x1": (64, 80, (1, 1), 1, (0, 0)),
        "Conv2d_4a_3x3": (80, 192, (3, 3), 1, (0, 0)),
    }


def _a_spec(prefix, in_ch, pool_features):
    return {
        f"{prefix}.branch1x1": (in_ch, 64, (1, 1), 1, (0, 0)),
        f"{prefix}.branch5x5_1": (in_ch, 48, (1, 1), 1, (0, 0)),
        f"{prefix}.branch5x5_2": (48, 64, (5, 5), 1, (2, 2)),
        f"{prefix}.branch3x3dbl_1": (in_ch, 64, (1, 1), 1, (0, 0)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3), 1, (1, 1)),
        f"{prefix}.branch_pool": (in_ch, pool_features, (1, 1), 1, (0, 0)),
    }


def _b_spec(prefix, in_ch):
    return {
        f"{prefix}.branch3x3": (in_ch, 384, (3, 3), 2, (0, 0)),
        f"{prefix}.branch3x3dbl_1": (in_ch, 64, (1, 1), 1, (0, 0)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3), 2, (0, 0)),
    }


def _c_spec(prefix, in_ch, c7):
    return {
        f"{prefix}.branch1x1": (in_ch, 192, (1, 1), 1, (0, 0)),
        f"{prefix}.branch7x7_1": (in_ch, c7, (1, 1), 1, (0, 0)),
        f"{prefix}.branch7x7_2": (c7, c7, (1, 7), 1, (0, 3)),
        f"{prefix}.branch7x7_3": (c7, 192, (7, 1), 1, (3, 0)),
        f"{prefix}.branch7x7dbl_1": (in_ch, c7, (1, 1), 1, (0, 0)),
        f"{prefix}.branch7x7dbl_2": (c7, c7, (7, 1), 1, (3, 0)),
        f"{prefix}.branch7x7dbl_3": (c7, c7, (1, 7), 1, (0, 3)),
        f"{prefix}.branch7x7dbl_4": (c7, c7, (7, 1), 1, (3, 0)),
        f"{prefix}.branch7x7dbl_5": (c7, 192, (1, 7), 1, (0, 3)),
        f"{prefix}.branch_pool": (in_ch, 192, (1, 1), 1, (0, 0)),
    }


def _d_spec(prefix, in_ch):
    return {
        f"{prefix}.branch3x3_1": (in_ch, 192, (1, 1), 1, (0, 0)),
        f"{prefix}.branch3x3_2": (192, 320, (3, 3), 2, (0, 0)),
        f"{prefix}.branch7x7x3_1": (in_ch, 192, (1, 1), 1, (0, 0)),
        f"{prefix}.branch7x7x3_2": (192, 192, (1, 7), 1, (0, 3)),
        f"{prefix}.branch7x7x3_3": (192, 192, (7, 1), 1, (3, 0)),
        f"{prefix}.branch7x7x3_4": (192, 192, (3, 3), 2, (0, 0)),
    }


def _e_spec(prefix, in_ch):
    return {
        f"{prefix}.branch1x1": (in_ch, 320, (1, 1), 1, (0, 0)),
        f"{prefix}.branch3x3_1": (in_ch, 384, (1, 1), 1, (0, 0)),
        f"{prefix}.branch3x3_2a": (384, 384, (1, 3), 1, (0, 1)),
        f"{prefix}.branch3x3_2b": (384, 384, (3, 1), 1, (1, 0)),
        f"{prefix}.branch3x3dbl_1": (in_ch, 448, (1, 1), 1, (0, 0)),
        f"{prefix}.branch3x3dbl_2": (448, 384, (3, 3), 1, (1, 1)),
        f"{prefix}.branch3x3dbl_3a": (384, 384, (1, 3), 1, (0, 1)),
        f"{prefix}.branch3x3dbl_3b": (384, 384, (3, 1), 1, (1, 0)),
        f"{prefix}.branch_pool": (in_ch, 192, (1, 1), 1, (0, 0)),
    }


def all_conv_specs() -> dict:
    specs = _stem_spec()
    specs.update(_a_spec("Mixed_5b", 192, 32))
    specs.update(_a_spec("Mixed_5c", 256, 64))
    specs.update(_a_spec("Mixed_5d", 288, 64))
    specs.update(_b_spec("Mixed_6a", 288))
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        specs.update(_c_spec(name, 768, c7))
    specs.update(_d_spec("Mixed_7a", 768))
    specs.update(_e_spec("Mixed_7b", 1280))
    specs.update(_e_spec("Mixed_7c", 2048))
    return specs


def random_params(generator: torch.Generator, with_fc: bool = False) -> dict:
    """Folded parameters drawn from ``generator`` (on the CPU): weights
    N(0, 1/fan_in), biases zero; the pipeline's smoke, not a metric."""
    params = {}
    for name, (i, o, (kh, kw), _, _) in all_conv_specs().items():
        params[f"{name}.weight"] = torch.randn(
            (o, i, kh, kw), generator=generator) / math.sqrt(i * kh * kw)
        params[f"{name}.bias"] = torch.zeros(o)
    if with_fc:
        params["fc.weight"] = torch.randn(
            (N_LOGITS, FID_DIM), generator=generator) / math.sqrt(FID_DIM)
        params["fc.bias"] = torch.zeros(N_LOGITS)
    return params


def load_torch_checkpoint(path: str) -> dict:
    """``pt_inception-2015-12-05-*.pth`` with BatchNorm folded into each
    convolution: ``<name>.conv.weight`` and ``<name>.bn.{weight, bias,
    running_mean, running_var}`` become ``<name>.weight`` and
    ``<name>.bias``, in float32 as the JAX package folds them; ``fc.*``
    (the logits head) is kept where the file has it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {}
    for name, (i, o, (kh, kw), _, _) in all_conv_specs().items():
        w = sd[f"{name}.conv.weight"].float()
        if tuple(w.shape) != (o, i, kh, kw):
            raise ValueError(f"{name}: weight {tuple(w.shape)}, expected "
                             f"{(o, i, kh, kw)}")
        inv_std = sd[f"{name}.bn.weight"].float() / torch.sqrt(
            sd[f"{name}.bn.running_var"].float() + BN_EPS)
        params[f"{name}.weight"] = w * inv_std[:, None, None, None]
        params[f"{name}.bias"] = sd[f"{name}.bn.bias"].float() \
            - sd[f"{name}.bn.running_mean"].float() * inv_std
    if "fc.weight" in sd:
        if tuple(sd["fc.weight"].shape) != (N_LOGITS, FID_DIM):
            raise ValueError(f"fc.weight {tuple(sd['fc.weight'].shape)}")
        params["fc.weight"] = sd["fc.weight"].float()
        params["fc.bias"] = sd["fc.bias"].float()
    return params


def _maxpool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)


def _avgpool_nocountpad(x):
    """3x3 average pool, stride 1, padding 1, the padding not counted
    (the FID change)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class FIDInception(nn.Module):
    """The folded graph: one ``nn.Conv2d`` with bias a convolution of
    :func:`all_conv_specs`, at the checkpoint's module path, and an
    ``fc`` head when ``with_fc``."""

    def __init__(self, with_fc: bool = False):
        super().__init__()
        for name, (i, o, k, s, p) in all_conv_specs().items():
            parent = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(parent, part):
                    parent.add_module(part, nn.Module())
                parent = getattr(parent, part)
            parent.add_module(leaf, nn.Conv2d(i, o, k, stride=s, padding=p))
        self.fc = nn.Linear(FID_DIM, N_LOGITS) if with_fc else None

    @classmethod
    def from_params(cls, params: dict, device="cuda") -> "FIDInception":
        """The network of ``params`` (strict), frozen, on ``device``."""
        net = cls(with_fc="fc.weight" in params)
        net.load_state_dict(params, strict=True)
        return net.eval().requires_grad_(False).to(device)

    def _conv(self, name, x):
        return F.relu(self.get_submodule(name)(x))

    def _chain(self, prefix, suffixes, x):
        for suffix in suffixes:
            x = self._conv(f"{prefix}.{suffix}", x)
        return x

    def _block_a(self, p, x):
        return torch.cat([
            self._conv(f"{p}.branch1x1", x),
            self._chain(p, ("branch5x5_1", "branch5x5_2"), x),
            self._chain(p, ("branch3x3dbl_1", "branch3x3dbl_2",
                            "branch3x3dbl_3"), x),
            self._conv(f"{p}.branch_pool", _avgpool_nocountpad(x))], dim=1)

    def _block_b(self, p, x):
        return torch.cat([
            self._conv(f"{p}.branch3x3", x),
            self._chain(p, ("branch3x3dbl_1", "branch3x3dbl_2",
                            "branch3x3dbl_3"), x),
            _maxpool(x)], dim=1)

    def _block_c(self, p, x):
        return torch.cat([
            self._conv(f"{p}.branch1x1", x),
            self._chain(p, [f"branch7x7_{i}" for i in (1, 2, 3)], x),
            self._chain(p, [f"branch7x7dbl_{i}" for i in (1, 2, 3, 4, 5)],
                        x),
            self._conv(f"{p}.branch_pool", _avgpool_nocountpad(x))], dim=1)

    def _block_d(self, p, x):
        return torch.cat([
            self._chain(p, ("branch3x3_1", "branch3x3_2"), x),
            self._chain(p, [f"branch7x7x3_{i}" for i in (1, 2, 3, 4)], x),
            _maxpool(x)], dim=1)

    def _block_e(self, p, x, pool: str):
        b3 = self._conv(f"{p}.branch3x3_1", x)
        bd = self._chain(p, ("branch3x3dbl_1", "branch3x3dbl_2"), x)
        # Mixed_7c's pool branch is a max pool in the FID graph
        bp = _avgpool_nocountpad(x) if pool == "avg" \
            else _maxpool(x, k=3, s=1, pad=1)
        return torch.cat([
            self._conv(f"{p}.branch1x1", x),
            self._conv(f"{p}.branch3x3_2a", b3),
            self._conv(f"{p}.branch3x3_2b", b3),
            self._conv(f"{p}.branch3x3dbl_3a", bd),
            self._conv(f"{p}.branch3x3dbl_3b", bd),
            self._conv(f"{p}.branch_pool", bp)], dim=1)

    def forward(self, x):
        """NCHW float32 in [-1, 1] at 299 x 299 (or any size the stem
        takes) -> [N, 2048] pool3 features."""
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = self._conv(name, x)
        x = _maxpool(x)
        x = self._conv("Conv2d_3b_1x1", x)
        x = self._conv("Conv2d_4a_3x3", x)
        x = _maxpool(x)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(p, x)
        x = self._block_b("Mixed_6a", x)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(p, x)
        x = self._block_d("Mixed_7a", x)
        x = self._block_e("Mixed_7b", x, pool="avg")
        x = self._block_e("Mixed_7c", x, pool="max")
        return x.mean(dim=(2, 3))


def _f32_convolutions():
    """cuDNN without TF32 for the scope, its other flags as they are
    (``cudnn.flags`` resets every flag it is not given)."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


def extract_features(net: FIDInception, images,
                     resize: bool = True) -> torch.Tensor:
    """NHWC float images in [0, 1] (a tensor or an array) -> [N, 2048]
    float32 pool3 features on ``net``'s device. As pytorch-fid: bilinear
    resize to 299 x 299 (half-pixel centres, no antialias), then x ->
    2x - 1."""
    device = next(net.parameters()).device
    x = torch.as_tensor(images).to(device, torch.float32).permute(0, 3, 1, 2)
    with torch.no_grad(), _f32_convolutions():
        if resize and tuple(x.shape[2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
        x = (2.0 * x - 1.0).contiguous(memory_format=torch.channels_last)
        return net(x)


def logits_from_features(net: FIDInception, feats: torch.Tensor,
                         unbiased: bool = True) -> torch.Tensor:
    """[N, 2048] pool3 features -> [N, 1008] logits. torch-fidelity's
    Inception Score reads ``logits_unbiased``: the fc product without its
    bias (``unbiased=True``)."""
    if net.fc is None:
        raise ValueError(
            "the parameters have no fc head (fc.weight/fc.bias): the "
            "Inception Score needs the full pt_inception-2015-12-05 "
            "state_dict")
    with torch.no_grad():
        return F.linear(feats, net.fc.weight,
                        None if unbiased else net.fc.bias)


def make_feature_fn(net: FIDInception):
    """images (NHWC in [0, 1]) -> pool3 features as a float32 array."""
    return lambda images: extract_features(net, images).cpu().numpy()


def make_feature_logits_fn(net: FIDInception):
    """images -> (pool3 features [N, 2048], logits [N, 1008]) as float32
    arrays."""
    def fn(images):
        feats = extract_features(net, images)
        return (feats.cpu().numpy(),
                logits_from_features(net, feats).cpu().numpy())

    return fn
