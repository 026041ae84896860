"""Reference (mandt-lab/PSLD) PyTorch Lightning checkpoints -> the port
(``psld_tpu/train/torch_import.py``).

The reference publishes its pretrained models as Lightning checkpoints
whose NCSN++ lives in a flat ``all_modules`` ModuleList walked with a
cursor (reference ncsnpp.py:168-284, ncsnpp_clf.py:100-196); the
Lightning wrapper stores it under ``score_fn.`` with the EMA copy under
``ema_score_fn.`` (wrapper.py:31), a classifier under ``clf_fn.``
(clf_wrapper.py).

The port's modules carry the flax auto-names (``models/ncsnpp.py``), so
replaying both construction orders -- the reference's ``all_modules``
append order and the flax naming order (one counter per class and
scope) -- maps ``all_modules.{i}`` straight onto the port's top-level
module names. Inside a module, parameters map by layer type:

* Conv2d ``weight`` (O, I, kh, kw) -> Conv / FIRConv2d ``weight``, the
  same layout (a FIR ``Conv2d_k`` becomes ``FIRConv2d_k``);
* Linear ``weight`` (O, I) -> Dense ``weight``, the same layout;
* GroupNorm ``weight`` / ``bias`` -> GroupNormAct ``scale`` / ``bias``
  (a top-level 1-D ``weight`` is a GroupNorm scale);
* NIN ``W`` (in, out) / ``b`` -> ``NIN_k.Dense_0.weight`` (out, in),
  transposed, / ``.bias``;
* GaussianFourierProjection ``W`` -> ``W``;
* the classifier's flatten head (n_cls, C*H*W): torch flattens NCHW
  channel-major (ncsnpp_clf.py:279), the port flattens NHWC, so the
  port's (n_cls, H*W*C) weight is the reference's with its columns
  permuted.

Every result is checked against the model's ``state_dict``: every key,
parameter and buffer, and every shape, or it raises.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import torch

logger = logging.getLogger(__name__)


def _namer():
    counts: dict[str, int] = {}

    def new(cls: str) -> str:
        n = counts.get(cls, 0)
        counts[cls] = n + 1
        return f"{cls}_{n}"

    return new


def _common_walk(kw, new, names):
    """Embedding + encoder trunk, shared by the score net and the classifier
    (reference ncsnpp.py:80-208 / ncsnpp_clf.py:78-190). Appends the flax
    name for each reference ``all_modules`` entry to ``names``; paramless
    flax modules bump their class counter without consuming an entry."""
    resblock = ("ResnetBlockDDPM" if kw["resblock_type"] == "ddpm"
                else "ResnetBlockBigGAN")
    num_res = len(kw["ch_mult"])
    all_res = [kw["image_size"] // (2 ** i) for i in range(num_res)]
    attn_res = set(kw["attn_resolutions"])

    if kw["embedding_type"] == "fourier":
        names.append(new("GaussianFourierProjection"))
    if kw["noise_cond"]:
        names.append(new("Dense"))
        names.append(new("Dense"))
    names.append(new("Conv"))  # input conv3x3

    for i_level in range(num_res):
        for _ in range(kw["num_res_blocks"]):
            names.append(new(resblock))
            if all_res[i_level] in attn_res:
                names.append(new("AttnBlock"))
        if i_level != num_res - 1:
            if kw["resblock_type"] == "ddpm":
                names.append(new("Downsample"))
            else:
                names.append(new(resblock))
            if kw["progressive_input"] == "input_skip":
                new("Downsample")  # paramless pyramid downsample
                names.append(new("Combine"))
            elif kw["progressive_input"] == "residual":
                names.append(new("Downsample"))

    names.append(new(resblock))  # middle
    names.append(new("AttnBlock"))
    names.append(new(resblock))
    return resblock, num_res, all_res, attn_res


def score_module_walk(kw) -> list[str]:
    """The port's top-level module name per ``all_modules`` index for
    NCSNpp (reference ncsnpp.py:168-284; the flax call order)."""
    new = _namer()
    names: list[str] = []
    resblock, num_res, all_res, attn_res = _common_walk(kw, new, names)

    for i_level in reversed(range(num_res)):
        for _ in range(kw["num_res_blocks"] + 1):
            names.append(new(resblock))
        if all_res[i_level] in attn_res:
            names.append(new("AttnBlock"))
        if kw["progressive"] != "none":
            if i_level == num_res - 1:
                names.append(new("GroupNormAct"))
                names.append(new("Conv"))
            elif kw["progressive"] == "output_skip":
                new("Upsample")  # paramless pyramid upsample
                names.append(new("GroupNormAct"))
                names.append(new("Conv"))
            else:  # residual
                names.append(new("Upsample"))
        if i_level != 0:
            if kw["resblock_type"] == "ddpm":
                names.append(new("Upsample"))
            else:
                names.append(new(resblock))

    if kw["progressive"] != "output_skip":
        names.append(new("GroupNormAct"))
        names.append(new("Conv"))
    return names


def clf_module_walk(kw) -> list[str]:
    """Same for NCSNppClassifier: encoder trunk + bias-free flatten head
    (reference ncsnpp_clf.py:78-196)."""
    new = _namer()
    names: list[str] = []
    _common_walk(kw, new, names)
    names.append(new("Dense"))  # flatten head (special-cased in conversion)
    return names


def head_geometry(kw, flat: int) -> tuple[int, int]:
    """(res, ch) of the classifier head's flattened (res, res, ch) map."""
    res = kw["image_size"] // (2 ** (len(kw["ch_mult"]) - 1))
    ch = flat // (res * res)
    if ch * res * res != flat:
        raise ValueError(f"classifier head of {flat} inputs is not a "
                         f"{res} x {res} map")
    return res, ch


def _map_suffix(suffix: str, arr: torch.Tensor):
    """(the port's key inside one module group, converted tensor) for one
    reference parameter."""
    parts = suffix.split(".")
    if len(parts) == 1:
        name = parts[0]
        if name == "W":  # GaussianFourierProjection
            return "W", arr
        if name == "weight":
            if arr.ndim in (2, 4):  # Dense (O, I) / Conv OIHW
                return "weight", arr
            if arr.ndim == 1:  # top-level GroupNorm
                return "scale", arr
        if name == "bias":
            return "bias", arr
        raise ValueError(f"unrecognized parameter `{suffix}`")
    mod, param = parts[0], parts[1]
    if mod.startswith("GroupNorm_"):
        sub = mod.replace("GroupNorm_", "GroupNormAct_")
        return f"{sub}.{'scale' if param == 'weight' else 'bias'}", arr
    if mod.startswith("NIN_"):
        if param == "W":  # (in, out) -> Dense (out, in)
            return f"{mod}.Dense_0.weight", arr.t()
        return f"{mod}.Dense_0.bias", arr
    if mod.startswith("Conv2d_"):  # FIR up_or_down_sampling.Conv2d
        return f"{mod.replace('Conv2d_', 'FIRConv2d_')}.{param}", arr
    if mod.startswith(("Conv_", "Dense_")):
        return f"{mod}.{param}", arr
    raise ValueError(f"unrecognized parameter `{suffix}`")


def _convert(sd: dict, names: list[str], kw,
             clf_head: bool = False) -> dict:
    """A reference ``all_modules.*`` state_dict -> the port's state_dict
    (float32, contiguous)."""
    groups: dict[int, dict[str, torch.Tensor]] = defaultdict(dict)
    for key, val in sd.items():
        if not key.startswith("all_modules."):
            raise ValueError(f"unexpected key `{key}` (not all_modules.*)")
        _, idx, suffix = key.split(".", 2)
        groups[int(idx)][suffix] = torch.as_tensor(val).float()
    if sorted(groups) != list(range(len(names))):
        raise ValueError(
            f"module-count mismatch: checkpoint has {len(groups)} "
            f"all_modules entries, the config implies {len(names)}; check "
            "the model overrides match the checkpoint's training config")

    out: dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        for suffix, arr in groups[i].items():
            if not kw["noise_cond"] and suffix.startswith("Dense_0."):
                # the reference always constructs the temb Dense
                # (temb_dim=nf*4 unconditionally, ncsnpp.py:146,158) but
                # never calls it when noise_cond=False; the port only
                # creates it when used -- drop the dead parameters
                continue
            if clf_head and i == len(names) - 1 and suffix == "weight":
                # flatten-head permutation: torch flattens NCHW
                # channel-major (ncsnpp_clf.py:279), the port NHWC
                n_cls, flat = arr.shape
                res, ch = head_geometry(kw, flat)
                key, arr = "weight", (arr.reshape(n_cls, ch, res, res)
                                      .permute(0, 2, 3, 1)
                                      .reshape(n_cls, flat))
            else:
                key, arr = _map_suffix(suffix, arr)
            full = f"{name}.{key}"
            if full in out:
                raise ValueError(f"two reference parameters map to {full}")
            out[full] = arr.contiguous()
    return out


def verify_state_dict(converted: dict, want: dict) -> None:
    """Raise with a readable diff unless ``converted`` has exactly the
    keys of ``want`` (a model's ``state_dict``: every parameter and
    buffer) with the same shapes."""
    problems = []
    for k in sorted(set(want) - set(converted)):
        problems.append(f"missing: {k} {tuple(want[k].shape)}")
    for k in sorted(set(converted) - set(want)):
        problems.append(f"unexpected: {k} {tuple(converted[k].shape)}")
    for k in sorted(set(converted) & set(want)):
        if tuple(converted[k].shape) != tuple(want[k].shape):
            problems.append(f"shape: {k} got {tuple(converted[k].shape)} "
                            f"want {tuple(want[k].shape)}")
    if problems:
        raise ValueError("converted checkpoint does not match the model:\n"
                         + "\n".join(problems))


def model_state_dict(config, clf: bool = False) -> dict:
    """The state_dict of the config's score network (``clf``: classifier)
    built on the meta device: its keys and shapes, no storage."""
    from psld_tpu_torch.registry import get_module

    import psld_tpu_torch.models  # noqa: F401  (registers the networks)

    fn = config.model.clf_fn if clf else config.model.score_fn
    cls = get_module("clf_fn" if clf else "score_fn", str(fn.name))
    with torch.device("meta"):
        return cls.from_config(config).state_dict()


def load_lightning_state_dict(path: str) -> dict:
    """The tensors of a Lightning checkpoint's ``state_dict`` (or of a
    bare state_dict file), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def convert_score_state_dict(sd: dict, config):
    """A reference Lightning score ``state_dict`` -> (params, ema_params),
    the port's state_dicts, checked against the network of ``config``
    (the diffusion config subtree, whose model overrides must match the
    checkpoint's training config: the walk is config-derived). A bare
    NCSNpp state_dict serves as both."""
    from psld_tpu_torch.models.ncsnpp import _model_kwargs

    kw = _model_kwargs(config)
    names = score_module_walk(kw)
    online = _strip(sd, "score_fn.")
    ema = _strip(sd, "ema_score_fn.")
    if not online and not ema:
        online = sd
    params = _convert(online, names, kw) if online else None
    ema_params = _convert(ema, names, kw) if ema else params
    if params is None:
        params = ema_params
    want = model_state_dict(config)
    verify_state_dict(params, want)
    verify_state_dict(ema_params, want)
    logger.info("converted %d modules (%d online / %d EMA tensors)",
                len(names), len(online), len(ema))
    return params, ema_params


def convert_clf_state_dict(sd: dict, config) -> dict:
    """A reference classifier ``state_dict`` -> the port's, checked
    against the classifier of ``config`` (the clf config subtree)."""
    from psld_tpu_torch.models.ncsnpp import _model_kwargs_clf

    kw = _model_kwargs_clf(config)
    clf = _strip(sd, "clf_fn.")
    if not clf:
        clf = {k: v for k, v in sd.items() if k.startswith("all_modules.")}
    params = _convert(clf, clf_module_walk(kw), kw, clf_head=True)
    verify_state_dict(params, model_state_dict(config, clf=True))
    return params


def convert_score_checkpoint(path: str, config):
    """A reference Lightning score checkpoint file -> (params,
    ema_params); see :func:`convert_score_state_dict`."""
    return convert_score_state_dict(load_lightning_state_dict(path), config)


def convert_clf_checkpoint(path: str, config) -> dict:
    """A reference Lightning classifier checkpoint file -> params; see
    :func:`convert_clf_state_dict`."""
    return convert_clf_state_dict(load_lightning_state_dict(path), config)
