"""The port's state_dicts -> reference (mandt-lab/PSLD) Lightning form
(``psld_tpu/train/torch_export.py``).

The inverse of :mod:`psld_tpu_torch.train.torch_import`: it walks the
same config-derived module order (the reference's ``all_modules`` append
order, ncsnpp.py:168-284 / ncsnpp_clf.py:100-196) and gives each of the
port's parameters its reference name and layout, producing a
Lightning-style ``{"state_dict": {...}}`` checkpoint that the reference
wrapper can ``load_state_dict`` strictly (wrapper.py:31 key prefixes).

Layout inverses:

* Conv / FIRConv2d ``weight`` OIHW, Dense ``weight`` (O, I) -> the same;
* GroupNormAct ``scale`` / ``bias`` -> GroupNorm ``weight`` / ``bias``;
* ``NIN_k.Dense_0.weight`` (out, in) / ``.bias`` -> NIN ``W`` (in, out),
  transposed, / ``b``;
* the classifier head (n_cls, H*W*C) -> (n_cls, C*H*W), the NHWC ->
  NCHW flatten permutation (ncsnpp_clf.py:279).

Only ``noise_cond=True`` models are exportable (every published reference
config): with ``noise_cond=False`` the reference still constructs dead
per-resblock temb Dense parameters (ncsnpp.py:146,158) that the port
never creates, so a strict state_dict cannot be reconstructed.
"""

from __future__ import annotations

import torch

from psld_tpu_torch.train.torch_import import (clf_module_walk,
                                               head_geometry,
                                               model_state_dict,
                                               score_module_walk,
                                               verify_state_dict)


def _unmap(rest: str, arr: torch.Tensor):
    """Inverse of ``torch_import._map_suffix``: the port's key inside one
    module group -> (reference suffix, reference-layout tensor)."""
    parts = rest.split(".")
    if len(parts) == 1:
        name = parts[0]
        if name in ("W", "weight", "bias"):
            return name, arr
        if name == "scale":
            return "weight", arr
        raise ValueError(f"unrecognized parameter `{rest}`")
    mod = parts[0]
    if mod.startswith("GroupNormAct_"):
        tmod = mod.replace("GroupNormAct_", "GroupNorm_")
        return f"{tmod}.{'weight' if parts[1] == 'scale' else 'bias'}", arr
    if mod.startswith("NIN_"):
        # NIN_k.Dense_0.{weight (out, in), bias} -> W (in, out), b
        if parts[2] == "weight":
            return f"{mod}.W", arr.t()
        return f"{mod}.b", arr
    if mod.startswith("FIRConv2d_"):
        return f"{mod.replace('FIRConv2d_', 'Conv2d_')}.{parts[1]}", arr
    if mod.startswith(("Conv_", "Dense_")):
        return rest, arr
    raise ValueError(f"unrecognized parameter `{rest}`")


def _export(sd: dict, names: list[str], kw,
            clf_head: bool = False) -> dict:
    """The port's state_dict -> reference ``all_modules.*`` tensors
    (float32, contiguous)."""
    if not kw["noise_cond"]:
        raise ValueError(
            "export requires noise_cond=True: the reference constructs "
            "dead temb Dense parameters the port cannot reconstruct")
    index_of = {name: i for i, name in enumerate(names)}
    unknown = sorted({k.split(".", 1)[0] for k in sd} - set(index_of))
    if unknown:
        raise ValueError(f"modules not in the reference walk: {unknown}")
    out: dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        name, rest = key.split(".", 1)
        i = index_of[name]
        arr = torch.as_tensor(val).detach().float()
        if clf_head and i == len(names) - 1 and rest == "weight":
            # flatten head: (n_cls, H*W*C) NHWC-major -> (n_cls, C*H*W)
            n_cls, flat = arr.shape
            res, ch = head_geometry(kw, flat)
            suffix, arr = "weight", (arr.reshape(n_cls, res, res, ch)
                                     .permute(0, 3, 1, 2)
                                     .reshape(n_cls, flat))
        else:
            suffix, arr = _unmap(rest, arr)
        out[f"all_modules.{i}.{suffix}"] = arr.contiguous()
    return out


def export_score_state_dict(params: dict, ema_params: dict, config) -> dict:
    """The port's (params, ema_params) state_dicts, checked against the
    network of ``config`` (the diffusion subtree) -> a reference Lightning
    ``state_dict`` with ``score_fn.`` / ``ema_score_fn.`` prefixes
    (wrapper.py:31)."""
    from psld_tpu_torch.models.ncsnpp import _model_kwargs

    kw = _model_kwargs(config)
    names = score_module_walk(kw)
    want = model_state_dict(config)
    sd = {}
    for prefix, tree in (("score_fn.", params), ("ema_score_fn.",
                                                 ema_params)):
        verify_state_dict(tree, want)
        for key, val in _export(tree, names, kw).items():
            sd[prefix + key] = val
    return sd


def export_clf_state_dict(params: dict, config) -> dict:
    """The port's classifier state_dict, checked against the classifier
    of ``config`` (the clf subtree) -> a reference ``state_dict`` with the
    ``clf_fn.`` prefix (clf_wrapper.py)."""
    from psld_tpu_torch.models.ncsnpp import _model_kwargs_clf

    kw = _model_kwargs_clf(config)
    verify_state_dict(params, model_state_dict(config, clf=True))
    return {f"clf_fn.{key}": val
            for key, val in _export(params, clf_module_walk(kw), kw,
                                    clf_head=True).items()}


def save_lightning_checkpoint(path: str, state_dict: dict,
                              step: int = 0) -> None:
    """Write a torch-loadable Lightning-style checkpoint file
    (``state_dict``, ``global_step``, ``epoch``)."""
    torch.save({"state_dict": {k: torch.as_tensor(v).detach().cpu()
                               .contiguous().clone()
                               for k, v in state_dict.items()},
                "global_step": int(step), "epoch": 0}, path)
