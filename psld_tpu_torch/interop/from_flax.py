"""A JAX-package param tree -> the port's ``state_dict``: the score and
classifier networks' flax trees, and (:func:`inception_state_dict`) the
FID InceptionV3's params.

The tree is nested dicts of numpy arrays (``jax.device_get`` of a flax
``params`` tree, with or without the top-level ``{"params": ...}``); no
jax is needed here. The port's modules carry the flax module names, so a
leaf maps by path, with two layout changes:

* ``kernel`` (kh, kw, I, O), a Conv or FIRConv2d kernel -> ``weight``
  (O, I, kh, kw);
* ``kernel`` (I, O), a Dense kernel -> ``weight`` (O, I);

and every other leaf (``bias``, GroupNorm ``scale``, Fourier ``W``) by its
own name. The mapping is strict both ways: every flax leaf is used
exactly once and every parameter and buffer of the port's model is
filled, with matching shapes, or it raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _map_leaf(path, arr):
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        leaf = "weight"
    # a writable C-order copy: device_get hands out read-only arrays
    return ".".join(mods + [leaf]), np.array(arr, order="C")


def flax_to_state_dict(params, model: torch.nn.Module) -> dict:
    """Map flax ``params`` onto ``model``'s state_dict keys (strict)."""
    if set(params) == {"params"}:
        params = params["params"]
    want = model.state_dict()
    sd = {}
    for path, arr in _flatten(params):
        key, arr = _map_leaf(path, arr)
        if key in sd:
            raise ValueError(f"two flax leaves map to {key}")
        if key not in want:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key}: no such "
                           "parameter in the port's model")
        if tuple(want[key].shape) != arr.shape:
            raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                             f"{tuple(want[key].shape)}")
        sd[key] = torch.from_numpy(arr)
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"port parameters with no flax leaf: {missing}")
    return sd


def load_flax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Fill ``model`` from a flax param tree in place; returns it."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


def train_state_from_flax(model: torch.nn.Module, params, ema_params, mu, nu,
                          count: int, step: int):
    """A JAX-package ``TrainState`` as the port's.

    ``params``, ``ema_params`` and the Adam moments ``mu`` and ``nu`` (of
    optax's ``ScaleByAdamState``) are flax trees with numpy leaves;
    ``count`` is the optimizer's update count and ``step`` the state's.
    ``model`` is filled with ``params`` and its parameters become the
    state's, so the returned state and ``model`` share storage."""
    from psld_tpu_torch.train.state import TrainState

    load_flax_params(model, params)
    own = dict(model.named_parameters())

    def tree(t):
        return {k: v.clone() for k, v in flax_to_state_dict(t, model).items()}

    return TrainState(step=int(step), params=own, ema_params=tree(ema_params),
                      opt_state={"mu": tree(mu), "nu": tree(nu),
                                 "count": int(count)})


def inception_state_dict(params) -> dict:
    """The JAX package's InceptionV3 params (``{name: {"w": HWIO, "b"}}``
    and an optional ``{"fc": {"w": (2048, 1008), "b"}}``, numpy leaves)
    as the port's ``FIDInception`` state_dict: ``<name>.weight`` OIHW,
    ``<name>.bias``, ``fc.weight`` (1008, 2048) and ``fc.bias``."""
    sd = {}
    for name, leaf in params.items():
        w, b = np.asarray(leaf["w"]), np.asarray(leaf["b"])
        if name == "fc":
            w = w.T
        elif w.ndim == 4:
            w = np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW
        else:
            raise ValueError(f"{name}: kernel of rank {w.ndim}")
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w, order="C"))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(b, order="C"))
    return sd
