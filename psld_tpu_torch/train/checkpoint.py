"""Checkpoints of the port (``psld_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file ``<name>.pt`` holding
``{"params", "ema_params", "step", "opt_state"}``: ``params`` and
``ema_params`` are the score network's state_dict (what
``eval/generate.py`` reads), ``opt_state`` is ``{"mu", "nu", "count"}``.
``<name>`` is the JAX package's ``<sde>-<prefix>-epoch=<N>-loss=<L>``, and
the resume sidecar ``<file>.meta.json`` is the JAX package's too. Saves
are synchronous; a file is written under a temporary name and renamed, so
a run cut mid-save leaves no half-written ``.pt``.
"""

from __future__ import annotations

import json
import os
import re

import torch

from psld_tpu_torch.train.state import TrainState

SUFFIX = ".pt"


def checkpoint_name(sde_type: str, prefix: str, epoch: int,
                    loss: float) -> str:
    prefix = prefix or "psld"
    return f"{sde_type}-{prefix}-epoch={epoch:04d}-loss={loss:.4f}"


def save_checkpoint(directory: str, name: str, state: TrainState) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name + SUFFIX))

    def cpu(tree):
        return {k: v.detach().cpu() for k, v in tree.items()}

    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"params": cpu(state.params),
                "ema_params": cpu(state.ema_params),
                "step": int(state.step),
                "opt_state": {"mu": cpu(state.opt_state["mu"]),
                              "nu": cpu(state.opt_state["nu"]),
                              "count": int(state.opt_state["count"])}}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The checkpoint file of the highest epoch; the newer file wins a
    tie (an interrupted epoch is replayed and written again)."""
    if not os.path.isdir(directory):
        return None
    best, best_key = None, (-1, -1.0)
    for entry in os.listdir(directory):
        full = os.path.join(directory, entry)
        if not entry.endswith(SUFFIX) or not os.path.isfile(full):
            continue  # sidecars, temporary files of a cut save
        m = re.search(r"epoch=(\d+)", entry)
        if not m:
            continue
        key = (int(m.group(1)), os.path.getmtime(full))
        if key > best_key:
            best, best_key = entry, key
    return os.path.join(directory, best) if best else None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Fill ``state`` (a freshly initialized TrainState of the same
    architecture) from the file, in place; returns it."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)

    def fill(dst, src, what):
        if set(dst) != set(src) or any(dst[k].shape != src[k].shape
                                       for k in dst):
            raise ValueError(
                f"failed to restore {path!r}: the {what} of the checkpoint "
                "do not match this architecture (check the overrides nf, "
                "ch_mult, num_res_blocks, attn_resolutions, fir, "
                "embedding_type, progressive*, in/out_ch)")
        with torch.no_grad():
            for k, v in dst.items():
                v.copy_(src[k])

    fill(state.params, ckpt["params"], "params")
    fill(state.ema_params, ckpt["ema_params"], "ema_params")
    if "opt_state" in ckpt:
        fill(state.opt_state["mu"], ckpt["opt_state"]["mu"], "Adam moments")
        fill(state.opt_state["nu"], ckpt["opt_state"]["nu"], "Adam moments")
        state.opt_state["count"] = int(ckpt["opt_state"]["count"])
    state.step = int(ckpt.get("step", 0))
    return state


def epoch_from_path(path: str) -> int:
    m = re.search(r"epoch=(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def write_meta(path: str, epoch: int, complete: bool,
               extra: dict | None = None) -> None:
    """Sidecar resume metadata ``<ckpt>.meta.json``. ``complete=True``: the
    named epoch finished, resume at epoch+1. ``complete=False``: the run
    stopped mid-epoch, resume replays that epoch from its start."""
    rec = {"epoch": int(epoch), "complete": bool(complete)}
    if extra:
        rec.update(extra)
    with open(path + ".meta.json", "w") as f:
        json.dump(rec, f)


def resume_epoch(path: str) -> int:
    """First epoch to run when resuming from ``path``: from the sidecar,
    else from the file name (replaying the named epoch)."""
    meta_path = str(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        return int(meta["epoch"]) + (1 if meta.get("complete") else 0)
    return epoch_from_path(str(path))
