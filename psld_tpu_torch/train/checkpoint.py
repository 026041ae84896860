"""Checkpoints of the port (``psld_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file ``<name>.pt`` holding
``{"params", "ema_params", "step", "opt_state"}``: ``params`` and
``ema_params`` are the score network's state_dict (what
``eval/generate.py`` reads), ``opt_state`` is ``{"mu", "nu", "count"}``.
``<name>`` is the JAX package's ``<sde>-<prefix>-epoch=<N>-loss=<L>``, and
the resume sidecar ``<file>.meta.json`` is the JAX package's too. A file
is written under a temporary name and renamed, so a run cut mid-save
leaves no half-written ``.pt``. :func:`save_checkpoint` writes before it
returns; the training loops save through :class:`AsyncSaver`, whose
write runs on a thread while training goes on.
"""

from __future__ import annotations

import json
import os
import re
import threading

import torch

from psld_tpu_torch.train.state import TrainState

SUFFIX = ".pt"


def checkpoint_name(sde_type: str, prefix: str, epoch: int,
                    loss: float) -> str:
    prefix = prefix or "psld"
    return f"{sde_type}-{prefix}-epoch={epoch:04d}-loss={loss:.4f}"


def _snapshot(state: TrainState, host=None) -> dict:
    """The checkpoint's payload: every tensor of ``state`` on the host,
    and its counters. ``host`` (see :class:`AsyncSaver`) maps
    (tree, key) to a host tensor to copy into; without it each tensor
    is written as it stands (a card's tensor is copied, a host tensor is
    not). Returns once every copy has landed, so with ``host`` the state
    may change in place right after."""
    trees = {"params": state.params, "ema_params": state.ema_params,
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    out = {}
    on_card = False
    for tree, values in trees.items():
        out[tree] = {}
        for k, v in values.items():
            v = v.detach()
            if host is None:  # written at once: no copy of a host tensor
                out[tree][k] = v.cpu()
                continue
            dst = host.get((tree, k))
            if dst is None or dst.shape != v.shape or dst.dtype != v.dtype:
                dst = torch.empty(v.shape, dtype=v.dtype,
                                  pin_memory=v.is_cuda)
                host[(tree, k)] = dst
            dst.copy_(v, non_blocking=v.is_cuda)
            on_card = on_card or v.is_cuda
            out[tree][k] = dst
    if on_card:  # the copies above were queued behind the step's work
        torch.cuda.synchronize()
    return {"params": out["params"], "ema_params": out["ema_params"],
            "step": int(state.step),
            "opt_state": {"mu": out["mu"], "nu": out["nu"],
                          "count": int(state.opt_state["count"])}}


def _path(directory: str, name: str) -> str:
    os.makedirs(directory, exist_ok=True)
    return os.path.abspath(os.path.join(directory, name + SUFFIX))


def _write(path: str, payload: dict) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, name: str, state: TrainState) -> str:
    """Write ``state`` as ``<directory>/<name>.pt``; returns the path."""
    path = _path(directory, name)
    _write(path, _snapshot(state))
    return path


class AsyncSaver:
    """The training loops' checkpoint writer
    (``psld_tpu/train/checkpoint.py::AsyncSaver``).

    ``save()`` returns once every tensor of the state has been copied to
    the host: the next step updates parameters, EMA and Adam moments in
    place, and cannot change what is written. The ``torch.save`` then
    runs on one background thread, into a temporary name that is renamed
    at the end, so :func:`latest_checkpoint` never picks a half-written
    file; the resume sidecar (``meta``, :func:`write_meta`'s arguments)
    is written on the same thread after the rename, so no sidecar stands
    beside a checkpoint that was never written. At most one write is in
    flight: ``save()`` first waits for the previous one. ``close()``
    waits for the last write and raises its error, if it had one; a
    second ``close()`` does nothing.

    The host copies go to buffers allocated at the first save (pinned,
    for tensors on a card) and reused by every later one: the wait for
    the previous write comes before the copy, so no write still reads a
    buffer that is being filled.
    """

    def __init__(self):
        self._host: dict = {}
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._closed = False

    def _run(self, path: str, payload: dict, meta: dict | None) -> None:
        try:
            _write(path, payload)
            if meta is not None:
                write_meta(path, **meta)
        except BaseException as e:  # raised by the next wait()
            self._error = e

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, directory: str, name: str, state: TrainState,
             meta: dict | None = None) -> str:
        if self._closed:
            raise RuntimeError("AsyncSaver.save after close()")
        self.wait()
        path = _path(directory, name)
        payload = _snapshot(state, self._host)
        self._thread = threading.Thread(target=self._run,
                                        args=(path, payload, meta),
                                        name="psld-ckpt", daemon=True)
        self._thread.start()
        return path

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            self._host.clear()

    def __enter__(self) -> "AsyncSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
