"""The training loops (``psld_tpu/train/loop.py::train_sde`` and
``train_clf``): build the components from a config through the registry,
run the epoch loop on one device, checkpoint.

``training.device`` (default ``cuda``) is where the run lives. Not ported,
and raising if asked for: ``training.spatial``, ``training.fsdp``.
Accepted without effect, and named in one log line at the start of a run
when set (:data:`TPU_ONLY_KEYS`): ``steps_per_dispatch`` (a dispatch
lever of the JAX package's remote runtime; eager PyTorch has no dispatch
to widen), ``prefetch``, ``profile_dir`` and ``optimizer.flatten``.
Graceful shutdown and ``auto_resume`` are not ported yet; ``restore_path``
(a file, or ``latest``) is.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time

import numpy as np
import torch

import psld_tpu_torch.losses  # noqa: F401  (registers the criteria)
import psld_tpu_torch.models  # noqa: F401  (registers the score nets)
import psld_tpu_torch.sde  # noqa: F401  (registers the SDEs)
from psld_tpu_torch import knobs
from psld_tpu_torch.data.loader import EpochLoader, get_dataset
from psld_tpu_torch.models.layers import init_parameters
from psld_tpu_torch.registry import get_module
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.state import count_params, init_state
from psld_tpu_torch.train.steps import (StepRandom, make_clf_train_step,
                                        make_train_step)

logger = logging.getLogger(__name__)

# per-step rows a run keeps (the newest) and returns
STATS_KEPT = 4096

# training keys of the JAX package that tune its TPU runtime and have no
# effect here: the host-side prefetch thread, the profiler trace window,
# steps scanned per dispatch, and the flattened Adam pass
TPU_ONLY_KEYS = ("prefetch", "profile_dir", "steps_per_dispatch",
                 "optimizer.flatten")


def build_score_model(config):
    return get_module("score_fn", config.model.score_fn.name).from_config(
        config)


def build_sde(config):
    return get_module("sde", config.model.sde.name)(config)


def init_score_params(net, seed: int, device="cpu") -> dict:
    """Initialize ``net`` in place (``default_init``, seeded) and return
    its parameters as the train state's ``params``: float32 leaf tensors
    on ``device``, the network's own storage."""
    init_parameters(net, torch.Generator().manual_seed(int(seed)))
    net.to(device)
    return dict(net.named_parameters())


class MetricsLogger:
    """Append-only JSONL metrics stream: one header record, then one
    object per logged step."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def header(self, **fields) -> None:
        self._write({"header": True, "time": time.time(), **fields})

    def log(self, step: int, **metrics) -> None:
        self._write({"step": int(step), "time": time.time(),
                     **{k: float(v) for k, v in metrics.items()}})

    def close(self) -> None:
        self._f.close()


def log_ignored_keys(tcfg, where: str) -> None:
    """Log one line naming each key of :data:`TPU_ONLY_KEYS` that the
    training config ``tcfg`` (found at ``where``) sets."""
    found = []
    for key in TPU_ONLY_KEYS:
        node = tcfg
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.get(part) or {}
        if leaf in node:
            found.append(f"{where}.{key}={node.get(leaf)}")
    if found:
        logger.info("accepted and ignored (TPU-only, no effect in the "
                    "port): %s", ", ".join(found))


def _check_single_device(tcfg) -> None:
    if int(tcfg.get("spatial", 1) or 1) > 1 or bool(tcfg.get("fsdp", False)):
        raise NotImplementedError(
            "the port trains on one device: training.spatial and "
            "training.fsdp are not ported yet")


def _step_clock(device):
    """A function that marks 'now' on the device's timeline and one that
    turns two marks into milliseconds: CUDA events on a card (no sync
    while the run goes), the host clock on the CPU."""
    if device.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return mark, lambda a, b: a.elapsed_time(b)
    return time.perf_counter, lambda a, b: (b - a) * 1e3


def _restore(tcfg, state, what: str):
    """``training.restore_path`` (a file, or ``latest`` in the run's
    checkpoint directory) into ``state``; returns (state, first epoch)."""
    restore = str(tcfg.restore_path or "")
    ckpt_dir = f"{tcfg.results_dir}/checkpoints"
    if restore == "latest":
        restore = ckpt.latest_checkpoint(ckpt_dir) or ""
        if not restore:
            logger.info("restore_path=latest: no %s checkpoint in %s yet, "
                        "starting fresh", what, ckpt_dir)
    if not restore:
        return state, 0
    state = ckpt.restore_checkpoint(restore, state)
    start_epoch = ckpt.resume_epoch(restore)
    logger.info("restored %s, resuming at epoch %d", restore, start_epoch)
    return state, start_epoch


def _run_epochs(tcfg, state, epoch_steps, device, ckpt_type: str,
                run_knobs: dict, start_epoch: int, max_steps):
    """The epoch loop both trainers share. ``epoch_steps()`` starts an
    epoch and returns a function that takes one optimizer step from the
    epoch's batches and returns its metrics (0-dim device tensors), or
    None when the epoch has no full batch left. Returns the newest
    ``STATS_KEPT`` rows (``step``, ``epoch``, the metrics as floats,
    ``ms``: the step's span on the device's timeline). The device's
    values are read only every ``training.log_step`` steps and at the
    end, so nothing else waits for the device."""
    log_step = int(tcfg.log_step)
    base_steps = state.step
    stats: collections.deque = collections.deque(maxlen=STATS_KEPT)
    if max_steps is not None and base_steps >= max_steps:
        logger.info("max_steps=%d already reached at restore (step %d): "
                    "nothing to do", max_steps, base_steps)
        return list(stats)

    def budget_spent():
        return max_steps is not None and state.step >= max_steps

    ckpt_dir = f"{tcfg.results_dir}/checkpoints"
    mlog = MetricsLogger(f"{tcfg.results_dir}/metrics.jsonl")
    mlog.header(knobs=run_knobs, device=str(device))
    mark, span_ms = _step_clock(device)
    last_mark = mark()
    last_loss = float("nan")
    pending: list = []  # (row, mark before, mark after) not yet read

    def settle():
        """Read the device values of the steps taken since the last call
        (one sync); afterwards their rows hold plain floats."""
        for row, before, after in pending:
            for k, v in row.items():
                if isinstance(v, torch.Tensor):
                    row[k] = float(v)
            row["ms"] = span_ms(before, after)
        pending.clear()

    try:
        for epoch in range(start_epoch, int(tcfg.epochs)):
            t_epoch = time.time()
            step_once = epoch_steps()
            while True:
                metrics = step_once()
                if metrics is None:
                    break
                row = {"step": state.step, "epoch": epoch, **metrics}
                before, last_mark = last_mark, mark()
                pending.append((row, before, last_mark))
                stats.append(row)
                taken = state.step - base_steps
                if taken % log_step == 0:
                    settle()
                    last_loss = row["loss"]
                    mlog.log(taken, epoch=epoch, **{
                        k: v for k, v in row.items()
                        if k not in ("step", "epoch", "ms")})
                elif len(pending) >= STATS_KEPT:
                    settle()
                if budget_spent():
                    break
            logger.info("epoch %d: loss=%.4f (%.1fs)", epoch, last_loss,
                        time.time() - t_epoch)
            # a budget that ends mid-epoch marks the checkpoint incomplete,
            # so a resume replays the epoch instead of skipping its tail
            interrupted = budget_spent()
            if interrupted or (epoch + 1) % int(tcfg.chkpt_interval) == 0:
                name = ckpt.checkpoint_name(ckpt_type, str(tcfg.chkpt_prefix),
                                            epoch, last_loss)
                path = ckpt.save_checkpoint(ckpt_dir, name, state)
                ckpt.write_meta(path, epoch, complete=not interrupted,
                                extra={"knobs": run_knobs})
                logger.info("checkpoint: %s", path)
            if interrupted:
                break
    finally:
        mlog.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    settle()
    return list(stats)


def train_sde(config, max_steps: int | None = None):
    """Unconditional score training. Returns ``(state, stats)``: the final
    TrainState and one dict per optimizer step, the newest ``STATS_KEPT``
    of them (``step``, ``epoch``, ``loss``, ``grad_norm``, ``ms``; see
    :func:`_run_epochs`)."""
    tcfg = config.training
    _check_single_device(tcfg)
    log_ignored_keys(tcfg, "training")
    seed = int(tcfg.seed)
    device = torch.device(str(tcfg.get("device", "cuda")))

    dataset = get_dataset(config)
    net = build_score_model(config)
    sde = build_sde(config)
    criterion = get_module("losses", tcfg.loss.name)(config, sde)
    params = init_score_params(net, seed, device)
    logger.info("score_fn: %.1fM params", count_params(params) / 1e6)

    accum = int(tcfg.get("grad_accum", 1))
    step_fn, optimizer = make_train_step(net, sde, criterion, config)
    state, start_epoch = _restore(tcfg, init_state(params, optimizer),
                                  "score")
    loader = EpochLoader(dataset, int(tcfg.batch_size), shuffle=True,
                         drop_last=True, hflip=bool(config.data.hflip),
                         seed=seed)
    rng = StepRandom(seed, device)

    def epoch_steps():
        batches = iter(loader)

        def step_once():
            chunk = [b for b in (next(batches, None) for _ in range(accum))
                     if b is not None]
            if len(chunk) < accum:
                if chunk:
                    logger.info("dropping %d tail microbatches "
                                "(< grad_accum=%d)", len(chunk), accum)
                return None
            arr = np.stack(chunk) if accum > 1 else chunk[0]
            batch = torch.from_numpy(arr).to(device, non_blocking=True)
            return step_fn(state, batch, rng)[1]

        return step_once

    run_knobs = knobs.resolved(config)
    run_knobs["bf16"] = bool(tcfg.get("bf16", False))
    stats = _run_epochs(tcfg, state, epoch_steps, device, sde.type,
                        run_knobs, start_epoch, max_steps)
    return state, stats


def build_clf_model(ccfg, seed: int = 0, device="cpu"):
    """The noise-conditional classifier of the ``clf`` config subtree,
    initialized (``default_init``, seeded) on ``device``."""
    net = get_module("clf_fn", str(ccfg.model.clf_fn.name)).from_config(ccfg)
    init_parameters(net, torch.Generator().manual_seed(int(seed)))
    return net.to(device)


def train_clf(config, max_steps: int | None = None):
    """Noise-conditional classifier training. ``config`` holds the
    ``diffusion`` tree (the SDE that perturbs the images, the loss's mode)
    and the ``clf`` tree. Returns ``(state, stats)`` as
    :func:`train_sde`, with ``top1`` in place of ``grad_norm``. The
    checkpoint is named ``clf-<prefix>-epoch=<N>-loss=<L>.pt``."""
    ccfg = config.clf
    tcfg = ccfg.training
    _check_single_device(tcfg)
    log_ignored_keys(tcfg, "clf.training")
    seed = int(tcfg.seed)
    device = torch.device(str(tcfg.get("device", "cuda")))

    dataset = get_dataset(ccfg)
    net = build_clf_model(ccfg, seed, device)
    params = dict(net.named_parameters())
    logger.info("clf_fn: %.1fM params", count_params(params) / 1e6)
    sde = build_sde(config.diffusion)
    criterion = get_module("losses", tcfg.loss.name)(config, sde)
    step_fn, optimizer = make_clf_train_step(net, sde, criterion, config)
    state, start_epoch = _restore(tcfg, init_state(params, optimizer),
                                  "classifier")
    loader = EpochLoader(dataset, int(tcfg.batch_size), shuffle=True,
                         drop_last=True, hflip=bool(ccfg.data.hflip),
                         seed=seed)
    rng = StepRandom(seed, device)

    def epoch_steps():
        batches = iter(loader)

        def step_once():
            b = next(batches, None)
            if b is None:
                return None
            if not isinstance(b, tuple):
                raise ValueError("classifier training needs labelled "
                                 "batches: set clf.data.return_target=true")
            imgs, targets = b
            x = torch.from_numpy(imgs).to(device, non_blocking=True)
            y = torch.from_numpy(targets.astype(np.int64)).to(device)
            return step_fn(state, x, y, rng)[1]

        return step_once

    run_knobs = knobs.resolved(ccfg)
    run_knobs["bf16"] = bool(tcfg.get(
        "bf16", config.diffusion.training.get("bf16", False)))
    stats = _run_epochs(tcfg, state, epoch_steps, device, "clf", run_knobs,
                        start_epoch, max_steps)
    return state, stats
