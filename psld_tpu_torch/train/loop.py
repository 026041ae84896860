"""The training loop (``psld_tpu/train/loop.py::train_sde``): build the
components from a config through the registry, run the epoch loop on one
device, checkpoint.

``training.device`` (default ``cuda``) is where the run lives. Not ported,
and raising if asked for: ``training.spatial``, ``training.fsdp``. Accepted
without effect: ``steps_per_dispatch`` (a dispatch lever of the JAX
package's remote runtime; eager PyTorch has no dispatch to widen),
``prefetch`` and ``profile_dir``. Graceful shutdown and ``auto_resume``
are not ported yet; ``restore_path`` (a file, or ``latest``) is.
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
from psld_tpu_torch.train.steps import StepRandom, make_train_step

logger = logging.getLogger(__name__)

# per-step rows a run keeps (the newest) and returns
STATS_KEPT = 4096


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


def train_sde(config, max_steps: int | None = None):
    """Unconditional score training. Returns ``(state, stats)``: the final
    TrainState and one dict per optimizer step, the newest ``STATS_KEPT``
    of them (``step``, ``epoch``, ``loss``, ``grad_norm``, ``ms``: the
    step's span on the device's timeline). The loop reads the device's
    values only every ``training.log_step`` steps (and at the end), so
    nothing else waits for the device."""
    tcfg = config.training
    _check_single_device(tcfg)
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
    state = init_state(params, optimizer)

    start_epoch = 0
    restore = str(tcfg.restore_path or "")
    ckpt_dir = f"{tcfg.results_dir}/checkpoints"
    if restore == "latest":
        restore = ckpt.latest_checkpoint(ckpt_dir) or ""
        if not restore:
            logger.info("restore_path=latest: no checkpoint in %s yet, "
                        "starting fresh", ckpt_dir)
    if restore:
        state = ckpt.restore_checkpoint(restore, state)
        start_epoch = ckpt.resume_epoch(restore)
        logger.info("restored %s, resuming at epoch %d", restore, start_epoch)

    loader = EpochLoader(dataset, int(tcfg.batch_size), shuffle=True,
                         drop_last=True, hflip=bool(config.data.hflip),
                         seed=seed)
    rng = StepRandom(seed, device)
    log_step = int(tcfg.log_step)
    base_steps = state.step
    stats: collections.deque = collections.deque(maxlen=STATS_KEPT)
    if max_steps is not None and base_steps >= max_steps:
        logger.info("max_steps=%d already reached at restore (step %d): "
                    "nothing to do", max_steps, base_steps)
        return state, list(stats)

    def budget_spent():
        return max_steps is not None and state.step >= max_steps

    run_knobs = knobs.resolved(config)
    run_knobs["bf16"] = bool(tcfg.get("bf16", False))
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
            row["loss"] = float(row["loss"])
            row["grad_norm"] = float(row["grad_norm"])
            row["ms"] = span_ms(before, after)
        pending.clear()

    try:
        for epoch in range(start_epoch, int(tcfg.epochs)):
            t_epoch = time.time()
            batches = iter(loader)
            while True:
                chunk = [b for b in (next(batches, None)
                                     for _ in range(accum)) if b is not None]
                if len(chunk) < accum:
                    if chunk:
                        logger.info("dropping %d tail microbatches "
                                    "(< grad_accum=%d)", len(chunk), accum)
                    break
                arr = np.stack(chunk) if accum > 1 else chunk[0]
                batch = torch.from_numpy(arr).to(device, non_blocking=True)
                state, metrics = step_fn(state, batch, rng)
                row = {"step": state.step, "epoch": epoch, **metrics}
                before, last_mark = last_mark, mark()
                pending.append((row, before, last_mark))
                stats.append(row)
                taken = state.step - base_steps
                if taken % log_step == 0:
                    settle()
                    last_loss = row["loss"]
                    mlog.log(taken, loss=last_loss,
                             grad_norm=row["grad_norm"], epoch=epoch)
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
                name = ckpt.checkpoint_name(sde.type, str(tcfg.chkpt_prefix),
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
    return state, list(stats)
