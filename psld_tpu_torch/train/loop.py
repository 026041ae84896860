"""The training loops (``psld_tpu/train/loop.py::train_sde`` and
``train_clf``): build the components from a config through the registry,
run the epoch loop, checkpoint.

``training.device`` (default ``cuda``) is where the run lives. Under a
process group (:mod:`psld_tpu_torch.parallel.distributed`; ``torchrun``
or ``PSLD_MULTIHOST=1``) of N ranks, rank r works on ``cuda:LOCAL_RANK``
(or the CPU), as the JAX package's loop on an N-device mesh:
``batch_size`` is per rank and the global batch is ``batch_size * N``,
each rank loads its rows of every global batch, the state starts as rank
0's, and only rank 0 writes ``metrics.jsonl``, checkpoints and the
profiler trace. ``training.fsdp=true`` shards the state
(:mod:`psld_tpu_torch.parallel.fsdp`); its checkpoints hold the full
state. ``training.spatial=S`` (:mod:`psld_tpu_torch.parallel.spatial`)
splits each image's height over spatial groups of S consecutive ranks:
S must divide the world size and the image height, the global batch is
``batch_size * world / S``, and each rank of a group loads its data
group's rows and keeps its slice of their height. The JAX package keeps
a spatial group inside one process (its ``(data, spatial)`` mesh of
local devices); here one rank is one card, so a group spans processes by
construction. The classifier's loop reads no ``spatial``, as in the JAX
package. Accepted without effect, and named in one log line at the start of a run
when set (:data:`TPU_ONLY_KEYS`): ``steps_per_dispatch`` (a dispatch
lever of the JAX package's remote runtime; eager PyTorch has no dispatch
to widen) and ``optimizer.flatten``.

As in the JAX package:
- ``restore_path`` (a file, or ``latest``), and ``auto_resume=true`` with
  an empty ``restore_path``, restore a checkpoint; ``latest`` and
  ``auto_resume`` take the newest in ``results_dir/checkpoints`` and
  start fresh where there is none;
- SIGTERM or SIGINT stops the run at the next step boundary with a
  checkpoint marked incomplete (:mod:`.interrupt`), which a relaunch
  resumes by replaying its epoch; the ranks of a process group agree on
  the stop at every step, so a signal that reaches one rank stops them
  all at the same step;
- checkpoints are written on a thread (:class:`.checkpoint.AsyncSaver`);
- ``prefetch`` (default 2; 0 turns it off) batches are loaded ahead on a
  thread (:func:`psld_tpu_torch.utils.pipeline.prefetch_iter`);
- ``profile_dir`` (with ``profile_steps``, default 10) writes a
  ``torch.profiler`` trace of the first steps, and the wall clock of the
  ``data``, ``step`` and ``ckpt`` phases is logged at the end of a run;
- ``remat``, when set, decides the network's per-resblock
  recomputation, over ``model.score_fn.remat``.
"""

from __future__ import annotations

import collections
import itertools
import logging
import time

import numpy as np
import torch

import psld_tpu_torch.losses  # noqa: F401  (registers the criteria)
import psld_tpu_torch.models  # noqa: F401  (registers the score nets)
import psld_tpu_torch.sde  # noqa: F401  (registers the SDEs)
from psld_tpu_torch import knobs
from psld_tpu_torch.data.loader import EpochLoader, get_dataset
from psld_tpu_torch.models.layers import init_parameters
from psld_tpu_torch.parallel import distributed, fsdp, spatial
from psld_tpu_torch.parallel.mesh import replicate_
from psld_tpu_torch.registry import get_module
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.interrupt import GracefulShutdown
from psld_tpu_torch.train.state import count_params, init_state
from psld_tpu_torch.train.steps import (StepRandom, make_clf_train_step,
                                        make_train_step)
from psld_tpu_torch.utils.pipeline import prefetch_iter
from psld_tpu_torch.utils.profiling import (BoundedTrace, MetricsLogger,
                                            StepTimer)

logger = logging.getLogger(__name__)

# per-step rows a run keeps (the newest) and returns
STATS_KEPT = 4096

# training keys of the JAX package that tune its TPU runtime and have no
# effect here: steps scanned per dispatch, and the flattened Adam pass
TPU_ONLY_KEYS = ("steps_per_dispatch", "optimizer.flatten")


def build_score_model(config):
    net = get_module("score_fn", config.model.score_fn.name).from_config(
        config)
    return _apply_remat(net, config.training)


def _apply_remat(net, tcfg):
    """``training.remat``, when present, sets the network's per-resblock
    recomputation (``models/ncsnpp.py``), either way."""
    flag = tcfg.get("remat", None)
    if flag is None:
        return net
    if not hasattr(net, "remat"):
        logger.warning("training.remat=%s ignored: %s has no remat support",
                       flag, type(net).__name__)
        return net
    net.remat = bool(flag)
    return net


def build_sde(config):
    return get_module("sde", config.model.sde.name)(config)


def init_score_params(net, seed: int, device="cpu") -> dict:
    """Initialize ``net`` in place (``default_init``, seeded) and return
    its parameters as the train state's ``params``: float32 leaf tensors
    on ``device``, the network's own storage."""
    init_parameters(net, torch.Generator().manual_seed(int(seed)))
    net.to(device)
    return dict(net.named_parameters())


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


def _run_device(tcfg):
    """``training.device``; under a process group, this rank's card."""
    return distributed.run_device(tcfg.get("device", "cuda"))


def _layout(tcfg, params):
    """The FSDP layout of ``params`` under ``training.fsdp``, else None."""
    if not bool(tcfg.get("fsdp", False)):
        return None
    return fsdp.Layout(params)


def _place(state, net, layout):
    """Rank 0's state on every rank (``replicate_``); under FSDP, this
    rank's shards of it. The network's own storage of the sharded leaves
    is released: the forward runs on the step's compute copies."""
    replicate_(state)
    if layout is None:
        return state
    state = fsdp.shard_state(state, layout)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if layout.is_sharded(name):
                p.data = p.data.new_empty(0)
    logger.info("fsdp: %d of %d leaves sharded over %d ranks, %.1f MB of "
                "state a rank", len(layout.sharded), len(layout.shapes),
                layout.world, fsdp.per_device_bytes(state) / 1e6)
    return state


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
    """``training.restore_path`` into ``state``: a file, or, for
    ``latest`` or an empty path with ``auto_resume`` true, the newest
    checkpoint in the run's checkpoint directory (none: a fresh start).
    Returns (state, first epoch)."""
    restore = str(tcfg.restore_path or "")
    ckpt_dir = f"{tcfg.results_dir}/checkpoints"
    if restore == "latest" or (not restore
                               and bool(tcfg.get("auto_resume", False))):
        why = "restore_path=latest" if restore else "auto_resume=true"
        # rank 0 picks the file, so every rank restores the same one
        restore = distributed.broadcast_object(
            ckpt.latest_checkpoint(ckpt_dir) or "")
        if not restore:
            logger.info("%s: no %s checkpoint in %s yet, starting fresh",
                        why, what, ckpt_dir)
    if not restore:
        return state, 0
    state = ckpt.restore_checkpoint(restore, state)
    start_epoch = ckpt.resume_epoch(restore)
    logger.info("restored %s, resuming at epoch %d", restore, start_epoch)
    return state, start_epoch


def _run_epochs(tcfg, state, epoch_batches, step_on, device, ckpt_type: str,
                run_knobs: dict, start_epoch: int, max_steps, stop,
                layout=None):
    """The epoch loop both trainers share. ``epoch_batches()`` gives an
    epoch's host batches in order, read ``training.prefetch`` ahead on a
    thread; ``step_on(batch)`` takes one optimizer step and returns its
    metrics (0-dim device tensors). Returns the newest ``STATS_KEPT``
    rows (``step``, ``epoch``, the metrics as floats, ``ms``: the step's
    span on the device's timeline). The device's values are read only
    every ``training.log_step`` steps and at the end, so nothing else
    waits for the device. ``stop`` (a :class:`GracefulShutdown`) or the
    ``max_steps`` budget ends the run at a step boundary with a
    checkpoint marked incomplete; the ranks of a process group agree on
    ``stop`` once a step (:meth:`GracefulShutdown.agreed`, over the
    host), so all stop at the same step. Only rank 0 writes the metrics,
    the trace and the checkpoints; under FSDP (``layout``) every rank
    takes part in gathering the state a checkpoint holds."""
    lead = distributed.process_info()[0] == 0
    log_step = int(tcfg.log_step)
    prefetch = int(tcfg.get("prefetch", 2))
    base_steps = state.step
    stats: collections.deque = collections.deque(maxlen=STATS_KEPT)
    if max_steps is not None and base_steps >= max_steps:
        logger.info("max_steps=%d already reached at restore (step %d): "
                    "nothing to do", max_steps, base_steps)
        return list(stats)

    def interrupted():
        return stop.agreed() or (max_steps is not None
                                 and state.step >= max_steps)

    ckpt_dir = f"{tcfg.results_dir}/checkpoints"
    mlog = MetricsLogger(f"{tcfg.results_dir}/metrics.jsonl" if lead else "")
    mlog.header(knobs=run_knobs, device=str(device))
    timer = StepTimer()
    btrace = BoundedTrace(
        str(tcfg.get("profile_dir", "") or "") if lead else "",
        int(tcfg.get("profile_steps", 10)), device)
    saver = ckpt.AsyncSaver()
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

    finished = False
    try:
        for epoch in range(start_epoch, int(tcfg.epochs)):
            t_epoch = time.time()
            batches = epoch_batches()
            if prefetch > 0:
                batches = prefetch_iter(batches, depth=prefetch)
            try:
                while True:
                    with timer.phase("data"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    with timer.phase("step"):
                        metrics = step_on(batch)
                    taken = state.step - base_steps
                    # the trace's sync and write land in the span of its
                    # last step, not of the next one
                    if btrace.maybe_stop(taken):
                        logger.info("profiler trace (%d steps): %s", taken,
                                    btrace.path)
                    row = {"step": state.step, "epoch": epoch, **metrics}
                    before, last_mark = last_mark, mark()
                    pending.append((row, before, last_mark))
                    stats.append(row)
                    if taken % log_step == 0:
                        settle()
                        last_loss = row["loss"]
                        mlog.log(taken, epoch=epoch, **{
                            k: v for k, v in row.items()
                            if k not in ("step", "epoch", "ms")})
                    elif len(pending) >= STATS_KEPT:
                        settle()
                    if interrupted():
                        break
            finally:
                if prefetch > 0:
                    batches.close()  # stops the producer thread
            logger.info("epoch %d: loss=%.4f (%.1fs)", epoch, last_loss,
                        time.time() - t_epoch)
            # a stop mid-epoch marks the checkpoint incomplete, so a
            # resume replays the epoch instead of skipping its tail
            cut = interrupted()
            if cut or (epoch + 1) % int(tcfg.chkpt_interval) == 0:
                with timer.phase("ckpt"):
                    full = state if layout is None \
                        else fsdp.gather_state(state, layout)
                    if lead:
                        name = ckpt.checkpoint_name(
                            ckpt_type, str(tcfg.chkpt_prefix), epoch,
                            last_loss)
                        path = saver.save(ckpt_dir, name, full, meta={
                            "epoch": epoch, "complete": not cut,
                            "extra": {"knobs": run_knobs}})
                        logger.info("checkpoint: %s", path)
                    del full
            if cut:
                if stop.agreed():
                    logger.warning("graceful shutdown: checkpointed at "
                                   "epoch %d (step %d)", epoch, state.step)
                break
        finished = True
    finally:
        try:
            btrace.stop()
            try:
                saver.close()  # waits for the write in flight
            except Exception:
                if finished:
                    raise
                # the loop's own error is the one that propagates
                logger.exception("checkpoint write failed")
        finally:
            logger.info("timing: %s", timer.summary())
            mlog.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    settle()
    return list(stats)


def train_sde(config, max_steps: int | None = None):
    """Unconditional score training. Returns ``(state, stats)``: the final
    TrainState and one dict per optimizer step, the newest ``STATS_KEPT``
    of them (``step``, ``epoch``, ``loss``, ``grad_norm``, ``ms``; see
    :func:`_run_epochs`). The shutdown handler is in place before the
    network is built, so a signal during the set-up still ends in a
    resumable exit."""
    with GracefulShutdown() as stop:
        return _train_sde(config, stop, max_steps)


def _train_sde(config, stop, max_steps):
    tcfg = config.training
    log_ignored_keys(tcfg, "training")
    seed = int(tcfg.seed)
    device = _run_device(tcfg)
    spatial.configure(int(tcfg.get("spatial", 1) or 1),
                      int(config.data.image_size))
    data_index, data_groups = distributed.data_info()

    dataset = get_dataset(config)
    net = build_score_model(config)
    sde = build_sde(config)
    criterion = get_module("losses", tcfg.loss.name)(config, sde)
    params = init_score_params(net, seed, device)
    logger.info("score_fn: %.1fM params", count_params(params) / 1e6)

    accum = int(tcfg.get("grad_accum", 1))
    layout = _layout(tcfg, params)
    step_fn, optimizer = make_train_step(net, sde, criterion, config,
                                         fsdp=layout)
    state, start_epoch = _restore(tcfg, init_state(params, optimizer),
                                  "score")
    state = _place(state, net, layout)
    loader = EpochLoader(dataset, int(tcfg.batch_size) * data_groups,
                         shuffle=True, drop_last=True,
                         hflip=bool(config.data.hflip), seed=seed,
                         process_index=data_index,
                         process_count=data_groups)
    rng = StepRandom(seed, device, shard=(data_index, data_groups))

    def epoch_batches():
        """An epoch's optimizer-step batches: ``grad_accum`` loader
        batches stacked; a tail that fills no group is dropped."""
        batches = iter(loader)
        while True:
            chunk = list(itertools.islice(batches, accum))
            if len(chunk) < accum:
                if chunk:
                    logger.info("dropping %d tail microbatches "
                                "(< grad_accum=%d)", len(chunk), accum)
                return
            yield np.stack(chunk) if accum > 1 else chunk[0]

    def step_on(arr):
        # this rank's slice of the rows' height (NHWC, or [A, B, H, W, C])
        batch = spatial.height_slice(torch.from_numpy(arr), arr.ndim - 3)
        batch = batch.to(device, non_blocking=True)
        return step_fn(state, batch, rng)[1]

    run_knobs = knobs.resolved(config)
    run_knobs["bf16"] = bool(tcfg.get("bf16", False))
    stats = _run_epochs(tcfg, state, epoch_batches, step_on, device,
                        sde.type, run_knobs, start_epoch, max_steps, stop,
                        layout)
    if layout is not None:
        state = fsdp.gather_state(state, layout)
    return state, stats


def build_clf_model(ccfg, seed: int = 0, device="cpu"):
    """The noise-conditional classifier of the ``clf`` config subtree,
    initialized (``default_init``, seeded) on ``device``;
    ``clf.training.remat`` applies as ``training.remat`` does."""
    net = get_module("clf_fn", str(ccfg.model.clf_fn.name)).from_config(ccfg)
    init_parameters(net, torch.Generator().manual_seed(int(seed)))
    return _apply_remat(net, ccfg.training).to(device)


def train_clf(config, max_steps: int | None = None):
    """Noise-conditional classifier training. ``config`` holds the
    ``diffusion`` tree (the SDE that perturbs the images, the loss's mode)
    and the ``clf`` tree. Returns ``(state, stats)`` as
    :func:`train_sde`, with ``top1`` in place of ``grad_norm``. The
    checkpoint is named ``clf-<prefix>-epoch=<N>-loss=<L>.pt``.
    Preemption-safe as :func:`train_sde`."""
    with GracefulShutdown() as stop:
        return _train_clf(config, stop, max_steps)


def _train_clf(config, stop, max_steps):
    ccfg = config.clf
    tcfg = ccfg.training
    log_ignored_keys(tcfg, "clf.training")
    seed = int(tcfg.seed)
    device = _run_device(tcfg)
    distributed.configure_spatial(1)
    rank, world = distributed.process_info()

    dataset = get_dataset(ccfg)
    net = build_clf_model(ccfg, seed, device)
    params = dict(net.named_parameters())
    logger.info("clf_fn: %.1fM params", count_params(params) / 1e6)
    sde = build_sde(config.diffusion)
    criterion = get_module("losses", tcfg.loss.name)(config, sde)
    layout = _layout(tcfg, params)
    step_fn, optimizer = make_clf_train_step(net, sde, criterion, config,
                                             fsdp=layout)
    state, start_epoch = _restore(tcfg, init_state(params, optimizer),
                                  "classifier")
    state = _place(state, net, layout)
    loader = EpochLoader(dataset, int(tcfg.batch_size) * world,
                         shuffle=True, drop_last=True,
                         hflip=bool(ccfg.data.hflip), seed=seed,
                         process_index=rank, process_count=world)
    rng = StepRandom(seed, device, shard=(rank, world))

    def step_on(b):
        if not isinstance(b, tuple):
            raise ValueError("classifier training needs labelled "
                             "batches: set clf.data.return_target=true")
        imgs, targets = b
        x = torch.from_numpy(imgs).to(device, non_blocking=True)
        y = torch.from_numpy(targets.astype(np.int64)).to(device)
        return step_fn(state, x, y, rng)[1]

    run_knobs = knobs.resolved(ccfg)
    run_knobs["bf16"] = bool(tcfg.get(
        "bf16", config.diffusion.training.get("bf16", False)))
    stats = _run_epochs(tcfg, state, lambda: iter(loader), step_on, device,
                        "clf", run_knobs, start_epoch, max_steps, stop,
                        layout)
    if layout is not None:
        state = fsdp.gather_state(state, layout)
    return state, stats
