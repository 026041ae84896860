"""Benchmark of the port (``psld_tpu/eval/bench.py``): CIFAR-10 img/s at
1000-NFE Euler--Maruyama sampling, and the training step's img/s, in one
JSON line.

    python -m psld_tpu_torch.eval.bench

The flagship CIFAR-10 PSLD configuration (NCSN++ nf 128, ch_mult [2,2,2],
8 BigGAN blocks a level, attention at 16x16, FIR, Fourier embedding,
progressive_input residual, dropout 0.15, nu 4.02, gamma 0.02; 97.6M
parameters, drawn as N(0, 1) * 0.02 from a numpy seed) runs:

- sampling: bf16 EM (``PSLD_BENCH_F32=1``: float32) over
  ``make_timesteps(nfe - 1, 1e-3)`` with the mean-only denoise step, at
  batch 64, through the sampler and score function ``cli.sample`` runs
  (eager, no CUDA graph). A short run of ``WARMUP_NFE`` NFE builds the
  kernels first; then one full run from a prior draw already on the
  device is timed on the host clock, to a device sync and the sample's
  copy to the host.
- training: the step ``cli.train_sde`` runs (``train.steps.make_train_step``:
  bf16 compute on float32 master weights, hash dropout ``hw_inline``, HSM,
  Adam with warmup, clip 1, EMA) at batch 128: one warm-up step, then 10
  timed, the loss read on the host at the end.

``gn_bf16`` is on unless ``PSLD_GN_BF16=0``. Overrides: ``PSLD_BENCH_BATCH``,
``PSLD_BENCH_NFE``, ``PSLD_BENCH_NF`` (width), ``PSLD_BENCH_TRAIN=0`` (no
train phase), ``PSLD_BENCH_TRAIN_BATCH``.

MFU divides the model FLOPs by the time and by the H100 SXM's dense bf16
peak, 989e12 FLOP/s. The FLOPs are those of convolutions and matrix
products, 2 a multiply-add, counted by ``torch.utils.flop_counter`` on the
CPU through the plain versions of the ops (the counter does not see the
card's hand-written kernels): one network forward at batch 1 times
``batch`` times ``nfe``, and one training step's forward and backward at
batch 1 times the train batch (the count is linear in the batch). A
transposed convolution (FIR upsampling) counts its multiply-adds per input
pixel. The JAX package's bench reads XLA's cost model instead, which also
counts elementwise work, so the line's ``flops_counted`` says
``conv+matmul``: its FLOP and MFU keys keep the JAX line's names but not
its definition. The sampler's own arithmetic is left out of both.

``vs_baseline`` divides by the JAX bench's estimate of the reference's
1000-NFE EM throughput on one V100 (0.25 img/s; the reference publishes
none), so ``baseline_is_estimate`` is true. ``device`` is the card's name
and power limit as ``nvidia-smi`` prints them.

No card and no explicit ``device``: :func:`run_bench` raises; it never
measures the CPU unless asked to.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

REF_GPU_IMG_PER_SEC = 0.25
# dense bf16 tensor-core peak of one H100 SXM, FLOP/s
H100_BF16_PEAK = 989e12
WARMUP_NFE = 3
TRAIN_WARMUP, TRAIN_TIMED = 1, 10
IMAGE_SIZE = 32

FLAGSHIP_ARGS = [
    "+dataset=cifar10/cifar10_psld",
    "dataset.diffusion.data.root=/unused",
    "dataset.diffusion.model.score_fn.ch_mult=[2,2,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=8",
    "dataset.diffusion.model.score_fn.attn_resolutions=[16]",
    "dataset.diffusion.model.score_fn.dropout=0.15",
    "dataset.diffusion.model.score_fn.progressive_input=residual",
    "dataset.diffusion.model.score_fn.fir=True",
    "dataset.diffusion.model.score_fn.embedding_type=fourier",
]


def flagship_config(nf: int, gn16: bool, train: bool = False):
    """The bench's sampling (or, with ``train``, training) config."""
    import psld_tpu_torch
    from psld_tpu_torch.config import compose

    psld_tpu_torch.import_modules_into_registry()
    extra = ([
        "+dataset.diffusion.model.score_fn.dropout_impl=hw_inline",
        "+dataset.diffusion.training.bf16=True",
    ] if train else [
        "dataset.diffusion.model.sde.nu=4.02",
        "dataset.diffusion.model.sde.gamma=0.02",
    ])
    return compose(FLAGSHIP_ARGS + [
        f"dataset.diffusion.model.score_fn.nf={nf}",
        f"+dataset.diffusion.model.score_fn.gn_bf16={gn16}",
    ] + extra).dataset.diffusion


def random_weights(net, rng: np.random.Generator) -> dict:
    """Every state_dict entry N(0, 1) * 0.02 from ``rng``, in key order."""
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape))
                                 * 0.02).astype(np.float32))
            for k, v in sorted(net.state_dict().items())}


def count_flops(config, batch: int = 1, train: bool = False) -> float:
    """FLOPs of the convolutions and matrix products of one network
    forward (``train``: one training step's forward and backward) at
    ``batch``, counted on the CPU through the plain versions."""
    from torch.utils.flop_counter import FlopCounterMode

    from psld_tpu_torch.config import ConfigDict
    from psld_tpu_torch.eval.generate import build_score_model, build_sde
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import StepRandom, make_train_step

    net = build_score_model(config)
    sde = build_sde(config)
    s, c = int(config.data.image_size), int(config.data.num_channels)
    counter = FlopCounterMode(display=False)
    if not train:
        # PSLD's state carries the momentum half beside x
        x = torch.zeros(batch, s, s, 2 * c if sde.is_augmented else c)
        t = torch.full((batch,), 0.5)
        with counter, torch.no_grad():
            net.eval()(x, t)
        return float(counter.get_total_flops())
    # the dtype moves no FLOP: count the float32 step
    tree = config.to_dict()
    tree["training"]["bf16"] = False
    config = ConfigDict(tree)
    criterion = get_module("losses", config.training.loss.name)(config, sde)
    step, optimizer = make_train_step(net, sde, criterion, config)
    state = init_state(dict(net.named_parameters()), optimizer)
    with counter:
        step(state, torch.zeros(batch, s, s, c), StepRandom(0))
    return float(counter.get_total_flops())


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``torch.cuda.get_device_name`` where it is missing); ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_sampling(cfg, device, batch: int, nfe: int, bf16: bool) -> float:
    """Seconds of one ``nfe``-NFE EM trajectory at ``batch``, after a
    ``WARMUP_NFE`` one."""
    from psld_tpu_torch.eval.generate import (build_score_model, build_sde,
                                              make_score_fn)
    from psld_tpu_torch.samplers.base import make_timesteps
    from psld_tpu_torch.samplers.sde_samplers import EulerMaruyamaSampler

    sde = build_sde(cfg)
    net = build_score_model(cfg)
    net.load_state_dict(random_weights(net, np.random.default_rng(0)),
                        strict=True)
    net = net.eval().to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (batch, IMAGE_SIZE, IMAGE_SIZE, 3)
    with torch.inference_mode():
        sampler = EulerMaruyamaSampler(cfg, sde,
                                       make_score_fn(net, bf16=bf16))
        z = sde.prior_sampling(gen, shape, device=device)
        sampler.sample(gen, z, make_timesteps(WARMUP_NFE - 1, 1e-3),
                       WARMUP_NFE - 1).cpu()
        ts = make_timesteps(nfe - 1, 1e-3)
        z = sde.prior_sampling(gen, shape, device=device)
        _sync(device)
        start = time.perf_counter()
        out = sampler.sample(gen, z, ts, nfe - 1, denoise=True, eps=1e-3)
        _sync(device)
        out.cpu()
        return time.perf_counter() - start


def _time_training(tcfg, device, batch: int) -> float:
    """Seconds of one training step at ``batch``, the mean of
    ``TRAIN_TIMED`` after ``TRAIN_WARMUP``."""
    from psld_tpu_torch.eval.generate import build_score_model, build_sde
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import StepRandom, make_train_step

    sde = build_sde(tcfg)
    net = build_score_model(tcfg)
    rng = np.random.default_rng(1)
    net.load_state_dict(random_weights(net, rng), strict=True)
    net.to(device)
    criterion = get_module("losses", tcfg.training.loss.name)(tcfg, sde)
    step, optimizer = make_train_step(net, sde, criterion, tcfg)
    state = init_state(dict(net.named_parameters()), optimizer)
    images = torch.from_numpy(rng.standard_normal(
        (batch, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)).to(device)
    step_rng = StepRandom(int(tcfg.training.seed), device)
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, images, step_rng)
    float(metrics["loss"])
    start = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        state, metrics = step(state, images, step_rng)
    float(metrics["loss"])
    return (time.perf_counter() - start) / TRAIN_TIMED


def run_bench(batch: int | None = None, nfe: int | None = None,
              device=None) -> dict:
    """The bench's line as a dict (see the module's docstring).
    ``device`` defaults to ``cuda``; without a card it must be given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench measures the card;"
                               " pass device='cpu' to run it on the CPU")
        device = "cuda"
    device = torch.device(device)
    batch = int(os.environ.get("PSLD_BENCH_BATCH", 64)
                if batch is None else batch)
    nfe = int(os.environ.get("PSLD_BENCH_NFE", 1000) if nfe is None else nfe)
    nf = int(os.environ.get("PSLD_BENCH_NF", 128))
    gn16 = os.environ.get("PSLD_GN_BF16", "1") != "0"
    bf16 = os.environ.get("PSLD_BENCH_F32", "0") != "1"
    do_train = os.environ.get("PSLD_BENCH_TRAIN", "1") != "0"
    train_bs = int(os.environ.get("PSLD_BENCH_TRAIN_BATCH", 128))

    cfg = flagship_config(nf, gn16)
    tcfg = flagship_config(nf, gn16, train=True) if do_train else None
    # counted before anything is timed: a few seconds on the host
    fwd_flops = count_flops(cfg) * batch
    train_flops = count_flops(tcfg, train=True) * train_bs if do_train \
        else None

    elapsed = _time_sampling(cfg, device, batch, nfe, bf16)
    value = batch / elapsed
    program_flops = fwd_flops * nfe
    out = {
        "metric": f"CIFAR-10 img/sec/chip at {nfe}-NFE EM sampling",
        "value": value,
        "unit": "img/s",
        "vs_baseline": value / REF_GPU_IMG_PER_SEC,
        "baseline_is_estimate": True,
        "bf16": bf16,
        "gn_bf16": gn16,
        "device": device_label(device),
        "flops_counted": "conv+matmul",
        "model_tflops_per_fwd": fwd_flops / 1e12,
        "program_tflops": program_flops / 1e12,
        "mfu_vs_h100_bf16_peak": program_flops / elapsed / H100_BF16_PEAK,
    }
    if do_train:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        step_s = _time_training(tcfg, device, train_bs)
        out.update({
            "train_img_per_s": train_bs / step_s,
            "train_batch": train_bs,
            "train_bf16": True,
            "train_dropout_impl": "hw_inline",
            "train_step_tflops": train_flops / 1e12,
            "train_mfu_vs_h100_bf16_peak":
                train_flops / step_s / H100_BF16_PEAK,
        })
    return out


def main():
    print(json.dumps(run_bench()), flush=True)


if __name__ == "__main__":
    main()
