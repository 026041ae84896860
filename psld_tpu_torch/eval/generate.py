"""Unconditional sampling driver (``psld_tpu/eval/generate.py::sample``).

One device, one process: the sample count is drawn in batches of
``evaluation.batch_size``; batch ``k`` gets its own generator seeded from
(``evaluation.seed``, k), which draws its prior sample and its trajectory
noise. A tail batch is drawn full-width and sliced, as in the JAX
package.

``evaluation.chkpt_path`` names a ``torch.save`` file
``{"params": state_dict, "ema_params": state_dict, "step": int}``;
``evaluation.sample_from`` picks ``ema_params`` (``target``) or ``params``.
``evaluation.device`` (default ``cuda``) is where the network runs.
``evaluation.nfe_per_dispatch`` is accepted and has no effect: the port
has no per-dispatch watchdog to split trajectories for.
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch

import psld_tpu_torch.models  # noqa: F401  (registers the score nets)
import psld_tpu_torch.samplers  # noqa: F401  (registers the samplers)
import psld_tpu_torch.sde  # noqa: F401  (registers the SDEs)
from psld_tpu_torch.data.datasets import SDELatentDataset, batch_generator
from psld_tpu_torch.eval.writers import SimpleImageWriter
from psld_tpu_torch.registry import get_module
from psld_tpu_torch.samplers.base import make_timesteps

logger = logging.getLogger(__name__)


def build_sde(config):
    return get_module("sde", config.model.sde.name)(config)


def build_score_model(config):
    return get_module("score_fn", config.model.score_fn.name).from_config(
        config)


def load_eval_state(config, net=None):
    """The score network with the checkpoint's EMA or online weights, per
    ``evaluation.sample_from``, in eval mode on the CPU."""
    net = net or build_score_model(config)
    ckpt = torch.load(str(config.evaluation.chkpt_path), map_location="cpu",
                      weights_only=True)
    use_ema = str(config.evaluation.sample_from) == "target"
    if use_ema:
        # before the EMA settles it is a lagged average over moving
        # params, which can sample pure noise
        tau = float(config.training.ema_decay)
        step = int(ckpt.get("step", 0))
        if step < int(5.0 / max(1e-12, 1.0 - tau)):
            logger.warning(
                "sample_from=target after only %d train steps: the EMA "
                "(decay=%s) is still a lagged average over moving params "
                "and can sample pure noise -- use sample_from=source or a "
                "smaller ema_decay for short runs", step, tau)
    net.load_state_dict(ckpt["ema_params" if use_ema else "params"],
                        strict=True)
    return net.eval()


def eval_bf16(config) -> bool:
    """``evaluation.bf16``: the network runs in bfloat16; the SDE math
    stays float32/float64."""
    return bool(config.evaluation.get("bf16", False))


def make_score_fn(net, bf16: bool = False):
    """Inference score function on ``net``'s device; ``bf16=True`` runs a
    bfloat16 copy of the weights on a bfloat16 input and returns f32."""
    if not bf16:
        return lambda z, t: net(z, t)
    net16 = copy.deepcopy(net).to(torch.bfloat16)
    return lambda z, t: net16(z.to(torch.bfloat16), t).float()


def _check_single_device(ecfg) -> None:
    corrector = str(ecfg.sampler.get("corrector", "none"))
    if corrector not in ("none", "None", ""):
        raise NotImplementedError(
            f"evaluation.sampler.corrector={corrector}: correctors are not "
            "ported yet")
    if int(ecfg.get("num_processes", 0) or 0) > 1 or \
            int(ecfg.get("spatial", 1) or 1) > 1:
        raise NotImplementedError(
            "the port samples on one device: multi-process and spatial "
            "fan-out are not ported yet")


def _run_sampler(config, sde, sampler, writer, latent, device) -> list:
    """The batch loop: prior draw, trajectory, write; returns one dict of
    stats per batch (samples written, NFE, seconds, non-finite values)."""
    ecfg = config.evaluation
    denoise = bool(ecfg.denoise)
    n_steps = int(ecfg.n_discrete_steps)
    n_eff = n_steps - 1 if denoise else n_steps
    ts = make_timesteps(n_eff, float(ecfg.eval_eps), sde.T,
                        str(ecfg.stride_type))
    eps = float(ecfg.eval_eps)
    per_step = int(ecfg.batch_size)
    n_samples = int(ecfg.n_samples)
    seed = int(ecfg.seed)
    written, batches = 0, []
    for batch_idx in range(-(-n_samples // per_step)):
        take = min(per_step, n_samples - written)
        t0 = time.perf_counter()
        gen = batch_generator(seed, batch_idx, device)
        z = latent.sample_batch(gen, per_step, device=device)
        out = sampler.sample(gen, z, ts, n_eff, denoise=denoise, eps=eps)
        out = out[:take].float().cpu().numpy()
        stats = {"batch": batch_idx, "samples": take, "width": per_step,
                 "nfe": len(ts) - 1 + int(denoise),
                 "seconds": time.perf_counter() - t0,
                 "nonfinite": int(out.size - np.isfinite(out).sum())}
        writer.write_batch(out, rank=0, batch_idx=batch_idx)
        written += take
        batches.append(stats)
        logger.info("batch %(batch)d: %(samples)d samples, %(nfe)d NFE in "
                    "%(seconds).3f s, %(nonfinite)d non-finite values", stats)
    return batches


def sample(config, preloaded=None):
    """Unconditional generation; ``preloaded`` is a score network with
    its weights already in place (skips the checkpoint). Returns the
    per-batch stats of ``_run_sampler``."""
    ecfg = config.evaluation
    _check_single_device(ecfg)
    device = torch.device(str(ecfg.get("device", "cuda")))
    sde = build_sde(config)
    net = preloaded if preloaded is not None else load_eval_state(config)
    net = net.eval().to(device)
    sampler_cls = get_module("samplers", str(ecfg.sampler.name))
    writer = SimpleImageWriter(
        str(ecfg.save_path),
        sample_prefix=str(ecfg.sample_prefix),
        path_prefix=str(ecfg.path_prefix),
        save_mode=str(ecfg.save_mode),
        is_norm=bool(config.data.norm),
        is_augmented=bool(config.model.sde.get("is_augmented", True)),
    )
    with torch.inference_mode():
        sampler = sampler_cls(config, sde,
                              make_score_fn(net, bf16=eval_bf16(config)))
        return _run_sampler(config, sde, sampler, writer,
                            SDELatentDataset(sde, config), device)
