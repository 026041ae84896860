"""Sampling (``psld_tpu/eval/generate.py``): unconditional ``sample``,
classifier-guided ``class_cond_sample``, ``inpaint`` and SDEdit-style
``edit``.

``sample`` runs any unguided sampler, the probability-flow ODE ones
(``rk_ode``, ``ei_ode``, ``adaptive_ode``, ``bb_ode``) included;
``class_cond_sample`` runs a guided one (``cc_em_sde``, ``cc_ei_ode``).
The ODE samplers are deterministic and ignore the batch's generator
beyond its prior draw, and count their network evaluations: a batch's
``nfe`` is what its sampler counted.

One device a process: the sample count is drawn in batches of
``evaluation.batch_size``; batch ``k`` gets its own generator seeded from
(``evaluation.seed``, k), which draws its prior sample (or, for
``inpaint`` and ``edit``, the draws that forward-diffuse its dataset
images) and its trajectory noise. A tail batch is drawn full-width and
sliced, as in the JAX package. ``inpaint`` and ``edit`` take batch k from
the dataset's images k * batch_size onwards, wrapping around its end.

Per-rank fan-out, as the JAX package's (``_rank_info``): independent
processes, each told ``evaluation.rank`` and ``evaluation.num_processes``
(N), each on its own card. Rank r takes ceil(n_samples / N) samples and
writes them as ``output_<prefix>_<r>_<batch>_<i>``; nothing is gathered.
With N > 1 batch k of rank r draws from a generator seeded from
(``evaluation.seed``, k) with r as numpy's spawn key
(``data.datasets.batch_generator``): the JAX package folds the rank into
its threefry key, which a Philox generator cannot reproduce, so this is
the port's own rule (N = 1 keeps the seeding of one process). Guided labels
cycle over global batch slots, batch k of rank r taking label
``(k * N + r) mod len(labels)``; ``inpaint`` and ``edit`` take dataset
images ``((k * batch_size + i) * N + r) mod len(dataset)``.

Lockstep sampling, as the JAX package's under its multi-process runtime:
under a process group of N ranks (``torchrun``, or ``PSLD_MULTIHOST=1``)
with ``evaluation.rank`` and ``evaluation.num_processes`` unset, every
rank runs the same loop over global batches of ``batch_size * N`` with
the generators one process would use, and keeps its own rows: rank r
takes rows ``r * batch_size`` onwards of the prior draw and of every
trajectory draw (drawn at the global width and sliced), and writes them
as ``output_<prefix>_<r>_<batch>_<i>``. ``n_samples`` is the total; a
tail batch is drawn full-width, and a rank writes only its rows below
the tail's count. The batch statistics some samplers take (the
corrector's step size, ``adaptive_ode``'s error norm) are means over the
global batch (``distributed.global_mean``). Inpainting, editing and
``bb_ode`` refuse lockstep, as in the JAX package.

Spatial parallelism (``evaluation.spatial=S``,
:mod:`psld_tpu_torch.parallel.spatial`): under a process group whose
world size S divides, each image's height is split over spatial groups
of S consecutive ranks, and a spatial group counts as one process of the
above (lockstep over the world / S data groups, fan-out, the dataset
images). The prior and every step's noise are drawn whole and sliced, so
a rank's rows are one process's; the sample-wise norms (the corrector's)
are summed over the group before their square root, the batch means are
over every rank; ``bb_ode`` gathers its state before it goes to the
host. Rows are gathered over the group before writing, and the group's
first rank writes each image once. Inpainting, editing and ``bb_ode`` run
under spatial groups, and refuse lockstep over several data groups.

``evaluation.sampler.corrector`` (``langevin``, with ``corrector_snr`` and
``corrector_steps``) adds a corrector to ``sample``, ``class_cond_sample``
and ``edit``; ``inpaint`` runs without one, as in the JAX package.

``evaluation.chkpt_path`` names a ``torch.save`` file
``{"params": state_dict, "ema_params": state_dict, "step": int}``;
``evaluation.sample_from`` picks ``ema_params`` (``target``) or ``params``.
``evaluation.device`` (default ``cuda``) is where the network runs.
``evaluation.nfe_per_dispatch`` is accepted and has no effect: the port
has no per-dispatch watchdog to split trajectories for.

``class_cond_sample`` reads the classifier's checkpoint
(``clf.evaluation.chkpt_path``) for its ``params``: the classifier's step
never updates its EMA, so ``ema_params`` there are its initial weights.
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
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.data.datasets import (InpaintDataset, SDELatentDataset,
                                          batch_generator)
from psld_tpu_torch.data.loader import get_dataset
from psld_tpu_torch.eval.writers import (InpaintingImageWriter,
                                         SimpleImageWriter)
from psld_tpu_torch.parallel import distributed, spatial
from psld_tpu_torch.parallel.mesh import shard_batch
from psld_tpu_torch.registry import get_module
from psld_tpu_torch.samplers.base import make_timesteps
from psld_tpu_torch.samplers.correctors import build_corrector
from psld_tpu_torch.samplers.ode import AdaptiveODESampler, BBODESampler
from psld_tpu_torch.samplers.sde_samplers import (EditEulerMaruyamaSampler,
                                                  EulerMaruyamaInpainter)

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


def _spatial_setup(config) -> None:
    """``evaluation.spatial`` for this process's later forwards: S must
    divide the world size and the image height (the JAX package's
    messages)."""
    spatial.configure(int(config.evaluation.get("spatial", 1) or 1),
                      int(config.data.image_size))


def _lockstep(config):
    """(data group, data groups) when the run samples lockstep: a process
    group of more than one data group (more than one rank without
    spatial parallelism), ``evaluation.rank`` and
    ``evaluation.num_processes`` unset; else None."""
    ecfg = config.evaluation
    if int(ecfg.get("num_processes", 0)) > 0 or int(ecfg.get("rank", -1)) >= 0:
        return None
    rank, world = distributed.data_info()
    return (rank, world) if world > 1 else None


def _refuse_lockstep(config, what: str) -> None:
    if _lockstep(config) is not None:
        raise NotImplementedError(
            "under a process group only prior-seeded samplers run lockstep "
            "(em_sde/sscs_sde/sscs2m_sde/rk_ode/adaptive_ode/ei_ode and the "
            f"guided ones), not {what}; for inpainting, editing or bb_ode "
            "launch one single-process job per rank with evaluation.rank=R "
            "evaluation.num_processes=N")


def _rank_info(config) -> tuple[int, int]:
    """(rank, num_processes) of per-rank fan-out: ``evaluation.rank`` and
    ``evaluation.num_processes``, which default to the process group's
    (0 and 1 without one). Lockstep sampling counts as one process."""
    ecfg = config.evaluation
    if _lockstep(config) is not None:
        return 0, 1
    rank = int(ecfg.get("rank", -1))
    nproc = int(ecfg.get("num_processes", 0))
    group_rank, world = distributed.data_info()
    nproc = nproc if nproc > 0 else world
    rank = rank if rank >= 0 else group_rank
    if not rank < nproc:
        raise ValueError(f"rank {rank} out of range for {nproc} processes")
    return rank, nproc


def _rows(x, rank: int, world: int):
    """Rank ``rank``'s rows (of ``world``) of ``x``, a tensor or a
    tuple."""
    if isinstance(x, tuple):
        return tuple(_rows(v, rank, world) for v in x)
    return shard_batch(x, rank, world)


def _lockstep_means(sampler) -> None:
    """The sampler's and its corrector's batch means over the global
    batch."""
    for obj in (sampler, getattr(sampler, "corrector_fn", None)):
        if hasattr(obj, "batch_mean"):
            obj.batch_mean = distributed.global_mean


def _latent_source(sde, config, device):
    """Batch source of the prior: batch k is a prior draw from its
    generator, on ``device``."""
    latent = SDELatentDataset(sde, config)
    return lambda k, gen, width: latent.sample_batch(gen, width,
                                                     device=device)


def _dataset_source(dataset, device, images_only: bool = False,
                    rank: int = 0, nproc: int = 1):
    """Batch source of a dataset: batch k of ``rank`` (of ``nproc``)
    holds the images ``(k * width + i) * nproc + rank``, wrapping around
    the end, as float32 tensors on ``device``; a tuple where the dataset
    gives one (images and masks), unless ``images_only``, which drops a
    labelled dataset's labels."""
    def batch_at(k, gen, width):
        del gen
        idxs = (np.arange(k * width, (k + 1) * width) * nproc + rank) \
            % len(dataset)
        arrays = dataset.batch(idxs)
        if isinstance(arrays, tuple) and images_only:
            arrays = arrays[0]
        if isinstance(arrays, tuple):
            return tuple(torch.from_numpy(np.asarray(a, np.float32))
                         .to(device) for a in arrays)
        return torch.from_numpy(np.asarray(arrays, np.float32)).to(device)

    return batch_at


def _run_sampler(config, sde, sampler_at, writer, batch_at, device,
                 prefix_at=None, n_samples=None, seed=None,
                 file_tag=None) -> list:
    """The batch loop: input batch, trajectory, write; returns one dict of
    stats per batch (samples written, NFE, the trajectory's seconds with
    its copy to the host, the write's seconds, non-finite values; the NFE
    is the grid's unless the sampler counts its own).
    ``sampler_at(k)`` is batch k's sampler; ``batch_at(k, generator,
    width)`` its input (a prior draw, or dataset images); ``prefix_at(k)``,
    when given, its file-name prefix. An input that is a tuple (images
    and masks) goes to the writer too. ``n_samples`` and ``seed`` default
    to ``evaluation``'s: this rank's share of ``n_samples``, and the
    rank's generators under fan-out (see the module's docstring).
    ``file_tag`` (default the rank) is the number the writer puts in the
    file names. Lockstep (see the module's docstring): the batches are
    global, each of ``world`` times ``evaluation.batch_size``, and the
    stats count this rank's rows."""
    ecfg = config.evaluation
    rank, nproc = _rank_info(config)
    lock = _lockstep(config)
    lock_rank, world = (0, 1) if lock is None else lock
    split = spatial.active()
    writes = distributed.spatial_info()[0] == 0
    if n_samples is None:
        n_samples = -(-int(ecfg.n_samples) // nproc)
    if file_tag is None:
        file_tag = lock_rank if lock is not None else rank
    denoise = bool(ecfg.denoise)
    n_steps = int(ecfg.n_discrete_steps)
    n_eff = n_steps - 1 if denoise else n_steps
    ts = make_timesteps(n_eff, float(ecfg.eval_eps), sde.T,
                        str(ecfg.stride_type))
    eps = float(ecfg.eval_eps)
    per_step = int(ecfg.batch_size)
    n_samples = int(n_samples)
    seed = int(ecfg.seed if seed is None else seed)
    width = per_step * world
    written, batches = 0, []
    for batch_idx in range(-(-n_samples // width)):
        take = min(width, n_samples - written)
        mine = min(max(take - lock_rank * per_step, 0), per_step)
        t0 = time.perf_counter()
        gen = batch_generator(seed, batch_idx, device,
                              rank if nproc > 1 else None)
        z = batch_at(batch_idx, gen, width)
        sampler = sampler_at(batch_idx)
        noise = None
        if lock is not None or split:
            z = _rows(z, lock_rank, world)
            _lockstep_means(sampler)
            sp = distributed.spatial_info()[1]

            def noise(k, like, gen=gen):
                """Draw ``k`` at the global width and the whole height;
                this rank's rows and height slice."""
                shape = (like.shape[0] * world, like.shape[1] * sp) \
                    + tuple(like.shape[2:])
                return spatial.height_slice(_rows(torch.randn(
                    shape, generator=gen, dtype=like.dtype,
                    device=like.device), lock_rank, world))
        rows = z
        z = spatial.height_slice(z)
        nfe0 = getattr(sampler, "nfe", None)
        out = sampler.sample(gen, z, ts, n_eff, denoise=denoise, eps=eps,
                             noise=noise)
        with torch.no_grad():
            out = spatial.gather(out, 1)
        out = out[:mine].float().cpu().numpy()
        stats = {"batch": batch_idx, "samples": mine, "width": per_step,
                 "nfe": (len(ts) - 1 + int(denoise) if nfe0 is None
                         else sampler.nfe - nfe0),
                 "seconds": time.perf_counter() - t0,
                 "nonfinite": int(out.size - np.isfinite(out).sum())}
        if prefix_at is not None:
            writer.sample_prefix = prefix_at(batch_idx)
        t0 = time.perf_counter()
        if not writes:
            pass  # the spatial group's first rank writes its rows
        elif isinstance(rows, tuple):
            writer.write_batch(out, rank=file_tag, batch_idx=batch_idx,
                               batch=tuple(b[:mine].float().cpu().numpy()
                                           for b in rows))
        else:
            writer.write_batch(out, rank=file_tag, batch_idx=batch_idx)
        stats["write_seconds"] = time.perf_counter() - t0
        written += take
        batches.append(stats)
        logger.info("batch %(batch)d: %(samples)d samples, %(nfe)d NFE in "
                    "%(seconds).3f s, %(nonfinite)d non-finite values", stats)
    return batches


def _writer(config, cls=SimpleImageWriter, is_augmented=None,
            save_path=None):
    """A ``cls`` writer from ``evaluation`` into ``save_path`` (default
    ``evaluation.save_path``); ``is_augmented`` defaults to the SDE's."""
    ecfg = config.evaluation
    if is_augmented is None:
        is_augmented = bool(config.model.sde.get("is_augmented", True))
    return cls(
        str(ecfg.save_path if save_path is None else save_path),
        sample_prefix=str(ecfg.sample_prefix),
        path_prefix=str(ecfg.path_prefix),
        save_mode=str(ecfg.save_mode),
        is_norm=bool(config.data.norm),
        is_augmented=is_augmented,
    )


def build_unguided(config, preloaded=None):
    """The set-up of unconditional sampling, shared by ``sample`` and
    serving: the SDE, the ``evaluation.sampler`` (with its corrector) on
    the score network from ``evaluation.chkpt_path`` (or ``preloaded``,
    its weights in place) on ``evaluation.device``, the prior's batch
    source and the device. A guided sampler, spatial fan-out, a rank
    outside ``num_processes`` and a missing card are refused before the
    checkpoint is read."""
    ecfg = config.evaluation
    _spatial_setup(config)
    _rank_info(config)  # raises on a rank outside num_processes
    device = distributed.run_device(ecfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: set evaluation.device=cpu to "
                           "sample on the CPU")
    sampler_cls = get_module("samplers", str(ecfg.sampler.name))
    if sampler_cls.guided:
        raise ValueError(f"evaluation.sampler.name={ecfg.sampler.name} is "
                         "guided: use cli.class_cond_sample")
    if issubclass(sampler_cls, BBODESampler):
        _refuse_lockstep(config, "bb_ode (a SciPy host loop)")
    sde = build_sde(config)
    net = preloaded if preloaded is not None else load_eval_state(config)
    net = net.eval().to(device)
    score_fn = make_score_fn(net, bf16=eval_bf16(config))
    sampler = sampler_cls(config, sde, score_fn, corrector_fn=(
        build_corrector(config, sde, score_fn)))
    return sde, sampler, _latent_source(sde, config, device), device


def sample(config, preloaded=None):
    """Unconditional generation; ``preloaded`` is a score network with
    its weights already in place (skips the checkpoint). Returns the
    per-batch stats of ``_run_sampler``."""
    sde, sampler, batch_at, device = build_unguided(config, preloaded)
    with torch.inference_mode():
        batches = _run_sampler(config, sde, lambda _: sampler,
                               _writer(config), batch_at, device)
    if isinstance(sampler, (BBODESampler, AdaptiveODESampler)) and batches:
        logger.info("%s mean NFE: %.1f", config.evaluation.sampler.name,
                    sampler.mean_nfe)
    return batches


def load_clf_model(ccfg):
    """The classifier with the ``params`` of ``clf.evaluation.chkpt_path``,
    in eval mode on the CPU, its weights not requiring grad."""
    net = get_module("clf_fn", str(ccfg.model.clf_fn.name)).from_config(ccfg)
    ckpt = torch.load(str(ccfg.evaluation.chkpt_path), map_location="cpu",
                      weights_only=True)
    net.load_state_dict(ckpt["params"], strict=True)
    return net.eval().requires_grad_(False)


def _parse_label_spec(spec, n_cls: int) -> list:
    """``label_to_sample``: one class, a comma list, or ``all``."""
    s = str(spec)
    if s == "all":
        return list(range(n_cls))
    if "," in s:
        labels = [int(x) for x in s.split(",") if x != ""]
    else:
        labels = [int(s)]
    bad = [y for y in labels if not 0 <= y < n_cls]
    if bad:
        # a label out of range would select no class: fail loudly
        raise ValueError(
            f"label_to_sample {bad} out of range for n_cls={n_cls}")
    return labels


def _merged_eval_config(config):
    """The diffusion tree with the ``clf`` tree beside its keys: the
    guided sampler reads ``clf.evaluation.*`` and the diffusion
    evaluation tree."""
    merged = ConfigDict(config.diffusion.to_dict())
    merged["clf"] = ConfigDict(config.clf.to_dict())
    return merged


def class_cond_sample(config):
    """Classifier-guided generation; ``config`` carries both the
    ``diffusion`` and ``clf`` trees. With several labels
    (``label_to_sample`` a list or ``all``) batch k samples label k (mod
    the list) and writes under the prefix ``{sample_prefix}y{label}``.
    The score network runs under ``no_grad``, and the guidance takes its
    gradient into the input alone. Returns the per-batch stats of
    ``_run_sampler``, each with its ``label``."""
    dcfg = config.diffusion
    ecfg = dcfg.evaluation
    _spatial_setup(dcfg)
    device = distributed.run_device(ecfg.get("device", "cuda"))
    sampler_cls = get_module("samplers", str(ecfg.sampler.name))
    if not sampler_cls.guided:
        raise ValueError(f"class_cond_sample needs a guided sampler "
                         f"(cc_em_sde, cc_ei_ode), not {ecfg.sampler.name}")
    labels = _parse_label_spec(config.clf.evaluation.label_to_sample,
                               int(config.clf.model.clf_fn.n_cls))
    sde = build_sde(dcfg)
    net = load_eval_state(dcfg).to(device)
    clf = load_clf_model(config.clf).to(device)
    merged = _merged_eval_config(config)
    bf16 = eval_bf16(merged)
    score_fn = make_score_fn(net, bf16=bf16)
    clf_fn = make_score_fn(clf, bf16=bf16)

    rank, nproc = _rank_info(dcfg)
    per_rank = -(-int(ecfg.n_samples) // nproc)
    n_slots = -(-per_rank // int(ecfg.batch_size)) * nproc
    if n_slots < len(labels):
        logger.warning(
            "label cycling is per batch: n_samples=%s fills only %d batch "
            "slots for %d labels -- classes %s will NOT be sampled",
            ecfg.n_samples, n_slots, len(labels), labels[n_slots:])

    def label_at(i):
        """Batch i's label: its global batch slot's, i * N + rank."""
        return labels[(i * nproc + rank) % len(labels)]

    corrector = build_corrector(merged, sde, score_fn)
    samplers = {y: sampler_cls(merged, sde, score_fn, clf_fn=clf_fn,
                               corrector_fn=corrector, y=y)
                for y in labels}
    base_prefix = str(ecfg.sample_prefix)
    prefix_at = (lambda i: f"{base_prefix}y{label_at(i)}") \
        if len(labels) > 1 else None
    with torch.no_grad():
        batches = _run_sampler(dcfg, sde, lambda i: samplers[label_at(i)],
                               _writer(dcfg, is_augmented=True),
                               _latent_source(sde, dcfg, device), device,
                               prefix_at=prefix_at)
    for row in batches:
        row["label"] = label_at(row["batch"])
    return batches


def _dataset_synthesis(config, build_sampler, batch_at_of, writer) -> list:
    """Shared body of ``inpaint`` and ``edit``, which start from dataset
    images: the score network from the checkpoint on
    ``evaluation.device``, the sampler ``build_sampler(sde, score_fn)``,
    batches from ``batch_at_of(dataset, device)``, written by
    ``writer``; ``batch_at_of(dataset, device, rank, num_processes)``
    gives this rank's batches."""
    ecfg = config.evaluation
    _spatial_setup(config)
    _refuse_lockstep(config, "inpainting or editing (dataset images)")
    device = distributed.run_device(ecfg.get("device", "cuda"))
    sde = build_sde(config)
    net = load_eval_state(config).to(device)
    dataset = get_dataset(config)
    rank, nproc = _rank_info(config)
    with torch.inference_mode():
        sampler = build_sampler(sde, make_score_fn(net,
                                                   bf16=eval_bf16(config)))
        return _run_sampler(config, sde, lambda _: sampler, writer,
                            batch_at_of(dataset, device, rank, nproc),
                            device)


def inpaint(config) -> list:
    """Inpainting of dataset images under MNIST-digit masks (square masks
    where MNIST is absent; ``data.InpaintDataset``): the known region
    (mask 1) is kept, the rest generated. Writes the samples under
    ``images/``, the ground truth under ``batch/`` and the masked input
    under ``corrupt/``. Returns the per-batch stats of ``_run_sampler``."""
    return _dataset_synthesis(
        config,
        lambda sde, score_fn: EulerMaruyamaInpainter(config, sde, score_fn),
        lambda dataset, device, rank, nproc: _dataset_source(
            InpaintDataset(config, dataset), device, rank=rank,
            nproc=nproc),
        _writer(config, InpaintingImageWriter))


def edit(config) -> list:
    """SDEdit-style editing of dataset images: each is forward-diffused to
    ``evaluation.sampler.edit_t0`` and reverse-diffused back
    (``edit_em_sde``); labels of a labelled dataset are dropped. Returns
    the per-batch stats of ``_run_sampler``."""
    return _dataset_synthesis(
        config,
        lambda sde, score_fn: EditEulerMaruyamaSampler(
            config, sde, score_fn,
            corrector_fn=build_corrector(config, sde, score_fn)),
        lambda dataset, device, rank, nproc: _dataset_source(
            dataset, device, images_only=True, rank=rank, nproc=nproc),
        _writer(config))
