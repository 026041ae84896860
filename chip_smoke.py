"""Smoke test of the PyTorch/CUDA port (``psld_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: a CUDA device must be present; its name and power limit are
   printed as ``nvidia-smi`` reports them.
2. build: the CUDA C++ kernels are compiled from ``psld_tpu_torch/csrc``
   with nvcc for sm_90a, one nvcc per source, started together (the
   Triton kernels compile at their first launch).
3. fused_act: the CUDA C++ fused bias + leaky ReLU kernels (forward and
   backward) against their plain versions, bit for bit, in f32 and bf16,
   at the flagship's activation shapes at batch 128 seen as (rows, C), its
   temb width and an odd shape. No path calls the op; this phase drives it.
4. gn: the CUDA C++ GroupNorm+act forward kernel against its plain
   PyTorch version at the (H*W, C) shapes of a flagship forward at batch
   64 (sample, sscs and guided paths) and 128 (train), and of a
   classifier forward at 64 (guided) and 32 (train_clf), H*W = 16
   included; under gn_bf16 bit for bit on at least 99% of the elements.
5. gn_bwd: the CUDA C++ GroupNorm+act backward kernel (dx, dscale,
   dbias) against autograd through the plain version, at the flagship's
   shapes at batch 128 and the classifier's at 64 and 32; its input-only
   mode (dx alone, the likelihood's) at the flagship's shapes at 64.
6. attention: the CUDA C++ attention kernel against its plain version at
   the attention shapes of the same four (network, batch) pairs, N = 16
   tokens included.
7. dropout: the Triton counter-hash dropout kernel against its plain
   version, bit for bit, at the dropout shapes of a flagship training
   step at batch 128 and a classifier step at 32, with an offset, an odd
   size, and its backward.
8. net: the flagship CIFAR-10 NCSN++ (97.6M parameters, weights drawn as
   N(0, 1) * 0.02 from a numpy seed): float32 forward on the card against
   the same forward on the CPU, with the kernel launch counts of one
   forward; then a 3-step Euler-Maruyama trajectory on the card against the
   CPU with the same injected noise; [sscs] then the same for a 3-NFE SSCS
   trajectory.
9. train_check: one float32 optimizer step of the flagship at batch 2 with
   hash dropout 0.15, on the card against the CPU with the same t, eps and
   seed words: loss, gradient norm and every parameter's gradient, and the
   kernel launch counts of one step.
10. clf_check: the same for one float32 step of the shipped classifier
    (loss, top-1, every parameter's gradient), then one float32 guidance
    gradient into the input, on the card against the CPU.
11. train: ``psld_tpu_torch.cli.train_sde`` on the synthetic dataset at the
    flagship's training point (batch 128, bf16 compute on float32 master
    weights, hash dropout 0.15, HSM loss, Adam with warmup, clip 1, EMA):
    2 warm-up and 10 timed steps with one sync at the end, a checkpoint
    written; every GroupNorm, attention and dropout call must have gone
    through the kernels.
12. sample: ``psld_tpu_torch.cli.sample`` loads the checkpoint the train
    phase wrote (batch 64, bf16 network, gn_bf16, 100-NFE EM with denoise)
    and writes 64 PNGs; every GroupNorm and attention call of that run must
    have gone through the kernels.
13. train_clf: ``psld_tpu_torch.cli.train_clf`` at the shipped classifier's
    width and batch 32 (bf16 compute, hash dropout 0.1), one epoch of the
    synthetic set, 16 steps, a checkpoint written.
14. interop: ``psld_tpu_torch.cli.export_checkpoint`` of the train
    checkpoint to a reference (mandt-lab) Lightning ``.ckpt``, then
    ``psld_tpu_torch.cli.convert_checkpoint`` back; the same with
    ``--clf`` for the train_clf checkpoint: every tensor of ``params``
    and ``ema_params`` bit-equal to the original (the classifier's
    ``params`` in both), the step carried, no kernel launched; the
    ``.ckpt``'s tensor count and size and the seconds each way.
15. serve: ``psld_tpu_torch.cli.serve`` of the converted flagship
    checkpoint in a thread of this process, batch 64, bf16 network,
    gn_bf16, 100-NFE EM; a client sends ping, info, a request of 64
    with the sample phase's seed, one of 96 (a full batch and a
    partial one), a bad request, the first again into the same
    directory, and shutdown. The first request's PNGs must equal the
    sample phase's bit for bit, the repeat's the first's, and the
    launches must be one forward's for every NFE of every batch (the
    warmup's included); warmup seconds and each reply's img/s, with its
    PNG writes and in its trajectories alone, are printed beside the
    sample phase's img/s over the same two spans.
16. guided: ``psld_tpu_torch.cli.class_cond_sample`` from the checkpoints
    of train and train_clf: two batches of 64, labels 0 and 1, 20-NFE
    guided EM with bf16 networks; every GroupNorm (forward and backward)
    and attention call through the kernels.
17. sscs: ``psld_tpu_torch.cli.sample`` with SSCS-2M on the quadratic grid,
    50 NFE at batch 64, bf16, from the train checkpoint.
18. pc_check, inpaint_check, edit_check (run right after the [sscs]
    check): 3-NFE float32 trajectories of the flagship at B=2 on the card
    against the CPU with the same injected draws, within 1e-4 of scale:
    EM and SSCS-2M with one Langevin corrector step a step, inpainting
    under the square mask (its known region equal to x_0 within 1e-2),
    and editing from edit_t0 = 0.5.
19. inpaint: ``psld_tpu_torch.cli.inpaint`` from the train checkpoint on
    the synthetic set with square masks, batch 64, 20-NFE bf16: 64
    samples, ground truths and masked inputs as PNGs, the known region of
    each sample within one level of its ground truth.
20. edit: ``psld_tpu_torch.cli.edit`` the same way, edit_t0 = 0.5.
21. pc: ``psld_tpu_torch.cli.sample`` with a Langevin corrector (one step),
    10 NFE of EM and of SSCS-2M, batch 64, bf16.
22. ode_check (run after clf_check): float32 probability-flow
    trajectories of the flagship at B=2 on the card against the CPU,
    within 1e-4 of scale: rk_ode (Heun, 2 steps), ei_ode (order 2, 3
    steps), adaptive_ode (2 controller iterations, the same NFE on both)
    and cc_ei_ode (2 guided steps, the shipped classifier); one RK4 step
    of the Hutchinson likelihood with the same probes (logp within 1e-4
    relative, its divergence integral and terminal state within 1e-4 of
    scale).
23. ode: ``psld_tpu_torch.cli.sample`` from the train checkpoint, batch
    64, bf16: ei_ode (order 2, 20 NFE), rk_ode (Heun, 10 steps, 21 NFE),
    adaptive_ode and bb_ode (SciPy RK45) at rtol = atol = 1e-2; ms/NFE,
    img/s and each run's NFE.
24. cc_ode: ``psld_tpu_torch.cli.class_cond_sample`` with cc_ei_ode
    (order 2), one batch of 64, label 0, 20 NFE.
25. likelihood: ``psld_tpu_torch.cli.likelihood`` from the train
    checkpoint on the synthetic set, batch 64, bf16, RK4 with 2 steps (8
    right-hand sides, each a forward and an input-only vector-Jacobian
    product), one Hutchinson probe: finite bits/dim, ms a right-hand
    side, peak memory.
26. vp_check (run after ode_check): the VP-SDE baseline
    (``cifar10_vpsde``, 61,804,419 parameters, weights N(0, 1) * 0.02
    from a numpy seed) in float32 on the card against the CPU: one
    training step at B=2 with hash dropout 0.1 (loss within 1e-4
    relative, every gradient within 1e-3 of its scale, the step's launch
    counts), 3 NFE of EM, EM with the Langevin corrector, editing and
    ``ei_ode`` at B=2 (1e-4 of scale), one RK4 likelihood step (logp
    1e-4 relative), and the Inception features of 4 images resized to
    299 (random weights, 1e-4 of scale, TF32 switched on around the
    extractor, which turns it off for itself). The kernel phases 4-7 run
    at the VP-SDE's shapes too: GroupNorm and attention at 64 and 128,
    the GN backward at 128 and in its input-only mode at 64, dropout at
    rate 0.1 at 128.
27. vp_train: ``cli.train_sde`` on ``cifar10_vpsde`` at batch 128, bf16,
    ``dropout_impl=hw_inline``, synthetic set, 12 steps: ms/step, img/s,
    peak memory, a checkpoint.
28. vp_sample, vp_pc, vp_edit, vp_ode, vp_likelihood: ``cli.sample``
    (100-NFE EM; 10 NFE of EM with one Langevin step; ``ei_ode``,
    ``rk_ode``, ``adaptive_ode`` and ``bb_ode`` as ``ode``), ``cli.edit``
    (20 NFE) and ``cli.likelihood`` (RK4 x 2, one probe; the VP-SDE's NLL
    without a momentum draw) from that checkpoint at batch 64, bf16.
29. fid: ``cli.fid --fid --kid --isc --save-stats1`` on the card with
    random Inception weights, 64 PNGs of the synthetic set against 64
    others: finite values, the stats file read back and FID from it
    equal, no kernel of the port launched; Inception's images/s at batch
    64. It runs in a thread beside build (its two host square roots
    beside nvcc; no kernel launches then) and prints after it.
30. sweep: ``cli.sweep_fid_nfe`` of the VP-SDE checkpoint over em_sde and
    ei_ode at 20 NFE (each record takes a host square root of 10 to 25 s),
    64 samples a point, FID against the
    synthetic PNGs with a fake ``pt_inception`` checkpoint (random values
    from a numpy seed): every record has a finite ``fid`` and no
    ``quality_error``.
31. hires_gn, hires_gn_bwd, hires_attention, hires_dropout (after the
    kernel phases 4-7): the same at the shapes of CelebA-HQ 256
    (``celebahq256_psld``, 65,623,338 parameters) at its batch 8,
    GroupNorm at up to 65,536 pixels, where the backward's plan holds
    part of its rows in shared memory and reads the rest, and of AFHQv2
    128 (``afhqv2128_psld``, 65,816,582 parameters) at its batch 32,
    dropout at its rate 0.2.
32. hires_check (after vp_check): one float32 training step of CelebA-HQ
    256 at B=1 on the card against the CPU (train_check's tolerances),
    the GN backward's partial residency in float32 too.
33. celebahq_train: ``cli.train_sde`` of CelebA-HQ 256 at batch 8, bf16,
    on a synthetic folder of 256 x 256 PNGs in its ``train/{male,female}``
    layout, read through the native codec with ``prefetch`` 2, and with
    ``profile_dir`` set: 4 profiled and 8 timed steps; one Chrome trace,
    holding the GroupNorm forwards of the 4 profiled steps and no more,
    and the StepTimer's ``data`` share.
34. resume: the same entry point in a process of its own, for one epoch
    with ``auto_resume=true``, gets SIGTERM after its first logged step,
    exits 0 and leaves a checkpoint marked incomplete; the same command
    again resumes at that checkpoint's step, replays its epoch and ends
    at the run's last step.
35. celebahq_sample: ``cli.sample`` of that checkpoint, batch 8, 20-NFE
    EM, bf16: 256 x 256 PNGs.
36. afhq_train: ``cli.train_sde`` of AFHQv2 128 at batch 32, bf16, hash
    dropout 0.2, on a synthetic ``train/{cat,dog,wild}`` folder of 128 x
    128 PNGs: 2 warm-up and 6 timed steps.
37. async_ckpt: the flagship's train state saved by ``save_checkpoint``
    against ``AsyncSaver.save()``'s return time, twice (pinned buffers
    allocated, then reused), a training step at batch 128 after each,
    each file bit-equal to the state at its ``save()``.
38. fanout: ``cli.sample`` of the flagship's train checkpoint as rank 0
    and then rank 1 of ``num_processes=2``, ``n_samples`` 64, batch 64,
    20-NFE EM: 64 PNGs named by rank, the ranks' images apart.
39. ddp: one process launched by ``torch.distributed.run --standalone
    --nproc_per_node=1`` drives ``cli.train_sde`` at [train]'s point
    three times, cuDNN held to its deterministic algorithms: without a
    process group, then under ``PSLD_MULTIHOST=1`` on NCCL at world
    size 1 (the gradient all-reduce, the loss all-reduce, the stop
    agreement), then with ``training.fsdp=true`` (every leaf of 2**14
    elements or more all-gathered and reduce-scattered), ``DDP_STEPS``
    steps each (one epoch). The three checkpoints must be bit-equal;
    ms/step beside [train]'s, and the device ms of the all-reduce
    (and of the whole reduction with its copies) at the flagship's
    gradient shapes.
40. ddp2, fsdp2: two ranks on the one card (NCCL takes one rank a card,
    so they join a gloo group on CUDA tensors; each collective gloo does
    not take on them is staged through the host in this script alone,
    and the choice printed), ``cli.train_sde`` of the flagship in float32
    at 64 a rank, hash dropout 0.15, one epoch of 4 steps, no flips
    (the JAX package's loader draws them per process): data parallel,
    then FSDP. Each state within 1e-4 of each tree's scale of a
    one-process float32 run at batch 128 (FSDP's also of the data
    parallel one); FSDP's bytes a rank beside the JAX package's
    ``per_device_bytes`` rule computed here on the CPU. The dropout
    phase holds the kernel on the rows of a rank at their offset
    ``row0 * H*W*C`` (and at that offset plus 77) against the whole
    batch's dropout.
41. lockstep: two ranks of ``cli.sample`` on the one card (gloo), the
    flagship in float32, 64 rows a rank of global batches of 128, 20 NFE
    of EM with the Langevin corrector (its step size a mean over both
    ranks): 128 distinct PNGs tagged with the rank, each rank's rows
    within 1e-4 of scale of a one-process run's at batch 128.
42. spatial_kernels (after the hires kernel phases): the split
    GroupNorm entries of spatial parallelism (stats, apply, partials, dx)
    at CelebA-HQ 256's shapes at batch 8 (a shard's half of the rows),
    each against its plain version in f32 and in bf16 under gn_bf16, and
    two shards' sums against the fused kernels on the whole map, forward
    and backward; the fused kernels, forward and backward, at the
    attention blocks' gathered map, where they run under spatial
    parallelism; the strided hash dropout (a rank's height slice, ``image =
    (L, Gi)``) at AFHQv2 128's dropout shapes at half height, bit for bit
    against the whole tensor's dropout sliced and its plain version; one
    kernel a stats call and a partials call (``torch.profiler``). Then
    routes: an ``AttnBlock`` at 1,024 tokens and a ``GroupNormAct`` at
    C = 2,048, shapes the kernels refuse, run the plain versions (no
    attention kernel, no kernel at all), card against CPU.
43. spatial2: two ranks of ``cli.train_sde`` on the one card (gloo),
    CelebA-HQ 256 at full width with ``training.spatial=2`` (one image's
    height split over the two), batch 8, 3 steps: in float32 the state
    within 1e-5 of each tree's scale of one process's (Adam's nu through
    its square root: the gradients' units), and two planted faults, the
    halo rows zeroed and GroupNorm on a shard's own moments, each outside
    that tolerance; in bf16 each rank's launch counts (the split entries,
    the attention blocks' fused GroupNorm and attention on the gathered
    map) and its peak memory beside one process's.
44. spatial_sample: ``cli.sample`` (20-NFE EM) and ``cli.inpaint`` of the
    CelebA-HQ checkpoint at batch 8 in float32 with
    ``evaluation.spatial=2`` in two ranks on the card: rank 0 writes each
    image once, its rows within 1e-5 of their scale of one process's.
    The rank processes of 40, 41, 43 and 44 run as three gloo groups
    started together (``phase_ranks``; [lockstep], [ddp2] and [fsdp2]
    share one launch), each rank's allocator held to
    ``RANK_MEMORY_FRACTION`` of the card, beside the one-process
    references in this process (held to ``REFERENCE_MEMORY_FRACTION``)
    and, in a thread, the CPU side of 47; the flagship group trains once
    those references have ended. The ``[ranks]`` line gives the block's
    seconds and the card's least free memory, and each phase's gates and
    planted faults are checked once all have ended.
45. bench: ``psld_tpu_torch.eval.bench.run_bench`` at the flagship's full
    width with 100 NFE (its default is 1000) and its train phase; its line
    is printed after ``[bench] line:``, its img/s and MFU shares must be
    positive, the shares at most 1.05.
46. legacy_gn, legacy_gn_bwd (after spatial_kernels): the GroupNorm
    kernels against their plain versions, as 4 and 5, with no
    activation, at the shapes of NCSNv2's encoder (``legacy_stack``: its
    eight residual blocks with the ``GroupNorm`` normalizer) at batch 128.
47. legacy (its CPU side beside the ranks of 40-44, its card side
    after them): the NCSNv1/v2 component library at the
    widths of NCSNv2's CIFAR-10 model (ngf 128, 232 noise levels from
    ``get_sigmas``, sigma 50 to 0.01, labels below 232), batch 128 at 32
    x 32 with 128 channels and 16 x 16 with 256: the forward and the
    input gradient of every class of ``models/normalization.py`` and
    ``models/legacy_layers.py`` in float32 on the card against the CPU
    with the same weights (1e-4 of scale forward, 1e-3 gradients), the
    GroupNorm cases' launches counted; the encoder stack with the
    ``GroupNorm`` normalizer in bf16 under gn_bf16, forward and backward
    (the legacy path: 16 launches of each GroupNorm kernel, exactly), and
    one forward's device ms of the stack (GroupNorm bf16; InstanceNorm++,
    the published normalization, float32) as a record.

Every path (train, sample, train_clf, interop, serve, guided, sscs,
inpaint, edit, pc, ode, cc_ode, likelihood, vp_train, vp_sample, vp_pc,
vp_edit, vp_ode, vp_likelihood, fid, sweep, bench, celebahq_train,
resume, celebahq_sample, afhq_train, async_ckpt, fanout, ddp, fsdp,
ddp2, fsdp2, lockstep, spatial2, spatial2_f32, spatial_sample,
spatial_inpaint, legacy; resume and the multi-process paths count in
their processes, which print their launches) is driven with the
kernels' launch counts set to 0 just before it and must launch exactly
the kernels its network calls, as many times as its forwards and steps
need (interop and fid: none).

Each kernel's time stands beside its bound (the larger of its bytes over
3.35 TB/s and its operations over the card's peak for their type, from
this run's shapes), its plain version's time, and the time of the one
PyTorch call that computes the same function (``library_ms``; the port
never calls it). Float32 comparisons run with TF32 off. The
second-to-last line is a JSON object listing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import ast
import concurrent.futures
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the port itself: outside a checkout of the repo this import fails, and
# the script ends before it has looked for a card
import psld_tpu_torch  # noqa: E402,F401

import numpy as np  # noqa: E402
import torch  # noqa: E402

from psld_tpu_torch.eval import bench  # noqa: E402

BATCH = 64
SAMPLE_NFE = 100
TRAIN_BATCH = 128
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# steps of each of [ddp]'s three runs: one epoch of the synthetic set
DDP_STEPS = 4

# published peaks of one H100 SXM: bytes/s of device memory, FLOP/s of the
# bf16 tensor cores, and of float32 (and, taken as the same, integer)
# arithmetic outside the tensor cores
HBM_BPS = 3.35e12
BF16_TENSOR_OPS = 989e12
SCALAR_OPS = 67e12

# (H*W, C, calls per flagship forward) of every GroupNorm and attention
GN_CALLS = [(1024, 128, 1), (1024, 256, 27), (1024, 384, 1), (1024, 512, 8),
            (256, 256, 38), (256, 512, 9), (64, 256, 32), (64, 512, 9)]
ATTN_CALLS = [(256, 256, 9), (64, 256, 1)]
# (H*W, C, sites per flagship forward) of the resblocks' dropout
DROPOUT_CALLS = [(1024, 256, 18), (256, 256, 19), (64, 256, 20)]

# the same for the shipped guidance classifier (cifar10_psld.yaml's clf
# tree: nf 128, ch_mult [1,2,2,2], 2 blocks a level, attention at 16^2;
# its middle block attends over the 4x4 map, N = 16)
CLF_GN_CALLS = [(1024, 128, 5), (256, 128, 2), (256, 256, 6), (64, 256, 6),
                (16, 256, 10)]
CLF_ATTN_CALLS = [(256, 256, 2), (16, 256, 1)]
CLF_DROPOUT_CALLS = [(1024, 128, 2), (256, 128, 1), (256, 256, 2),
                     (64, 256, 3), (16, 256, 5)]
CLF_TRAIN_BATCH = 32
GUIDED_NFE = 20
SSCS_NFE = 50
INPAINT_NFE = EDIT_NFE = 20
PC_NFE = 10
BENCH_NFE = 100
# the ODE paths: ei_ode at its documented floor (order 2, 20 NFE), rk_ode
# Heun with 10 steps, the adaptive solvers at a tolerance loose enough for
# the barely trained network (adaptive_ode capped at 2 + 6 * 40 + 1 NFE),
# guided ei_ode at 20 NFE, and the likelihood with 2 RK4 steps (8
# right-hand sides, each a forward and a vector-Jacobian product)
EI_NFE = CC_ODE_NFE = 20
RK_STEPS = 10
ODE_TOL = 1e-2
ODE_MAX_STEPS = 40
LIK_STEPS = 2
# (rows, C) of the fused bias + leaky ReLU phase: the flagship's
# activations at batch 128 seen as (B*H*W, C), its temb width, an odd one
FUSED_ACT_SHAPES = [(128 * 1024, 256), (128 * 256, 256), (128 * 64, 512),
                    (128, 512), (1000, 6)]

# the VP-SDE baseline, cifar10_vpsde.yaml at full width (nf 128, ch_mult
# [1,2,2,2], 4 BigGAN blocks a level, attention at 16^2, positional
# embedding, no FIR, dropout 0.1, 3 channels; 61,804,419 parameters):
# (H*W, C, calls per forward) of every GroupNorm and attention, and the
# (H*W, C, sites) of its dropout; its middle block attends over 4 x 4
VP_GN_CALLS = [(1024, 128, 15), (1024, 256, 5), (1024, 384, 1),
               (256, 128, 2), (256, 256, 20), (256, 384, 1), (256, 512, 4),
               (64, 256, 17), (64, 512, 5), (16, 256, 20), (16, 512, 5)]
VP_ATTN_CALLS = [(256, 256, 5), (16, 256, 1)]
VP_DROPOUT_CALLS = [(1024, 128, 9), (1024, 256, 1), (256, 128, 1),
                    (256, 256, 10), (64, 256, 11), (16, 256, 12)]
VP_RATE = 0.1
VP_PARAMS = 61_804_419
VP_ARGS = ["+dataset=cifar10/cifar10_vpsde",
           "dataset.diffusion.data.root=/unused",
           "+dataset.diffusion.model.score_fn.gn_bf16=True"]
# the sweep's samplers and NFEs (each sampler at each): a record's FID
# takes a host SciPy square root of 10 to 25 s, so the depth is one NFE
SWEEP_SAMPLERS = ("em_sde", "ei_ode")
SWEEP_NFES = (20,)

# CelebA-HQ 256 (celebahq256_psld.yaml at full width: nf 128, ch_mult
# [1,1,2,2,2,2,2], 2 BigGAN blocks a level, attention at 16^2, Fourier
# embedding, FIR, output_skip / input_skip, no dropout, 6 channels;
# 65,623,338 parameters) and AFHQv2 128 (afhqv2128_psld.yaml: nf 128,
# ch_mult [1,2,2,2,3], 2 blocks a level, attention at 16^2, positional
# embedding, dropout 0.2, 6 channels; 65,816,582 parameters): the (H*W,
# C, calls per forward) of every GroupNorm and attention, and the (H*W,
# C, sites) of AFHQ's dropout, as a forward of each network calls them
HQ_GN_CALLS = [(65536, 128, 10), (65536, 256, 3), (16384, 128, 11),
               (16384, 256, 3), (16384, 384, 1), (4096, 128, 2),
               (4096, 256, 10), (4096, 384, 1), (4096, 512, 2),
               (1024, 256, 12), (1024, 512, 3), (256, 256, 15),
               (256, 512, 3), (64, 256, 12), (64, 512, 3), (16, 256, 15),
               (16, 512, 3)]
HQ_ATTN_CALLS = [(256, 256, 3), (16, 256, 1)]
AFHQ_GN_CALLS = [(16384, 128, 9), (16384, 256, 3), (16384, 384, 1),
                 (4096, 128, 2), (4096, 256, 9), (4096, 384, 1),
                 (4096, 512, 2), (1024, 256, 11), (1024, 512, 3),
                 (256, 256, 13), (256, 384, 1), (256, 512, 2),
                 (256, 640, 1), (64, 256, 2), (64, 384, 12), (64, 640, 1),
                 (64, 768, 2)]
AFHQ_ATTN_CALLS = [(256, 256, 3), (64, 384, 1)]
AFHQ_DROPOUT_CALLS = [(16384, 128, 5), (16384, 256, 1), (4096, 128, 1),
                      (4096, 256, 6), (1024, 256, 7), (256, 256, 6),
                      (256, 384, 1), (64, 256, 1), (64, 384, 7)]
AFHQ_RATE = 0.2
HQ_BATCH, AFHQ_BATCH = 8, 32  # the configs' training and sampling batches
HQ_PARAMS, AFHQ_PARAMS = 65_623_338, 65_816_582
HQ_SAMPLE_NFE = FANOUT_NFE = 20
HQ_TIMED, AFHQ_TIMED = 8, 6  # timed steps after the warm-up ones
HQ_ARGS = ["+dataset=celebahq/celebahq256_psld",
           "+dataset.diffusion.model.score_fn.gn_bf16=True"]
AFHQ_ARGS = ["+dataset=afhqv2/afhqv2128_psld",
             "+dataset.diffusion.model.score_fn.gn_bf16=True",
             "+dataset.diffusion.model.score_fn.dropout_impl=hw"]


SPATIAL = 2          # ranks of the spatial group the phases run
SPATIAL_STEPS = 3    # steps of each [spatial2] run
SPATIAL_NFE = 20     # EM NFE of [spatial_sample]
# [spatial2]'s planted faults, each a run that its gate must refuse: the
# halo rows zeroed, GroupNorm of a shard's own moments
SPATIAL_FAULTS = ("halo", "gn")
# the shares of the card's memory a gloo rank's allocator, and this
# process's while it computes the references, may hold while the rank
# groups share the card (``phase_ranks``)
RANK_MEMORY_FRACTION = 0.22
REFERENCE_MEMORY_FRACTION = 0.32


# NCSNv2's CIFAR-10 model (``configs/cifar10.yml`` of the NCSNv2
# repository): ngf 128, 232 noise levels (its num_classes) from sigma 50
# to 0.01, InstanceNorm++, ELU; [legacy] drives the component library at
# these widths, at batch 128 on 32 x 32
LEGACY_NGF, LEGACY_CLASSES = 128, 232
LEGACY_SIGMA_MAX, LEGACY_SIGMA_MIN = 50.0, 0.01
LEGACY_BATCH = TRAIN_BATCH
# the GroupNorm calls of one forward of its eight encoder residual blocks
# with the GroupNorm normalizer (``legacy_stack``): (H*W, C, calls)
LEGACY_GN_CALLS = [(1024, 128, 6), (256, 256, 10)]


def _split_calls(calls, attn_calls):
    """(H*W, C, calls) of a forward's split GroupNorms under spatial
    parallelism, each on a shard's H / SPATIAL rows: every GroupNorm but
    the attention blocks' (one a block, at the block's shape), which run
    fused on the gathered map."""
    attn = {(hw, c): n for hw, c, n in attn_calls}
    return [(hw, c, n - attn.get((hw, c), 0)) for hw, c, n in calls
            if n - attn.get((hw, c), 0)]


HQ_SPLIT_GN_CALLS = _split_calls(HQ_GN_CALLS, HQ_ATTN_CALLS)

# the flagship option set of the bench (psld_tpu/eval/bench.py's), at
# its full width, with gn_bf16 and the sampling SDE
FLAGSHIP_ARGS = bench.FLAGSHIP_ARGS + [
    "dataset.diffusion.model.score_fn.nf=128",
    "+dataset.diffusion.model.score_fn.gn_bf16=True",
    "dataset.diffusion.model.sde.nu=4.02",
    "dataset.diffusion.model.sde.gamma=0.02",
]
# the shipped classifier with CIFAR-10's 10 classes, on synthetic data
CLF_ARGS = [
    "dataset.clf.data.root=/unused",
    "dataset.clf.data.name=synthetic",
    "dataset.clf.model.clf_fn.n_cls=10",
    "+dataset.clf.model.clf_fn.dropout_impl=hw",
]


class Net:
    """A network the paths drive: its config arguments, the channels of
    its state, and the kernel calls of one forward (GroupNorm, attention)
    and of one training step's dropout."""

    def __init__(self, name, args, channels, gn_calls, attn_calls,
                 dropout_calls):
        self.name, self.args, self.channels = name, args, channels
        self.gn = sum(n for _, _, n in gn_calls)
        self.attn = sum(n for _, _, n in attn_calls)
        self.dropout_sites = sum(n for _, _, n in dropout_calls)

    def step_counts(self, steps: int = 1) -> dict:
        """The launches of ``steps`` training steps."""
        return expected(group_norm_act=self.gn * steps,
                        group_norm_act_bwd=self.gn * steps,
                        attention=self.attn * steps,
                        hash_dropout=2 * self.dropout_sites * steps)

    def fwd_counts(self, forwards: int, input_vjps: int = 0) -> dict:
        """The launches of ``forwards`` forwards and ``input_vjps``
        backwards into the input alone."""
        return expected(group_norm_act=self.gn * forwards,
                        group_norm_act_bwd=self.gn * input_vjps,
                        attention=self.attn * forwards)


FLAGSHIP = Net("flagship", FLAGSHIP_ARGS, 6, GN_CALLS, ATTN_CALLS,
               DROPOUT_CALLS)
CLF = Net("classifier", FLAGSHIP_ARGS + CLF_ARGS, 6, CLF_GN_CALLS,
          CLF_ATTN_CALLS, CLF_DROPOUT_CALLS)
VP = Net("VP-SDE", VP_ARGS, 3, VP_GN_CALLS, VP_ATTN_CALLS, VP_DROPOUT_CALLS)
HQ = Net("CelebA-HQ 256", HQ_ARGS, 6, HQ_GN_CALLS, HQ_ATTN_CALLS, [])
AFHQ = Net("AFHQv2 128", AFHQ_ARGS, 6, AFHQ_GN_CALLS, AFHQ_ATTN_CALLS,
           AFHQ_DROPOUT_CALLS)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# (tag, seconds) of each phase: from the previous phase's last line to
# this phase's first, as the lines print
_PHASE_S: list = []
_START = time.perf_counter()
_LAST_LINE = [_START]


def say(*parts) -> None:
    now = time.perf_counter()
    text = " ".join(str(p) for p in parts)
    if text.startswith("[") and "]" in text:
        tag = text[1:text.index("]")]
        if not _PHASE_S or _PHASE_S[-1][0] != tag:
            _PHASE_S.append([tag, 0.0])
            _PHASE_S[-1][1] = now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    print(*parts, flush=True)


_SIDE = None


def side_stream():
    """The stream the timed graphs are captured on."""
    global _SIDE
    if _SIDE is None:
        _SIDE = torch.cuda.Stream()
    return _SIDE


def device_ms(fn, launches: int = 10, replays: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the device alone: ``launches``
    calls are captured into one CUDA graph, and the graph's replays are
    timed with CUDA events, so the host's cost of a launch stays out."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # compiles and allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


# one call of each split entry of argv[1] ("stats", "apply", "partials") at
# each (batch, rows, width, C, G) of argv[2], entry after entry, under one
# torch.profiler session in a process of its own (a second profiler session
# in one process may record no device activity, and the smoke's
# [celebahq_train] traces its own window): prints the kernels' names
_SPLIT_KERNELS_SCRIPT = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from psld_tpu_torch.ops import group_norm as gn
calls = []
for entry in json.loads(sys.argv[1]):
    for b, h, w, c, g in json.loads(sys.argv[2]):
        x = torch.randn(b, h, w, c, device="cuda").bfloat16()
        if entry == "stats":
            calls.append(lambda x=x, g=g: gn.group_norm_split_stats(x, g))
            continue
        args = (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"),
                gn.group_norm_split_stats(x, g), float(h * w * (c // g)), g,
                1e-6, "swish")
        if entry == "apply":
            calls.append(lambda x=x, args=args:
                         gn.group_norm_split_apply(x, *args))
            continue
        calls.append(lambda x=x, gx=torch.randn_like(x), args=args:
                     gn.group_norm_split_partials(x, gx, *args))
for call in calls:
    call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for call in calls:
        call()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not any(w in e.name.lower()
                              for w in ("memcpy", "memset"))]))
"""


def split_kernels(entries, shapes) -> list:
    """The kernels that one call of each split entry of ``entries``
    ("stats", "apply", "partials") at each of ``shapes`` runs on the card,
    in order, in a fresh process (``_SPLIT_KERNELS_SCRIPT``)."""
    proc = subprocess.run(
        [sys.executable, "-c", _SPLIT_KERNELS_SCRIPT, json.dumps(entries),
         json.dumps(shapes)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, text=True,
        capture_output=True, timeout=300)
    check(proc.returncode == 0, "the split entries' profiler process "
          "failed: " + proc.stdout[-2000:] + proc.stderr[-2000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` called eagerly on the current stream
    (CUDA events): the host's cost of a launch counts where it exceeds
    the device's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def add_bound(total: dict, calls: int, n_bytes: float, n_ops: float,
              ops_per_s: float) -> None:
    """Add ``calls`` times one call's bound to a kernel's running total."""
    ms, by = bound(n_bytes, n_ops, ops_per_s)
    total["bound_ms"] = total.get("bound_ms", 0.0) + calls * ms
    total.setdefault("by", set()).add(by)


def bound_by(total: dict) -> str:
    by = total.pop("by")
    return "bytes" if "bytes" in by else "operations"


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def assert_close(got, want, rtol: float, atol: float, what: str) -> float:
    """|got - want| <= atol + rtol * |want| elementwise; returns the max
    absolute error."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = max_err(g, w)
    check(not bool(bad.any()), f"{what}: max abs error {err:.3e} over "
          f"rtol={rtol} atol={atol} ({int(bad.sum())} elements)")
    return err


def set_gn_bf16(on: bool) -> None:
    """The plain GroupNorm reads gn_bf16 from the environment first."""
    os.environ["PSLD_GN_BF16"] = "1" if on else "0"


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[torch.cuda.current_device()] if smi else "unknown"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from psld_tpu_torch.kernels import build

    t0 = time.perf_counter()
    srcs = ["attention.cu", "fused_act.cu", "group_norm_bwd.cu",
            "group_norm_fwd.cu", "group_norm_split_bwd.cu"]
    build.build_all(srcs)  # one nvcc per source, started together
    for src in srcs:
        build.load(src)
    say(f"[build] nvcc sm_90a: {', '.join(srcs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {src}: {line.strip()}")


# under gn_bf16 the forward kernel computes the plain version's bf16
# chain: at least this share of the elements bit-equal, the rest within
# the bf16 tolerance (a sum in another order can move a group's mean or
# rstd across a bf16 rounding boundary)
GN_BF16_EQUAL = 0.99


def _library_act(act: str):
    """The activation after ``F.group_norm`` in the library's version of
    a GroupNorm + ``act`` call, and its name."""
    import torch.nn.functional as F

    if act == "swish":
        return F.silu, "F.group_norm+F.silu"
    check(act == "none", f"no library version timed for act {act!r}")
    return (lambda t: t), "F.group_norm"


def phase_gn(card, batch, calls=GN_CALLS, net="flagship", tag="gn",
             act="swish"):
    """The forward kernel against its plain version at the (H*W, C)
    shapes of one ``net`` forward (``calls``) at ``batch``: f32 and bf16
    within tolerance, bf16 under gn_bf16 also bit-equal on at least
    ``GN_BF16_EQUAL`` of the elements. Timed with the activation ``net``
    runs, ``act``."""
    from psld_tpu_torch.ops import group_norm_act, group_norm_act_plain

    import torch.nn.functional as F

    lib_act, lib = _library_act(act)
    rng = np.random.default_rng(0)
    rows, errs, equal = [], {}, 1.0
    kernel_fwd = eager_fwd = plain_fwd = lib_fwd = 0.0
    total = {}
    t0 = time.perf_counter()
    for hw, c, n_calls in calls:
        s = int(round(hw ** 0.5))
        g = min(c // 4, 32)
        x32 = torch.from_numpy((rng.standard_normal((batch, s, s, c)) * 2.0
                                + 0.5).astype(np.float32)).cuda()
        sc32 = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        bi32 = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        acts = ["none", "swish"] + (["relu", "elu", "lrelu", "silu"]
                                    if (hw, c) == (1024, 256) else [])
        for a in acts:
            for dt, gn16, tol in ((torch.float32, False, 1e-5),
                                  (torch.bfloat16, False, 1e-2),
                                  (torch.bfloat16, True, 1e-2)):
                x, sc, bi = x32.to(dt), sc32.to(dt), bi32.to(dt)
                set_gn_bf16(gn16)
                got = group_norm_act(x, sc, bi, g, 1e-6, a)
                want = group_norm_act_plain(x, sc, bi, g, 1e-6, a)
                torch.cuda.synchronize()
                what = f"gn {hw}x{c} {a} {dt} gn_bf16={gn16}"
                err = assert_close(got, want, tol, tol, what)
                if gn16:
                    share = float((got == want).float().mean())
                    check(share >= GN_BF16_EQUAL, f"{what}: {share:.5f} of "
                          f"the elements bit-equal, under {GN_BF16_EQUAL}")
                    equal = min(equal, share)
                mode = f"{str(dt)[6:]}{'+gn_bf16' if gn16 else ''}"
                errs[mode] = max(errs.get(mode, 0.0), err)
        # time the main path's case: bf16, its act, gn_bf16 on
        x, sc, bi = x32.bfloat16(), sc32.bfloat16(), bi32.bfloat16()
        set_gn_bf16(True)
        k_ms = device_ms(lambda: group_norm_act(x, sc, bi, g, 1e-6, act))
        e_ms = cuda_ms(lambda: group_norm_act(x, sc, bi, g, 1e-6, act))
        p_ms = device_ms(lambda: group_norm_act_plain(x, sc, bi, g, 1e-6,
                                                      act))
        # the library's GroupNorm takes NCHW: the same memory, permuted
        xn = x.permute(0, 3, 1, 2)
        l_ms = device_ms(lambda: lib_act(F.group_norm(xn, g, sc, bi, 1e-6)))
        kernel_fwd += n_calls * k_ms
        eager_fwd += n_calls * e_ms
        plain_fwd += n_calls * p_ms
        lib_fwd += n_calls * l_ms
        # read x, write y, read scale and bias; ~12 f32 operations a value
        n_bytes = (2 * x.numel() + 2 * c) * x.element_size()
        add_bound(total, n_calls, n_bytes, 12 * x.numel(), SCALAR_OPS)
        rows.append((hw, c, n_calls, k_ms, e_ms, p_ms, l_ms,
                     n_bytes / 1e9 / (k_ms / 1e3),
                     bound(n_bytes, 12 * x.numel(), SCALAR_OPS)[0] / k_ms))
    os.environ.pop("PSLD_GN_BF16")
    say(f"[{tag}] CUDA kernel == plain at all {len(calls)} {net} shapes, "
        f"B={batch}"
        f" (f32 tol 1e-5; bf16 tol 1e-2; bf16+gn_bf16 tol 1e-2 and >= "
        f"{GN_BF16_EQUAL} bit-equal) in "
        f"{time.perf_counter() - t0:.1f} s; max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; bf16+gn_bf16 bit-equal share at least {equal:.5f}")
    say(f"[{tag}] device times (CUDA-graph replay; eager = called one by one, "
        f"the host's launch cost included): bf16 {act}, B={batch}, {card}")
    for hw, c, n_calls, k_ms, e_ms, p_ms, l_ms, gbps, share in rows:
        say(f"[{tag}]   HW={hw:5d} C={c:3d} x{n_calls:2d}/fwd: kernel "
            f"{k_ms:.4f} ms"
            f" ({gbps:.0f} GB/s read+write, {share:.2f} of its bound; "
            f"eager {e_ms:.4f} ms), plain "
            f"{p_ms:.4f} ms, {lib} {l_ms:.4f} ms")
    say(f"[{tag}]   per {net} forward at B={batch} "
        f"({sum(n for _, _, n in calls)} calls): kernel "
        f"{kernel_fwd:.3f} ms (eager {eager_fwd:.3f} ms), bound "
        f"{total['bound_ms']:.3f} ms, plain {plain_fwd:.3f} ms, "
        f"{lib} {lib_fwd:.3f} ms")
    return {"max_abs_err": errs["bfloat16+gn_bf16"],
            "bit_equal_share": equal, "ms": kernel_fwd, "eager_ms": eager_fwd, "plain_ms": plain_fwd,
            "bound_by": bound_by(total), **total, "library_ms": lib_fwd}


def phase_gn_bwd(card, batch=TRAIN_BATCH, calls=GN_CALLS, net="flagship",
                 need_params=True, tag="gn_bwd", act="swish"):
    """dx, dscale, dbias of the backward kernel against autograd through
    the plain version, at the (H*W, C) shapes of one ``net`` backward
    (``calls``) at ``batch``; with ``need_params=False`` the input-only
    mode (dx alone, the weights frozen: the likelihood's divergence)
    against autograd into x alone, and it is that mode that is timed.
    Tolerances, relative
    to each gradient's largest magnitude: f32 1e-4 (sums of up to
    131,072 x 64 terms in another order); bf16 2e-2 (bf16 inputs, one rounding of dx; dscale and dbias
    rounded to bf16); bf16 with gn_bf16 1e-2 (both differentiate the
    bf16-rounded chain; the kernel keeps two group sums in f32 and takes
    the slopes from the special-function unit). Under gn_bf16 relu and
    leaky relu have a kink where the two can disagree on the sign of z
    (where a group's mean or rstd rounds the other way), and such an
    element's dx differs by its whole size: there dx is held by the share
    of elements outside the tolerance, at most 1e-3 of them. Timed with
    the activation ``net`` runs, ``act``."""
    import torch.nn.functional as F

    from psld_tpu_torch.ops import (group_norm_act_backward,
                                    group_norm_act_backward_plain,
                                    group_norm_act_plain)

    def reference_bwd(x, sc, bi, ct, g, act):
        if need_params:
            return group_norm_act_backward_plain(x, sc, bi, ct, g, 1e-6, act)
        with torch.enable_grad():
            xl = x.detach().requires_grad_()
            y = group_norm_act_plain(xl, sc, bi, g, 1e-6, act)
            return torch.autograd.grad(y, [xl], ct)[0], None, None

    lib_act, lib = _library_act(act)
    rng = np.random.default_rng(3)
    rows, errs, abs_errs = [], {}, {}
    kernel_bwd = eager_bwd = plain_bwd = lib_bwd = 0.0
    total = {}
    t0 = time.perf_counter()

    def rel_err(got, want, tol, what, mode, kinked):
        worst = 0.0
        for a, w, name in zip(got, want, ("dx", "dscale", "dbias")):
            if w is None:  # the input-only mode
                check(a is None, f"{what}: {name} in the input-only mode")
                continue
            check(a.dtype == w.dtype and a.shape == w.shape,
                  f"{what}: {name} is {a.dtype} {tuple(a.shape)}")
            check(bool(torch.isfinite(a.float()).all()),
                  f"{what}: non-finite {name}")
            ref = float(w.float().abs().max()) + 1e-12
            if kinked and name == "dx":
                out = float(((a.float() - w.float()).abs()
                             > tol * ref).float().mean())
                check(out <= 1e-3, f"{what}: {out:.3e} of dx outside {tol} "
                      f"of its scale {ref:.3e} (at most 1e-3 may be)")
                continue
            err = max_err(a, w)
            check(err <= tol * ref, f"{what}: {name} max abs error {err:.3e}"
                  f" over {tol} of its scale {ref:.3e}")
            worst = max(worst, err / ref)
            abs_errs[mode] = max(abs_errs.get(mode, 0.0), err)
        return worst

    for hw, c, n_calls in calls:
        s = int(round(hw ** 0.5))
        g = min(c // 4, 32)
        x32 = torch.from_numpy((rng.standard_normal((batch, s, s, c))
                                * 2.0 + 0.5).astype(np.float32)).cuda()
        ct32 = torch.from_numpy(rng.standard_normal(
            (batch, s, s, c)).astype(np.float32)).cuda()
        sc32 = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        bi32 = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        acts = [act] + [a for a in ("swish", "none", "relu", "elu", "lrelu")
                        if a != act and (hw, c) == (1024, 256)]
        for a in acts:
            for dt, gn16, tol in ((torch.float32, False, 1e-4),
                                  (torch.bfloat16, False, 2e-2),
                                  (torch.bfloat16, True, 1e-2)):
                x, ct, sc, bi = (a.to(dt) for a in (x32, ct32, sc32, bi32))
                set_gn_bf16(gn16)
                got = group_norm_act_backward(x, sc, bi, ct, g, 1e-6, a,
                                              need_params=need_params)
                want = reference_bwd(x, sc, bi, ct, g, a)
                torch.cuda.synchronize()
                mode = f"{str(dt)[6:]}{'+gn_bf16' if gn16 else ''}"
                errs[mode] = max(errs.get(mode, 0.0), rel_err(
                    got, want, tol, f"gn_bwd {hw}x{c} {a} {mode}", mode,
                    kinked=gn16 and a in ("relu", "lrelu")))
        # time the training path's case: bf16, its act, gn_bf16 on
        x, ct, sc, bi = (a.bfloat16() for a in (x32, ct32, sc32, bi32))
        set_gn_bf16(True)
        k_ms = device_ms(lambda: group_norm_act_backward(
            x, sc, bi, ct, g, 1e-6, act, need_params=need_params))
        e_ms = cuda_ms(lambda: group_norm_act_backward(
            x, sc, bi, ct, g, 1e-6, act, need_params=need_params))
        # the plain version's forward is part of its autograd: it is
        # timed on its own and taken off
        p_ms = device_ms(lambda: reference_bwd(x, sc, bi, ct, g, act),
                         launches=3) - device_ms(
            lambda: group_norm_act_plain(x, sc, bi, g, 1e-6, act))
        # the library's backward alone: its forward runs once, on the
        # stream the timed graph is captured on, and its graph is kept
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        scl, bil = (t.detach().requires_grad_(need_params) for t in (sc, bi))
        leaves = [xl, scl, bil] if need_params else [xl]
        side_stream().wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side_stream()):
            y = lib_act(F.group_norm(xl, g, scl, bil, 1e-6))
        ctn = ct.permute(0, 3, 1, 2)
        l_ms = device_ms(lambda: torch.autograd.grad(y, leaves, ctn,
                                                     retain_graph=True))
        del y, leaves
        kernel_bwd += n_calls * k_ms
        eager_bwd += n_calls * e_ms
        plain_bwd += n_calls * p_ms
        lib_bwd += n_calls * l_ms
        # read x and g, write dx; scale, bias (and dscale, dbias); ~30 f32
        # operations a value
        n_bytes = (3 * x.numel() + (4 if need_params else 2) * c) \
            * x.element_size()
        add_bound(total, n_calls, n_bytes, 30 * x.numel(), SCALAR_OPS)
        rows.append((hw, c, n_calls, k_ms, e_ms, p_ms, l_ms,
                     n_bytes / 1e12 / (k_ms / 1e3),
                     30 * x.numel() / 1e12 / (k_ms / 1e3)))
    os.environ.pop("PSLD_GN_BF16")
    mode = "dx, dscale, dbias" if need_params else \
        "input-only mode (dx alone, need_params=False)"
    say(f"[{tag}] CUDA C++ backward kernel, {mode}, == autograd through "
        f"plain at all {len(calls)} {net} shapes, B={batch} (of each "
        f"gradient's scale: "
        f"f32 "
        f"tol 1e-4; bf16 tol 2e-2; bf16+gn_bf16 tol 1e-2) in "
        f"{time.perf_counter() - t0:.1f} s; max error of scale "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in abs_errs.items()))
    say(f"[{tag}] device times (CUDA-graph replay; eager = called one by "
        f"one): bf16 {act}, {mode}, B={batch}, {card}")
    for hw, c, n_calls, k_ms, e_ms, p_ms, l_ms, tbps, tflops in rows:
        say(f"[{tag}]   HW={hw:5d} C={c:3d} x{n_calls:2d}/bwd: kernel "
            f"{k_ms:.4f} ms ({tbps:.3f} TB/s of x, g, dx; {tflops:.2f} "
            f"TFLOP/s f32 at ~30 a value; eager {e_ms:.4f} "
            f"ms), plain autograd {p_ms:.4f} ms, {lib} "
            f"backward {l_ms:.4f} ms")
    say(f"[{tag}]   per {net} backward at B={batch} "
        f"({sum(n for _, _, n in calls)} calls): kernel "
        f"{kernel_bwd:.3f} ms (eager {eager_bwd:.3f} ms), bound "
        f"{total['bound_ms']:.3f} ms, plain {plain_bwd:.3f} ms, library "
        f"{lib_bwd:.3f} ms")
    return {"max_abs_err": abs_errs["bfloat16+gn_bf16"],
            "max_err_of_scale": errs["bfloat16+gn_bf16"], "ms": kernel_bwd,
            "eager_ms": eager_bwd, "plain_ms": plain_bwd,
            "bound_by": bound_by(total), **total, "library_ms": lib_bwd}


def phase_dropout(card, batch=TRAIN_BATCH, calls=DROPOUT_CALLS,
                  net="flagship", rate=0.15, tag="dropout"):
    """The hash dropout kernel against its plain version, bit for bit, at
    the (H*W, C) shapes of ``net``'s dropout sites (``calls``) at
    ``batch``, at ``net``'s ``rate`` (timed) and 0.5."""
    import torch.nn.functional as F

    from psld_tpu_torch.ops import hash_dropout, hash_dropout_plain

    rng = np.random.default_rng(4)
    rows = []
    kernel_step = eager_step = plain_step = lib_step = 0.0
    total = {}
    seed = (123456789, 4000000000)
    n_cases, worst = 0, 0.0
    for hw, c, n_calls in calls:
        s = int(round(hw ** 0.5))
        x32 = torch.from_numpy(rng.standard_normal(
            (batch, s, s, c)).astype(np.float32)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            # the layout inside the network: NCHW-logical, channels_last
            x = x32.to(dt).permute(0, 3, 1, 2)
            for p, off in ((rate, 0), (0.5, 0), (rate, 1_000_003)):
                got = hash_dropout(x, seed, p, elem_off=off)
                want = hash_dropout_plain(x, seed, p, elem_off=off)
                torch.cuda.synchronize()
                what = f"dropout {hw}x{c} {dt} rate={p} off={off}"
                check(got.dtype == dt and got.stride() == x.stride(),
                      f"{what}: output dtype or layout changed")
                worst = max(worst, max_err(got, want))
                check(torch.equal(got, want), f"{what}: kernel != plain")
                kept = float((got != 0).float().mean())
                sigma = (p * (1 - p) / x.numel()) ** 0.5
                check(abs(kept - (1 - p)) < 4 * sigma,
                      f"{what}: kept share {kept:.6f}")
                n_cases += 1
            # a rank's rows of the batch at their offset (data parallel),
            # and mid-row, 77 positions on
            half = batch // 2
            whole = hash_dropout(x, seed, rate)
            for off in (half * hw * c, half * hw * c + 77):
                got = hash_dropout(x[half:], seed, rate, elem_off=off)
                what = f"dropout {hw}x{c} {dt} rows {half}: off={off}"
                check(torch.equal(got, hash_dropout_plain(
                    x[half:], seed, rate, elem_off=off)),
                    f"{what}: kernel != plain")
                check(off != half * hw * c or torch.equal(got, whole[half:]),
                      f"{what}: the rows' dropout != the batch's")
                worst = max(worst, max_err(got, hash_dropout_plain(
                    x[half:], seed, rate, elem_off=off)))
                n_cases += 1
        x = x32.bfloat16().permute(0, 3, 1, 2)
        xg = x.detach().requires_grad_()
        ct = torch.randn_like(x)
        (dx,) = torch.autograd.grad(hash_dropout(xg, seed, rate), xg, ct)
        check(torch.equal(dx, hash_dropout_plain(ct, seed, rate)),
              f"dropout {hw}x{c}: backward does not re-mask the cotangent")
        k_ms = device_ms(lambda: hash_dropout(x, seed, rate))
        e_ms = cuda_ms(lambda: hash_dropout(x, seed, rate))
        p_ms = device_ms(lambda: hash_dropout_plain(x, seed, rate),
                         launches=3)
        l_ms = device_ms(lambda: F.dropout(x, rate, training=True))
        # forward and backward of a step launch the same kernel
        kernel_step += 2 * n_calls * k_ms
        eager_step += 2 * n_calls * e_ms
        plain_step += 2 * n_calls * p_ms
        lib_step += 2 * n_calls * l_ms
        # one read, one write; ~25 integer operations a value
        n_bytes = 2 * x.numel() * x.element_size()
        add_bound(total, 2 * n_calls, n_bytes, 25 * x.numel(), SCALAR_OPS)
        rows.append((hw, c, n_calls, k_ms, e_ms, p_ms, l_ms,
                     n_bytes / 1e9 / (k_ms / 1e3)))
    # a size that is no multiple of 128, four seed words
    odd = torch.from_numpy(rng.standard_normal(100_003).astype(
        np.float32)).cuda()
    got = hash_dropout(odd, (1, 2, 0xFFFFFFFF, 7), 0.15)
    want = hash_dropout_plain(odd, (1, 2, 0xFFFFFFFF, 7), 0.15)
    worst = max(worst, max_err(got, want))
    check(torch.equal(got, want),
          "dropout: odd size, 4-word seed: kernel != plain")
    say(f"[{tag}] Triton kernel == plain bit for bit in {n_cases + 1} cases"
        f" (f32 and bf16, rates {rate} and 0.5, an offset, the rows "
        f"{batch // 2}.. at their offset (= the batch's rows) and 77 "
        f"positions on, an odd size), "
        f"{net} shapes, B={batch}; kept share within 4 sigma; backward "
        f"re-masks")
    say(f"[{tag}] device times (CUDA-graph replay; eager = called one by "
        f"one): bf16, rate {rate}, {card}")
    for hw, c, n_calls, k_ms, e_ms, p_ms, l_ms, gbps in rows:
        say(f"[{tag}]   HW={hw:5d} C={c} x{n_calls} sites: kernel {k_ms:.4f}"
            f" ms ({gbps:.0f} GB/s read+write; eager {e_ms:.4f} ms), plain "
            f"{p_ms:.4f} ms, F.dropout {l_ms:.4f} ms")
    say(f"[{tag}]   per {net} step at B={batch} "
        f"({2 * sum(n for _, _, n in calls)} launches): "
        f"kernel {kernel_step:.3f} ms (eager {eager_step:.3f} ms), bound "
        f"{total['bound_ms']:.3f} ms, plain {plain_step:.3f} ms, F.dropout "
        f"{lib_step:.3f} ms")
    return {"max_abs_err": worst, "ms": kernel_step, "eager_ms": eager_step,
            "plain_ms": plain_step, "bound_by": bound_by(total), **total,
            "library_ms": lib_step}


def phase_attention(card, batch, calls=ATTN_CALLS, net="flagship",
                    tag="attention"):
    """The kernel against its plain version at the (N, C) shapes of one
    ``net`` forward (``calls``) at ``batch``."""
    from psld_tpu_torch.ops import attention, attention_plain

    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    rows, errs = [], {}
    kernel_fwd = eager_fwd = plain_fwd = lib_fwd = 0.0
    total = {}
    for n, c, n_calls in calls:
        qkv32 = [torch.from_numpy(rng.standard_normal((batch, n, c)).astype(
            np.float32)).cuda() for _ in range(3)]
        scale = float(c) ** -0.5
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            q, k, v = (a.to(dt) for a in qkv32)
            got = attention(q, k, v, scale)
            want = attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            err = assert_close(got, want, tol, tol, f"attention {n}x{c} {dt}")
            errs[str(dt)[6:]] = max(errs.get(str(dt)[6:], 0.0), err)
        q, k, v = (a.bfloat16() for a in qkv32)
        k_ms = device_ms(lambda: attention(q, k, v, scale))
        e_ms = cuda_ms(lambda: attention(q, k, v, scale))
        p_ms = device_ms(lambda: attention_plain(q, k, v, scale))
        q4, k4, v4 = (a[:, None] for a in (q, k, v))  # one head
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=scale))
        kernel_fwd += n_calls * k_ms
        eager_fwd += n_calls * e_ms
        plain_fwd += n_calls * p_ms
        lib_fwd += n_calls * l_ms
        flops = batch * 4 * n * n * c
        # q, k, v read, o written; bf16 inputs: the tensor cores' peak
        add_bound(total, n_calls, 4 * q.numel() * q.element_size(), flops,
                  BF16_TENSOR_OPS)
        rows.append((n, c, n_calls, k_ms, e_ms, p_ms, l_ms,
                     flops / (k_ms / 1e3) / 1e12,
                     4 * q.numel() * q.element_size() / 1e12 / (k_ms / 1e3)))
    say(f"[{tag}] CUDA kernel == plain at {len(calls)} {net} shapes, "
        f"B={batch} (f32 tol 1e-5; bf16 tol 1e-2); max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    say(f"[{tag}] device times (CUDA-graph replay; eager = called one "
        f"by one): bf16, B={batch}, {card}")
    for n, c, n_calls, k_ms, e_ms, p_ms, l_ms, tflops, tbps in rows:
        say(f"[{tag}]   N={n:3d} C={c} x{n_calls}/fwd: kernel "
            f"{k_ms:.4f} ms "
            f"({tflops:.1f} TFLOP/s of 4*N*N*C a batch element, {tbps:.3f} "
            f"TB/s of q, k, v, o; eager {e_ms:.4f} ms), plain {p_ms:.4f} "
            f"ms, F.scaled_dot_product_attention {l_ms:.4f} ms")
    say(f"[{tag}]   per {net} forward at B={batch} "
        f"({sum(n for _, _, n in calls)} calls): kernel "
        f"{kernel_fwd:.3f} ms (eager {eager_fwd:.3f} ms), bound "
        f"{total['bound_ms']:.3f} ms, plain {plain_fwd:.3f} ms, "
        f"F.scaled_dot_product_attention {lib_fwd:.3f} ms")
    return {"max_abs_err": errs["bfloat16"], "ms": kernel_fwd,
            "eager_ms": eager_fwd, "plain_ms": plain_fwd,
            "bound_by": bound_by(total), **total, "library_ms": lib_fwd}


def phase_fused_act(card):
    """Both fused bias + leaky ReLU kernels against their plain versions,
    bit for bit, in f32 and bf16, at ``FUSED_ACT_SHAPES``; autograd goes
    through both. No path of the port calls the op (nor any model of the
    JAX package), so this phase is all that runs it."""
    from psld_tpu_torch.ops import (fused_leaky_relu,
                                    fused_leaky_relu_backward,
                                    fused_leaky_relu_backward_plain,
                                    fused_leaky_relu_plain)

    rng = np.random.default_rng(6)
    t0 = time.perf_counter()
    rows, n_cases, worst = [], 0, 0.0
    sums = {d: dict.fromkeys(("ms", "eager_ms", "plain_ms"), 0.0)
            for d in ("fwd", "bwd")}
    totals = {"fwd": {}, "bwd": {}}
    for shape in FUSED_ACT_SHAPES:
        x32, g32 = (torch.from_numpy((rng.standard_normal(shape) * 3).astype(
            np.float32)).cuda() for _ in range(2))
        bias = torch.from_numpy(rng.standard_normal(shape[-1]).astype(
            np.float32)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            x, g = x32.to(dt), g32.to(dt)
            what = f"fused_act {shape} {dt}"
            got = fused_leaky_relu(x, bias)
            want = fused_leaky_relu_plain(x, bias)
            dx, db = fused_leaky_relu_backward(x, bias, g)
            wdx, wdb = fused_leaky_relu_backward_plain(x, bias, g)
            xg = x.detach().requires_grad_()
            bg = bias.detach().requires_grad_()
            adx, adb = torch.autograd.grad(fused_leaky_relu(xg, bg), (xg, bg),
                                           g)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, want), max_err(dx, wdx))
            check(got.dtype == dt and torch.equal(got, want),
                  f"{what}: forward kernel != plain")
            check(torch.equal(dx, wdx) and torch.equal(db, wdb),
                  f"{what}: backward kernel != plain")
            check(torch.equal(adx, dx) and torch.equal(adb, db),
                  f"{what}: autograd != the backward kernel")
            n_cases += 1
        # time bf16: the kernels alone (dbias, a PyTorch sum, left out)
        x, g = x32.bfloat16(), g32.bfloat16()
        times = {}
        for d, kern, plain in (
                ("fwd", lambda: fused_leaky_relu(x, bias),
                 lambda: fused_leaky_relu_plain(x, bias)),
                ("bwd", lambda: fused_leaky_relu_backward(
                    x, bias, g, need_dbias=False),
                 lambda: fused_leaky_relu_backward_plain(
                    x, bias, g, need_dbias=False))):
            times[d] = (device_ms(kern), cuda_ms(kern), device_ms(plain))
            for k, v in zip(("ms", "eager_ms", "plain_ms"), times[d]):
                sums[d][k] += v
            # forward: read x, write y; backward: read x and g, write dx;
            # the bias once; ~3 f32 operations a value
            n_bytes = ((2 if d == "fwd" else 3) * x.numel()
                       + shape[-1]) * x.element_size()
            add_bound(totals[d], 1, n_bytes, 3 * x.numel(), SCALAR_OPS)
            times[d] += (bound(n_bytes, 3 * x.numel(), SCALAR_OPS)[0],)
        rows.append((shape, times))
    say(f"[fused_act] CUDA kernels (forward, backward) == plain bit for bit "
        f"in {n_cases} cases (f32 and bf16, {len(FUSED_ACT_SHAPES)} shapes), "
        f"autograd through both, in {time.perf_counter() - t0:.1f} s")
    say(f"[fused_act] device times (CUDA-graph replay; eager = called one by "
        f"one), bf16, against bytes over 3.35 TB/s; no single PyTorch call "
        f"computes bias + leaky ReLU + gain, so there is no library time; "
        f"{card}")
    for shape, times in rows:
        for d, (k_ms, e_ms, p_ms, b_ms) in times.items():
            say(f"[fused_act]   {d} {shape}: kernel {k_ms:.4f} ms (eager "
                f"{e_ms:.4f} ms), bound {b_ms:.4f} ms, plain {p_ms:.4f} ms")
    out = {}
    for d in ("fwd", "bwd"):
        out[d] = {"max_abs_err": worst, **sums[d],
                  "bound_by": bound_by(totals[d]), **totals[d],
                  "library_ms": None}
        say(f"[fused_act]   {d}, one call at each shape: kernel "
            f"{out[d]['ms']:.4f} ms (eager {out[d]['eager_ms']:.4f} ms), "
            f"bound {out[d]['bound_ms']:.4f} ms, plain "
            f"{out[d]['plain_ms']:.4f} ms")
    return out


def _wrappers() -> dict:
    from psld_tpu_torch import ops

    return {"group_norm_act": ops.group_norm_act,
            "group_norm_act_bwd": ops.group_norm_act_backward,
            "attention": ops.attention, "hash_dropout": ops.hash_dropout,
            "fused_leaky_relu": ops.fused_leaky_relu,
            "fused_leaky_relu_bwd": ops.fused_leaky_relu_backward,
            "group_norm_split_stats": ops.group_norm_split_stats,
            "group_norm_split_apply": ops.group_norm_split_apply,
            "group_norm_split_partials": ops.group_norm_split_partials,
            "group_norm_split_dx": ops.group_norm_split_dx}


def expected(**launches) -> dict:
    """Launch counts of every kernel: those given, 0 for the rest."""
    return {name: launches.get(name, 0) for name in _wrappers()}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def all_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def counts():
    c = all_counts()
    return c["group_norm_act"], c["attention"]


def flagship_weights(net, seed: int = 0) -> dict:
    """Every parameter N(0, 1) * 0.02 from a numpy seed, in key order, as
    the bench draws them."""
    return bench.random_weights(net, np.random.default_rng(seed))


def phase_net(card, cfg):
    import copy

    from psld_tpu_torch.eval.generate import (build_score_model, build_sde,
                                              make_score_fn)
    from psld_tpu_torch.samplers.base import make_timesteps
    from psld_tpu_torch.samplers.sde_samplers import EulerMaruyamaSampler

    t0 = time.perf_counter()
    net = build_score_model(cfg).eval()
    weights = flagship_weights(net)
    net.load_state_dict(weights, strict=True)
    n_params = sum(p.numel() for p in net.parameters())
    check(n_params == 97_627_910, f"flagship has {n_params} params")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32))
    t = torch.tensor([0.3, 0.7], dtype=torch.float32)
    with torch.inference_mode():
        want = net(x, t)
        gnet = copy.deepcopy(net).cuda()
        reset_counts()
        got = gnet(x.cuda(), t.cuda())
        torch.cuda.synchronize()
        n_gn, n_attn = counts()
    check((n_gn, n_attn) == (FLAGSHIP.gn, FLAGSHIP.attn),
          f"one forward launched {n_gn} GN and {n_attn} attention kernels")
    scale = float(want.abs().max())
    err = max_err(got.cpu(), want)
    check(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale,
          f"net: card vs CPU max abs error {err:.3e} (output scale "
          f"{scale:.3e}, tol 1e-4 of scale)")
    say(f"[net] flagship NCSN++ {n_params} params: f32 card == CPU at B=2 "
        f"(max abs err {err:.3e}, {err / scale:.2e} of the output scale "
        f"{scale:.3e}; tol 1e-4); one forward launched {n_gn} GN and "
        f"{n_attn} attention kernels")

    # 3-step EM (2 noisy steps + denoise) with the same noise on both sides
    sde = build_sde(cfg)
    ts = make_timesteps(2, 1e-3)
    z0 = torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32))
    noise = [torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32)) for _ in range(2)]
    outs = []
    with torch.inference_mode():
        for m, dev in ((net, "cpu"), (gnet, "cuda")):
            sampler = EulerMaruyamaSampler(cfg, sde, make_score_fn(m))
            outs.append(sampler.sample(
                None, z0.to(dev), ts, 2, denoise=True, eps=1e-3,
                noise=lambda i, x_, d=dev: noise[i].to(d)).cpu())
    scale = float(outs[0].abs().max())
    err = max_err(outs[1], outs[0])
    check(bool(torch.isfinite(outs[1]).all()) and err <= 1e-4 * scale,
          f"EM: card vs CPU max abs error {err:.3e} (scale {scale:.3e})")
    say(f"[net] 3-step EM trajectory: card == CPU (max abs err {err:.3e}, "
        f"{err / scale:.2e} of scale {scale:.3e}; tol 1e-4)")

    # the sample phase's network alone: bf16, batch 64
    score = make_score_fn(gnet, bf16=True)
    zb = torch.randn(BATCH, 32, 32, 6, device="cuda")
    tb = torch.full((BATCH,), 0.5, device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: score(zb, tb), iters=10, warmup=2)
    say(f"[net] bf16 forward at B={BATCH}: {fwd_ms:.2f} ms ({card}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    del gnet, score
    torch.cuda.empty_cache()
    return weights, fwd_ms


TRAIN_ARGS = [
    "dataset.diffusion.data.name=synthetic",
    "+dataset.diffusion.model.score_fn.dropout_impl=hw",
    "+dataset.diffusion.training.bf16=True",
]
VP_TRAIN_ARGS = [
    "dataset.diffusion.data.name=synthetic",
    "+dataset.diffusion.model.score_fn.dropout_impl=hw_inline",
    "+dataset.diffusion.training.bf16=True",
]
# one guided NFE: the score network's forward, the classifier's forward
# and its backward into the input (attention's gradient is no kernel)
GUIDED_NFE_COUNTS = expected(group_norm_act=FLAGSHIP.gn + CLF.gn,
                             group_norm_act_bwd=CLF.gn,
                             attention=FLAGSHIP.attn + CLF.attn)


def phase_train_check(card, weights, net=FLAGSHIP, tag="train_check",
                      seed: int = 5, batch: int = 2, extra=()):
    """One float32 optimizer step of ``net`` at ``batch`` (2 or 1), with
    its config's hash dropout (``extra``: more config arguments), on the
    card against the CPU, with the same t, eps and seed words. The first step's learning rate is 0 (warmup), so the
    weights stay and Adam's first moment is (1 - beta_1) times the
    clipped gradient: it holds every parameter's gradient. Tolerances:
    the loss within 1e-4 relative, the gradient norm within 1e-3, each
    gradient within 1e-3 of its scale (float32 sums in another order
    through ~250 layers, TF32 off); and the launches of one step."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.train.loop import build_score_model, build_sde
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import make_train_step
    from psld_tpu_torch.registry import get_module

    t0 = time.perf_counter()
    cfg = bootstrap(net.args + [
        "+dataset.diffusion.model.score_fn.dropout_impl=hw", *extra
    ]).dataset.diffusion
    rate = float(cfg.model.score_fn.dropout)
    size = int(cfg.data.image_size)
    set_gn_bf16(False)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, size, size, 3)).astype(
        np.float32))
    t = torch.tensor([0.3, 0.7], dtype=torch.float64)[:batch]
    eps = torch.from_numpy(rng.standard_normal(
        (batch, size, size, net.channels)).astype(np.float32))
    seeds = [tuple(int(w) for w in row)
             for row in rng.integers(0, 2 ** 32, (net.dropout_sites, 2))]
    want_n = net.step_counts()
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_score_model(cfg)
        model.load_state_dict(weights, strict=True)
        model.to(dev)
        sde = build_sde(cfg)
        crit = get_module("losses", cfg.training.loss.name)(cfg, sde)
        step, opt = make_train_step(model, sde, crit, cfg)
        state = init_state(dict(model.named_parameters()), opt)
        reset_counts()
        state, m = step(state, x.to(dev), t=t, eps=eps.to(dev),
                        dropout_seeds=seeds)
        if dev == "cuda":
            torch.cuda.synchronize()
            n = all_counts()
            check(n == want_n, f"{tag}: one train step launched {n}, "
                  f"expected {want_n}")
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    {k: v.cpu() for k, v in state.opt_state["mu"].items()})
        del state, step, model
    os.environ.pop("PSLD_GN_BF16")
    (l_c, g_c, mu_c), (l_g, g_g, mu_g) = out["cpu"], out["cuda"]
    check(abs(l_g - l_c) <= 1e-4 * abs(l_c),
          f"{tag}: loss {l_g} on the card, {l_c} on the CPU")
    check(abs(g_g - g_c) <= 1e-3 * abs(g_c),
          f"{tag}: grad_norm {g_g} on the card, {g_c} on the CPU")
    worst, worst_key = _mu_close(mu_g, mu_c, tag)
    n_params = sum(v.numel() for v in mu_c.values())
    say(f"[{tag}] {net.name} {n_params} params, f32 step at B={batch}, "
        f"{size} x {size}, hash dropout {rate}: card == CPU (loss {l_g:.7f} vs {l_c:.7f}, tol "
        f"1e-4 relative; grad_norm {g_g:.6f} vs {g_c:.6f}; worst parameter "
        f"gradient {worst:.2e} of its scale, {worst_key}; tol 1e-3); one "
        f"step launched {want_n}; phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def phase_likelihood_check(card, weights, net=FLAGSHIP, tag="ode_check",
                           seed: int = 32):
    """One RK4 step of the Hutchinson likelihood of ``net`` (float32, B=2)
    on the card against the CPU with the same probe: data in [-1, 1] (and,
    for PSLD, a momentum drawn from its N(0, mm_0)); logp within 1e-4
    relative, its divergence integral and terminal state within 1e-4 of
    their scales; 4 forwards and 4 input-only backwards launched (the GN
    backward kernel in its input-only mode)."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval.generate import build_score_model, make_score_fn
    from psld_tpu_torch.eval.likelihood import make_likelihood_fn
    from psld_tpu_torch.train.loop import build_sde

    t0 = time.perf_counter()
    set_gn_bf16(False)
    cfg = bootstrap(net.args).dataset.diffusion
    sde = build_sde(cfg)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (2, 32, 32, 3))
    if hasattr(sde, "mm_0"):
        x = np.concatenate([x, rng.standard_normal((2, 32, 32, 3))
                            * np.sqrt(sde.mm_0)], axis=-1)
    x = torch.from_numpy(x.astype(np.float32))
    probes = torch.from_numpy(rng.choice(
        [-1.0, 1.0], (1, 2, 32, 32, net.channels)).astype(np.float32))
    want_n = net.fwd_counts(4, input_vjps=4)
    logp, delta, z_t = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = build_score_model(cfg).eval().requires_grad_(False)
        model.load_state_dict(weights, strict=True)
        fn = make_likelihood_fn(sde, make_score_fn(model.to(dev)),
                                n_steps=1, method="rk4")
        reset_counts()
        with torch.no_grad():
            out = fn(None, x.to(dev), probes=probes.to(dev))
        logp[dev], delta[dev], z_t[dev] = (
            out[k].cpu() for k in ("logp", "delta_logp", "z_T"))
        if dev == "cuda":
            torch.cuda.synchronize()
            n = all_counts()
            check(n == want_n, f"{tag}: one RK4 likelihood step launched "
                  f"{n}, expected {want_n}")
        del model
    os.environ.pop("PSLD_GN_BF16")
    rel = float(((logp["cuda"] - logp["cpu"]).abs()
                 / logp["cpu"].abs()).max())
    check(bool(torch.isfinite(logp["cuda"]).all()) and rel <= 1e-4,
          f"{tag} likelihood: logp {logp['cuda'].tolist()} on the card, "
          f"{logp['cpu'].tolist()} on the CPU")
    d_err = max_err(delta["cuda"], delta["cpu"]) / float(
        delta["cpu"].abs().max())
    z_err = max_err(z_t["cuda"], z_t["cpu"]) / float(z_t["cpu"].abs().max())
    check(d_err <= 1e-4 and z_err <= 1e-4,
          f"{tag} likelihood: divergence integral off by {d_err:.3e}, "
          f"terminal state by {z_err:.3e} of scale (tol 1e-4)")
    say(f"[{tag}] f32 Hutchinson likelihood of the {net.name}, one RK4 step "
        f"(4 forwards and 4 input-only backwards), B=2: card == CPU, logp "
        f"{rel:.2e} relative (tol 1e-4; {logp['cuda'].tolist()}), "
        f"divergence integral {d_err:.2e} of its scale "
        f"{float(delta['cpu'].abs().max()):.3e}, z_T {z_err:.2e} of scale "
        f"(tol 1e-4); launched {want_n}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def _mu_close(mu_g, mu_c, what: str):
    """Every parameter's first Adam moment (the first step's lr is 0, so
    it is (1 - beta_1) times the gradient) on the card against the CPU:
    within 1e-3 of its scale, floored at 1e-4 of the largest; returns the
    worst share and its key."""
    top = max(float(v.abs().max()) for v in mu_c.values())
    worst, worst_key = 0.0, ""
    for k, want in mu_c.items():
        if k.endswith(".W"):
            check(not mu_g[k].any(), f"{what}: {k} has a gradient")
            continue
        ref = max(float(want.abs().max()), 1e-4 * top)
        err = max_err(mu_g[k], want) / ref
        if err > worst:
            worst, worst_key = err, k
    check(worst <= 1e-3, f"{what}: gradient of {worst_key} differs by "
          f"{worst:.3e} of its scale (tol 1e-3)")
    return worst, worst_key


def phase_clf_check(card):
    """One float32 step of the shipped classifier at B=2, hash dropout
    0.1, on the card against the CPU with the same t, eps and seed words:
    loss, top-1 and every parameter's gradient (1e-3 of its scale, as
    ``train_check``); then one float32 guidance gradient (the gradient of
    log p(y | x, t) into x, the classifier's weights frozen) on the card
    against the CPU, within 1e-3 of its scale. Weights N(0, 1) * 0.02
    from a numpy seed, the head's too."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval.generate import (_merged_eval_config,
                                              make_score_fn)
    from psld_tpu_torch.losses.score import PSLDTimeCELoss
    from psld_tpu_torch.samplers import ClassCondEulerMaruyamaSampler
    from psld_tpu_torch.train.loop import build_clf_model, build_sde
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import make_clf_train_step

    t0 = time.perf_counter()
    cfg = bootstrap(FLAGSHIP_ARGS + CLF_ARGS).dataset
    set_gn_bf16(False)
    weights = flagship_weights(build_clf_model(cfg.clf, device="meta"),
                               seed=7)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    y = torch.tensor([3, 7])
    t = torch.tensor([0.3, 0.7], dtype=torch.float64)
    eps = torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32))
    seeds = [tuple(int(w) for w in row)
             for row in rng.integers(0, 2 ** 32, (CLF.dropout_sites, 2))]
    z = torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        net = build_clf_model(cfg.clf)
        net.load_state_dict(weights, strict=True)
        net.to(dev)
        sde = build_sde(cfg.diffusion)
        step, opt = make_clf_train_step(net, sde, PSLDTimeCELoss(cfg, sde),
                                        cfg)
        state = init_state(dict(net.named_parameters()), opt)
        reset_counts()
        state, m = step(state, x.to(dev), y.to(dev), t=t, eps=eps.to(dev),
                        dropout_seeds=seeds)
        if dev == "cuda":
            torch.cuda.synchronize()
            n = all_counts()
            check(n == CLF.step_counts(), f"one classifier step launched "
                  f"{n}, expected {CLF.step_counts()}")
        mu = {k: v.cpu() for k, v in state.opt_state["mu"].items()}
        # the guidance gradient, through the frozen classifier
        net.eval().requires_grad_(False)
        sampler = ClassCondEulerMaruyamaSampler(
            _merged_eval_config(cfg), sde, None, clf_fn=make_score_fn(net),
            y=5)
        reset_counts()
        with torch.no_grad():
            grad = sampler._guidance(z.to(dev), 0.6).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            n = all_counts()
            want_n = CLF.fwd_counts(1, input_vjps=1)
            check(n == want_n, f"one guidance gradient launched {n}, "
                  f"expected {want_n}")
        out[dev] = (float(m["loss"]), float(m["top1"]), mu, grad)
        del state, step, net
    os.environ.pop("PSLD_GN_BF16")
    (l_c, a_c, mu_c, g_c), (l_g, a_g, mu_g, g_g) = out["cpu"], out["cuda"]
    check(abs(l_g - l_c) <= 1e-3 * abs(l_c),
          f"clf_check: loss {l_g} on the card, {l_c} on the CPU")
    check(a_g == a_c, f"clf_check: top-1 {a_g} on the card, {a_c} on the "
          f"CPU")
    worst, worst_key = _mu_close(mu_g, mu_c, "clf_check")
    g_scale = float(g_c.abs().max())
    g_err = max_err(g_g, g_c)
    check(g_scale > 0 and bool(torch.isfinite(g_g).all())
          and g_err <= 1e-3 * g_scale,
          f"clf_check: guidance gradient differs by {g_err:.3e} (scale "
          f"{g_scale:.3e}, tol 1e-3 of scale)")
    say(f"[clf_check] classifier {sum(v.numel() for v in mu_c.values())} "
        f"params, f32 step at B=2, hash dropout 0.1: card == CPU (loss "
        f"{l_g:.6f} vs {l_c:.6f}; top-1 {a_g} vs {a_c}; worst parameter "
        f"gradient {worst:.2e} of its scale, {worst_key}; tol 1e-3); one "
        f"step launched {CLF.step_counts()}")
    say(f"[clf_check] f32 guidance gradient at B=2: card == CPU (max abs "
        f"err {g_err:.3e}, {g_err / g_scale:.2e} of its scale "
        f"{g_scale:.3e}; tol 1e-3); phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


FLAGSHIP_TRAIN = ("hash dropout 0.15, HSM, Adam+warmup, clip 1, EMA "
                  "0.9999")


def phase_train(card, work, net=FLAGSHIP, train_args=TRAIN_ARGS,
                tag="train", what=FLAGSHIP_TRAIN):
    """``cli.train_sde`` at ``net``'s training point (``train_args``;
    ``what`` says what it is); returns the path of the checkpoint it
    wrote, the launch counts of the run and its times."""
    from psld_tpu_torch.cli import train_sde as train_cli
    from psld_tpu_torch.train.checkpoint import latest_checkpoint

    n_steps = TRAIN_WARMUP + TRAIN_TIMED

    def run(batch, accum, results):
        # the synthetic set holds 512 images: 512 / (batch * accum) steps
        # an epoch; one checkpoint, after the last epoch; one read of the
        # loss, at the last step
        epochs = n_steps * batch * accum // 512
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        return train_cli.main(net.args + train_args + [
            f"dataset.diffusion.training.results_dir={results}",
            f"dataset.diffusion.training.batch_size={batch}",
            f"+dataset.diffusion.training.grad_accum={accum}",
            f"dataset.diffusion.training.epochs={epochs}",
            f"dataset.diffusion.training.chkpt_interval={epochs}",
            f"dataset.diffusion.training.log_step={n_steps}",
            "+dataset.diffusion.training.device=cuda",
        ])

    t0 = time.perf_counter()
    batch, accum = TRAIN_BATCH, 1
    results = os.path.join(work, tag)
    try:
        state, stats = run(batch, accum, results)
    except torch.cuda.OutOfMemoryError as e:
        # a finding to print, not to hide: the step does not fit at 128
        say(f"[{tag}] batch {TRAIN_BATCH} does not fit in the card's memory "
            f"({e}); running 2 x {TRAIN_BATCH // 2} through grad_accum")
        torch.cuda.empty_cache()
        batch, accum = TRAIN_BATCH // 2, 2
        results = os.path.join(work, f"{tag}_accum")
        state, stats = run(batch, accum, results)
    wall = time.perf_counter() - t0
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(stats) == n_steps and state.step == n_steps,
          f"{tag} took {len(stats)} steps")
    want = net.step_counts(n_steps * accum)
    check(n == want, f"{tag}: training launched {n}, expected {want}")
    losses = [r["loss"] for r in stats]
    check(all(np.isfinite(v) for v in losses)
          and all(np.isfinite(r["grad_norm"]) for r in stats),
          f"{tag}: non-finite loss or gradient norm: {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    check(last <= 1.05 * first, f"{tag}: loss rose from {first} to {last}")
    for tree in (state.params, state.ema_params):
        check(all(bool(torch.isfinite(v).all()) for v in tree.values()),
              f"{tag}: non-finite parameters")
    ckpt = latest_checkpoint(os.path.join(results, "checkpoints"))
    check(ckpt is not None and os.path.exists(ckpt + ".meta.json"),
          f"{tag} wrote no checkpoint")
    timed = [r["ms"] for r in stats[TRAIN_WARMUP:]]
    ms_step = float(np.mean(timed))
    img_s = batch * accum / (ms_step / 1e3)
    say(f"[{tag}] cli.train_sde: {n_steps} steps of the {net.name} at "
        f"batch {batch} x grad_accum {accum} (bf16 compute, f32 master "
        f"weights, {what}), "
        f"synthetic data: {ms_step:.2f} ms/step over the last {TRAIN_TIMED} "
        f"(min {min(timed):.2f}, max {max(timed):.2f}), {img_s:.2f} img/s, "
        f"peak {peak_gb:.2f} GB allocated; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; entry point {wall:.1f} s; {card}")
    say(f"[{tag}] kernel launches in the run: {n}")
    say(f"[{tag}] checkpoint: {os.path.basename(ckpt)} "
        f"({os.path.getsize(ckpt) / 1e9:.2f} GB)")
    del state
    torch.cuda.empty_cache()
    return ckpt, n, {"ms_step": ms_step, "img_s": img_s, "peak_gb": peak_gb}


def phase_sample(card, work, ckpt, net=FLAGSHIP, tag="sample"):
    """``cli.sample`` of ``net``, ``SAMPLE_NFE``-NFE EM, from the checkpoint its
    train phase wrote."""
    from psld_tpu_torch.cli import sample as sample_cli

    out_dir = os.path.join(work, tag)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches = sample_cli.main(net.args + [
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.save_path={out_dir}",
        f"dataset.diffusion.evaluation.batch_size={BATCH}",
        f"dataset.diffusion.evaluation.n_samples={BATCH}",
        f"dataset.diffusion.evaluation.n_discrete_steps={SAMPLE_NFE}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda",
    ])
    wall = time.perf_counter() - t0
    n = all_counts()
    n_gn, n_attn = n["group_norm_act"], n["attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = [f for f in os.listdir(os.path.join(out_dir, "images"))
            if f.endswith(".png")]
    check(len(batches) == 1, f"sample drew {len(batches)} batches")
    row = batches[0]
    check(row["samples"] == BATCH and len(pngs) == BATCH,
          f"sample wrote {row['samples']} samples, {len(pngs)} PNGs")
    check(row["nonfinite"] == 0, f"{row['nonfinite']} non-finite values")
    check(row["nfe"] == SAMPLE_NFE, f"sampled with {row['nfe']} NFE")
    want = net.fwd_counts(SAMPLE_NFE)
    check(n == want, f"{tag}: sampling launched {n} for {SAMPLE_NFE} NFE, "
          f"expected {want}")
    ms_nfe = row["seconds"] / SAMPLE_NFE * 1e3
    img_s = BATCH / row["seconds"]
    # the batch with its write, the span a served request times
    img_s_written = BATCH / (row["seconds"] + row["write_seconds"])
    say(f"[{tag}] cli.sample of the {net.name} from the trained "
        f"checkpoint: {len(pngs)} PNGs, "
        f"finite, batch {BATCH}, {SAMPLE_NFE}-NFE EM (bf16 net, gn_bf16): "
        f"{ms_nfe:.2f} ms/NFE, {img_s:.3f} img/s at {SAMPLE_NFE} NFE "
        f"(trajectory {row['seconds']:.2f} s, PNG writes "
        f"{row['write_seconds']:.3f} s, {img_s_written:.3f} img/s with them; "
        f"entry point {wall:.2f} s), peak {peak_gb:.2f} GB allocated; {card}")
    say(f"[{tag}] kernel launches in the run: GN {n_gn} "
        f"({net.gn}/NFE), attention {n_attn} ({net.attn}/NFE)")
    return n, {"ms_nfe": ms_nfe, "img_s": img_s,
               "img_s_written": img_s_written}


def phase_train_clf(card, work):
    """``cli.train_clf`` at the shipped classifier's width and batch (32),
    bf16 compute on float32 master weights, hash dropout 0.1, on the
    synthetic set's 512 images: one epoch of 16 steps, one sync at the
    end; returns the checkpoint it wrote and the launch counts."""
    from psld_tpu_torch.cli import train_clf as train_clf_cli
    from psld_tpu_torch.train.checkpoint import latest_checkpoint

    n_steps = 512 // CLF_TRAIN_BATCH
    results = os.path.join(work, "train_clf")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, stats = train_clf_cli.main(FLAGSHIP_ARGS + CLF_ARGS + [
        f"dataset.clf.training.results_dir={results}",
        f"dataset.clf.training.batch_size={CLF_TRAIN_BATCH}",
        "dataset.clf.training.epochs=1",
        f"dataset.clf.training.log_step={n_steps}",
        "+dataset.clf.training.bf16=True",
        "+dataset.clf.training.device=cuda",
    ])
    wall = time.perf_counter() - t0
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(stats) == n_steps and state.step == n_steps,
          f"train_clf took {len(stats)} steps")
    want = CLF.step_counts(n_steps)
    check(n == want, f"classifier training launched {n}, expected {want}")
    losses = [r["loss"] for r in stats]
    check(all(np.isfinite(v) for v in losses)
          and all(0.0 <= r["top1"] <= 1.0 for r in stats),
          f"train_clf: loss or top-1 out of range: {stats}")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()),
          "train_clf: non-finite parameters")
    ckpt = latest_checkpoint(os.path.join(results, "checkpoints"))
    check(ckpt is not None and os.path.basename(ckpt).startswith("clf-")
          and os.path.exists(ckpt + ".meta.json"),
          "train_clf wrote no classifier checkpoint")
    timed = [r["ms"] for r in stats[TRAIN_WARMUP:]]
    ms_step = float(np.mean(timed))
    img_s = CLF_TRAIN_BATCH / (ms_step / 1e3)
    say(f"[train_clf] cli.train_clf: {n_steps} steps of the shipped "
        f"classifier ({sum(v.numel() for v in state.params.values())} "
        f"params) at batch {CLF_TRAIN_BATCH} (bf16 compute, f32 master "
        f"weights, hash dropout 0.1, Adam+warmup, no clip, no EMA), "
        f"synthetic data: {ms_step:.2f} ms/step over the last "
        f"{len(timed)} (min {min(timed):.2f}, max {max(timed):.2f}), "
        f"{img_s:.2f} img/s, peak {peak_gb:.2f} GB allocated; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; entry point {wall:.1f} s; "
        f"{card}")
    say(f"[train_clf] kernel launches in the run: {n}")
    del state
    torch.cuda.empty_cache()
    return ckpt, n, {"ms_step": ms_step, "img_s": img_s, "peak_gb": peak_gb}


def phase_guided(card, work, score_ckpt, clf_ckpt):
    """``cli.class_cond_sample`` from the score checkpoint of ``train`` and
    the classifier checkpoint of ``train_clf``: guided EM at batch 64,
    bf16 networks, ``GUIDED_NFE`` NFE, ``label_to_sample=all`` over two
    batches, so the two batches carry labels 0 and 1."""
    from psld_tpu_torch.cli import class_cond_sample as guided_cli

    out_dir = os.path.join(work, "guided")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches = guided_cli.main(FLAGSHIP_ARGS + CLF_ARGS + [
        "dataset.diffusion.evaluation.sampler.name=cc_em_sde",
        f"dataset.diffusion.evaluation.chkpt_path={score_ckpt}",
        f"dataset.diffusion.evaluation.save_path={out_dir}",
        f"dataset.diffusion.evaluation.batch_size={BATCH}",
        f"dataset.diffusion.evaluation.n_samples={2 * BATCH}",
        f"dataset.diffusion.evaluation.n_discrete_steps={GUIDED_NFE}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda",
        f"dataset.clf.evaluation.chkpt_path={clf_ckpt}",
        "dataset.clf.evaluation.label_to_sample=all",
    ])
    wall = time.perf_counter() - t0
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = sorted(f for f in os.listdir(os.path.join(out_dir, "images"))
                  if f.endswith(".png"))
    check([(b["label"], b["samples"], b["nfe"]) for b in batches]
          == [(0, BATCH, GUIDED_NFE), (1, BATCH, GUIDED_NFE)],
          f"guided sampling drew {batches}")
    check(all(b["nonfinite"] == 0 for b in batches),
          "guided sampling: non-finite values")
    check(len(pngs) == 2 * BATCH
          and sum(f.startswith("output_tpuy0_") for f in pngs) == BATCH
          and sum(f.startswith("output_tpuy1_") for f in pngs) == BATCH,
          f"guided sampling wrote {len(pngs)} PNGs, not {BATCH} a label")
    want = {k: v * GUIDED_NFE * len(batches)
            for k, v in GUIDED_NFE_COUNTS.items()}
    check(n == want, f"guided sampling launched {n}, expected {want}")
    seconds = sum(b["seconds"] for b in batches)
    ms_nfe = seconds / (GUIDED_NFE * len(batches)) * 1e3
    per_batch = ", ".join(f"{b['seconds']:.2f}" for b in batches)
    say(f"[guided] cli.class_cond_sample: {len(pngs)} PNGs, finite, two "
        f"batches of {BATCH} (labels 0 and 1), {GUIDED_NFE}-NFE guided EM "
        f"(bf16 score net and classifier, clf_temp 1, diffusion time): "
        f"{ms_nfe:.2f} ms/NFE ({per_batch} s a batch; entry point "
        f"{wall:.2f} s), peak {peak_gb:.2f} GB allocated; {card}")
    say(f"[guided] kernel launches in the run: {n} ({GUIDED_NFE_COUNTS} an "
        f"NFE)")
    return n, {"ms_nfe": ms_nfe, "peak_gb": peak_gb}


def phase_sscs_check(card, cfg, weights):
    """A 3-NFE float32 SSCS trajectory (two split steps and the mean-only
    denoise) of the flagship at B=2 on the card against the CPU, with the
    same four injected draws: within 1e-4 of the sample's scale, as the
    EM check of ``net``."""
    from psld_tpu_torch.eval.generate import (build_score_model, build_sde,
                                              make_score_fn)
    from psld_tpu_torch.samplers import SSCSSampler
    from psld_tpu_torch.samplers.base import make_timesteps

    t0 = time.perf_counter()
    sde = build_sde(cfg)
    rng = np.random.default_rng(9)
    z0 = torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32))
    noise = [torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32)) for _ in range(4)]
    outs = []
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            net = build_score_model(cfg).eval()
            net.load_state_dict(weights, strict=True)
            sampler = SSCSSampler(cfg, sde, make_score_fn(net.to(dev)))
            outs.append(sampler.sample(
                None, z0.to(dev), make_timesteps(2, 1e-3), 2, denoise=True,
                eps=1e-3, noise=lambda k, x_, d=dev: noise[k].to(d)).cpu())
            del net
    scale = float(outs[0].abs().max())
    err = max_err(outs[1], outs[0])
    check(bool(torch.isfinite(outs[1]).all()) and err <= 1e-4 * scale,
          f"SSCS: card vs CPU max abs error {err:.3e} (scale {scale:.3e})")
    say(f"[sscs] 3-NFE f32 SSCS trajectory of the flagship: card == CPU (max "
        f"abs err {err:.3e}, {err / scale:.2e} of scale {scale:.3e}; tol "
        f"1e-4); phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def phase_sscs(card, work, ckpt):
    """``cli.sample`` with SSCS-2M on the quadratic grid, ``SSCS_NFE`` NFE,
    batch 64, bf16 network, from the checkpoint of ``train``."""
    from psld_tpu_torch.cli import sample as sample_cli

    out_dir = os.path.join(work, "sscs")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches = sample_cli.main(FLAGSHIP_ARGS + [
        "dataset.diffusion.evaluation.sampler.name=sscs2m_sde",
        "dataset.diffusion.evaluation.stride_type=quadratic",
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.save_path={out_dir}",
        f"dataset.diffusion.evaluation.batch_size={BATCH}",
        f"dataset.diffusion.evaluation.n_samples={BATCH}",
        f"dataset.diffusion.evaluation.n_discrete_steps={SSCS_NFE}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda",
    ])
    wall = time.perf_counter() - t0
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = [f for f in os.listdir(os.path.join(out_dir, "images"))
            if f.endswith(".png")]
    check(len(batches) == 1 and batches[0]["samples"] == BATCH
          and len(pngs) == BATCH, f"sscs wrote {len(pngs)} PNGs")
    row = batches[0]
    check(row["nonfinite"] == 0, f"sscs: {row['nonfinite']} non-finite")
    check(row["nfe"] == SSCS_NFE, f"sscs sampled with {row['nfe']} NFE")
    want = FLAGSHIP.fwd_counts(SSCS_NFE)
    check(n == want, f"SSCS-2M sampling launched {n}, expected {want}")
    ms_nfe = row["seconds"] / SSCS_NFE * 1e3
    img_s = BATCH / row["seconds"]
    say(f"[sscs] cli.sample with sscs2m_sde, quadratic grid: {len(pngs)} "
        f"PNGs, finite, batch {BATCH}, {SSCS_NFE} NFE (bf16 net): "
        f"{ms_nfe:.2f} ms/NFE, {img_s:.3f} img/s at {SSCS_NFE} NFE "
        f"(trajectory {row['seconds']:.2f} s, entry point {wall:.2f} s), "
        f"peak {peak_gb:.2f} GB allocated; {card}")
    say(f"[sscs] kernel launches in the run: {n}")
    return n, {"ms_nfe": ms_nfe, "img_s": img_s}


class NamedDraws:
    """Injected standard normal draws by the samplers' names: each name
    is drawn once, from a numpy seed, at the shape of the first request,
    so the CPU and the card runs see the same numbers."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws: dict = {}

    def __call__(self, name, like):
        if name not in self.draws:
            self.draws[name] = torch.from_numpy(self.rng.standard_normal(
                tuple(like.shape)).astype(np.float32))
        return self.draws[name].to(like.device)


def card_vs_cpu(cfg, weights, run, what: str, grad: bool = False):
    """``run(score_fn, device)`` with a CPU and a card copy of the flagship
    (float32, ``weights``): the card's output within 1e-4 of the CPU
    output's scale, as ``net`` holds EM. ``grad`` runs under ``no_grad``
    (a run that takes a gradient, as guidance does) rather than
    ``inference_mode``. Returns (card, CPU) outputs on the host and the
    error and scale."""
    from psld_tpu_torch.eval.generate import build_score_model, make_score_fn

    outs = []
    with torch.no_grad() if grad else torch.inference_mode():
        for dev in ("cpu", "cuda"):
            net = build_score_model(cfg).eval().requires_grad_(False)
            net.load_state_dict(weights, strict=True)
            outs.append(run(make_score_fn(net.to(dev)), dev).cpu())
            del net
    scale = float(outs[0].abs().max())
    err = max_err(outs[1], outs[0])
    check(bool(torch.isfinite(outs[1]).all()) and err <= 1e-4 * scale,
          f"{what}: card vs CPU max abs error {err:.3e} (scale {scale:.3e})")
    torch.cuda.empty_cache()
    return outs[1], outs[0], err, scale


def phase_pc_check(card, cfg, weights):
    """3-NFE float32 trajectories of the flagship at B=2 with one Langevin
    corrector step (snr 0.16) after each step, EM and SSCS-2M, on the
    card against the CPU with the same injected predictor and corrector
    draws: within 1e-4 of scale."""
    from psld_tpu_torch.samplers import (EulerMaruyamaSampler, SSCS2MSampler,
                                         build_corrector, make_timesteps)
    from psld_tpu_torch.train.loop import build_sde

    t0 = time.perf_counter()
    sde = build_sde(cfg)
    z0 = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (2, 32, 32, 6)).astype(np.float32))
    for cls, seed in ((EulerMaruyamaSampler, 22), (SSCS2MSampler, 23)):
        draws = NamedDraws(seed)

        def run(score, dev):
            sampler = cls(cfg, sde, score,
                          corrector_fn=build_corrector(cfg, sde, score))
            return sampler.sample(None, z0.to(dev), make_timesteps(2, 1e-3),
                                  2, denoise=True, eps=1e-3, noise=draws)

        _, _, err, scale = card_vs_cpu(cfg, weights, run,
                                       f"pc_check {cls.__name__}")
        n_corr = sum(isinstance(k, tuple) for k in draws.draws)
        check(n_corr == 2, f"pc_check: {n_corr} corrector draws, not 2")
        say(f"[pc_check] 3-NFE f32 {cls.__name__} + Langevin (1 step a "
            f"step) of the flagship: card == CPU (max abs err {err:.3e}, "
            f"{err / scale:.2e} of scale {scale:.3e}; tol 1e-4)")
    say(f"[pc_check] phase {time.perf_counter() - t0:.1f} s")


def square_mask(batch: int, size: int = 32) -> torch.Tensor:
    """``InpaintDataset``'s square mask: 1 on the known frame, 0 on the
    centre square of half the side."""
    m = torch.ones(batch, size, size, 3)
    q = size // 4
    m[:, q: 3 * q, q: 3 * q] = 0.0
    return m


def phase_inpaint_check(card, cfg, weights):
    """A 3-NFE float32 inpainting trajectory (``ip_em_sde``) of the
    flagship at B=2 under the square mask, on the card against the CPU
    with the same injected draws: within 1e-4 of scale; the known region
    of the card's sample equals x_0 within 1e-2."""
    from psld_tpu_torch.samplers import EulerMaruyamaInpainter, make_timesteps
    from psld_tpu_torch.train.loop import build_sde

    t0 = time.perf_counter()
    sde = build_sde(cfg)
    x0 = torch.from_numpy(np.random.default_rng(24).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    mask = square_mask(2)
    draws = NamedDraws(25)

    def run(score, dev):
        return EulerMaruyamaInpainter(cfg, sde, score).sample(
            None, (x0.to(dev), mask.to(dev)), make_timesteps(2, 1e-3), 2,
            denoise=True, eps=1e-3, noise=draws)

    got, _, err, scale = card_vs_cpu(cfg, weights, run, "inpaint_check")
    known = mask == 1
    k_err = max_err(got[..., :3][known], x0[known])
    check(k_err <= 1e-2, f"inpaint_check: known region off x_0 by {k_err}")
    say(f"[inpaint_check] 3-NFE f32 ip_em_sde of the flagship, square mask: "
        f"card == CPU (max abs err {err:.3e}, {err / scale:.2e} of scale "
        f"{scale:.3e}; tol 1e-4); known region == x_0 (max abs err "
        f"{k_err:.2e}; tol 1e-2); phase {time.perf_counter() - t0:.1f} s")


def phase_edit_check(card, cfg, weights):
    """A 3-NFE float32 editing trajectory (``edit_em_sde``, edit_t0 0.5)
    of the flagship at B=2 on the card against the CPU with the same
    injected draws: within 1e-4 of scale."""
    from psld_tpu_torch.samplers import EditEulerMaruyamaSampler, \
        make_timesteps
    from psld_tpu_torch.train.loop import build_sde

    t0 = time.perf_counter()
    sde = build_sde(cfg)
    x0 = torch.from_numpy(np.random.default_rng(26).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    draws = NamedDraws(27)

    def run(score, dev):
        return EditEulerMaruyamaSampler(cfg, sde, score).sample(
            None, x0.to(dev), make_timesteps(2, 1e-3), 2, denoise=True,
            eps=1e-3, noise=draws)

    _, _, err, scale = card_vs_cpu(cfg, weights, run, "edit_check")
    say(f"[edit_check] 3-NFE f32 edit_em_sde (edit_t0 0.5) of the flagship: "
        f"card == CPU (max abs err {err:.3e}, {err / scale:.2e} of scale "
        f"{scale:.3e}; tol 1e-4); phase {time.perf_counter() - t0:.1f} s")


def _pngs(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".png"))


def _eval_args(ckpt, out_dir, nfe):
    return [f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
            f"dataset.diffusion.evaluation.save_path={out_dir}",
            f"dataset.diffusion.evaluation.batch_size={BATCH}",
            f"dataset.diffusion.evaluation.n_samples={BATCH}",
            f"dataset.diffusion.evaluation.n_discrete_steps={nfe}",
            "dataset.diffusion.evaluation.sample_from=source",
            "+dataset.diffusion.evaluation.bf16=True",
            "+dataset.diffusion.evaluation.device=cuda"]


def _one_batch(batches, nfe: int, what: str):
    check(len(batches) == 1 and batches[0]["samples"] == BATCH,
          f"{what} drew {batches}")
    row = batches[0]
    check(row["nonfinite"] == 0, f"{what}: {row['nonfinite']} non-finite")
    check(row["nfe"] == nfe, f"{what} sampled with {row['nfe']} NFE")
    return row


def phase_inpaint(card, work, ckpt):
    """``cli.inpaint`` from the checkpoint of ``train`` on the synthetic
    set (square masks: no MNIST under the run's data root), batch 64, bf16, ``INPAINT_NFE`` NFE:
    samples, ground truth and masked input written under one set of
    names; the known region of every sample PNG equals the ground truth
    PNG within one level of 255."""
    from PIL import Image

    from psld_tpu_torch.cli import inpaint as inpaint_cli

    out_dir = os.path.join(work, "inpaint")
    # a data root inside the run's directory: no MNIST there, so the
    # masks are the square ones whatever the host holds
    data_root = os.path.join(work, "inpaint_data")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches = inpaint_cli.main(FLAGSHIP_ARGS + [
        "dataset.diffusion.data.name=synthetic",
        f"dataset.diffusion.data.root={data_root}"] + _eval_args(
        ckpt, out_dir, INPAINT_NFE))
    wall = time.perf_counter() - t0
    n = all_counts()
    row = _one_batch(batches, INPAINT_NFE, "inpaint")
    names = {d: _pngs(os.path.join(out_dir, d))
             for d in ("images", "batch", "corrupt")}
    check(len(names["images"]) == BATCH
          and names["images"] == names["batch"] == names["corrupt"],
          f"inpaint wrote {[len(v) for v in names.values()]} PNGs")
    known = square_mask(1)[0].numpy() == 1
    worst = 0
    for f in names["images"]:
        got, want = (np.asarray(Image.open(os.path.join(out_dir, d, f)),
                                np.int16) for d in ("images", "batch"))
        worst = max(worst, int(np.abs(got - want)[known].max()))
    check(worst <= 1, f"inpaint: known region off the ground truth by "
          f"{worst} levels")
    want = FLAGSHIP.fwd_counts(INPAINT_NFE)
    check(n == want, f"inpainting launched {n}, expected {want}")
    say(f"[inpaint] cli.inpaint from the trained checkpoint, synthetic set, "
        f"square masks: {BATCH} samples, ground truths and masked inputs "
        f"as PNGs, finite, known region within {worst} level of the ground "
        f"truth; batch {BATCH}, {INPAINT_NFE}-NFE EM (bf16 net): "
        f"{row['seconds'] / INPAINT_NFE * 1e3:.2f} ms/NFE (trajectory "
        f"{row['seconds']:.2f} s, entry point {wall:.2f} s), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; {card}")
    say(f"[inpaint] kernel launches in the run: {n}")
    return n


def phase_edit(card, work, ckpt, net=FLAGSHIP, tag="edit"):
    """``cli.edit`` of ``net`` from its trained checkpoint on the
    synthetic set, edit_t0 0.5, batch 64, bf16, ``EDIT_NFE`` NFE."""
    from psld_tpu_torch.cli import edit as edit_cli

    out_dir = os.path.join(work, tag)
    reset_counts()
    t0 = time.perf_counter()
    batches = edit_cli.main(net.args + [
        "dataset.diffusion.data.name=synthetic",
        "+dataset.diffusion.evaluation.sampler.edit_t0=0.5"] + _eval_args(
        ckpt, out_dir, EDIT_NFE))
    wall = time.perf_counter() - t0
    n = all_counts()
    row = _one_batch(batches, EDIT_NFE, tag)
    pngs = _pngs(os.path.join(out_dir, "images"))
    check(len(pngs) == BATCH and sorted(os.listdir(out_dir)) == ["images"],
          f"{tag} wrote {len(pngs)} PNGs and {os.listdir(out_dir)}")
    want = net.fwd_counts(EDIT_NFE)
    check(n == want, f"{tag}: editing launched {n}, expected {want}")
    say(f"[{tag}] cli.edit of the {net.name} from the trained checkpoint, "
        f"synthetic set, "
        f"edit_t0 0.5: {len(pngs)} PNGs, finite, batch {BATCH}, "
        f"{EDIT_NFE}-NFE EM over [0.5, 1 - 1e-3] (bf16 net): "
        f"{row['seconds'] / EDIT_NFE * 1e3:.2f} ms/NFE (trajectory "
        f"{row['seconds']:.2f} s, entry point {wall:.2f} s); {card}")
    say(f"[{tag}] kernel launches in the run: {n}")
    return n


PC_SAMPLERS = (("em_sde", []), ("sscs2m_sde", [
    "dataset.diffusion.evaluation.stride_type=quadratic"]))


def phase_pc(card, work, ckpt, net=FLAGSHIP, tag="pc",
             samplers=PC_SAMPLERS):
    """``cli.sample`` of ``net`` with ``corrector=langevin`` (one step,
    snr 0.16) from its trained checkpoint, batch 64, bf16, ``PC_NFE`` NFE
    of each of ``samplers`` (the flagship: EM and SSCS-2M on the
    quadratic grid). A corrector step is one more network forward after
    each step but the mean-only denoise one, so a run of N NFE makes 2N -
    1 forwards."""
    from psld_tpu_torch.cli import sample as sample_cli

    reset_counts()
    rows = []
    for name, extra in samplers:
        out_dir = os.path.join(work, f"{tag}_{name}")
        batches = sample_cli.main(net.args + extra + [
            f"dataset.diffusion.evaluation.sampler.name={name}",
            "+dataset.diffusion.evaluation.sampler.corrector=langevin",
            "+dataset.diffusion.evaluation.sampler.corrector_steps=1",
        ] + _eval_args(ckpt, out_dir, PC_NFE))
        rows.append(_one_batch(batches, PC_NFE, f"{tag} {name}"))
        check(len(_pngs(os.path.join(out_dir, "images"))) == BATCH,
              f"{tag} {name} wrote no {BATCH} PNGs")
    n = all_counts()
    fwd = 2 * PC_NFE - 1
    want = net.fwd_counts(len(samplers) * fwd)
    check(n == want, f"{tag}: predictor-corrector sampling launched {n}, "
          f"expected {want}")
    for (name, _), row in zip(samplers, rows):
        say(f"[{tag}] cli.sample of the {net.name} + Langevin corrector (1 "
            f"step), {PC_NFE} NFE of {name}, batch {BATCH}, bf16 net: "
            f"{BATCH} finite PNGs; {row['seconds']:.2f} s a trajectory of "
            f"{fwd} forwards ({row['seconds'] / fwd * 1e3:.2f} ms a "
            f"forward); {card}")
    say(f"[{tag}] kernel launches in the run: {n} ({len(samplers)} x {fwd} "
        f"forwards)")
    return n


def phase_ode_check(card, weights):
    """Float32 probability-flow trajectories of the flagship at B=2 on the
    card against the CPU, within 1e-4 of scale: ``rk_ode`` Heun, 2 steps;
    ``ei_ode`` order 2, 3 steps; ``adaptive_ode`` cut at 2 controller
    iterations (the same NFE on both); ``cc_ei_ode`` order 2, 2 steps,
    with the shipped classifier (weights from a numpy seed)."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval.generate import (_merged_eval_config,
                                              make_score_fn)
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.samplers import make_timesteps
    from psld_tpu_torch.train.loop import build_clf_model, build_sde

    t0 = time.perf_counter()
    set_gn_bf16(False)
    rng = np.random.default_rng(31)
    z0 = torch.from_numpy(rng.standard_normal((2, 32, 32, 6)).astype(
        np.float32))
    runs = [("rk_ode", 2, ["+dataset.diffusion.evaluation.sampler.solver="
                           "heun"]),
            ("ei_ode", 3, ["+dataset.diffusion.evaluation.sampler.order=2"]),
            ("adaptive_ode", 0, [
                "+dataset.diffusion.evaluation.sampler.rtol=1e-3",
                "+dataset.diffusion.evaluation.sampler.atol=1e-3",
                "+dataset.diffusion.evaluation.sampler.max_steps=2"])]
    for name, n, extra in runs:
        cfg = bootstrap(FLAGSHIP_ARGS + extra + [
            f"dataset.diffusion.evaluation.sampler.name={name}"
        ]).dataset.diffusion
        sde, nfe = build_sde(cfg), {}

        def run(score, dev):
            sampler = get_module("samplers", name)(cfg, sde, score)
            out = sampler.sample(None, z0.to(dev), make_timesteps(n, 1e-3),
                                 n, denoise=True, eps=1e-3)
            nfe[dev] = sampler.nfe
            return out

        _, _, err, scale = card_vs_cpu(cfg, weights, run,
                                       f"ode_check {name}")
        check(nfe["cuda"] == nfe["cpu"], f"ode_check {name}: {nfe} NFE")
        say(f"[ode_check] f32 {name} ({nfe['cuda']} NFE) of the flagship: "
            f"card == CPU (max abs err {err:.3e}, {err / scale:.2e} of "
            f"scale {scale:.3e}; tol 1e-4)")

    # guided: the classifier on each device beside the score network
    dcfg = bootstrap(FLAGSHIP_ARGS + CLF_ARGS + [
        "dataset.diffusion.evaluation.sampler.name=cc_ei_ode",
        "+dataset.diffusion.evaluation.sampler.order=2"]).dataset
    clf_weights = flagship_weights(build_clf_model(dcfg.clf, device="meta"),
                                   seed=7)
    merged = _merged_eval_config(dcfg)
    sde = build_sde(dcfg.diffusion)

    def guided(score, dev):
        clf = build_clf_model(dcfg.clf).eval().requires_grad_(False)
        clf.load_state_dict(clf_weights, strict=True)
        sampler = get_module("samplers", "cc_ei_ode")(
            merged, sde, score, clf_fn=make_score_fn(clf.to(dev)), y=3)
        return sampler.sample(None, z0.to(dev), make_timesteps(2, 1e-3), 2,
                              denoise=True, eps=1e-3)

    _, _, err, scale = card_vs_cpu(dcfg.diffusion, weights, guided,
                                   "ode_check cc_ei_ode", grad=True)
    say(f"[ode_check] f32 cc_ei_ode (2 guided steps + denoise, label 3) of "
        f"the flagship and the shipped classifier: card == CPU (max abs err "
        f"{err:.3e}, {err / scale:.2e} of scale {scale:.3e}; tol 1e-4); "
        f"phase {time.perf_counter() - t0:.1f} s")
    os.environ.pop("PSLD_GN_BF16")


def phase_ode(card, work, ckpt, net=FLAGSHIP, tag="ode"):
    """``cli.sample`` of ``net`` with the probability-flow ODE samplers
    from its trained checkpoint, batch 64, bf16: ``ei_ode`` order 2 at
    ``EI_NFE``, ``rk_ode`` Heun with ``RK_STEPS`` steps, ``adaptive_ode``
    and ``bb_ode`` at rtol = atol = ``ODE_TOL``. One forward an NFE.
    SciPy's integrator module is imported (and its import timed) before
    the runs: the trajectories' times are those of a process that has
    it."""
    t0 = time.perf_counter()
    import scipy
    import scipy.integrate  # noqa: F401

    import_s = time.perf_counter() - t0
    from psld_tpu_torch.cli import sample as sample_cli

    reset_counts()
    rows = []
    for name, nfe_arg, extra in (
            ("ei_ode", EI_NFE,
             ["+dataset.diffusion.evaluation.sampler.order=2"]),
            ("rk_ode", RK_STEPS + 1,
             ["+dataset.diffusion.evaluation.sampler.solver=heun"]),
            ("adaptive_ode", 2, [
                f"+dataset.diffusion.evaluation.sampler.rtol={ODE_TOL}",
                f"+dataset.diffusion.evaluation.sampler.atol={ODE_TOL}",
                "+dataset.diffusion.evaluation.sampler.max_steps="
                f"{ODE_MAX_STEPS}"]),
            ("bb_ode", 2, [
                f"+dataset.diffusion.evaluation.sampler.rtol={ODE_TOL}",
                f"+dataset.diffusion.evaluation.sampler.atol={ODE_TOL}"])):
        out_dir = os.path.join(work, f"{tag}_{name}")
        batches = sample_cli.main(net.args + extra + [
            f"dataset.diffusion.evaluation.sampler.name={name}",
        ] + _eval_args(ckpt, out_dir, nfe_arg))
        check(len(batches) == 1 and batches[0]["samples"] == BATCH
              and batches[0]["nonfinite"] == 0, f"{tag} {name} drew {batches}")
        check(len(_pngs(os.path.join(out_dir, "images"))) == BATCH,
              f"{tag} {name} wrote no {BATCH} PNGs")
        rows.append((name, batches[0]))
    nfes = {name: row["nfe"] for name, row in rows}
    check(nfes["ei_ode"] == EI_NFE and nfes["rk_ode"] == 2 * RK_STEPS + 1,
          f"{tag}: fixed-grid NFE {nfes}")
    n = all_counts()
    total = sum(nfes.values())
    want = net.fwd_counts(total)
    check(n == want, f"{tag}: ODE sampling launched {n}, expected {want}")
    for name, row in rows:
        extra = ""
        if name == "adaptive_ode":
            capped = row["nfe"] == 2 + 6 * ODE_MAX_STEPS + 1
            extra = (f"; rtol = atol = {ODE_TOL}, max_steps {ODE_MAX_STEPS}"
                     f" ({'reached' if capped else 'not reached'})")
        elif name == "bb_ode":
            extra = (f"; SciPy {scipy.__version__} RK45 (scipy.integrate "
                     f"imported in {import_s:.2f} s before the run), rtol = "
                     f"atol = {ODE_TOL}, mean NFE {row['nfe']}")
        say(f"[{tag}] cli.sample of the {net.name}, {name}: {BATCH} finite "
            f"PNGs, batch {BATCH}, "
            f"{row['nfe']} NFE (bf16 net): "
            f"{row['seconds'] / row['nfe'] * 1e3:.2f} ms/NFE, "
            f"{BATCH / row['seconds']:.3f} img/s (trajectory "
            f"{row['seconds']:.2f} s){extra}; {card}")
    say(f"[{tag}] kernel launches in the run: {n} ({total} NFE, "
        f"{net.gn} GN and {net.attn} attention an NFE)")
    return n, {name: row["seconds"] / row["nfe"] * 1e3 for name, row in rows}


def phase_cc_ode(card, work, score_ckpt, clf_ckpt):
    """``cli.class_cond_sample`` with ``cc_ei_ode`` (order 2) from the
    checkpoints of ``train`` and ``train_clf``: one batch of 64, label 0,
    ``CC_ODE_NFE`` NFE, bf16 networks. Every NFE but the unguided denoise
    microstep runs the score network, the classifier and its gradient."""
    from psld_tpu_torch.cli import class_cond_sample as guided_cli

    out_dir = os.path.join(work, "cc_ode")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    batches = guided_cli.main(FLAGSHIP_ARGS + CLF_ARGS + [
        "dataset.diffusion.evaluation.sampler.name=cc_ei_ode",
        "+dataset.diffusion.evaluation.sampler.order=2",
        f"dataset.clf.evaluation.chkpt_path={clf_ckpt}",
        "dataset.clf.evaluation.label_to_sample=0",
    ] + _eval_args(score_ckpt, out_dir, CC_ODE_NFE))
    n = all_counts()
    row = _one_batch(batches, CC_ODE_NFE, "cc_ode")
    check(row["label"] == 0 and len(_pngs(os.path.join(out_dir, "images")))
          == BATCH, f"cc_ode drew {batches}")
    guided = CC_ODE_NFE - 1
    want = {k: v * guided for k, v in GUIDED_NFE_COUNTS.items()}
    want["group_norm_act"] += FLAGSHIP.gn
    want["attention"] += FLAGSHIP.attn
    check(n == want, f"guided ODE sampling launched {n}, expected {want}")
    ms_nfe = row["seconds"] / CC_ODE_NFE * 1e3
    say(f"[cc_ode] cli.class_cond_sample cc_ei_ode (order 2), label 0: "
        f"{BATCH} finite PNGs, batch {BATCH}, {CC_ODE_NFE} NFE ({guided} "
        f"guided, bf16 score net and classifier): {ms_nfe:.2f} ms/NFE, "
        f"{BATCH / row['seconds']:.3f} img/s (trajectory "
        f"{row['seconds']:.2f} s), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; {card}")
    say(f"[cc_ode] kernel launches in the run: {n}")
    return n


def linear_flow_bits_per_dim(args, eps: float = 1e-5):
    """bits/dim of the synthetic set's first batch of ``BATCH`` under the
    probability flow of a VP-SDE whose eps-prediction is 0, on the host:
    (exact, float64; ``cli.likelihood``'s RK4 with ``LIK_STEPS`` steps,
    float32). The drift is -beta(t) x / 2, so the flow from ``eps`` (the
    likelihood's default) to 1 maps x to a x with log a =
    log_mean_coeff(1) - log_mean_coeff(eps), and logp(x) = log N(a x; 0,
    I) + D log a; a Rademacher probe's divergence of the linear drift is
    exact, so the RK4 number differs from it by the solver's error
    alone."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.data.loader import get_dataset
    from psld_tpu_torch.eval.likelihood import (bits_per_dim,
                                                make_likelihood_fn)
    from psld_tpu_torch.train.loop import build_sde

    cfg = bootstrap(args + [
        "dataset.diffusion.data.name=synthetic"]).dataset.diffusion
    sde = build_sde(cfg)
    x = torch.from_numpy(get_dataset(cfg).batch(np.arange(BATCH)))
    dim = math.prod(x.shape[1:])
    t = torch.tensor([1.0, eps], dtype=torch.float64)
    lmc = sde._log_mean_coeff(t)
    log_a = float(lmc[0] - lmc[1])
    exact = sde.prior_logp(x.double() * math.exp(log_a)) + dim * log_a
    rk4 = make_likelihood_fn(sde, lambda z, tt: torch.zeros_like(z),
                             n_steps=LIK_STEPS, eps=eps, method="rk4")(
        torch.Generator().manual_seed(0), x)["logp"]
    return tuple(float(np.mean(bits_per_dim(-v.numpy(), dim)))
                 for v in (exact, rk4))


def phase_likelihood(card, work, ckpt, net=FLAGSHIP, tag="likelihood"):
    """``cli.likelihood`` of ``net`` from its trained checkpoint on the
    synthetic set: one batch of 64, bf16 network, RK4 with ``LIK_STEPS``
    steps (4 right-hand sides a step, each one forward and one
    vector-Jacobian product into the input), one Hutchinson probe; finite
    bits/dim (PSLD's the augmented bound, the VP-SDE's its NLL)."""
    from psld_tpu_torch.cli import likelihood as likelihood_cli

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bpd, batches = likelihood_cli.main(net.args + [
        "dataset.diffusion.data.name=synthetic",
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.batch_size={BATCH}",
        f"dataset.diffusion.evaluation.n_samples={BATCH}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda",
        f"+dataset.diffusion.evaluation.likelihood.n_steps={LIK_STEPS}",
        "+dataset.diffusion.evaluation.likelihood.solver=rk4",
        "+dataset.diffusion.evaluation.likelihood.n_probes=1",
    ])
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rhs = 4 * LIK_STEPS
    check(len(batches) == 1 and batches[0]["samples"] == BATCH
          and batches[0]["nonfinite"] == 0 and np.isfinite(bpd)
          and batches[0]["nfe"] == rhs, f"{tag}: {bpd}, {batches}")
    want = net.fwd_counts(rhs, input_vjps=rhs)
    check(n == want, f"{tag}: the likelihood launched {n}, expected {want}")
    seconds = batches[0]["seconds"]
    say(f"[{tag}] cli.likelihood of the {net.name} from the trained "
        f"checkpoint, synthetic "
        f"set, batch {BATCH}, bf16 net, RK4 x {LIK_STEPS} ({rhs} right-hand "
        f"sides), 1 Hutchinson probe: {bpd:.4f} bits/dim (finite); "
        f"{seconds / rhs * 1e3:.2f} ms a right-hand side (a forward and an "
        f"input-only VJP; batch {seconds:.2f} s), peak {peak_gb:.2f} GB "
        f"allocated; {card}")
    say(f"[{tag}] kernel launches in the run: {n}")
    out = {"ms_rhs": seconds / rhs * 1e3, "peak_gb": peak_gb, "bpd": bpd}
    if net is VP:
        exact, rk4 = linear_flow_bits_per_dim(net.args)
        out["zero_eps_bpd"] = {"exact": exact, "rk4": rk4}
        say(f"[{tag}] the same batch under the flow of a zero "
            f"eps-prediction, on the host: {exact:.4f} bits/dim exact, "
            f"{rk4:.4f} through RK4 x {LIK_STEPS} (the solver's error "
            f"alone); the network's flow: {bpd:.4f}")
    return n, out


def phase_bench(card):
    """``psld_tpu_torch.eval.bench.run_bench`` in this process at the
    flagship's full width with ``BENCH_NFE`` NFE (the bench's default is
    1000) and its train phase; its line is printed, and its img/s and MFU
    shares must be positive, the shares at most 1.05."""
    reset_counts()
    t0 = time.perf_counter()
    line = bench.run_bench(nfe=BENCH_NFE)
    wall = time.perf_counter() - t0
    n = all_counts()
    say(f"[bench] line: {json.dumps(line)}")
    for key in ("value", "train_img_per_s", "mfu_vs_h100_bf16_peak",
                "train_mfu_vs_h100_bf16_peak"):
        v = line.get(key)
        check(isinstance(v, float) and v > 0 and np.isfinite(v),
              f"bench: {key} = {v}")
    for key in ("mfu_vs_h100_bf16_peak", "train_mfu_vs_h100_bf16_peak"):
        check(line[key] <= 1.05, f"bench: {key} = {line[key]} > 1.05")
    fwd = bench.WARMUP_NFE + BENCH_NFE
    steps = bench.TRAIN_WARMUP + bench.TRAIN_TIMED
    want = {k: v + FLAGSHIP.fwd_counts(fwd)[k]
            for k, v in FLAGSHIP.step_counts(steps).items()}
    check(n == want, f"the bench launched {n}, expected {want}")
    say(f"[bench] run_bench(nfe={BENCH_NFE}) in {wall:.1f} s: "
        f"{line['value']:.4f} img/s, MFU {line['mfu_vs_h100_bf16_peak']:.4f};"
        f" train {line['train_img_per_s']:.2f} img/s, MFU "
        f"{line['train_mfu_vs_h100_bf16_peak']:.4f}; {line['device']}")
    say(f"[bench] kernel launches in the run: {n}")
    return n, line


def vp_weights(seed: int = 11) -> dict:
    """The VP-SDE network's weights, N(0, 1) * 0.02 from a numpy seed."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval.generate import build_score_model

    cfg = bootstrap(VP.args).dataset.diffusion
    with torch.device("meta"):
        net = build_score_model(cfg)
    n_params = sum(p.numel() for p in net.parameters())
    check(n_params == VP_PARAMS, f"the VP-SDE net has {n_params} params")
    return flagship_weights(net, seed=seed)


def phase_vp_check(card, weights):
    """Float32 paths of the VP-SDE network (``weights``) on the card
    against the CPU with the same injected draws, beside its training step
    and likelihood step (``phase_train_check``, ``phase_likelihood_check``):
    3 NFE of EM, of EM with one Langevin step a step, of editing
    (edit_t0 0.5) and of ``ei_ode`` (order 2, a 3-NFE grid) at B=2, within
    1e-4 of scale; and the Inception features of 4 images at 32 x 32
    resized to 299, random weights, within 1e-4 of scale, with cuDNN's
    TF32 switched on around the call (the extractor turns it off for its
    own scope)."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval.fid import (FIDInception, extract_features,
                                         random_params)
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.samplers import build_corrector, make_timesteps
    from psld_tpu_torch.train.loop import build_sde

    t0 = time.perf_counter()
    set_gn_bf16(False)
    rng = np.random.default_rng(41)

    # 3-NFE trajectories
    z0 = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    x0 = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    runs = [("EM", "em_sde", [], z0),
            ("EM + Langevin", "em_sde", [
                "+dataset.diffusion.evaluation.sampler.corrector=langevin"],
             z0),
            ("editing (edit_t0 0.5)", "edit_em_sde", [], x0),
            ("ei_ode (order 2)", "ei_ode", [
                "+dataset.diffusion.evaluation.sampler.order=2"], z0)]
    for k, (label, name, extra, start) in enumerate(runs):
        rcfg = bootstrap(VP.args + extra + [
            f"dataset.diffusion.evaluation.sampler.name={name}"
        ]).dataset.diffusion
        sde = build_sde(rcfg)
        draws = NamedDraws(42 + k)

        def run(score, dev):
            sampler = get_module("samplers", name)(
                rcfg, sde, score,
                corrector_fn=build_corrector(rcfg, sde, score))
            return sampler.sample(None, start.to(dev),
                                  make_timesteps(2, 1e-3), 2, denoise=True,
                                  eps=1e-3, noise=draws)

        _, _, err, scale = card_vs_cpu(rcfg, weights, run,
                                       f"vp_check {label}")
        say(f"[vp_check] 3-NFE f32 {label} of the VP-SDE net at B=2: card "
            f"== CPU (max abs err {err:.3e}, {err / scale:.2e} of scale "
            f"{scale:.3e}; tol 1e-4)")
    os.environ.pop("PSLD_GN_BF16")

    # Inception: random weights, 4 images of 32 x 32 resized to 299
    params = random_params(torch.Generator().manual_seed(0))
    imgs = torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32))
    want = extract_features(FIDInception.from_params(params, device="cpu"),
                            imgs)
    net = FIDInception.from_params(params, device="cuda")
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = extract_features(net, imgs.cuda()).cpu()
        check(torch.backends.cudnn.allow_tf32,
              "the feature extractor left cuDNN's TF32 flag changed")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    scale = float(want.abs().max())
    err = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale,
          f"vp_check Inception: card vs CPU max abs error {err:.3e} (scale "
          f"{scale:.3e}, tol 1e-4)")
    say(f"[vp_check] Inception features of 4 images 32 -> 299, random "
        f"weights, TF32 on outside the extractor: card == CPU (max abs err "
        f"{err:.3e}, {err / scale:.2e} of scale {scale:.3e}; tol 1e-4); "
        f"phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def write_reference_pngs(work, first: int = 0,
                         name: str = "reference") -> str:
    """Images ``first`` to ``first + 64`` of the synthetic set as PNGs in
    ``work/name``: the reference side of ``fid`` and ``sweep`` (the first
    64), and ``fid``'s other side (the next 64)."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.data.loader import get_dataset
    from psld_tpu_torch.utils.images import save_as_images

    cfg = bootstrap(VP.args + [
        "dataset.diffusion.data.name=synthetic"]).dataset.diffusion
    out = os.path.join(work, name)
    os.makedirs(out)
    save_as_images(get_dataset(cfg).batch(np.arange(first, first + BATCH)),
                   os.path.join(out, "synthetic"))
    return out


def write_fake_inception(path, seed: int = 12) -> str:
    """A ``pt_inception-2015-12-05`` state_dict of random values
    (convolutions, BatchNorm statistics and the fc head, by the
    checkpoint's keys) from a numpy seed: ``load_torch_checkpoint``'s
    input, whose metric values mean nothing."""
    from psld_tpu_torch.eval.fid import FID_DIM, N_LOGITS
    from psld_tpu_torch.eval.fid.inception import all_conv_specs

    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32))

    sd = {}
    for name, (i, o, (kh, kw), _, _) in all_conv_specs().items():
        sd[f"{name}.conv.weight"] = arr((o, i, kh, kw), (i * kh * kw) ** -0.5)
        sd[f"{name}.bn.weight"] = arr((o,), 0.1, 1.0)
        sd[f"{name}.bn.bias"] = arr((o,), 0.1)
        sd[f"{name}.bn.running_mean"] = arr((o,), 0.1)
        sd[f"{name}.bn.running_var"] = arr((o,), 0.1, 1.0).abs() + 0.1
    sd["fc.weight"] = arr((N_LOGITS, FID_DIM), FID_DIM ** -0.5)
    sd["fc.bias"] = arr((N_LOGITS,), 0.1)
    torch.save(sd, path)
    return path


def phase_fid(card, work, samples, reference, lines):
    """``cli.fid --fid --kid --isc --save-stats1`` on the card with random
    Inception weights: 64 PNGs (``samples``) against 64 others of the
    synthetic set (``reference``). The three values must be finite and no
    kernel of the port may run (Inception is cuDNN); the saved ``.npz`` is
    read back, and FID from it as ``--input1`` must equal the first. Then
    Inception's feature extraction is timed at batch 64 (CUDA events, 32
    x 32 images resized to 299). The phase runs in a thread beside
    [build] (its two SciPy square roots are host work, and no kernel of
    the port launches then): its lines go into ``lines``, which the
    caller prints."""
    from psld_tpu_torch.cli import fid as fid_cli
    from psld_tpu_torch.eval.fid import (FID_DIM, FIDInception,
                                         extract_features, load_stats,
                                         random_params)

    stats = os.path.join(work, "samples_stats.npz")
    reset_counts()
    t0 = time.perf_counter()
    scores = fid_cli.main(["--input1", samples, "--input2", reference,
                           "--fid", "--kid", "--isc", "--save-stats1",
                           stats, "--batch", str(BATCH)])
    wall = time.perf_counter() - t0
    n = all_counts()
    check(n == expected(), f"fid launched kernels of the port: {n}")
    check(len(scores) == 5 and all(np.isfinite(v) for v in scores.values()),
          f"fid: {scores}")
    mu, sigma = load_stats(stats)
    with np.load(stats) as f:
        count = int(f["count"])
    check(mu.shape == (FID_DIM,) and sigma.shape == (FID_DIM, FID_DIM)
          and count == BATCH and np.isfinite(sigma).all(),
          f"fid: stats file {mu.shape} {sigma.shape} count {count}")
    again = fid_cli.main(["--input1", stats, "--input2", reference,
                          "--batch", str(BATCH)])
    first = scores["frechet_inception_distance"]
    check(abs(again["frechet_inception_distance"] - first)
          <= 1e-6 * abs(first) + 1e-12,
          f"fid: from the stats file {again}, from the images {first}")
    net = FIDInception.from_params(random_params(
        torch.Generator().manual_seed(0)), device="cuda")
    imgs = torch.rand(BATCH, 32, 32, 3, device="cuda")
    ms = cuda_ms(lambda: extract_features(net, imgs), iters=5, warmup=2)
    lines.append(
        f"[fid] cli.fid --fid --kid --isc, random Inception weights, "
        f"{BATCH} synthetic images against {BATCH} others: "
        + ", ".join(f"{k} {v:.6g}" for k, v in scores.items())
        + f" (finite); --save-stats1 read back (count {count}), FID from it "
        f"{again['frechet_inception_distance']:.6g}; entry point "
        f"{wall:.1f} s; no kernel of the port launched")
    lines.append(
        f"[fid] Inception features, f32 (TF32 off), batch {BATCH}, 32 -> "
        f"299: {ms:.2f} ms a batch, {BATCH / ms * 1e3:.1f} images/s; {card}; "
        f"the phase ran beside [build]")
    del net
    torch.cuda.empty_cache()
    return {"ms_batch": ms, "img_s": BATCH / ms * 1e3}


def phase_sweep(card, work, ckpt, reference, weights_path):
    """``cli.sweep_fid_nfe`` of the VP-SDE checkpoint over
    ``SWEEP_SAMPLERS`` at ``SWEEP_NFES`` each (uniform grid), 64 samples a
    point, bf16,
    FID against ``reference`` with the fake Inception checkpoint: every
    record has a finite ``fid`` and no ``quality_error``, each record (the
    first stride of its (sampler, NFE)) is marked ``includes_compile`` as
    the JAX sweep marks it (the kernels were built by earlier phases, so
    no record here holds a build), and the launches are exactly those of
    the points' forwards."""
    from psld_tpu_torch.cli import sweep_fid_nfe as sweep_cli

    out = os.path.join(work, "sweep")
    reset_counts()
    t0 = time.perf_counter()
    records = sweep_cli.main([
        "--samplers", ",".join(SWEEP_SAMPLERS), "--nfes",
        ",".join(str(v) for v in SWEEP_NFES), "--strides", "uniform",
        "--out-dir", out, "--ref-dir", reference, "--weights", weights_path,
        "--fid-batch", str(BATCH)] + VP.args + [
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.batch_size={BATCH}",
        f"dataset.diffusion.evaluation.n_samples={BATCH}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda"])
    wall = time.perf_counter() - t0
    n = all_counts()
    check(len(records) == len(SWEEP_SAMPLERS) * len(SWEEP_NFES),
          f"sweep: {records}")
    for rec in records:
        check("quality_error" not in rec and np.isfinite(rec.get("fid",
                                                               np.nan))
              and rec["n_samples"] == BATCH, f"sweep record {rec}")
    check([r["includes_compile"] for r in records] == [True] * len(records),
          f"sweep: includes_compile {records}")
    forwards = len(SWEEP_SAMPLERS) * sum(SWEEP_NFES)
    want = VP.fwd_counts(forwards)
    check(n == want, f"sweep launched {n}, expected {want}")
    for rec in records:
        say(f"[sweep] {rec['sampler']} {rec['nfe']} NFE: FID {rec['fid']:.6g} "
            f"(fake Inception checkpoint), {rec['img_per_s']} img/s over "
            f"{rec['elapsed_s']} s, pixel delta mean "
            f"{rec['pixel_stats']['delta']['mean']}")
    say(f"[sweep] cli.sweep_fid_nfe: {len(records)} records in {wall:.1f} s, "
        f"each with fid and no quality_error; kernel launches {n} "
        f"({forwards} forwards); {card}")
    return n


def phase_interop(card, work, ckpt, clf_ckpt):
    """``cli.export_checkpoint`` of the train checkpoint to a reference
    Lightning ``.ckpt``, then ``cli.convert_checkpoint`` back; the same
    with ``--clf`` for the train_clf checkpoint. Every tensor of the
    round trip must be bit-equal to the original (a classifier's
    ``params``, which the conversion also puts in ``ema_params``), the
    ``.ckpt`` must carry the checkpoint's step, and nothing may launch a
    kernel. Returns the converted flagship checkpoint."""
    from psld_tpu_torch.cli import convert_checkpoint, export_checkpoint

    reset_counts()
    converted = None
    for tag, src, args, flag in (
            ("flagship", ckpt, FLAGSHIP_ARGS, []),
            ("classifier", clf_ckpt, FLAGSHIP_ARGS + CLF_ARGS, ["--clf"])):
        lit = os.path.join(work, "interop", f"{tag}.ckpt")
        os.makedirs(os.path.dirname(lit), exist_ok=True)
        t0 = time.perf_counter()
        export_checkpoint.main([src, lit, *flag, *args])
        t1 = time.perf_counter()
        conv = convert_checkpoint.main(
            [lit, os.path.join(work, "interop", f"{tag}.pt"), *flag, *args])
        t2 = time.perf_counter()
        orig = torch.load(src, map_location="cpu", weights_only=True)
        back = torch.load(conv, map_location="cpu", weights_only=True)
        ref = torch.load(lit, map_location="cpu", weights_only=True)
        check(ref["global_step"] == orig["step"],
              f"interop {tag}: .ckpt step {ref['global_step']}, checkpoint "
              f"step {orig['step']}")
        pairs = [("params", "params"), ("ema_params", "ema_params")]
        if flag:
            pairs[1] = ("ema_params", "params")
        for got, want in pairs:
            a, b = back[got], orig[want]
            check(sorted(a) == sorted(b),
                  f"interop {tag}: {got} keys differ from {want}")
            bad = [k for k in b if not torch.equal(a[k], b[k])]
            check(not bad, f"interop {tag}: {got} differs from the "
                  f"original's {want} in {len(bad)} tensors: {bad[:3]}")
        sd = ref["state_dict"]
        n_el = sum(v.numel() for v in sd.values())
        say(f"[interop] {tag}: {os.path.basename(src)} -> .ckpt "
            f"({len(sd)} tensors, {n_el} values, "
            f"{os.path.getsize(lit) / 1e9:.3f} GB) in {t1 - t0:.2f} s -> "
            f"{os.path.basename(conv)} "
            f"({os.path.getsize(conv) / 1e9:.3f} GB) in {t2 - t1:.2f} s; "
            f"{len(b)} tensors of params"
            f"{'' if flag else ' and ema_params'} bit-equal to the "
            f"original; step {ref['global_step']} carried")
        if not flag:
            converted = conv
        del orig, back, ref, sd
    n = all_counts()
    check(not any(n.values()), f"interop launched kernels: {n}")
    say(f"[interop] kernel launches: {n}")
    return converted


SERVE_LARGE = 96  # a full batch and a partial one


def phase_serve(card, work, ckpt, sampled_rates):
    """``cli.serve`` of the converted flagship checkpoint in a thread of
    this process (so the launch counts see it): batch 64, bf16 network,
    gn_bf16, ``SAMPLE_NFE``-NFE EM, as ``[sample]``. A client sends ping, info, a
    request of 64 with ``[sample]``'s seed, one of 96, a bad request, the
    first again into the same directory, and shutdown. The first
    request's PNGs must equal ``[sample]``'s, the repeat's the first's;
    the launches must be exactly one forward's per NFE of every batch
    (the warmup's included). Rates are compared span for span with
    ``[sample]``'s: trajectories alone, and trajectories with writes."""
    import tempfile

    sock = os.path.join(work, "serve.sock")
    if len(sock) <= 100:  # AF_UNIX paths hold 108 bytes
        return _serve(card, work, ckpt, sampled_rates, sock)
    with tempfile.TemporaryDirectory(prefix="ps") as d:
        return _serve(card, work, ckpt, sampled_rates,
                      os.path.join(d, "serve.sock"))


def _serve(card, work, ckpt, sampled_rates, sock):
    import threading

    from PIL import Image

    from psld_tpu_torch.cli import serve as serve_cli
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.serve import request

    args = FLAGSHIP_ARGS + _eval_args(ckpt, os.path.join(work, "unused"),
                                      SAMPLE_NFE)
    seed = int(bootstrap(args).dataset.diffusion.evaluation.seed)
    box = {}
    ready = threading.Event()

    def up(svc):
        box["svc"] = svc
        ready.set()

    def run():
        try:
            box["served"] = serve_cli.main(["--socket", sock] + args,
                                           ready_callback=up)
        except Exception as e:  # reported by the main thread
            box["error"] = e
            ready.set()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    th = threading.Thread(target=run, name="serve", daemon=True)
    th.start()
    check(ready.wait(timeout=600), "the server did not come up in 600 s")
    check("error" not in box, f"the server failed: {box.get('error')!r}")
    up_s = time.perf_counter() - t0
    warm_s = box["svc"].warmup_s
    out_dir = os.path.join(work, "serve")
    first_dir = os.path.join(out_dir, "first")
    check(request(sock, {"cmd": "ping"})["ok"], "ping failed")
    info = request(sock, {"cmd": "info"})
    check(info["ok"] and info["compiled"] and info["devices"] == 1
          and info["per_dispatch_batch"] == BATCH
          and info["n_discrete_steps"] == SAMPLE_NFE, f"info: {info}")
    replies = [request(sock, {"cmd": "sample", "n": BATCH, "seed": seed,
                              "out": first_dir}),
               request(sock, {"cmd": "sample", "n": SERVE_LARGE,
                              "seed": seed + 1,
                              "out": os.path.join(out_dir, "large")})]
    bad = request(sock, {"cmd": "sample", "n": 1})
    check(not bad["ok"] and "out" in bad["error"], f"bad request: {bad}")
    replies.append(request(sock, {"cmd": "sample", "n": BATCH,
                                  "seed": seed, "out": first_dir}))
    check(request(sock, {"cmd": "shutdown"})["ok"], "shutdown failed")
    th.join(timeout=120)
    check(not th.is_alive() and "error" not in box,
          f"the server did not stop cleanly: {box.get('error')!r}")
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_b = [(BATCH, 1), (SERVE_LARGE, 2), (BATCH, 1)]
    check(all(r["ok"] for r in replies)
          and [(r["written"], r["batches"]) for r in replies] == want_b
          and [r["request_id"] for r in replies] == [0, 1, 2],
          f"sample replies: {replies}")
    batches = 1 + sum(r["batches"] for r in replies)  # the warmup's too
    want = FLAGSHIP.fwd_counts(SAMPLE_NFE * batches)
    check(n == want, f"serve launched {n} for {batches} batches of "
          f"{SAMPLE_NFE} NFE, expected {want}")
    check(box["served"] == 7, f"the server counted {box['served']} requests")

    def images(d, rid):
        names = sorted(f for f in _pngs(d) if f.startswith(
            f"output_tpu_{rid}_"))
        return names, [np.asarray(Image.open(os.path.join(d, f)))
                       for f in names]

    sample_names, sampled = images(os.path.join(work, "sample", "images"), 0)
    first_names, first = images(os.path.join(first_dir, "images"), 0)
    again_names, again = images(os.path.join(first_dir, "images"), 2)
    large, _ = images(os.path.join(out_dir, "large", "images"), 1)
    check(len(large) == SERVE_LARGE, f"the large request wrote {len(large)}")
    check(first_names == sample_names and len(first) == BATCH
          and len(again) == BATCH, f"served {len(first)} and "
          f"{len(again)} PNGs, [sample] {len(sampled)}")
    gaps = []
    for what, got in (("[sample]", first), ("the first request", again)):
        want_imgs = sampled if what == "[sample]" else first
        diff = [int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                for a, b in zip(got, want_imgs)]
        gaps.append(max(diff))
        check(max(diff) == 0, f"served PNGs differ from {what}'s: "
              f"{sum(d > 0 for d in diff)} of {len(diff)} images, up to "
              f"{max(diff)} levels")
    img_s = [r["img_per_s"] for r in replies]
    traj_img_s = [r["written"] / r["trajectory_s"] for r in replies]
    write_share = [r["write_s"] / r["elapsed_s"] for r in replies]
    say(f"[serve] cli.serve of the converted flagship checkpoint, batch "
        f"{BATCH}, {SAMPLE_NFE}-NFE EM (bf16 net, gn_bf16): up in "
        f"{up_s:.2f} s, warmup (one batch) {warm_s:.2f} s; peak "
        f"{peak_gb:.2f} GB allocated; {card}")
    for what, r, tot, traj, share in zip(
            ("first", "large", "repeat"), replies, img_s, traj_img_s,
            write_share):
        say(f"[serve] {what} request, {r['written']} img: {tot:.3f} img/s "
            f"with writes ({r['elapsed_s']:.3f} s, PNG writes "
            f"{r['write_s']:.3f} s = {share:.4f} of it), {traj:.3f} img/s "
            f"in trajectories")
    say(f"[serve] against [sample] in this call: with writes "
        f"{img_s[0] / sampled_rates['img_s_written']:.3f} x "
        f"({sampled_rates['img_s_written']:.3f} img/s), trajectories "
        f"{traj_img_s[0] / sampled_rates['img_s']:.3f} x "
        f"({sampled_rates['img_s']:.3f} img/s)")
    say(f"[serve] the first request's {len(first)} PNGs equal [sample]'s "
        f"bit for bit, the repeat's equal the first's (max gap "
        f"{max(gaps)} levels); a bad request answered ok=false and the "
        f"server went on; {box['served']} requests served")
    say(f"[serve] kernel launches over {batches} batches: GN "
        f"{n['group_norm_act']} ({FLAGSHIP.gn}/NFE), attention "
        f"{n['attention']} ({FLAGSHIP.attn}/NFE)")
    return n, {"warmup_s": warm_s, "img_s": img_s,
               "trajectory_img_s": traj_img_s, "write_share": write_share}


def phase_hires_check(card):
    """One float32 training step of CelebA-HQ 256 at B=1 on the card
    against the CPU (``phase_train_check``'s tolerances): GroupNorm at
    65,536 pixels in float32, where the backward's plan reads part of its
    rows from device memory."""
    from psld_tpu_torch.ops.group_norm import plan_backward

    plans = {dt: plan_backward(65536, 128, 32, dt)
             for dt in (torch.float32, torch.bfloat16)}
    for dt, plan in plans.items():
        rows = -(-65536 // plan["cluster"])
        check(plan["resident"] < rows, f"hires_check: the {dt} backward plan"
              f" {plan} holds every row")
        say(f"[hires_check] GN backward plan at 65,536 pixels, C=128, "
            f"{str(dt)[6:]}: cluster {plan['cluster']}, {plan['resident']} "
            f"of {rows} rows a block resident, {plan['smem']} bytes")
    phase_train_check(card, hq_weights(HQ, 51), HQ, "hires_check", seed=52,
                      batch=1, extra=["dataset.diffusion.data.root=/unused"])


def hq_weights(net_desc, seed: int) -> dict:
    """A network's weights, N(0, 1) * 0.02 from a numpy seed, checked
    against its published parameter count."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval.generate import build_score_model

    cfg = bootstrap(net_desc.args).dataset.diffusion
    with torch.device("meta"):
        net = build_score_model(cfg)
    n_params = sum(p.numel() for p in net.parameters())
    want = HQ_PARAMS if net_desc is HQ else AFHQ_PARAMS
    check(n_params == want, f"{net_desc.name} has {n_params} params")
    return flagship_weights(net, seed=seed)


def write_folder(root, subdirs, per_dir: int, size: int, seed: int) -> int:
    """Synthetic images (``SyntheticDataset``'s blobs, numpy seed) as
    PNGs at ``size`` into each of ``subdirs`` under ``root``, through the
    native codec; returns how many were written."""
    from psld_tpu_torch import native
    from psld_tpu_torch.data.datasets import SyntheticDataset

    for i, sub in enumerate(subdirs):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        imgs = SyntheticDataset(None, image_size=size, n=per_dir,
                                seed=seed + i).images
        native.write_png_batch(imgs, os.path.join(d, "img"))
    return per_dir * len(subdirs)


HQ_SUBDIRS = ("train/male", "train/female")
# epochs of [resume]'s run: SIGTERM lands in the first, the relaunch
# replays it
RESUME_EPOCHS = 1
AFHQ_SUBDIRS = ("train/cat", "train/dog", "train/wild")
PROFILE_STEPS = 4


class LogLines:
    """Captures the messages of one logger while it is installed."""

    def __init__(self, name: str):
        import logging

        self.lines, self.logger = [], logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.lines.append(r.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _folder_train_args(net, root, results, batch, epochs, log_step):
    return net.args + [
        f"dataset.diffusion.data.root={root}",
        f"dataset.diffusion.training.results_dir={results}",
        f"dataset.diffusion.training.batch_size={batch}",
        f"dataset.diffusion.training.epochs={epochs}",
        f"dataset.diffusion.training.chkpt_interval={epochs}",
        f"dataset.diffusion.training.log_step={log_step}",
        "+dataset.diffusion.training.bf16=True",
        "+dataset.diffusion.training.device=cuda",
    ]


def phase_folder_train(card, work, net, subdirs, size, batch, warmup, timed,
                       tag, what, profile: bool = False):
    """``cli.train_sde`` of ``net`` at its config's batch on a synthetic
    image folder of its dataset's layout (``warmup + timed`` images a
    batch, one epoch), read through the native codec with ``prefetch``
    2; with ``profile``, ``profile_dir`` set and ``profile_steps``
    ``PROFILE_STEPS`` (the warm-up steps): one Chrome trace holding those
    steps' kernels alone. Returns the checkpoint, the launches and the
    times."""
    from psld_tpu_torch.cli import train_sde as train_cli
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.data.loader import get_dataset
    from psld_tpu_torch.train.checkpoint import latest_checkpoint

    root = os.path.join(work, f"{tag}_data")
    n_steps = warmup + timed
    t0 = time.perf_counter()
    n_imgs = write_folder(root, subdirs, -(-n_steps * batch // len(subdirs)),
                          size, seed=61)
    write_s = time.perf_counter() - t0
    results = os.path.join(work, tag)
    trace_dir = os.path.join(work, f"{tag}_trace")
    args = _folder_train_args(net, root, results, batch, 1, n_steps) + [
        "+dataset.diffusion.training.prefetch=2"]
    if profile:
        args += [f"+dataset.diffusion.training.profile_dir={trace_dir}",
                 f"+dataset.diffusion.training.profile_steps={PROFILE_STEPS}"]
    dataset = get_dataset(bootstrap(args).dataset.diffusion)
    check(len(dataset) == n_imgs and dataset.native,
          f"{tag}: the folder of {n_imgs} PNGs did not take the native "
          "codec")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with LogLines("psld_tpu_torch.train.loop") as lines:
        state, stats = train_cli.main(args)
    wall = time.perf_counter() - t0
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(stats) == n_steps and state.step == n_steps,
          f"{tag} took {len(stats)} steps")
    want = net.step_counts(n_steps)
    check(n == want, f"{tag}: training launched {n}, expected {want}")
    losses = [r["loss"] for r in stats]
    check(all(np.isfinite(v) for v in losses)
          and all(np.isfinite(r["grad_norm"]) for r in stats),
          f"{tag}: non-finite loss or gradient norm: {losses}")
    for tree in (state.params, state.ema_params):
        check(all(bool(torch.isfinite(v).all()) for v in tree.values()),
              f"{tag}: non-finite parameters")
    ckpt = latest_checkpoint(os.path.join(results, "checkpoints"))
    check(ckpt is not None and os.path.exists(ckpt + ".meta.json"),
          f"{tag} wrote no checkpoint")
    timing = [line for line in lines if line.startswith("timing: ")]
    check(len(timing) == 1, f"{tag}: no StepTimer summary in the log")
    summary = ast.literal_eval(timing[0][len("timing: "):])
    total = sum(v["total_s"] for v in summary.values())
    data_share = summary["data"]["total_s"] / total
    timed_ms = [r["ms"] for r in stats[warmup:]]
    ms_step = float(np.mean(timed_ms))
    img_s = batch / (ms_step / 1e3)
    say(f"[{tag}] cli.train_sde: {n_steps} steps of the {net.name} at batch "
        f"{batch} (bf16 compute, f32 master weights, {what}) on {n_imgs} "
        f"synthetic {size} x {size} PNGs (native codec, prefetch 2; written "
        f"in {write_s:.2f} s): {ms_step:.2f} ms/step over the last {timed} "
        f"(min {min(timed_ms):.2f}, max {max(timed_ms):.2f}), {img_s:.2f} "
        f"img/s, peak {peak_gb:.2f} GB allocated; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; entry point {wall:.1f} s; {card}")
    say(f"[{tag}] StepTimer: " + ", ".join(
        f"{k} {v['total_s']:.3f} s / {v['count']}" for k, v in
        summary.items()) + f"; data share {data_share:.4f}")
    say(f"[{tag}] kernel launches in the run: {n}")
    out = {"ms_step": ms_step, "img_s": img_s, "peak_gb": peak_gb,
           "data_share": data_share}
    if profile:
        files = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
        check(len(files) == 1, f"{tag}: {len(files)} trace files in "
              f"profile_dir")
        path = os.path.join(trace_dir, files[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        gn_fwd = sum(1 for e in kernels if "gn_fwd" in e.get("name", ""))
        check(gn_fwd == PROFILE_STEPS * net.gn,
              f"{tag}: the trace holds {gn_fwd} GroupNorm forward kernels, "
              f"not the {PROFILE_STEPS} x {net.gn} of {PROFILE_STEPS} steps")
        say(f"[{tag}] trace {os.path.basename(path)} "
            f"({os.path.getsize(path) / 1e6:.1f} MB): {len(kernels)} kernel "
            f"events, {gn_fwd} GroupNorm forwards = {PROFILE_STEPS} steps x "
            f"{net.gn}")
        out["trace_kernels"] = len(kernels)
    del state
    torch.cuda.empty_cache()
    return ckpt, n, out


_RESUME_DRIVER = """
import json, sys
from psld_tpu_torch import ops
from psld_tpu_torch.cli import train_sde
state, stats = train_sde.main(sys.argv[1:])
print("RESUME " + json.dumps({
    "step": state.step, "rows": [[r["step"], r["epoch"]] for r in stats],
    "launches": {k: getattr(ops, f).launches for k, f in (
        ("group_norm_act", "group_norm_act"),
        ("group_norm_act_bwd", "group_norm_act_backward"),
        ("attention", "attention"), ("hash_dropout", "hash_dropout"),
        ("fused_leaky_relu", "fused_leaky_relu"),
        ("fused_leaky_relu_bwd", "fused_leaky_relu_backward"),
        ("group_norm_split_stats", "group_norm_split_stats"),
        ("group_norm_split_apply", "group_norm_split_apply"),
        ("group_norm_split_partials", "group_norm_split_partials"),
        ("group_norm_split_dx", "group_norm_split_dx"))}}),
      flush=True)
"""


def phase_resume(card, work, net=HQ, tag="resume"):
    """A process of ``cli.train_sde`` (CelebA-HQ 256 at batch 8 on the
    ``celebahq_train`` folder, ``RESUME_EPOCHS`` epochs,
    ``auto_resume=true``) gets
    SIGTERM after its first logged step: it must exit 0 and leave a
    checkpoint marked incomplete. The same command, started again,
    resumes at that checkpoint's step and replays its epoch, then runs
    to its end. Each process prints its launches and rows."""
    import signal

    from psld_tpu_torch.train.checkpoint import latest_checkpoint

    root = os.path.join(work, "celebahq_train_data")
    results = os.path.join(work, tag)
    per_epoch = len([f for sub in HQ_SUBDIRS
                     for f in os.listdir(os.path.join(root, sub))]) \
        // HQ_BATCH
    args = _folder_train_args(net, root, results, HQ_BATCH, RESUME_EPOCHS,
                              1) + [
        "+dataset.diffusion.training.auto_resume=true"]
    cmd = [sys.executable, "-c", _RESUME_DRIVER, *args]
    env = {**os.environ, "PYTHONPATH": REPO}

    def run(kill: bool):
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        waited = None
        try:
            if kill:
                metrics = os.path.join(results, "metrics.jsonl")
                deadline = time.time() + 300
                while time.time() < deadline and proc.poll() is None:
                    if os.path.exists(metrics) and any(
                            '"step"' in line for line in open(metrics)):
                        break
                    time.sleep(0.05)
                check(proc.poll() is None, f"{tag}: the run ended before "
                      "its first logged step")
                waited = time.perf_counter() - t0
                proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"{tag}: exit {proc.returncode}:\n"
              + out[-3000:])
        line = [x for x in out.splitlines() if x.startswith("RESUME ")]
        check(len(line) == 1, f"{tag}: no result line:\n{out[-3000:]}")
        return json.loads(line[0][len("RESUME "):]), \
            time.perf_counter() - t0, waited

    first, first_s, waited = run(kill=True)
    ckpt = latest_checkpoint(os.path.join(results, "checkpoints"))
    check(ckpt is not None, f"{tag}: no checkpoint after SIGTERM")
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    saved_step = int(torch.load(ckpt, map_location="cpu",
                                weights_only=True)["step"])
    check(meta["complete"] is False and saved_step == first["step"]
          and 1 <= saved_step < RESUME_EPOCHS * per_epoch,
          f"{tag}: after SIGTERM at step {first['step']} the checkpoint "
          f"holds step {saved_step}, meta {meta}")
    second, second_s, _ = run(kill=False)
    epoch = int(meta["epoch"])
    rows = second["rows"]
    want_steps = saved_step + (RESUME_EPOCHS - epoch) * per_epoch
    check(rows[0] == [saved_step + 1, epoch] and second["step"] == want_steps
          and len(rows) == (RESUME_EPOCHS - epoch) * per_epoch,
          f"{tag}: the relaunch began at {rows[0]} and ended at step "
          f"{second['step']}; expected step {saved_step + 1} of epoch "
          f"{epoch}, ending at {want_steps}")
    n = {k: first["launches"][k] + second["launches"][k]
         for k in first["launches"]}
    want = net.step_counts(first["step"] + len(rows))
    check(n == want, f"{tag}: the two runs launched {n}, expected {want}")
    say(f"[{tag}] cli.train_sde of the {net.name} in a process: SIGTERM "
        f"after its first logged step ({waited:.1f} s after start) -> exit "
        f"0 in {first_s:.1f} s at step {saved_step}, checkpoint "
        f"{os.path.basename(ckpt)} marked incomplete (epoch {epoch}); the "
        f"same command again (auto_resume=true) resumed at step "
        f"{saved_step + 1} of epoch {epoch} and ended at step "
        f"{second['step']} ({second_s:.1f} s); launches {n}")
    return n


def phase_async_ckpt(card, work, tag="async_ckpt"):
    """The flagship's train state (97.6M parameters: params, EMA, two Adam
    moments, 1.562 GB) on the card: ``save_checkpoint`` (synchronous)
    against ``AsyncSaver.save()``'s return time, twice (the first save
    allocates the pinned buffers, the second reuses them), with a
    training step at batch 128 after each ``save()`` that changes every
    tensor in place; the time of each write behind it; each file read back
    bit-equal to the state at its ``save()``."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.train import checkpoint as ckpt
    from psld_tpu_torch.train.loop import build_score_model, build_sde
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import StepRandom, make_train_step

    cfg = bootstrap(FLAGSHIP.args + TRAIN_ARGS + [
        "dataset.diffusion.training.results_dir=/unused"]).dataset.diffusion
    net = build_score_model(cfg)
    net.load_state_dict(flagship_weights(net, seed=71), strict=True)
    net.cuda()
    sde = build_sde(cfg)
    crit = get_module("losses", cfg.training.loss.name)(cfg, sde)
    step, opt = make_train_step(net, sde, crit, cfg)
    state = init_state(dict(net.named_parameters()), opt)
    rng = StepRandom(72, "cuda")
    x = torch.rand(TRAIN_BATCH, 32, 32, 3, device="cuda") * 2 - 1
    state, _ = step(state, x, rng)  # non-zero moments
    torch.cuda.synchronize()
    out_dir = os.path.join(work, tag)

    def snapshot():
        return {name: {k: v.detach().cpu().clone() for k, v in tree.items()}
                for name, tree in (("params", state.params),
                                   ("ema_params", state.ema_params),
                                   ("mu", state.opt_state["mu"]),
                                   ("nu", state.opt_state["nu"]))}

    t0 = time.perf_counter()
    sync_path = ckpt.save_checkpoint(out_dir, "sync", state)
    sync_s = time.perf_counter() - t0
    size_gb = os.path.getsize(sync_path) / 1e9
    writes = []
    real_write = ckpt._write

    def timed_write(path, payload):
        t = time.perf_counter()
        real_write(path, payload)
        writes.append(time.perf_counter() - t)

    ckpt._write = timed_write
    returns = []
    reset_counts()
    try:
        with ckpt.AsyncSaver() as saver:
            for i in range(2):
                want, step_no = snapshot(), state.step
                t0 = time.perf_counter()
                path = saver.save(out_dir, f"async{i}", state)
                returns.append(time.perf_counter() - t0)
                state, _ = step(state, x, rng)  # changes every tensor
                torch.cuda.synchronize()
                saver.wait()
                raw = torch.load(path, map_location="cpu", weights_only=True)
                check(raw["step"] == step_no, f"{tag}: file {i} holds step "
                      f"{raw['step']}, saved at {step_no}")
                for name, tree in want.items():
                    got = raw[name] if name in ("params", "ema_params") \
                        else raw["opt_state"][name]
                    for k, v in tree.items():
                        check(torch.equal(got[k], v), f"{tag}: file {i}, "
                              f"{name} {k} differs from the state at save()")
                check(any(not torch.equal(state.params[k].cpu(), v)
                          for k, v in want["params"].items()),
                      f"{tag}: the step after save() changed no parameter")
    finally:
        ckpt._write = real_write
    torch.cuda.synchronize()
    n = all_counts()
    want_n = FLAGSHIP.step_counts(2)
    check(n == want_n, f"{tag}: the two steps launched {n}, expected "
          f"{want_n}")
    say(f"[{tag}] flagship train state ({size_gb:.3f} GB file): "
        f"save_checkpoint {sync_s:.3f} s; AsyncSaver.save() returned in "
        f"{returns[0]:.3f} s (first: pinned buffers allocated) and "
        f"{returns[1]:.3f} s (buffers reused), "
        f"{returns[1] / sync_s:.4f} of the synchronous save; the writes "
        f"behind them {writes[0]:.3f} and {writes[1]:.3f} s; each file "
        f"bit-equal to the state at its save() after a step at batch "
        f"{TRAIN_BATCH} changed it; {card}")
    del state, step, net
    torch.cuda.empty_cache()
    return n, {"sync_s": sync_s, "return_s": returns, "write_s": writes,
               "size_gb": size_gb}


def phase_folder_sample(card, work, ckpt, net=HQ, tag="celebahq_sample",
                        nfe: int = HQ_SAMPLE_NFE):
    """``cli.sample`` of ``net`` from its folder-trained checkpoint: one
    batch of ``HQ_BATCH``, ``nfe``-NFE EM, bf16."""
    from psld_tpu_torch.cli import sample as sample_cli

    out_dir = os.path.join(work, tag)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches = sample_cli.main(net.args + [
        "dataset.diffusion.data.root=/unused",
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.save_path={out_dir}",
        f"dataset.diffusion.evaluation.batch_size={HQ_BATCH}",
        f"dataset.diffusion.evaluation.n_samples={HQ_BATCH}",
        f"dataset.diffusion.evaluation.n_discrete_steps={nfe}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda"])
    wall = time.perf_counter() - t0
    n = all_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = _pngs(os.path.join(out_dir, "images"))
    check(len(batches) == 1 and batches[0]["samples"] == HQ_BATCH
          and len(pngs) == HQ_BATCH, f"{tag} drew {batches}")
    row = batches[0]
    check(row["nonfinite"] == 0 and row["nfe"] == nfe, f"{tag}: {row}")
    from psld_tpu_torch import native

    shape = native.read_png_info(os.path.join(out_dir, "images", pngs[0]))
    check(shape == (256, 256, 3), f"{tag}: PNGs of {shape}")
    want = net.fwd_counts(nfe)
    check(n == want, f"{tag}: sampling launched {n}, expected {want}")
    ms_nfe = row["seconds"] / nfe * 1e3
    say(f"[{tag}] cli.sample of the {net.name}: {len(pngs)} finite 256 x "
        f"256 PNGs, batch {HQ_BATCH}, {nfe}-NFE EM (bf16, gn_bf16): "
        f"{ms_nfe:.2f} ms/NFE, {HQ_BATCH / row['seconds']:.3f} img/s "
        f"(entry point {wall:.2f} s), peak {peak_gb:.2f} GB; launches {n}; "
        f"{card}")
    return n, {"ms_nfe": ms_nfe, "img_s": HQ_BATCH / row["seconds"],
               "peak_gb": peak_gb}


def phase_fanout(card, work, ckpt, tag="fanout"):
    """Per-rank fan-out: ``cli.sample`` from the flagship's train
    checkpoint as rank 0 and then rank 1 of ``num_processes=2``,
    ``n_samples`` 64, batch 64 (each rank draws one full-width batch and
    keeps its 32), ``FANOUT_NFE``-NFE EM, bf16: 64 PNGs in all, named by
    rank, and the two ranks' images differ."""
    from PIL import Image

    from psld_tpu_torch.cli import sample as sample_cli

    out_dir = os.path.join(work, tag)
    reset_counts()
    t0 = time.perf_counter()
    for rank in range(2):
        batches = sample_cli.main(FLAGSHIP.args + [
            f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
            f"dataset.diffusion.evaluation.save_path={out_dir}",
            f"dataset.diffusion.evaluation.batch_size={BATCH}",
            f"dataset.diffusion.evaluation.n_samples={BATCH}",
            f"dataset.diffusion.evaluation.n_discrete_steps={FANOUT_NFE}",
            "dataset.diffusion.evaluation.sample_from=source",
            "+dataset.diffusion.evaluation.bf16=True",
            "+dataset.diffusion.evaluation.device=cuda",
            f"+dataset.diffusion.evaluation.rank={rank}",
            "+dataset.diffusion.evaluation.num_processes=2"])
        check([(b["samples"], b["nonfinite"]) for b in batches]
              == [(BATCH // 2, 0)], f"{tag} rank {rank} drew {batches}")
    wall = time.perf_counter() - t0
    n = all_counts()
    pngs = _pngs(os.path.join(out_dir, "images"))
    want_names = sorted(f"output_tpu_{r}_0_{i}.png" for r in range(2)
                        for i in range(BATCH // 2))
    check(pngs == want_names, f"{tag}: wrote {len(pngs)} PNGs: {pngs[:4]}")
    imgs = {r: np.stack([np.asarray(Image.open(os.path.join(
        out_dir, "images", f"output_tpu_{r}_0_{i}.png")))
        for i in range(BATCH // 2)]) for r in range(2)}
    gap = float(np.abs(imgs[0].astype(np.float32) - imgs[1]).mean())
    check(gap > 1.0, f"{tag}: the two ranks' images differ by {gap:.3f} "
          "levels on average")
    want = FLAGSHIP.fwd_counts(2 * FANOUT_NFE)
    check(n == want, f"{tag}: the two ranks launched {n}, expected {want}")
    say(f"[{tag}] cli.sample as rank 0 and rank 1 of 2, n_samples "
        f"{BATCH}: {len(pngs)} PNGs named output_tpu_<rank>_0_<i>, 32 a "
        f"rank; the ranks' images differ by {gap:.2f} levels on average; "
        f"{FANOUT_NFE}-NFE EM, {wall:.2f} s for both; launches {n}")
    return n


# -- multi-process paths ------------------------------------------------------
_RANK_SCRIPT = r'''
"""One rank of a multi-process phase of chip_smoke.py: the runs of a spec
file, each with the kernels' launch counts set to 0 before it, and one
line "DIST <json>" of what they did."""
import json, os, sys, time
spec = json.load(open(sys.argv[1]))
rank = int(os.environ.get("RANK", "0"))
import numpy as np
import torch
# as in the smoke's own process: float32 is float32, not TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if spec.get("deterministic"):
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
from psld_tpu_torch import ops
from psld_tpu_torch.parallel import distributed, fsdp
from psld_tpu_torch.train import loop

NAMES = (("group_norm_act", "group_norm_act"),
         ("group_norm_act_bwd", "group_norm_act_backward"),
         ("attention", "attention"), ("hash_dropout", "hash_dropout"),
         ("fused_leaky_relu", "fused_leaky_relu"),
         ("fused_leaky_relu_bwd", "fused_leaky_relu_backward"),
         ("group_norm_split_stats", "group_norm_split_stats"),
         ("group_norm_split_apply", "group_norm_split_apply"),
         ("group_norm_split_partials", "group_norm_split_partials"),
         ("group_norm_split_dx", "group_norm_split_dx"))
result = {"rank": rank, "runs": {}}


def staged(name, fn):
    """``fn`` on host copies of its CUDA tensors."""
    if name in ("all_reduce_", "broadcast_"):
        def run(t, *args, **kwargs):
            h = t.cpu()
            fn(h, *args, **kwargs)
            t.copy_(h)
    else:
        def run(out, inp, **kwargs):
            h = out.cpu()
            fn(h, inp.cpu(), **kwargs)
            out.copy_(h)
    return run


if spec.get("gloo"):
    # NCCL takes one rank a card: two ranks on one card join over gloo
    torch.set_num_threads(spec["threads"])
    torch.cuda.set_device(0)
    # several groups share the card: a rank's allocator stays within its
    # share (cuDNN then takes algorithms whose workspace fits in it)
    torch.cuda.set_per_process_memory_fraction(spec["memory_fraction"])
    torch.distributed.init_process_group("gloo")
    world = torch.distributed.get_world_size()
    dev = torch.device("cuda", 0)
    probes = {
        "all_reduce_": lambda: distributed.all_reduce_(
            torch.ones(4, device=dev)),
        "broadcast_": lambda: distributed.broadcast_(
            torch.full((4,), float(rank), device=dev), 0),
        "all_gather_flat": lambda: distributed.all_gather_flat(
            torch.empty(4 * world, device=dev),
            torch.full((4,), float(rank), device=dev)),
        "reduce_scatter_flat": lambda: distributed.reduce_scatter_flat(
            torch.empty(4, device=dev), torch.ones(4 * world, device=dev)),
    }
    result["gloo"] = {}
    for name, probe in probes.items():
        try:
            probe()
            torch.cuda.synchronize()
            result["gloo"][name] = "gloo on CUDA tensors"
        except Exception as e:  # the smoke's own choice, printed
            result["gloo"][name] = ("staged through the host: "
                                    f"{type(e).__name__}: {str(e)[:120]}")
            setattr(distributed, name, staged(name, getattr(distributed,
                                                            name)))
    # the staged or direct collectives give the right numbers
    t = torch.ones(4, device=dev)
    distributed.all_reduce_(t)
    g = torch.empty(4 * world, device=dev)
    distributed.all_gather_flat(g, torch.full((4,), float(rank), device=dev))
    r = torch.empty(4, device=dev)
    distributed.reduce_scatter_flat(
        r, torch.arange(4 * world, device=dev, dtype=torch.float32))
    assert float(t[0]) == world, t
    assert g.view(world, 4)[:, 0].tolist() == list(map(float, range(world)))
    assert r.tolist() == [float(world * (4 * rank + i)) for i in range(4)]

captured = {}
real_place = loop._place


def place(state, net, layout):
    out = real_place(state, net, layout)
    captured["state_bytes"] = fsdp.per_device_bytes(out)
    captured["rule_bytes"] = None if layout is None \
        else layout.bytes_per_rank()
    captured["sharded_leaves"] = None if layout is None \
        else len(layout.sharded)
    return out


loop._place = place
kept = None
world_n = int(os.environ.get("WORLD_SIZE", "1"))
for run in spec["runs"]:
    if run.get("wait_for"):
        # the smoke's process holds the card's memory until it marks the
        # end of its references, one file a rank
        deadline = time.time() + 600
        while not all(os.path.exists(f"{run['wait_for']}.{r}")
                      for r in range(world_n)):
            if time.time() > deadline:
                raise RuntimeError(f"waited 600 s for {run['wait_for']}")
            time.sleep(0.5)
    if run.get("group"):
        os.environ["PSLD_MULTIHOST"] = "1"
    else:
        os.environ.pop("PSLD_MULTIHOST", None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _, f in NAMES:
        getattr(ops, f).launches = 0
    captured.clear()
    undo = []
    if run.get("fault") == "halo":
        # a planted fault: the rows every halo exchange brings in are 0
        from psld_tpu_torch.parallel import spatial
        real_halo = spatial.halo

        def zero_halo(x, top, bottom, dim=2, real=real_halo):
            y = real(x, top, bottom, dim)
            keep = torch.zeros(y.shape[dim], dtype=y.dtype, device=y.device)
            keep[top:top + x.shape[dim]] = 1
            shape = [1] * y.ndim
            shape[dim] = -1
            return y * keep.view(shape)

        undo.append((spatial, "halo", real_halo))
        spatial.halo = zero_halo
    elif run.get("fault") == "gn":
        # a planted fault: GroupNorm of a shard's own moments
        from psld_tpu_torch.models import layers
        undo.append((layers, "group_norm_act_split",
                     layers.group_norm_act_split))
        layers.group_norm_act_split = layers.group_norm_act
    t0 = time.perf_counter()
    if run["kind"] == "train":
        from psld_tpu_torch.cli import train_sde
        from psld_tpu_torch.cli._common import bootstrap
        if run.get("max_steps"):
            state, stats = loop.train_sde(
                bootstrap(run["argv"]).dataset.diffusion, run["max_steps"])
        else:
            state, stats = train_sde.main(run["argv"])
        torch.cuda.synchronize()
        rec = {"step": state.step, "ms": [r["ms"] for r in stats],
               "loss": [r["loss"] for r in stats],
               "grad_norm": [r["grad_norm"] for r in stats]}
        if run.get("keep"):
            kept = state.params
        del state
    else:
        from psld_tpu_torch.cli import inpaint, sample
        from psld_tpu_torch.eval import writers
        reals = {}
        for cls in (writers.SimpleImageWriter, writers.InpaintingImageWriter):
            reals[cls] = cls.write_batch

            def recording(self, samples, rank, batch_idx, real=reals[cls],
                          **kw):
                np.save(os.path.join(run["rows_dir"],
                                     f"rows_{rank}_{batch_idx}.npy"), samples)
                return real(self, samples, rank, batch_idx, **kw)

            cls.write_batch = recording
        os.makedirs(run["rows_dir"], exist_ok=True)
        main = inpaint.main if run["kind"] == "inpaint" else sample.main
        batches = main(run["argv"])
        for cls, real in reals.items():
            cls.write_batch = real
        torch.cuda.synchronize()
        rec = {"batches": [[b["samples"], b["nfe"], b["nonfinite"],
                            b["seconds"]] for b in batches]}
    for mod, name, real in undo:
        setattr(mod, name, real)
    rec.update(launches={k: getattr(ops, f).launches for k, f in NAMES},
               seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated(),
               world=distributed.process_info()[1], **captured)
    result["runs"][run["tag"]] = rec
    torch.cuda.empty_cache()

if spec.get("time_reduce") and distributed.initialized():
    # the gradient reduction of one step at the trained network's shapes
    grads = [torch.zeros_like(v) for v in kept.values() if v.requires_grad]
    grads.append(torch.zeros((), device=grads[0].device))
    reducer = distributed.GradReducer(True)
    reducer(grads)

    def timed(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def all_reduce():
        for bucket in reducer.buckets:
            distributed.all_reduce_(bucket)

    result["reduce"] = {"all_reduce_ms": timed(all_reduce),
                        "reducer_ms": timed(lambda: reducer(grads)),
                        "buckets": len(reducer.buckets),
                        "bytes": reducer.flat.numel() * 4}
print("DIST " + json.dumps(result), flush=True)
'''


_PORTS: set = set()  # the ports handed out, so that no two groups share one


def _free_port() -> int:
    import socket

    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _PORTS:
            _PORTS.add(port)
            return port


def start_ranks(work, tag, spec, world: int, torchrun: bool = False):
    """Start the rank script on ``spec`` in ``world`` processes (through
    ``torch.distributed.run`` when ``torchrun``, else as ranks of a gloo
    group on card 0, ``spec["threads"]`` intra-op threads each); returns
    the handle :func:`finish_ranks` takes."""
    script = os.path.join(work, "rank_script.py")
    with open(script, "w") as f:
        f.write(_RANK_SCRIPT)
    spec_path = os.path.join(work, f"{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("PSLD_MULTIHOST", None)
    if torchrun:
        cmds = [([sys.executable, "-m", "torch.distributed.run",
                  "--standalone", f"--nproc_per_node={world}", script,
                  spec_path], env)]
    else:
        port = str(_free_port())
        cmds = [([sys.executable, script, spec_path],
                 {**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                  "RANK": str(r), "WORLD_SIZE": str(world),
                  "LOCAL_RANK": "0"}) for r in range(world)]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=e, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd, e in cmds]
    return tag, procs


def finish_ranks(handle, timeout: float = 600):
    """Wait for the processes of :func:`start_ranks`; every one must exit
    0. Returns each rank's result, in rank order."""
    tag, procs = handle
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"{tag}: a rank exited {p.returncode}:\n"
              + out[-4000:])
        lines = [x for x in out.splitlines() if x.startswith("DIST ")]
        check(len(lines) == 1, f"{tag}: no result line:\n{out[-3000:]}")
        results.append(json.loads(lines[0][len("DIST "):]))
    return sorted(results, key=lambda r: r["rank"])


def launch_ranks(work, tag, spec, world: int, torchrun: bool = False):
    """:func:`start_ranks`, then :func:`finish_ranks`."""
    return finish_ranks(start_ranks(work, tag, spec, world, torchrun))


@functools.lru_cache(maxsize=4)
def _trees(path):
    """A checkpoint's trees, read once for the comparisons that take it
    (the callers only read them)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return {"params": raw["params"], "ema": raw["ema_params"],
            "mu": raw["opt_state"]["mu"], "nu": raw["opt_state"]["nu"]}, \
        (int(raw["step"]), int(raw["opt_state"]["count"]))


def compare_states(path_a, path_b):
    """(bit-equal, worst error over each tree's largest magnitude, and
    where it is) of two checkpoints' params, EMA and Adam moments."""
    (a, ca), (b, cb) = _trees(path_a), _trees(path_b)
    equal, worst, where = ca == cb, 0.0, ""
    for name in a:
        check(set(a[name]) == set(b[name]), f"{name}: keys differ")
        scale = max(float(v.abs().max()) for v in b[name].values())
        for k, v in b[name].items():
            equal = equal and torch.equal(a[name][k], v)
            err = max_err(a[name][k], v) / max(scale, 1e-30)
            if err > worst:
                worst, where = err, f"{name} {k}"
    return equal, worst, where


def _ckpt_of(results):
    from psld_tpu_torch.train.checkpoint import latest_checkpoint

    path = latest_checkpoint(os.path.join(results, "checkpoints"))
    check(path is not None, f"no checkpoint in {results}")
    return path


def _train_argv(batch, epochs, results, bf16=True, fsdp=False,
                hflip=True):
    """``cli.train_sde`` of the flagship on the synthetic set. Without
    ``hflip``: the loader of N processes draws its flips per local batch
    from the same seed in each (the JAX package's rule), which a run of
    one process does not, so a comparison across the two turns it off."""
    return FLAGSHIP.args + [
        "dataset.diffusion.data.name=synthetic",
        f"dataset.diffusion.data.hflip={hflip}",
        "+dataset.diffusion.model.score_fn.dropout_impl=hw",
        f"+dataset.diffusion.training.bf16={bf16}",
        f"dataset.diffusion.training.results_dir={results}",
        f"dataset.diffusion.training.batch_size={batch}",
        "+dataset.diffusion.training.grad_accum=1",
        f"dataset.diffusion.training.epochs={epochs}",
        f"dataset.diffusion.training.chkpt_interval={epochs}",
        f"dataset.diffusion.training.log_step={epochs * 512 // 128}",
        "+dataset.diffusion.training.device=cuda",
    ] + (["+dataset.diffusion.training.fsdp=true"] if fsdp else [])


def phase_ddp(card, work, train_ms):
    """[ddp] and [fsdp] at world size 1 on NCCL (see the module's
    docstring); returns the launch counts of the NCCL run and of the FSDP
    run."""
    n_steps = DDP_STEPS
    epochs = n_steps * TRAIN_BATCH // 512
    dirs = {t: os.path.join(work, t) for t in ("ddp_plain", "ddp", "fsdp")}
    runs = [{"tag": "plain", "kind": "train", "group": False,
             "argv": _train_argv(TRAIN_BATCH, epochs, dirs["ddp_plain"])},
            {"tag": "ddp", "kind": "train", "group": True, "keep": True,
             "argv": _train_argv(TRAIN_BATCH, epochs, dirs["ddp"])},
            {"tag": "fsdp", "kind": "train", "group": True,
             "argv": _train_argv(TRAIN_BATCH, epochs, dirs["fsdp"],
                                 fsdp=True)}]
    t0 = time.perf_counter()
    res = launch_ranks(work, "ddp", {"deterministic": True, "runs": runs,
                                     "time_reduce": True}, 1,
                       torchrun=True)[0]
    wall = time.perf_counter() - t0
    want = FLAGSHIP.step_counts(n_steps)
    ms = {}
    for tag, rec in res["runs"].items():
        check(rec["step"] == n_steps, f"[ddp] {tag} took {rec['step']} "
              "steps")
        check(rec["launches"] == want, f"[ddp] {tag} launched "
              f"{rec['launches']}, expected {want}")
        check(all(np.isfinite(rec["loss"])), f"[ddp] {tag}: non-finite "
              "loss")
        ms[tag] = float(np.mean(rec["ms"][TRAIN_WARMUP:]))
    check(res["runs"]["plain"]["world"] == 1
          and res["runs"]["ddp"]["world"] == 1
          and res["runs"]["fsdp"]["world"] == 1, "[ddp] world size")
    ckpts = {t: _ckpt_of(d) for t, d in dirs.items()}
    same_plain, err_plain, _ = compare_states(ckpts["ddp"],
                                              ckpts["ddp_plain"])
    check(same_plain, f"[ddp] NCCL at world size 1 differs from one "
          f"process by {err_plain:.3e} of scale: not bit-equal")
    same_fsdp, err_fsdp, _ = compare_states(ckpts["fsdp"], ckpts["ddp"])
    check(same_fsdp, f"[fsdp] FSDP at world size 1 differs from [ddp] by "
          f"{err_fsdp:.3e} of scale: not bit-equal")
    red = res["reduce"]
    fs = res["runs"]["fsdp"]
    say(f"[ddp] cli.train_sde of the flagship under torch.distributed.run "
        f"(--standalone, 1 process), NCCL, world size 1, batch "
        f"{TRAIN_BATCH}, bf16, hash dropout 0.15, {n_steps} steps, cuDNN "
        f"deterministic: checkpoint bit-equal to the same process's run "
        f"without a process group; ms/step {ms['ddp']:.2f} over "
        f"{n_steps - TRAIN_WARMUP} steps (no group "
        f"{ms['plain']:.2f}, [train] {train_ms:.2f}); all-reduce "
        f"{red['all_reduce_ms']:.3f} ms a step ({red['buckets']} buckets, "
        f"{red['bytes'] / 1e6:.1f} MB), with the copy in and the division "
        f"{red['reducer_ms']:.3f} ms; ranks' process {wall:.1f} s (the "
        "runs' own seconds: " + ", ".join(
            f"{t} {r['seconds']:.1f}" for t, r in res["runs"].items())
        + f"); {card}")
    say(f"[fsdp] the same with training.fsdp=true at world size 1: "
        f"checkpoint bit-equal to [ddp]'s; {fs['sharded_leaves']} leaves "
        f"sharded, {fs['state_bytes'] / 1e9:.4f} GB of state a rank (the "
        f"JAX package's per_device_bytes rule: "
        f"{fs['rule_bytes'] / 1e9:.4f} GB); ms/step {ms['fsdp']:.2f}; "
        f"{card}")
    say(f"[ddp] kernel launches: ddp {res['runs']['ddp']['launches']}, "
        f"fsdp {fs['launches']}")
    return res["runs"]["ddp"]["launches"], fs["launches"], {
        "ms_step": ms["ddp"], "ms_step_plain": ms["plain"],
        "ms_step_fsdp": ms["fsdp"], **red}


def _tree_gate(path_a, path_b, what: str) -> float:
    _, err, where = compare_states(path_a, path_b)
    check(err <= 1e-4, f"{what}: states {err:.3e} of scale apart at "
          f"{where} (tol 1e-4)")
    return err


def phase_ddp2(card, work):
    """[ddp2] and [fsdp2]: two ranks on the one card against one process
    (see the module's docstring), a phase of :func:`phase_ranks`; returns
    the launch counts of both paths, summed over the ranks."""
    from psld_tpu_torch.cli import train_sde as train_cli
    from psld_tpu_torch.parallel import fsdp
    from psld_tpu_torch.train.loop import build_score_model

    steps = 512 // TRAIN_BATCH
    dirs = {t: os.path.join(work, t) for t in ("ddp2", "fsdp2")}
    yield "flagship", [
        {"tag": "ddp2", "kind": "train",
         "argv": _train_argv(BATCH, 1, dirs["ddp2"], bf16=False,
                             hflip=False)},
        {"tag": "fsdp2", "kind": "train",
         "argv": _train_argv(BATCH, 1, dirs["fsdp2"], bf16=False, fsdp=True,
                             hflip=False)}]
    ref_dir = os.path.join(work, "ddp2_ref")
    t0 = time.perf_counter()
    train_cli.main(_train_argv(TRAIN_BATCH, 1, ref_dir, bf16=False,
                               hflip=False))
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    res, wall = yield
    want = FLAGSHIP.step_counts(steps)
    n = {}
    for tag in dirs:
        for r in res:
            rec = r["runs"][tag]
            check(rec["world"] == 2 and rec["step"] == steps,
                  f"[{tag}] rank {r['rank']}: world {rec['world']}, "
                  f"{rec['step']} steps")
            check(rec["launches"] == want, f"[{tag}] rank {r['rank']} "
                  f"launched {rec['launches']}, expected {want} (one "
                  f"process's at batch {BATCH})")
        check(res[0]["runs"][tag]["loss"] == res[1]["runs"][tag]["loss"],
              f"[{tag}] the ranks logged different losses")
        n[tag] = {k: sum(r["runs"][tag]["launches"][k] for r in res)
                  for k in want}
    ref = _ckpt_of(ref_dir)
    err_ddp = _tree_gate(_ckpt_of(dirs["ddp2"]), ref,
                         "[ddp2] two ranks vs one process")
    err_fsdp = _tree_gate(_ckpt_of(dirs["fsdp2"]), _ckpt_of(dirs["ddp2"]),
                          "[fsdp2] FSDP vs data parallel")
    err_fsdp_ref = _tree_gate(_ckpt_of(dirs["fsdp2"]), ref,
                              "[fsdp2] FSDP vs one process")
    with torch.device("meta"):
        net = build_score_model(bootstrap_cfg(FLAGSHIP.args))
    rule = fsdp.Layout(dict(net.named_parameters()), rank=0,
                       world=2).bytes_per_rank()
    rec = [r["runs"]["fsdp2"] for r in res]
    check(all(r["state_bytes"] == rule == r["rule_bytes"] for r in rec),
          f"[fsdp2] bytes a rank {[r['state_bytes'] for r in rec]}, JAX's "
          f"rule {rule}")
    ms = {tag: float(np.mean(res[0]["runs"][tag]["ms"][1:])) for tag in dirs}
    say(f"[ddp2] gloo collectives on CUDA tensors: {res[0]['gloo']}")
    time_save_mask(card)
    say(f"[ddp2] two ranks of cli.train_sde on the one card (gloo), the "
        f"flagship in float32 at {BATCH} a rank, hash dropout 0.15 (kernel "
        f"at elem_off = rank * {BATCH} * H*W*C), {steps} steps: params, "
        f"EMA and Adam moments {err_ddp:.3e} of scale from one process at "
        f"batch {TRAIN_BATCH} (tol 1e-4); ranks' losses equal; "
        f"{ms['ddp2']:.1f} ms/step on rank 0 (two ranks share the card and "
        f"gloo stages through the host: not a speed); ranks' group "
        f"{wall:.1f} s, reference {ref_s:.1f} s; {card}")
    replicated = 4 * 4 * sum(math.prod(v.shape) for v in net.parameters())
    say(f"[fsdp2] the same under training.fsdp=true: {err_fsdp:.3e} of "
        f"scale from [ddp2], {err_fsdp_ref:.3e} from one process; "
        f"{rec[0]['sharded_leaves']} leaves sharded, "
        f"{rec[0]['state_bytes'] / 1e9:.4f} GB of state a rank = the JAX "
        f"package's per_device_bytes rule {rule / 1e9:.4f} GB (replicated: "
        f"{replicated / 1e9:.4f} GB); {ms['fsdp2']:.1f} ms/step on rank 0; "
        f"{card}")
    say(f"[ddp2] kernel launches over both ranks: ddp2 {n['ddp2']}, fsdp2 "
        f"{n['fsdp2']}")
    return n["ddp2"], n["fsdp2"]


def time_save_mask(card):
    """The ``save_mask`` dropout of a rank of two: the mask of the global
    batch (128) drawn from the card's generator and its rows kept, as
    ``DropoutSites`` does, against a mask drawn at the rank's 64 rows
    alone, over the flagship's dropout sites of one forward; returns
    the two times."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(rows):
        def fn():
            for hw, c, n in DROPOUT_CALLS:
                s = int(round(hw ** 0.5))
                for _ in range(n):
                    torch.rand((rows, c, s, s), generator=gen,
                               device="cuda")[:BATCH]
        return fn

    glob_ms = cuda_ms(draw(TRAIN_BATCH), iters=5, warmup=1)
    local_ms = cuda_ms(draw(BATCH), iters=5, warmup=1)
    say(f"[ddp2] save_mask dropout of a rank of two (one forward's "
        f"{sum(n for _, _, n in DROPOUT_CALLS)} sites): the global batch's "
        f"mask drawn and sliced {glob_ms:.3f} ms against {local_ms:.3f} ms "
        f"for the rank's rows alone; {card}")
    return glob_ms, local_ms


def bootstrap_cfg(args):
    from psld_tpu_torch.cli._common import bootstrap

    return bootstrap(args).dataset.diffusion


LOCKSTEP_NFE = 20


def phase_lockstep(card, work, ckpt):
    """[lockstep]: two ranks of cli.sample on the one card against one
    process (see the module's docstring), a phase of :func:`phase_ranks`;
    returns the launch counts summed over the ranks."""
    from PIL import Image

    from psld_tpu_torch.cli import sample as sample_cli
    from psld_tpu_torch.eval.writers import SimpleImageWriter

    n_samples = 2 * BATCH
    base = FLAGSHIP.args + [
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.n_samples={n_samples}",
        f"dataset.diffusion.evaluation.n_discrete_steps={LOCKSTEP_NFE}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.sampler.corrector=langevin",
        "+dataset.diffusion.evaluation.device=cuda"]
    out_dir, rows_dir = (os.path.join(work, t)
                         for t in ("lockstep", "lockstep_rows"))
    yield "flagship", [{
        "tag": "lockstep", "kind": "sample", "rows_dir": rows_dir,
        "argv": base + [f"dataset.diffusion.evaluation.batch_size={BATCH}",
                        f"dataset.diffusion.evaluation.save_path={out_dir}"]
    }]
    real, ref = SimpleImageWriter.write_batch, {}

    def recording(self, samples, rank, batch_idx):
        ref[batch_idx] = np.asarray(samples)
        return real(self, samples, rank, batch_idx)

    SimpleImageWriter.write_batch = recording
    try:
        sample_cli.main(base + [
            f"dataset.diffusion.evaluation.batch_size={n_samples}",
            f"dataset.diffusion.evaluation.save_path={work}/lockstep_one"])
    finally:
        SimpleImageWriter.write_batch = real
    torch.cuda.empty_cache()
    res, wall = yield
    fwd = 2 * LOCKSTEP_NFE - 1
    want = FLAGSHIP.fwd_counts(fwd)
    worst = 0.0
    for r in res:
        rec = r["runs"]["lockstep"]
        check([b[:3] for b in rec["batches"]] == [[BATCH, LOCKSTEP_NFE, 0]],
              f"[lockstep] rank {r['rank']} drew {rec['batches']}")
        check(rec["launches"] == want, f"[lockstep] rank {r['rank']} "
              f"launched {rec['launches']}, expected {want}")
        got = np.load(os.path.join(rows_dir, f"rows_{r['rank']}_0.npy"))
        w = ref[0][r["rank"] * BATCH:(r["rank"] + 1) * BATCH]
        scale = float(np.abs(w).max())
        err = float(np.abs(got - w).max()) / scale
        check(err <= 1e-4, f"[lockstep] rank {r['rank']}'s rows "
              f"{err:.3e} of scale from one process's (tol 1e-4)")
        worst = max(worst, err)
    pngs = _pngs(os.path.join(out_dir, "images"))
    names = sorted(f"output_tpu_{r}_0_{i}.png" for r in range(2)
                   for i in range(BATCH))
    check(pngs == names, f"[lockstep] wrote {len(pngs)} PNGs: {pngs[:4]}")
    digests = {Image.open(os.path.join(out_dir, "images", p)).tobytes()
               for p in pngs}
    check(len(digests) == n_samples, f"[lockstep] {len(digests)} distinct "
          f"images of {n_samples}")
    n = {k: sum(r["runs"]["lockstep"]["launches"][k] for r in res)
         for k in want}
    secs = [r["runs"]["lockstep"]["batches"][0][3] for r in res]
    say(f"[lockstep] two ranks of cli.sample on the one card (gloo), the "
        f"flagship in float32, {BATCH} rows a rank of a global batch of "
        f"{n_samples}, {LOCKSTEP_NFE} NFE of EM with the Langevin corrector "
        f"({fwd} forwards): {len(pngs)} distinct PNGs tagged with the rank; "
        f"rows {worst:.3e} of scale from one process at batch {n_samples} "
        f"(tol 1e-4); trajectories {secs[0]:.2f} s and {secs[1]:.2f} s (two "
        f"ranks share the card); ranks' group {wall:.1f} s; {card}")
    say(f"[lockstep] kernel launches over both ranks: {n}")
    return n


def phase_spatial_kernels(card, batch=HQ_BATCH, calls=HQ_SPLIT_GN_CALLS,
                          tag="spatial_kernels"):
    """[spatial_kernels]: the split GroupNorm entries (stats, apply,
    partials, dx) at CelebA-HQ 256's shapes at ``batch`` on a shard's
    half of the rows, each against its plain version in f32 and in bf16
    under gn_bf16 (the config's), two shards' sums against the fused
    kernels on the whole map, forward and backward; the fused kernels at
    the attention blocks' gathered map, as [gn] and [gn_bwd] hold them;
    the strided dropout at AFHQv2 128's shapes at half height against the
    whole tensor's dropout sliced and its plain version, bit for bit.
    Times by CUDA graph replay beside the bound, the plain version and
    the library's call: (stats) ``torch.var_mean`` of the shard's grouped
    view, (apply) ``F.group_norm`` + ``F.silu`` on the shard. Returns each
    entry's numbers summed over one forward's (stats, apply) or
    backward's (partials, dx) calls, the fused kernels' over the
    attention blocks' GroupNorms of one forward and backward, and the
    strided dropout's over an AFHQ step. Under gn_bf16 the apply is also
    held bit-equal to its plain version on at least ``GN_BF16_EQUAL`` of
    the elements, as [gn] holds the fused forward."""
    import torch.nn.functional as F

    from psld_tpu_torch import ops
    from psld_tpu_torch.ops import group_norm as gn

    rng = np.random.default_rng(7)
    names = ("stats", "apply", "partials", "dx")
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
           for k in names}
    out["apply"]["bit_equal_share"] = 1.0
    totals = {k: {} for k in names}
    lib = lib_stats = 0.0
    rows = []
    one_launch = []
    f32_err = {"partials": 0.0, "dx": 0.0}
    t0 = time.perf_counter()
    for hw, c, n_calls in calls:
        s = int(round(hw ** 0.5))
        rows_held = s // SPATIAL
        g = min(c // 4, 32)
        count = float(s * s * (c // g))
        x32 = torch.from_numpy((rng.standard_normal((batch, s, s, c)) * 2.0
                                + 0.5).astype(np.float32)).cuda()
        g32 = torch.from_numpy(rng.standard_normal((batch, s, s, c)).astype(
            np.float32)).cuda()
        sc = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        bi = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        for dt, gn16, tol in ((torch.float32, False, 1e-5),
                              (torch.bfloat16, True, 1e-2)):
            set_gn_bf16(gn16)
            xw, gw = x32.to(dt), g32.to(dt)
            halves = [(xw[:, i * rows_held:(i + 1) * rows_held].contiguous(),
                       gw[:, i * rows_held:(i + 1) * rows_held].contiguous())
                      for i in range(SPATIAL)]
            what = f"split gn {hw}x{c} {dt} gn_bf16={gn16}"
            sums = sum(gn.group_norm_split_stats(h, g) for h, _ in halves)
            p_sums = sum(gn.group_norm_split_stats_plain(h, g)
                         for h, _ in halves)
            scale_s = float(p_sums.abs().max())
            err = max_err(sums, p_sums)
            check(err <= 1e-5 * scale_s, f"{what}: stats {err:.3e} of "
                  f"{scale_s:.3e}")
            out["stats"]["max_abs_err"] = max(out["stats"]["max_abs_err"],
                                              err / scale_s)
            ys, ps, dss, dbs = [], [], [], []
            for h, gh in halves:
                y = gn.group_norm_split_apply(h, sc, bi, sums, count, g,
                                              1e-6, "swish")
                want = gn.group_norm_split_apply_plain(h, sc, bi, sums, count,
                                                       g, 1e-6, "swish")
                torch.cuda.synchronize()
                e = assert_close(y, want, tol, tol, what + ": apply")
                if gn16:
                    out["apply"]["max_abs_err"] = max(
                        out["apply"]["max_abs_err"], e)
                    share = float((y == want).float().mean())
                    check(share >= GN_BF16_EQUAL, f"{what}: apply "
                          f"{share:.5f} of the elements bit-equal, under "
                          f"{GN_BF16_EQUAL}")
                    out["apply"]["bit_equal_share"] = min(
                        out["apply"]["bit_equal_share"], share)
                p, ds, db = gn.group_norm_split_partials(
                    h, gh, sc, bi, sums, count, g, 1e-6, "swish")
                wp, wds, wdb = gn.group_norm_split_partials_plain(
                    h, gh, sc, bi, sums, count, g, 1e-6, "swish")
                for a, b, nm in ((p, wp, "P"), (ds, wds, "dscale"),
                                 (db, wdb, "dbias")):
                    ref = max(float(b.abs().max()), 1e-30)
                    e = max_err(a, b) / ref
                    check(e <= (1e-5 if dt == torch.float32 else 1e-3),
                          f"{what}: partials {nm} {e:.3e} of scale")
                    if gn16:
                        out["partials"]["max_abs_err"] = max(
                            out["partials"]["max_abs_err"], e)
                    else:
                        f32_err["partials"] = max(f32_err["partials"], e)
                ys.append(y)
                ps.append(p)
                dss.append(ds)
                dbs.append(db)
            p_all = sum(ps)
            dxs = []
            for h, gh in halves:
                dx = gn.group_norm_split_dx(h, gh, sc, bi, sums, p_all, count,
                                            g, 1e-6, "swish")
                want = gn.group_norm_split_dx_plain(h, gh, sc, bi, sums,
                                                    p_all, count, g, 1e-6,
                                                    "swish")
                ref = float(want.float().abs().max())
                e = max_err(dx, want) / ref
                check(e <= tol, f"{what}: dx {e:.3e} of scale")
                if gn16:
                    out["dx"]["max_abs_err"] = max(out["dx"]["max_abs_err"],
                                                   e)
                else:
                    f32_err["dx"] = max(f32_err["dx"], e)
                dxs.append(dx)
            # two shards combined against the fused kernels on the whole map
            y_whole = ops.group_norm_act(xw, sc, bi, g, 1e-6, "swish")
            dx_w, ds_w, db_w = ops.group_norm_act_backward(
                xw, sc, bi, gw, g, 1e-6, "swish")
            torch.cuda.synchronize()
            for a, b, nm in ((torch.cat(ys, 1), y_whole, "y"),
                             (torch.cat(dxs, 1), dx_w, "dx"),
                             (sum(dss), ds_w, "dscale"),
                             (sum(dbs), db_w, "dbias")):
                ref = float(b.float().abs().max())
                e = max_err(a, b) / ref
                check(e <= (2e-5 if dt == torch.float32 else 2e-2),
                      f"{what}: two shards' {nm} {e:.3e} of scale from the "
                      "fused kernel's on the whole map")
        # time the path's case: bf16 under gn_bf16, swish, a rank's shard
        set_gn_bf16(True)
        x, gg = (t[:, :rows_held].contiguous().bfloat16()
                 for t in (x32, g32))
        sums = gn.group_norm_split_stats(x, g)
        p = gn.group_norm_split_partials(x, gg, sc, bi, sums, count, g,
                                         1e-6, "swish")[0]
        fns = {
            "stats": (lambda: gn.group_norm_split_stats(x, g),
                      lambda: gn.group_norm_split_stats_plain(x, g)),
            "apply": (lambda: gn.group_norm_split_apply(
                x, sc, bi, sums, count, g, 1e-6, "swish"),
                lambda: gn.group_norm_split_apply_plain(
                    x, sc, bi, sums, count, g, 1e-6, "swish")),
            "partials": (lambda: gn.group_norm_split_partials(
                x, gg, sc, bi, sums, count, g, 1e-6, "swish"),
                lambda: gn.group_norm_split_partials_plain(
                    x, gg, sc, bi, sums, count, g, 1e-6, "swish")),
            "dx": (lambda: gn.group_norm_split_dx(
                x, gg, sc, bi, sums, p, count, g, 1e-6, "swish"),
                lambda: gn.group_norm_split_dx_plain(
                    x, gg, sc, bi, sums, p, count, g, 1e-6, "swish"))}
        e = x.element_size()
        n = x.numel()
        # bytes each entry must move, and its f32 operations a value
        need = {"stats": (n * e, 3 * n), "apply": (2 * n * e, 12 * n),
                "partials": (2 * n * e, 30 * n),
                "dx": (3 * n * e, 30 * n)}
        row = [hw, c, n_calls, rows_held]
        for k, (kern, plain) in fns.items():
            k_ms = device_ms(kern)
            p_ms = device_ms(plain, launches=3)
            out[k]["ms"] += n_calls * k_ms
            out[k]["plain_ms"] += n_calls * p_ms
            add_bound(totals[k], n_calls, *need[k], SCALAR_OPS)
            row += [k_ms, bound(need[k][0], need[k][1], SCALAR_OPS)[0]]
        xn = x.permute(0, 3, 1, 2)
        l_ms = device_ms(lambda: F.silu(F.group_norm(xn, g, sc.bfloat16(),
                                                     bi.bfloat16(), 1e-6)))
        lib += n_calls * l_ms
        # the stats' library call: torch.var_mean over a group's pixels
        # and channels of the shard's grouped view
        xg = x.view(batch, rows_held * s, g, c // g)
        ls_ms = device_ms(lambda: torch.var_mean(xg, dim=(1, 3)))
        lib_stats += n_calls * ls_ms
        rows.append(row + [ls_ms, l_ms])
        if (hw, c) in (calls[0][:2], calls[-1][:2]):
            one_launch.append((batch, rows_held, s, c, g))
    os.environ.pop("PSLD_GN_BF16")
    for k in names:
        out[k].update(totals[k])
        out[k]["bound_by"] = bound_by(out[k])
        out[k]["library_ms"] = None
    out["apply"]["library_ms"] = lib
    out["stats"]["library_ms"] = lib_stats
    say(f"[{tag}] split GroupNorm entries == plain at all {len(calls)} "
        f"CelebA-HQ 256 split shapes (a shard of {SPATIAL}), B={batch} "
        f"(f32 1e-5, "
        f"bf16+gn_bf16 1e-2; stats 1e-5, partials 1e-5 (f32) and 1e-3 "
        f"(bf16) of scale), "
        f"and {SPATIAL} shards' sums == the fused kernels on the whole map "
        f"(f32 2e-5, bf16 2e-2 of scale), forward and backward, in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[{tag}] device times (CUDA-graph replay), bf16 gn_bf16 swish, "
        f"one shard of {SPATIAL}, B={batch}, {card}: kernel / bound ms")
    for hw, c, n_calls, held, *ts, ls_ms, l_ms in rows:
        say(f"[{tag}]   HW={hw:5d} rows {held:3d} C={c:3d} x{n_calls:2d}: "
            + ", ".join(f"{k} {ts[2 * i]:.4f}/{ts[2 * i + 1]:.4f}"
                        for i, k in enumerate(names))
            + f"; torch.var_mean {ls_ms:.4f}; F.group_norm+F.silu "
            f"{l_ms:.4f}")
    # the stats, the apply and the partials are one kernel a call, the
    # chunks' (and the batch elements') partials folded in the launch: a
    # call at the largest shard and one at the smallest
    entries = ["stats", "apply", "partials"]
    ran = split_kernels(entries, one_launch)
    want = [e for e in entries for _ in one_launch]
    check(len(ran) == len(want)
          and all(f"gn_split_{e}" in k for e, k in zip(want, ran)),
          f"split stats, apply and partials: the kernels of one call at "
          f"each of {one_launch} (B, rows, W, C, G): {ran}")
    st, ap = out["stats"], out["apply"]
    say(f"[{tag}]   stats, apply and partials: one kernel a call "
        "(torch.profiler, shards "
        + ", ".join(f"{h * w}x{c}" for _, h, w, c, _ in one_launch)
        + "); stats " f"{st['bound_ms'] / st['ms']:.3f} of its "
        f"bound, {st['library_ms'] / st['ms']:.2f}x faster than "
        f"torch.var_mean; apply {ap['bound_ms'] / ap['ms']:.3f} of its "
        f"bound, {ap['library_ms'] / ap['ms']:.2f}x faster than "
        f"F.group_norm+F.silu, bf16+gn_bf16 bit-equal share at least "
        f"{ap['bit_equal_share']:.5f}; partials "
        f"{out['partials']['bound_ms'] / out['partials']['ms']:.3f}, dx "
        f"{out['dx']['bound_ms'] / out['dx']['ms']:.3f} of their bounds; "
        "worst f32 error of scale: partials "
        f"{f32_err['partials']:.3e}, dx {f32_err['dx']:.3e}")
    for k in names:
        say(f"[{tag}]   {k} per CelebA-HQ {'forward' if k in ('stats', 'apply') else 'backward'} "
            f"({sum(n for _, _, n in calls)} calls): kernel "
            f"{out[k]['ms']:.3f} ms, bound {out[k]['bound_ms']:.3f} ms "
            f"({out[k]['bound_by']}), plain {out[k]['plain_ms']:.3f} ms, "
            + ("no library call" if out[k]["library_ms"] is None
               else f"library {out[k]['library_ms']:.3f} ms"))
    # the attention blocks' GroupNorms: the fused kernels on the
    # gathered map, which every rank of the group holds whole
    where = "CelebA-HQ 256 attention blocks' gathered map"
    out["attn_gn"] = phase_gn(card, batch, calls=HQ_ATTN_CALLS, net=where,
                              tag=tag)
    out["attn_gn_bwd"] = phase_gn_bwd(card, batch, calls=HQ_ATTN_CALLS,
                                      net=where, tag=tag)
    out["dropout"] = _strided_dropout(card, tag)
    return out


def phase_routes(card, tag="routes"):
    """[routes]: shapes the kernels refuse run the plain versions in the
    model layers, chosen by shape before any launch, as the JAX package's
    dispatchers fall back: an ``AttnBlock`` at N = 1,024 tokens (32 x 32,
    C = 256; the attention kernel takes N <= 256) launches its GroupNorm's
    kernels once each way and no attention kernel, a ``GroupNormAct``
    (swish) at C = 2,048 (past the GroupNorm kernels' 1,024) launches
    nothing. Forward and gradients into x and every parameter, f32, within
    1e-4 of the scale of the CPU's (the plain chain; a gradient's scale
    floored at 1e-3 of the largest gradient's), B=2."""
    from psld_tpu_torch import ops
    from psld_tpu_torch.models.layers import AttnBlock, GroupNormAct

    def launches():
        return [ops.group_norm_act.launches,
                ops.group_norm_act_backward.launches, ops.attention.launches,
                ops.group_norm_split_stats.launches,
                ops.group_norm_split_partials.launches]

    t0 = time.perf_counter()
    torch.manual_seed(11)
    rng = np.random.default_rng(11)
    gna = GroupNormAct(2048, "swish")
    with torch.no_grad():
        gna.scale.normal_(1.0, 0.1)
        gna.bias.normal_(0.0, 0.1)
    cases = [("AttnBlock N=1024 C=256", AttnBlock(256, init_scale=0.1),
              (2, 256, 32, 32), [1, 1, 0, 0, 0]),
             ("GroupNormAct C=2048", gna, (2, 2048, 8, 8), [0] * 5)]
    worst = 0.0
    for name, mod, shape, want in cases:
        x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(
            np.float32))
        ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        res = []
        for dev in ("cpu", "cuda"):
            m = mod.to(dev)
            xi = x.to(dev).requires_grad_()
            n = launches()
            y = m(xi)
            grads = torch.autograd.grad(y, [xi, *m.parameters()], ct.to(dev))
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(launches(), n)]
            res.append([t.detach().cpu() for t in (y, *grads)])
        check(ran == want, f"[{tag}] {name}: launches (gn, gn_bwd, "
              f"attention, split stats, split partials) {ran}, want {want}")
        # a gradient's scale floored at 1e-3 of the largest gradient's: the
        # keys' bias has a gradient of 0 up to rounding
        top = max(float(r.abs().max()) for r in res[0][1:])
        for i, (got, ref) in enumerate(zip(res[1], res[0])):
            e = max_err(got, ref) / max(float(ref.abs().max()),
                                        1e-3 * top if i else 1e-30)
            check(e <= 1e-4, f"[{tag}] {name}: {e:.3e} of scale from the "
                  "plain chain on the CPU")
            worst = max(worst, e)
        say(f"[{tag}] {name}: launches (gn, gn_bwd, attention, split stats, "
            f"split partials) {ran}")
    say(f"[{tag}] refused shapes run the plain versions in the layers: "
        f"forward and gradients within {worst:.3e} of scale of the CPU's "
        f"(gate 1e-4, f32), in {time.perf_counter() - t0:.1f} s; {card}")


def _strided_dropout(card, tag, batch=AFHQ_BATCH, calls=AFHQ_DROPOUT_CALLS,
                     rate=AFHQ_RATE):
    """The dropout of a rank's height slice at AFHQv2 128's dropout
    shapes (``image = (L, Gi)``), bit for bit against the whole tensor's
    dropout sliced and against the plain version; its device time per
    training step beside the unstrided launch on the same elements."""
    import torch.nn.functional as F

    from psld_tpu_torch.ops import hash_dropout, hash_dropout_plain

    rng = np.random.default_rng(8)
    seed = (2024, 4000000001)
    res = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flat_ms": 0.0,
           "max_abs_err": 0.0}
    total = {}
    n_cases = 0
    for hw, c, n_calls in calls:
        s = int(round(hw ** 0.5))
        h = s // SPATIAL
        x32 = torch.from_numpy(rng.standard_normal((batch, s, s, c)).astype(
            np.float32)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            whole = x32.to(dt).permute(0, 3, 1, 2)
            ref = hash_dropout(whole, seed, rate)
            for d, i in ((0, 0), (0, 1), (1, 1)):
                rows = slice(d * batch // 2, (d + 1) * batch // 2)
                part = whole[rows, :, i * h:(i + 1) * h].contiguous(
                    memory_format=torch.channels_last)
                local = part[0].numel()
                off = rows.start * whole[0].numel() + i * local
                image = (local, whole[0].numel())
                got = hash_dropout(part, seed, rate, elem_off=off,
                                   image=image)
                want = hash_dropout_plain(part, seed, rate, elem_off=off,
                                          image=image)
                torch.cuda.synchronize()
                what = f"strided dropout {hw}x{c} {dt} rows {d} slice {i}"
                check(torch.equal(got, want), f"{what}: kernel != plain")
                check(torch.equal(got, ref[rows, :, i * h:(i + 1) * h]),
                      f"{what}: != the whole tensor's dropout, sliced")
                n_cases += 1
        part = x32[:, :h].contiguous().bfloat16().permute(0, 3, 1, 2)
        local = part[0].numel()
        image = (local, SPATIAL * local)
        k_ms = device_ms(lambda: hash_dropout(part, seed, rate, elem_off=local,
                                              image=image))
        f_ms = device_ms(lambda: hash_dropout(part, seed, rate))
        p_ms = device_ms(lambda: hash_dropout_plain(
            part, seed, rate, elem_off=local, image=image), launches=3)
        l_ms = device_ms(lambda: F.dropout(part, rate, training=True))
        for k, v in (("ms", k_ms), ("flat_ms", f_ms), ("plain_ms", p_ms),
                     ("library_ms", l_ms)):
            res[k] += 2 * n_calls * v
        add_bound(total, 2 * n_calls, 2 * part.numel() * part.element_size(),
                  40 * part.numel(), SCALAR_OPS)
    res.update(total)
    res["bound_by"] = bound_by(res)
    say(f"[{tag}] strided hash dropout (image = (L, Gi)) == plain and == the "
        f"whole tensor's dropout sliced, bit for bit, in {n_cases} cases "
        f"(AFHQv2 128 dropout shapes at half height, B={batch}, f32 and "
        f"bf16, two data rows and both slices); per AFHQ step of a rank "
        f"(bf16, rate {rate}): strided {res['ms']:.3f} ms, unstrided on "
        f"the same elements {res['flat_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
        f"F.dropout {res['library_ms']:.3f} ms: "
        f"{res['ms'] / res['flat_ms']:.3f}x the unstrided, "
        f"{res['ms'] / res['library_ms']:.3f}x F.dropout, "
        f"{res['bound_ms'] / res['ms']:.3f} of the bound; {card}")
    return res


def _hq_spatial_argv(root, results, bf16, spatial=1):
    """``cli.train_sde`` of CelebA-HQ 256 on its folder, at its batch 8,
    without flips, one epoch (the runs stop at ``SPATIAL_STEPS``)."""
    return _folder_train_args(HQ, root, results, HQ_BATCH, 1, 1) + [
        f"+dataset.diffusion.training.bf16={bf16}",
        "dataset.diffusion.data.hflip=false",
        "+dataset.diffusion.training.prefetch=0"] + (
        [f"+dataset.diffusion.training.spatial={spatial}"]
        if spatial > 1 else [])


def hq_split_counts(forwards: int, backwards: int = 0) -> dict:
    """The launches of CelebA-HQ 256 under spatial parallelism: every
    GroupNorm through the split entries but the attention blocks' (one a
    block), which run fused on the gathered map, and attention."""
    split = HQ.gn - HQ.attn
    return expected(group_norm_split_stats=split * forwards,
                    group_norm_split_apply=split * forwards,
                    group_norm_split_partials=split * backwards,
                    group_norm_split_dx=split * backwards,
                    group_norm_act=HQ.attn * forwards,
                    group_norm_act_bwd=HQ.attn * backwards,
                    attention=HQ.attn * forwards)


def phase_spatial2(card, work, root):
    """[spatial2]: ``cli.train_sde`` of CelebA-HQ 256 at full width with
    ``training.spatial=2`` in two ranks on the one card over gloo (see
    [ddp2]): one data group, each rank holding half the height of the 8
    images of a step. Float32, ``SPATIAL_STEPS`` steps: the state within
    1e-5 of each tree's scale of one process's, each tree in the units
    of the parameters or their gradients (Adam's ``nu``, squared
    gradients, through its square root), and the same two ranks with a
    planted fault (``SPATIAL_FAULTS``) outside that tolerance; bf16:
    each rank's launch counts and peak memory beside one process's.
    A phase of :func:`phase_ranks`. Returns the launches of both sound
    runs, summed over the ranks, and the peaks and errors."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.train.loop import train_sde

    dirs = {bf16: os.path.join(work, f"spatial2_{int(bf16)}")
            for bf16 in (False, True)}
    runs = [{"tag": f"bf16={bf16}", "kind": "train",
             "max_steps": SPATIAL_STEPS,
             "argv": _hq_spatial_argv(root, dirs[bf16], bf16, SPATIAL)}
            for bf16 in (False, True)]
    for fault in SPATIAL_FAULTS:
        dirs[fault] = os.path.join(work, f"spatial2_fault_{fault}")
        runs.append({"tag": f"fault={fault}", "kind": "train",
                     "max_steps": SPATIAL_STEPS, "fault": fault,
                     "argv": _hq_spatial_argv(root, dirs[fault], False,
                                              SPATIAL)})
    yield "spatial2", runs
    ref = {}
    for bf16 in (False, True):
        results = os.path.join(work, f"spatial2_ref_{int(bf16)}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, _ = train_sde(bootstrap(_hq_spatial_argv(
            root, results, bf16)).dataset.diffusion, SPATIAL_STEPS)
        torch.cuda.synchronize()
        check(state.step == SPATIAL_STEPS, f"[spatial2] one process took "
              f"{state.step} steps")
        ref[bf16] = {"peak": torch.cuda.max_memory_allocated(),
                     "launches": all_counts(), "results": results,
                     "s": time.perf_counter() - t0}
        del state
    torch.cuda.empty_cache()
    res, wall = yield
    want = hq_split_counts(SPATIAL_STEPS, SPATIAL_STEPS)
    check(ref[True]["launches"] == HQ.step_counts(SPATIAL_STEPS),
          f"[spatial2] one process launched {ref[True]['launches']}")
    n = {}
    for run in runs[:2]:
        tag = run["tag"]
        for r in res:
            rec = r["runs"][tag]
            check(rec["world"] == SPATIAL and rec["step"] == SPATIAL_STEPS,
                  f"[spatial2] {tag} rank {r['rank']}: world {rec['world']},"
                  f" {rec['step']} steps")
            check(rec["launches"] == want, f"[spatial2] {tag} rank "
                  f"{r['rank']} launched {rec['launches']}, expected {want}")
            check(all(np.isfinite(rec["loss"])), f"[spatial2] {tag}: loss "
                  f"{rec['loss']}")
        check(res[0]["runs"][tag]["loss"] == res[1]["runs"][tag]["loss"],
              f"[spatial2] {tag}: the ranks logged different losses")
        n[tag] = {k: sum(r["runs"][tag]["launches"][k] for r in res)
                  for k in want}
    b, _ = _trees(_ckpt_of(ref[False]["results"]))

    def tree_errs(results):
        """Each tree's worst error over its scale against one process's,
        in the units of the parameters or their gradients: Adam's nu
        holds squared gradients, so it is compared through its root."""
        a, _ = _trees(_ckpt_of(results))
        per_tree, at = {}, {}
        for name in b:
            unit = torch.sqrt if name == "nu" else (lambda v: v)
            scale = max(float(unit(v).abs().max()) for v in b[name].values())
            errs = {k: max_err(unit(a[name][k]), unit(v)) / scale
                    for k, v in b[name].items()}
            at[name] = max(errs, key=errs.get)
            per_tree[name] = errs[at[name]]
        return per_tree, at

    per_tree, where = tree_errs(dirs[False])
    worst = max(per_tree, key=per_tree.get)
    err = per_tree[worst]
    faults = {f: max(tree_errs(dirs[f])[0].values()) for f in SPATIAL_FAULTS}
    say(f"[spatial2] float32, each tree's worst error over its scale "
        "(nu through its square root): " + ", ".join(
            f"{k} {v:.3e}" for k, v in per_tree.items())
        + "; planted faults, the worst tree: " + ", ".join(
            f"{f} {v:.3e}" for f, v in faults.items()))
    check(err <= 1e-5, f"[spatial2] two height shards vs one process: "
          f"{worst} {err:.3e} of scale apart at {where[worst]} (tol 1e-5)")
    for f, v in faults.items():
        check(v > 1e-5, f"[spatial2] the planted fault {f} is {v:.3e} of "
              "scale from one process's: the 1e-5 gate does not see it")
    peaks = [r["runs"]["bf16=True"]["peak_bytes"] / 1e9 for r in res]
    ms = float(np.mean(res[0]["runs"]["bf16=True"]["ms"][1:]))
    say(f"[spatial2] two ranks of cli.train_sde on the one card (gloo), "
        f"CelebA-HQ 256 at full width ({HQ_PARAMS:,} parameters), "
        f"training.spatial=2: one image's 256 rows split 128/128, batch "
        f"{HQ_BATCH}, {SPATIAL_STEPS} steps. float32: params, EMA and Adam "
        f"moments {err:.3e} of scale from one process's (tol 1e-5; the "
        f"worst at {worst} {where[worst]}), the "
        f"ranks' losses equal. bf16 (gn_bf16): peak "
        f"{peaks[0]:.3f} / {peaks[1]:.3f} GB a rank against "
        f"{ref[True]['peak'] / 1e9:.3f} GB in one process; "
        f"{ms:.1f} ms/step on rank 0 (two ranks share the card and every "
        f"halo and GroupNorm sum goes through gloo on the host: not a "
        f"speed); launches a rank {res[0]['runs']['bf16=True']['launches']}"
        f" (one process: {ref[True]['launches']}); ranks' group "
        f"{wall:.1f} s, references {ref[False]['s'] + ref[True]['s']:.1f} s;"
        f" {card}")
    return n["bf16=True"], n["bf16=False"], {
        "peak_gb_rank": peaks, "peak_gb_one": ref[True]["peak"] / 1e9,
        "f32_err_of_scale": err, "f32_err_by_tree": per_tree,
        "planted_fault_err_of_scale": faults}


def phase_spatial_sample(card, work, ckpt, root):
    """[spatial_sample]: ``cli.sample`` (``SPATIAL_NFE``-NFE EM) and
    ``cli.inpaint`` of the CelebA-HQ 256 checkpoint at batch 8 in
    float32, with ``evaluation.spatial=2`` in two ranks on the one card
    (gloo): the first rank writes each image once, and its rows are
    within 1e-5 of their scale of one process's. A phase of
    :func:`phase_ranks`. Returns the launches of both runs, summed over
    the ranks."""
    from psld_tpu_torch.cli import inpaint as inpaint_cli
    from psld_tpu_torch.cli import sample as sample_cli
    from psld_tpu_torch.eval import writers

    base = HQ.args + [
        f"dataset.diffusion.data.root={root}",
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.n_samples={HQ_BATCH}",
        f"dataset.diffusion.evaluation.batch_size={HQ_BATCH}",
        f"dataset.diffusion.evaluation.n_discrete_steps={SPATIAL_NFE}",
        "dataset.diffusion.evaluation.sample_from=source",
        "+dataset.diffusion.evaluation.device=cuda"]
    kinds = {"sample": (sample_cli.main, []),
             "inpaint": (inpaint_cli.main, [
                 "dataset.diffusion.evaluation.sampler.name=ip_em_sde"])}
    runs = [{"tag": kind, "kind": kind,
             "rows_dir": os.path.join(work, f"spatial_{kind}_rows"),
             "argv": base + extra + [
                 f"+dataset.diffusion.evaluation.spatial={SPATIAL}",
                 f"dataset.diffusion.evaluation.save_path={work}/"
                 f"spatial_{kind}"]}
            for kind, (_, extra) in kinds.items()]
    yield "spatial_sample", runs
    ref, one = {}, {}
    for kind, (main, extra) in kinds.items():
        rows, reals = {}, {}
        for cls in (writers.SimpleImageWriter, writers.InpaintingImageWriter):
            reals[cls] = cls.write_batch

            def recording(self, samples, rank, batch_idx, real=reals[cls],
                          **kw):
                rows[batch_idx] = np.asarray(samples)
                return real(self, samples, rank, batch_idx, **kw)

            cls.write_batch = recording
        reset_counts()
        try:
            main(base + extra + [f"dataset.diffusion.evaluation.save_path="
                                 f"{work}/spatial_{kind}_one"])
        finally:
            for cls, real in reals.items():
                cls.write_batch = real
        ref[kind], one[kind] = rows[0], all_counts()
        torch.cuda.empty_cache()
    res, wall = yield
    n, worst = {}, {}
    for run in runs:
        kind = run["tag"]
        forwards = one[kind]["attention"] // HQ.attn
        want = hq_split_counts(forwards)
        for r in res:
            rec = r["runs"][kind]
            check([b[:3] for b in rec["batches"]] == [[HQ_BATCH,
                                                        SPATIAL_NFE, 0]],
                  f"[spatial_sample] {kind} rank {r['rank']} drew "
                  f"{rec['batches']}")
            check(rec["launches"] == want, f"[spatial_sample] {kind} rank "
                  f"{r['rank']} launched {rec['launches']}, expected {want}")
        files = sorted(os.listdir(run["rows_dir"]))
        check(files == ["rows_0_0.npy"], f"[spatial_sample] {kind}: rows "
              f"written {files} (the first rank alone, once)")
        got = np.load(os.path.join(run["rows_dir"], files[0]))
        scale = float(np.abs(ref[kind]).max())
        worst[kind] = float(np.abs(got - ref[kind]).max()) / scale
        check(got.shape == ref[kind].shape and worst[kind] <= 1e-5,
              f"[spatial_sample] {kind}: rows {worst[kind]:.3e} of scale "
              f"from one process's (tol 1e-5)")
        n[kind] = {k: sum(r["runs"][kind]["launches"][k] for r in res)
                   for k in want}
    secs = {k: [r["runs"][k]["batches"][0][3] for r in res] for k in kinds}
    say(f"[spatial_sample] two ranks (gloo, the one card), "
        f"evaluation.spatial=2, CelebA-HQ 256 in float32 at batch "
        f"{HQ_BATCH}, {SPATIAL_NFE}-NFE EM: cli.sample rows "
        f"{worst['sample']:.3e} and cli.inpaint rows {worst['inpaint']:.3e}"
        f" of scale from one process's (tol 1e-5), written once by rank 0; "
        f"trajectories {secs['sample'][0]:.2f} s and "
        f"{secs['inpaint'][0]:.2f} s on rank 0 (not a speed); ranks' group "
        f"{wall:.1f} s; launches over both ranks {n}; {card}")
    return n["sample"], n["inpaint"]


def legacy_stack(normalization):
    """The eight residual blocks of NCSNv2's CIFAR-10 score network (its
    res1 to res4: 32 x 32 at ngf, then 16 x 16 at 2 ngf, dilated by 2
    and 4), ELU, each normalized by ``normalization``."""
    import torch.nn.functional as F

    from psld_tpu_torch.models.legacy_layers import ResidualBlock as R

    n = LEGACY_NGF
    kw = dict(act=F.elu, normalization=normalization)
    return torch.nn.Sequential(
        R(n, n, **kw), R(n, n, **kw),
        R(n, 2 * n, "down", **kw), R(2 * n, 2 * n, **kw),
        R(2 * n, 2 * n, "down", dilation=2, **kw),
        R(2 * n, 2 * n, dilation=2, **kw),
        R(2 * n, 2 * n, "down", dilation=4, **kw),
        R(2 * n, 2 * n, dilation=4, **kw))


def phase_legacy(card):
    """[legacy]: the NCSNv1/v2 component library at NCSNv2's CIFAR-10
    widths (see the module's docstring), a phase of :func:`phase_ranks`
    without ranks: its CPU side runs while the ranks do, its card side
    after. Returns the launch counts of the legacy path, the GroupNorm
    stack's bf16 step."""
    import copy

    import torch.nn.functional as F

    from psld_tpu_torch.models import legacy_layers as L
    from psld_tpu_torch.models import normalization as N
    from psld_tpu_torch.utils.legacy import get_sigmas

    n, k, b = LEGACY_NGF, LEGACY_CLASSES, LEGACY_BATCH
    sigmas = get_sigmas(sigma_min=LEGACY_SIGMA_MIN,
                        sigma_max=LEGACY_SIGMA_MAX, num_scales=k)
    check(sigmas.dtype == np.float32 and sigmas.shape == (k,)
          and math.isclose(sigmas[0], LEGACY_SIGMA_MAX, rel_tol=1e-6)
          and math.isclose(sigmas[-1], LEGACY_SIGMA_MIN, rel_tol=1e-6),
          f"[legacy] get_sigmas gave {sigmas.dtype} {sigmas.shape}, "
          f"{sigmas[0]} to {sigmas[-1]}")
    rng = np.random.default_rng(21)
    labels = rng.integers(0, k, b)
    # NCSNv2's input: x + sigma_y z, mapped to [-1, 1] and through its
    # first convolution (3 -> ngf)
    x0 = rng.random((b, 3, 32, 32), dtype=np.float32)
    xt = x0 + sigmas[labels][:, None, None, None] * rng.standard_normal(
        x0.shape).astype(np.float32)
    torch.manual_seed(21)
    with torch.no_grad():
        h = L.ncsn_conv3x3(3, n)(torch.from_numpy(2 * xt - 1)).contiguous(
            memory_format=torch.channels_last)
    h2 = torch.from_numpy(rng.standard_normal((b, 2 * n, 16, 16)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    y = torch.from_numpy(labels)
    # class -> (builder, inputs); "xs": the two scales a fusion takes,
    # fused at 32 x 32
    cases = {
        "InstanceNorm2d": (lambda: N.InstanceNorm2d(n), "h"),
        "VarianceNorm2d": (lambda: N.VarianceNorm2d(n), "h"),
        "NoneNorm2d": (lambda: N.NoneNorm2d(n), "h"),
        "InstanceNorm2dPlus": (lambda: N.InstanceNorm2dPlus(n), "h"),
        "GroupNorm": (lambda: N.GroupNorm(n), "h"),
        **{c: (lambda c=c: getattr(N, c)(n, k), "hy")
           for c in ("ConditionalBatchNorm2d", "ConditionalInstanceNorm2d",
                     "ConditionalVarianceNorm2d", "ConditionalNoneNorm2d",
                     "ConditionalInstanceNorm2dPlus")},
        "CRPBlock": (lambda: L.CRPBlock(n, 2, F.elu), "h"),
        "CondCRPBlock": (lambda: L.CondCRPBlock(n, 2, k, act=F.elu), "hy"),
        "RCUBlock": (lambda: L.RCUBlock(n, 2, 2, F.elu), "h"),
        "CondRCUBlock": (lambda: L.CondRCUBlock(n, 2, 2, k, act=F.elu),
                         "hy"),
        "MSFBlock": (lambda: L.MSFBlock([2 * n, n], n), "xs"),
        "CondMSFBlock": (lambda: L.CondMSFBlock([2 * n, n], n, k), "xsy"),
        # average pooling in its CRP: a max-pooling tie routed apart (see
        # ``kinked``) spreads through the RCUs before it reaches dx
        "RefineBlock": (lambda: L.RefineBlock([2 * n, n], n, F.elu,
                                              maxpool=False), "xs"),
        "CondRefineBlock": (lambda: L.CondRefineBlock(
            [2 * n, n], n, k, act=F.elu, end=True), "xsy"),
        "ConvMeanPool": (lambda: L.ConvMeanPool(n, 2 * n), "h"),
        "MeanPoolConv": (lambda: L.MeanPoolConv(n, 2 * n), "h"),
        "UpsampleConv": (lambda: L.UpsampleConv(2 * n, n), "h2"),
        "ResidualBlock": (lambda: L.ResidualBlock(
            n, 2 * n, "down", normalization=N.GroupNorm), "h"),
        "ResidualBlock(InstanceNorm++)": (lambda: L.ResidualBlock(
            n, n, normalization=N.InstanceNorm2dPlus), "h"),
        "ConditionalResidualBlock": (lambda: L.ConditionalResidualBlock(
            2 * n, 2 * n, k, dilation=2), "h2y"),
    }

    def call(mod, kind, dev):
        """The class on its inputs on ``dev``: (output, input leaves)."""
        leaves = [t.to(dev).detach().requires_grad_() for t in
                  {"h": [h], "hy": [h], "h2": [h2], "h2y": [h2],
                   "xs": [h2, h], "xsy": [h2, h]}[kind]]
        args = [leaves] if kind.startswith("xs") else list(leaves)
        if kind.endswith("y"):
            args.append(y.to(dev))
        if kind.startswith("xs"):
            args.append((32, 32))
        return mod(*args), leaves

    # max pooling's gradient goes to each window's largest input: where
    # two inputs of a window lie closer than the card and the CPU agree,
    # the two route it to different elements, each off by its whole
    # size, so there dx is held by the share of elements outside the
    # tolerance, at most 1e-3 of them (as the GroupNorm kinks are)
    kinked = ("CRPBlock",)
    # every module, its weights drawn from the seeded global generator
    # here: the CPU's side runs beside other work (``phase_ranks``)
    modules = {}
    for i, (name, (build, _)) in enumerate(cases.items()):
        torch.manual_seed(100 + i)
        modules[name] = build().requires_grad_(False)  # dx alone
    yield None, []
    # the CPU's side: each class's output and input gradient, on a
    # quarter of the cores (the ranks beside it stage through the host)
    t1 = time.perf_counter()
    cpu_side = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    for name, (_, kind) in cases.items():
        cpu = modules.pop(name)
        out, leaves = call(cpu, kind, "cpu")
        ct = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).contiguous(memory_format=torch.channels_last)
        cpu_side[name] = (cpu, ct, [out.detach()] + list(
            torch.autograd.grad(out, leaves, ct)))
        del out, leaves
    torch.set_num_threads(threads)
    cpu_s = time.perf_counter() - t1
    yield
    t0 = time.perf_counter()
    errs, off = {}, {}
    for name, (_, kind) in cases.items():
        cpu, ct, want = cpu_side.pop(name)
        gpu = copy.deepcopy(cpu).cuda()
        n_gn = sum(isinstance(m, N.GroupNorm) for m in cpu.modules())
        reset_counts()
        out, leaves = call(gpu, kind, "cuda")
        got = [out.detach()] + list(torch.autograd.grad(out, leaves,
                                                        ct.cuda()))
        torch.cuda.synchronize()
        check(all_counts() == expected(group_norm_act=n_gn,
                                       group_norm_act_bwd=n_gn),
              f"[legacy] {name} launched {all_counts()}, {n_gn} GroupNorms")
        errs[name] = []
        for j, (g, w) in enumerate(zip(got, want)):
            tol = 1e-4 if j == 0 else 1e-3
            scale = float(w.abs().max())
            diff = (g.cpu() - w).abs()
            err = float(diff.max()) / scale
            check(bool(torch.isfinite(g).all()), f"[legacy] {name}: "
                  "non-finite values on the card")
            errs[name].append(err)
            if j and name in kinked:
                share = float((diff > tol * scale).float().mean())
                off[name] = max(off.get(name, 0.0), share)
                check(share <= 1e-3, f"[legacy] {name} dx: {share:.3e} of "
                      f"its elements outside {tol} of its scale {scale:.3e} "
                      "(at most 1e-3 may be)")
                continue
            check(err <= tol, f"[legacy] {name} "
                  f"{'output' if j == 0 else 'dx'}: card vs CPU {err:.3e} "
                  f"of scale {scale:.3e} (tol {tol})")
        del cpu, gpu, out, leaves, got, want
    torch.cuda.empty_cache()
    worst_f = max(e[0] for e in errs.values())
    worst_g = max(max(e[1:]) for c, e in errs.items() if c not in kinked)
    say(f"[legacy] NCSNv2's CIFAR-10 widths (ngf {n}, {k} noise levels from "
        f"get_sigmas: sigma {sigmas[0]:g} to {sigmas[-1]:g}, labels below "
        f"{k}), B={b}, 32 x 32 at {n} channels and 16 x 16 at {2 * n}: the "
        f"forward and input gradient of every class of "
        f"models/normalization.py and models/legacy_layers.py "
        f"({len(cases)} cases), float32 on the card against the CPU with "
        f"the same weights: outputs at most {worst_f:.3e} of their scale "
        f"(tol 1e-4), gradients {worst_g:.3e} (tol 1e-3) but through max "
        f"pooling, where " + ", ".join(f"{c} {v:.3e}" for c, v in off.items())
        + " of dx lies outside 1e-3 of scale (ties routed apart; at most "
        f"1e-3 may); the GroupNorm cases through the kernels, counted; CPU "
        f"side {cpu_s:.1f} s")
    say("[legacy] error of scale by class (output, input gradients): "
        + json.dumps({c: [float(f"{v:.3e}") for v in e]
                      for c, e in errs.items()}))

    # the GroupNorm variant in bf16 under gn_bf16: the encoder stack's
    # forward and backward, every GroupNorm through the kernels
    torch.manual_seed(31)
    stack32 = legacy_stack(N.GroupNorm).cuda().to(
        memory_format=torch.channels_last)
    stack = copy.deepcopy(stack32).to(torch.bfloat16)
    hg = h.cuda()
    ctb = torch.from_numpy(rng.standard_normal((b, 2 * n, 16, 16)).astype(
        np.float32)).cuda().bfloat16().contiguous(
        memory_format=torch.channels_last)
    set_gn_bf16(True)
    xb = hg.bfloat16().requires_grad_()
    reset_counts()
    out = stack(xb)
    out.backward(ctb)
    torch.cuda.synchronize()
    launches = all_counts()
    n_gn = sum(c for _, _, c in LEGACY_GN_CALLS)
    check(launches == expected(group_norm_act=n_gn, group_norm_act_bwd=n_gn),
          f"[legacy] the GroupNorm stack's step launched {launches}, "
          f"expected {n_gn} of each GroupNorm kernel")
    check(bool(torch.isfinite(out).all()) and bool(
        torch.isfinite(xb.grad).all()), "[legacy] non-finite bf16 stack")
    with torch.no_grad():
        ref = stack32(hg)
        err = max_err(out, ref) / float(ref.abs().max())
        # bf16 rounds 16 convolutions and 16 GroupNorms: a sanity bound
        check(err <= 0.1, f"[legacy] bf16 stack {err:.3e} of scale from "
              "float32")
        # the convolutions' FLOPs of one forward, from their outputs
        flops = []
        hooks = [m.register_forward_hook(
            lambda m, i, o: flops.append(2 * o.numel() * m.weight[0].numel()))
            for m in stack.modules() if isinstance(m, L.NCSNConv)]
        stack(xb.detach())
        for hook in hooks:
            hook.remove()
        flops = sum(flops)
        gn_ms = device_ms(lambda: stack(xb.detach()), launches=3)
        gn_eager = cuda_ms(lambda: stack(xb.detach()), iters=5, warmup=1)
        set_gn_bf16(False)
        torch.manual_seed(31)
        plus = legacy_stack(N.InstanceNorm2dPlus).cuda().to(
            memory_format=torch.channels_last)
        plus_ms = device_ms(lambda: plus(hg), launches=3)
    os.environ.pop("PSLD_GN_BF16")
    say(f"[legacy] record, not a target: one forward of NCSNv2's eight "
        f"encoder residual blocks at B={b} (device ms, CUDA-graph replay): "
        f"GroupNorm variant bf16 under gn_bf16 {gn_ms:.3f} ms (eager "
        f"{gn_eager:.3f} ms; {flops / 1e12:.2f} TFLOP of convolutions, "
        f"{flops / (gn_ms / 1e3) / 1e12:.1f} TFLOP/s), InstanceNorm++ "
        f"(the published config's) float32 {plus_ms:.3f} ms; its bf16 "
        f"step launched {launches['group_norm_act']} GroupNorm forwards "
        f"and {launches['group_norm_act_bwd']} backwards (exact), output "
        f"{err:.3e} of scale from float32; card side "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    say("[legacy] " + json.dumps({
        "stack_gn_bf16_ms": gn_ms, "stack_gn_bf16_eager_ms": gn_eager,
        "stack_instancenorm_plus_f32_ms": plus_ms, "stack_tflop": flops / 1e12,
        "card_vs_cpu_fwd": worst_f, "card_vs_cpu_grad": worst_g,
        "maxpool_dx_share_outside": off,
        "cpu_s": cpu_s, "launches": launches}))
    del stack, stack32, plus, out, xb
    torch.cuda.empty_cache()
    return launches


def phase_ranks(card, work, phases: dict) -> dict:
    """Run the phases ``phases`` (name -> generator) that wait on gloo
    ranks, together. Each generator yields ``(group, runs)``: the runs
    its ranks make in the rank group ``group`` (None: no ranks); then,
    when resumed, computes its reference in this process (or, without
    ranks, its host work) and yields; then takes ``(results, wall)``, its
    group's results and seconds, checks them and returns. The groups (one
    launch of ``SPATIAL`` ranks each, every run of its phases in order)
    start together, and this process computes the references beside
    them, and the host work in a thread, so that the card and the host's
    cores serve several at once; every allocator is held to a share of
    the card, and all but the first group's training wait for the
    references (see below). Returns name -> what each phase returned."""
    groups, group_of = {}, {}
    for name, gen in phases.items():
        group_of[name], runs = next(gen)
        if group_of[name] is not None:
            groups.setdefault(group_of[name], []).extend(runs)
    # the card's memory holds two groups' float32 training at full width
    # beside sampling (a rank of either allocates 11-13 GB; H100 80GB),
    # or one beside this process's references: the first group's
    # training runs beside the references, every later group's waits for
    # them to end
    refs_done = os.path.join(work, "references_done")
    first = True
    for g, runs in groups.items():
        train = [r for r in runs if r["kind"] == "train"]
        if train and not first:
            train[0]["wait_for"] = refs_done
        first = first and not train
    # every rank shares the host's cores with the others and this process
    threads = max(1, (os.cpu_count() or 2) // (2 * len(groups)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    handles = {}
    free = [torch.cuda.mem_get_info()[0]]
    watching = threading.Event()

    def watch():
        while not watching.wait(0.5):
            free.append(torch.cuda.mem_get_info()[0])

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        for g, runs in groups.items():
            handles[g] = start_ranks(work, g, {
                "gloo": True, "runs": runs, "threads": threads,
                "memory_fraction": RANK_MEMORY_FRACTION}, SPATIAL)
        # the host work in a thread (the CPU's kernels release the
        # interpreter), the references here
        hosts = [pool.submit(next, gen) for name, gen in phases.items()
                 if group_of[name] is None]
        # cuDNN takes algorithms whose workspace fits in the share
        torch.cuda.set_per_process_memory_fraction(REFERENCE_MEMORY_FRACTION)
        try:
            for name, gen in phases.items():
                if group_of[name] is not None:
                    next(gen)
                    torch.cuda.empty_cache()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        for r in range(SPATIAL):
            open(f"{refs_done}.{r}", "w").close()
        ref_s = time.perf_counter() - t0
        for host in hosts:
            host.result()
        results, walls = {None: None}, {None: 0.0}
        for g, handle in handles.items():
            results[g] = finish_ranks(handle)
            walls[g] = time.perf_counter() - t0
    finally:
        watching.set()
        watcher.join()
        for _, procs in handles.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        pool.shutdown(wait=True)
    # one line, at the end: [time] gives the block's seconds to it
    say(f"[ranks] {len(groups)} groups of {SPATIAL} gloo ranks on the one "
        f"card, started together ({threads} intra-op threads and "
        f"{RANK_MEMORY_FRACTION:.0%} of the card's memory a rank; "
        + "; ".join(f"{g}: {', '.join(r['tag'] for r in runs)}"
                    for g, runs in groups.items())
        + f"), all done {time.perf_counter() - t0:.1f} s after their start "
        f"(each group's end as seen in turn: "
        + ", ".join(f"{g} {w:.1f} s" for g, w in walls.items() if g)
        + f"); this process's references beside them ("
        f"{REFERENCE_MEMORY_FRACTION:.0%} of the card) took the first "
        f"{ref_s:.1f} s, its host work (" + ", ".join(
            n for n, g in group_of.items() if g is None)
        + f") ran in a thread beside those; the card's free memory "
        f"{free[0] / 1e9:.1f} GB before, {min(free) / 1e9:.1f} GB at least; "
        f"rank peaks "
        + json.dumps({
            g: [round(max(r["peak_bytes"] for r in res_r["runs"].values())
                      / 1e9, 2) for res_r in results[g]] for g in groups})
        + f" GB; {card}")
    out = {}
    for name, gen in phases.items():
        try:
            gen.send((results[group_of[name]], walls[group_of[name]]))
        except StopIteration as done:
            out[name] = done.value
        else:
            check(False, f"[ranks] phase {name} did not end")
    return out


def combine(*timings) -> dict:
    """The timings of one path that launches a kernel at the shapes of
    two networks (guided sampling: the score network's and the
    classifier's): times and bounds add, errors and bit-equal shares take
    the worst."""
    out = {}
    for t in timings:
        for k, v in t.items():
            if k in ("max_abs_err", "max_err_of_scale"):
                out[k] = max(out.get(k, 0.0), v)
            elif k == "bit_equal_share":
                out[k] = min(out.get(k, 1.0), v)
            elif k == "bound_by":
                out[k] = "bytes" if "bytes" in (out.get(k), v) else v
            else:
                out[k] = out.get(k, 0.0) + v
    return out


# the paths the script drives, each with the batch its kernels run at
PATHS = {"sample": BATCH, "serve": BATCH, "train": TRAIN_BATCH,
         "train_clf": CLF_TRAIN_BATCH, "guided": BATCH, "sscs": BATCH,
         "inpaint": BATCH, "edit": BATCH, "pc": BATCH, "ode": BATCH,
         "cc_ode": BATCH, "likelihood": BATCH,
         "vp_train": TRAIN_BATCH, "vp_sample": BATCH, "vp_pc": BATCH,
         "vp_edit": BATCH, "vp_ode": BATCH, "vp_likelihood": BATCH,
         "sweep": BATCH, "bench": [BATCH, TRAIN_BATCH],
         "celebahq_train": HQ_BATCH, "resume": HQ_BATCH,
         "celebahq_sample": HQ_BATCH, "afhq_train": AFHQ_BATCH,
         "async_ckpt": TRAIN_BATCH, "fanout": BATCH, "ddp": TRAIN_BATCH,
         "fsdp": TRAIN_BATCH, "ddp2": BATCH, "fsdp2": BATCH,
         "lockstep": BATCH, "spatial2": HQ_BATCH, "spatial2_f32": HQ_BATCH,
         "spatial_sample": HQ_BATCH, "spatial_inpaint": HQ_BATCH,
         "legacy": LEGACY_BATCH}
# the spatial paths: the two training runs, then the two sampling runs
SPATIAL_PATHS = ("spatial2", "spatial2_f32", "spatial_sample",
                 "spatial_inpaint")
# the kernels that run only in the bench's train phase, at its batch
BENCH_TRAIN_ONLY = ("group_norm_act_bwd", "hash_dropout")


def path_batch(path: str, name: str):
    """The batch (or batches) at which ``path`` launches kernel ``name``."""
    if path == "bench" and name in BENCH_TRAIN_ONLY:
        return TRAIN_BATCH
    return PATHS[path]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import shutil

    from psld_tpu_torch.cli._common import bootstrap

    card = phase_device()
    work = os.path.join(REPO, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # [fid] is host work (two SciPy square roots of 2048 x 2048) and
    # launches no kernel of the port: it runs in a thread beside the nvcc
    # builds, and its lines print after them
    reference = write_reference_pngs(work)
    fid_lines: list = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fid_job = pool.submit(phase_fid, card, work, write_reference_pngs(
            work, BATCH, "fid_input"), reference, fid_lines)
        phase_build()
        fid = fid_job.result()
    for line in fid_lines:
        say(line)
    fused = phase_fused_act(card)
    # each kernel at the shapes of every path that launches it: the
    # flagship's at 64 (sample, sscs, guided) and 128 (train), the
    # classifier's at 64 (guided) and 32 (train_clf), the VP-SDE's at 64
    # (vp_sample, vp_pc, vp_edit, vp_ode, vp_likelihood, sweep) and 128
    # (vp_train)
    gn = {"flagship64": phase_gn(card, BATCH),
          "flagship128": phase_gn(card, TRAIN_BATCH),
          "clf64": phase_gn(card, BATCH, CLF_GN_CALLS, "classifier"),
          "clf32": phase_gn(card, CLF_TRAIN_BATCH, CLF_GN_CALLS,
                            "classifier"),
          "vp64": phase_gn(card, BATCH, VP_GN_CALLS, "VP-SDE"),
          "vp128": phase_gn(card, TRAIN_BATCH, VP_GN_CALLS, "VP-SDE")}
    gn_bwd = {"flagship128": phase_gn_bwd(card),
              # a rank's step of [ddp2] and [fsdp2]
              "flagship64": phase_gn_bwd(card, BATCH),
              "flagship64_dx": phase_gn_bwd(card, BATCH, need_params=False),
              "clf64": phase_gn_bwd(card, BATCH, CLF_GN_CALLS, "classifier"),
              "clf32": phase_gn_bwd(card, CLF_TRAIN_BATCH, CLF_GN_CALLS,
                                    "classifier"),
              "vp128": phase_gn_bwd(card, TRAIN_BATCH, VP_GN_CALLS,
                                    "VP-SDE"),
              "vp64_dx": phase_gn_bwd(card, BATCH, VP_GN_CALLS, "VP-SDE",
                                      need_params=False)}
    attn = {"flagship64": phase_attention(card, BATCH),
            "flagship128": phase_attention(card, TRAIN_BATCH),
            "clf64": phase_attention(card, BATCH, CLF_ATTN_CALLS,
                                     "classifier"),
            "clf32": phase_attention(card, CLF_TRAIN_BATCH, CLF_ATTN_CALLS,
                                     "classifier"),
            "vp64": phase_attention(card, BATCH, VP_ATTN_CALLS, "VP-SDE"),
            "vp128": phase_attention(card, TRAIN_BATCH, VP_ATTN_CALLS,
                                     "VP-SDE")}
    drop = {"flagship128": phase_dropout(card),
            "flagship64": phase_dropout(card, BATCH),
            "clf32": phase_dropout(card, CLF_TRAIN_BATCH, CLF_DROPOUT_CALLS,
                                   "classifier"),
            "vp128": phase_dropout(card, TRAIN_BATCH, VP_DROPOUT_CALLS,
                                   "VP-SDE", rate=VP_RATE)}
    # CelebA-HQ 256 at its batch 8 (train, sample, resume) and AFHQv2 128
    # at its 32 (train): GroupNorm up to 65,536 pixels, where the
    # backward's plan holds part of its rows in shared memory
    gn["hq8"] = phase_gn(card, HQ_BATCH, HQ_GN_CALLS, HQ.name, "hires_gn")
    gn["afhq32"] = phase_gn(card, AFHQ_BATCH, AFHQ_GN_CALLS, AFHQ.name,
                            "hires_gn")
    gn_bwd["hq8"] = phase_gn_bwd(card, HQ_BATCH, HQ_GN_CALLS, HQ.name,
                                 tag="hires_gn_bwd")
    gn_bwd["afhq32"] = phase_gn_bwd(card, AFHQ_BATCH, AFHQ_GN_CALLS,
                                    AFHQ.name, tag="hires_gn_bwd")
    attn["hq8"] = phase_attention(card, HQ_BATCH, HQ_ATTN_CALLS, HQ.name,
                                  "hires_attention")
    attn["afhq32"] = phase_attention(card, AFHQ_BATCH, AFHQ_ATTN_CALLS,
                                     AFHQ.name, "hires_attention")
    drop["afhq32"] = phase_dropout(card, AFHQ_BATCH, AFHQ_DROPOUT_CALLS,
                                   AFHQ.name, AFHQ_RATE, "hires_dropout")
    # the split entries of spatial parallelism at CelebA-HQ's shapes at
    # half height, and the dropout of a height slice at AFHQv2's
    split = phase_spatial_kernels(card)
    # the shapes the kernels refuse, routed to the plain versions
    phase_routes(card)
    # the GroupNorm variant of the legacy normalizers (no activation) at
    # the shapes of NCSNv2's encoder at batch 128
    gn["legacy128"] = phase_gn(card, LEGACY_BATCH, LEGACY_GN_CALLS,
                               "NCSNv2 encoder", "legacy_gn", act="none")
    gn_bwd["legacy128"] = phase_gn_bwd(card, LEGACY_BATCH, LEGACY_GN_CALLS,
                                       "NCSNv2 encoder", tag="legacy_gn_bwd",
                                       act="none")
    cfg = bootstrap(FLAGSHIP_ARGS).dataset.diffusion
    weights, _ = phase_net(card, cfg)
    phase_sscs_check(card, cfg, weights)
    phase_pc_check(card, bootstrap(FLAGSHIP_ARGS + [
        "+dataset.diffusion.evaluation.sampler.corrector=langevin"
    ]).dataset.diffusion, weights)
    phase_inpaint_check(card, cfg, weights)
    phase_edit_check(card, cfg, weights)
    phase_train_check(card, weights)
    phase_clf_check(card)
    phase_ode_check(card, weights)
    phase_likelihood_check(card, weights)
    del weights
    weights = vp_weights()
    phase_train_check(card, weights, VP, "vp_check", seed=41)
    phase_vp_check(card, weights)
    phase_likelihood_check(card, weights, VP, "vp_check", seed=43)
    del weights
    phase_hires_check(card)
    # each path is driven with the counts set to 0 just before it
    ckpt, n_train, train_t = phase_train(card, work)
    n_sample, sample = phase_sample(card, work, ckpt)
    clf_ckpt, n_train_clf, _ = phase_train_clf(card, work)
    # the reference's checkpoint format both ways, then serving
    converted = phase_interop(card, work, ckpt, clf_ckpt)
    n_serve, _ = phase_serve(card, work, converted, sample)
    n_guided, _ = phase_guided(card, work, ckpt, clf_ckpt)
    n_sscs, _ = phase_sscs(card, work, ckpt)
    n_inpaint = phase_inpaint(card, work, ckpt)
    n_edit = phase_edit(card, work, ckpt)
    n_pc = phase_pc(card, work, ckpt)
    n_ode, _ = phase_ode(card, work, ckpt)
    n_cc_ode = phase_cc_ode(card, work, ckpt, clf_ckpt)
    n_likelihood, _ = phase_likelihood(card, work, ckpt)
    # the VP-SDE baseline and the evaluation
    vp_ckpt, n_vp_train, vp_train = phase_train(
        card, work, VP, VP_TRAIN_ARGS, "vp_train",
        f"hash dropout {VP_RATE} (hw_inline), eps loss, Adam+warmup, clip "
        f"1, EMA 0.9999")
    n_vp_sample, vp_sample = phase_sample(card, work, vp_ckpt, VP,
                                          "vp_sample")
    n_vp_pc = phase_pc(card, work, vp_ckpt, VP, "vp_pc", PC_SAMPLERS[:1])
    n_vp_edit = phase_edit(card, work, vp_ckpt, VP, "vp_edit")
    n_vp_ode, vp_ode = phase_ode(card, work, vp_ckpt, VP, "vp_ode")
    n_vp_likelihood, vp_lik = phase_likelihood(card, work, vp_ckpt, VP,
                                               "vp_likelihood")
    n_sweep = phase_sweep(card, work, vp_ckpt, reference,
                          write_fake_inception(os.path.join(
                              work, "pt_inception-fake.pth")))
    # CelebA-HQ 256 and AFHQv2 128 from image folders, preemption and
    # resume, the asynchronous checkpoint, per-rank fan-out
    hq_ckpt, n_hq_train, hq_train = phase_folder_train(
        card, work, HQ, HQ_SUBDIRS, 256, HQ_BATCH, PROFILE_STEPS,
        HQ_TIMED, "celebahq_train", "no dropout, HSM, Adam+warmup, clip 1, "
        "EMA 0.9999", profile=True)
    n_resume = phase_resume(card, work)
    n_hq_sample, hq_sample = phase_folder_sample(card, work, hq_ckpt)
    _, n_afhq_train, afhq_train = phase_folder_train(
        card, work, AFHQ, AFHQ_SUBDIRS, 128, AFHQ_BATCH, TRAIN_WARMUP,
        AFHQ_TIMED, "afhq_train", f"hash dropout {AFHQ_RATE}, HSM, "
        "Adam+warmup, clip 1, EMA 0.9999")
    n_async, async_ckpt = phase_async_ckpt(card, work)
    n_fanout = phase_fanout(card, work, ckpt)
    # several processes: world size 1 on NCCL, then two ranks on the card
    n_ddp, n_fsdp, _ = phase_ddp(card, work, train_t["ms_step"])
    # and spatial parallelism, one image's height split over two ranks:
    # the gloo groups run together, beside the references and the CPU's
    # side of the NCSNv1/v2 component library (its path: the GroupNorm
    # stack's bf16 step, counted from 0 after the ranks)
    hq_root = os.path.join(work, "celebahq_train_data")
    ranks = phase_ranks(card, work, {
        "spatial2": phase_spatial2(card, work, hq_root),
        "spatial_sample": phase_spatial_sample(card, work, hq_ckpt,
                                               hq_root),
        "lockstep": phase_lockstep(card, work, ckpt),
        "ddp2": phase_ddp2(card, work),
        "legacy": phase_legacy(card)})
    n_legacy = ranks["legacy"]
    n_ddp2, n_fsdp2 = ranks["ddp2"]
    n_lockstep = ranks["lockstep"]
    n_spatial2, n_spatial2_f32, spatial2 = ranks["spatial2"]
    n_spatial_sample, n_spatial_inpaint = ranks["spatial_sample"]
    say("[hires] " + json.dumps({
        "celebahq_train": hq_train, "celebahq_sample": hq_sample,
        "afhq_train": afhq_train, "async_ckpt": async_ckpt,
        "launches": {"celebahq_step": HQ.step_counts(),
                     "celebahq_nfe": HQ.fwd_counts(1),
                     "afhq_step": AFHQ.step_counts()}}))
    n_bench, _ = phase_bench(card)
    on_path = {"sample": n_sample, "serve": n_serve, "train": n_train,
               "train_clf": n_train_clf, "guided": n_guided,
               "sscs": n_sscs, "inpaint": n_inpaint, "edit": n_edit,
               "pc": n_pc, "ode": n_ode, "cc_ode": n_cc_ode,
               "likelihood": n_likelihood, "vp_train": n_vp_train,
               "vp_sample": n_vp_sample, "vp_pc": n_vp_pc,
               "vp_edit": n_vp_edit, "vp_ode": n_vp_ode,
               "vp_likelihood": n_vp_likelihood, "sweep": n_sweep,
               "bench": n_bench, "celebahq_train": n_hq_train,
               "resume": n_resume, "celebahq_sample": n_hq_sample,
               "afhq_train": n_afhq_train, "async_ckpt": n_async,
               "fanout": n_fanout, "ddp": n_ddp, "fsdp": n_fsdp,
               "ddp2": n_ddp2, "fsdp2": n_fsdp2, "lockstep": n_lockstep,
               "spatial2": n_spatial2, "spatial2_f32": n_spatial2_f32,
               "spatial_sample": n_spatial_sample,
               "spatial_inpaint": n_spatial_inpaint, "legacy": n_legacy}
    say("[vp] " + json.dumps({
        "train": vp_train, "sample_em_100": vp_sample, "ode_ms_nfe": vp_ode,
        "likelihood": vp_lik, "inception_batch64": fid,
        "launches": {"sample_nfe": VP.fwd_counts(1),
                     "train_step": VP.step_counts(),
                     "likelihood_rhs": VP.fwd_counts(1, input_vjps=1)}}))
    # what each path runs, at the shapes it runs it
    # the bench samples at 64 and trains at 128: its forward kernels'
    # numbers add one forward at each batch
    times = {
        "group_norm_act": {
            "sample": gn["flagship64"], "serve": gn["flagship64"],
            "train": gn["flagship128"],
            "train_clf": gn["clf32"],
            "guided": combine(gn["flagship64"], gn["clf64"]),
            "sscs": gn["flagship64"], "inpaint": gn["flagship64"],
            "edit": gn["flagship64"], "pc": gn["flagship64"],
            "ode": gn["flagship64"],
            "cc_ode": combine(gn["flagship64"], gn["clf64"]),
            "likelihood": gn["flagship64"],
            "vp_train": gn["vp128"], "vp_sample": gn["vp64"],
            "vp_pc": gn["vp64"], "vp_edit": gn["vp64"], "vp_ode": gn["vp64"],
            "vp_likelihood": gn["vp64"], "sweep": gn["vp64"],
            "bench": combine(gn["flagship64"], gn["flagship128"]),
            "celebahq_train": gn["hq8"], "resume": gn["hq8"],
            "celebahq_sample": gn["hq8"], "afhq_train": gn["afhq32"],
            "async_ckpt": gn["flagship128"], "fanout": gn["flagship64"],
            "ddp": gn["flagship128"], "fsdp": gn["flagship128"],
            "ddp2": gn["flagship64"], "fsdp2": gn["flagship64"],
            "lockstep": gn["flagship64"],
            **{p: split["attn_gn"] for p in SPATIAL_PATHS},
            "legacy": gn["legacy128"]},
        "group_norm_act_bwd": {
            "train": gn_bwd["flagship128"], "train_clf": gn_bwd["clf32"],
            "guided": gn_bwd["clf64"], "cc_ode": gn_bwd["clf64"],
            "likelihood": gn_bwd["flagship64_dx"],
            "vp_train": gn_bwd["vp128"], "vp_likelihood": gn_bwd["vp64_dx"],
            "bench": gn_bwd["flagship128"], "celebahq_train": gn_bwd["hq8"],
            "resume": gn_bwd["hq8"], "afhq_train": gn_bwd["afhq32"],
            "async_ckpt": gn_bwd["flagship128"],
            "ddp": gn_bwd["flagship128"], "fsdp": gn_bwd["flagship128"],
            "ddp2": gn_bwd["flagship64"], "fsdp2": gn_bwd["flagship64"],
            **{p: split["attn_gn_bwd"] for p in SPATIAL_PATHS[:2]},
            "legacy": gn_bwd["legacy128"]},
        "attention": {
            "sample": attn["flagship64"], "serve": attn["flagship64"],
            "train": attn["flagship128"],
            "train_clf": attn["clf32"],
            "guided": combine(attn["flagship64"], attn["clf64"]),
            "sscs": attn["flagship64"], "inpaint": attn["flagship64"],
            "edit": attn["flagship64"], "pc": attn["flagship64"],
            "ode": attn["flagship64"],
            "cc_ode": combine(attn["flagship64"], attn["clf64"]),
            "likelihood": attn["flagship64"],
            "vp_train": attn["vp128"], "vp_sample": attn["vp64"],
            "vp_pc": attn["vp64"], "vp_edit": attn["vp64"],
            "vp_ode": attn["vp64"], "vp_likelihood": attn["vp64"],
            "sweep": attn["vp64"],
            "bench": combine(attn["flagship64"], attn["flagship128"]),
            "celebahq_train": attn["hq8"], "resume": attn["hq8"],
            "celebahq_sample": attn["hq8"], "afhq_train": attn["afhq32"],
            "async_ckpt": attn["flagship128"], "fanout": attn["flagship64"],
            "ddp": attn["flagship128"], "fsdp": attn["flagship128"],
            "ddp2": attn["flagship64"], "fsdp2": attn["flagship64"],
            "lockstep": attn["flagship64"], "spatial2": attn["hq8"],
            "spatial2_f32": attn["hq8"], "spatial_sample": attn["hq8"],
            "spatial_inpaint": attn["hq8"]},
        "hash_dropout": {"train": drop["flagship128"],
                         "train_clf": drop["clf32"],
                         "vp_train": drop["vp128"],
                         "bench": drop["flagship128"],
                         "afhq_train": drop["afhq32"],
                         "async_ckpt": drop["flagship128"],
                         "ddp": drop["flagship128"],
                         "fsdp": drop["flagship128"],
                         "ddp2": drop["flagship64"],
                         "fsdp2": drop["flagship64"]},
        # the split entries launch only under spatial parallelism
        **{f"group_norm_split_{k}": {p: split[k] for p in SPATIAL_PATHS[
            :4 if k in ("stats", "apply") else 2]}
           for k in ("stats", "apply", "partials", "dx")},
    }
    for name, paths in times.items():
        for path in paths:
            check(on_path[path][name] > 0,
                  f"the {path} path never launched the {name} kernel")
    for name in ("fused_leaky_relu", "fused_leaky_relu_bwd"):
        check(all(c[name] == 0 for c in on_path.values()),
              f"a path launched {name}, which no model calls")

    def row(name, route, source, replaces, basis, timed=None,
            redesigned_in=None):
        """One kernel's line. Its numbers are those at the shapes of the
        path named by ``path`` (the first that launches it, in the order
        of ``PATHS``); ``by_path`` holds the same keys for every path that
        launches the kernel, each at that path's shapes and batch.
        ``timed`` is the line of a kernel no path launches: its own
        phase's numbers, 0 launches, no path. ``redesigned_in`` names the
        change that replaced the kernel's first design."""
        more = {} if redesigned_in is None else {
            "redesigned_in": redesigned_in}
        if timed is not None:
            return {"name": name, "route": route, "source": source,
                    "replaces": replaces, "launches": 0, "path": None,
                    **timed, "basis": basis, "by_path": {}, **more}
        per = times[name]
        by_path = {p: {"launches": on_path[p][name],
                       "batch": path_batch(p, name), **per[p]}
                   for p in PATHS if p in per}
        path = next(p for p in PATHS if p in per)
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "launches": sum(c[name] for c in on_path.values()),
                "path": path, **per[path], "basis": basis,
                "by_path": by_path, **more}

    fwd = ("bf16: device ms (CUDA-graph replay) summed over the calls of "
           "one network forward at the path's batch (guided and cc_ode: the "
           "score network's and the classifier's; vp_* and sweep: the "
           "VP-SDE network's; bench: one forward at 64 and one at 128; "
           "legacy: NCSNv2's encoder with the GroupNorm normalizer, no "
           "activation, at 128), "
           "eager_ms the same calls made one by one; "
           "max_abs_err of the bf16 kernel against the plain version "
           "(GroupNorm: its gn_bf16 chain)")
    fused_basis = ("bf16: device ms summed over one call at each of "
                   f"{FUSED_ACT_SHAPES} (rows, C); no path of the port or "
                   "model of the JAX package calls the op, so launches is 0 "
                   "and its own phase drives it; the phase demands bit "
                   "equality with the plain version in f32 and bf16")
    split_basis = (
        "bf16 under gn_bf16 (CelebA-HQ's config), swish: device ms (CUDA-"
        "graph replay) summed over the split calls of one CelebA-HQ 256 "
        f"forward (stats, apply) or backward (partials, dx) on one shard of "
        f"{SPATIAL} at B={HQ_BATCH}; launches over [spatial2] (bf16 and "
        "f32) and [spatial_sample]; max_abs_err of the bf16 entry against "
        "its plain version (partials and dx: over each output's scale); "
        "bit_equal_share (apply): the least share of bit-equal elements "
        "under gn_bf16 over the compared cases; "
        "library_ms: stats torch.var_mean over the shard's grouped view "
        "(bf16 in, its own dtype out), apply F.group_norm+F.silu on the "
        "shard, which normalizes the shard alone; none for partials and "
        "dx, which take the whole map's moments and have no single "
        "PyTorch call")
    say("[spatial] " + json.dumps({"spatial2": spatial2,
                                   "strided_dropout": split["dropout"]}))
    say("[time] seconds a phase, to its first line: " + json.dumps(
        {tag: round(sec, 1) for tag, sec in _PHASE_S if sec >= 1.0})
        + f"; the whole smoke to here {time.perf_counter() - _START:.1f} s")
    drop_row = row(
        "hash_dropout", "triton", "psld_tpu_torch/ops/dropout.py",
        "psld_tpu/ops/dropout.py:96",
        "bf16, rate 0.15, vp_train at its 0.1 (the classifier trains at "
        "0.1 and is timed at 0.15; the kernel "
        "reads and writes every element at any rate): device ms summed "
        "over the launches of one training step (forward and backward) "
        "at the path's shapes; max_abs_err measured over every compared "
        "case, f32 and bf16 (the phase demands bit equality); strided: "
        "the image-strided launch (a rank's height slice) over one "
        "AFHQv2 128 step of a rank, flat_ms the unstrided launch on the "
        "same elements")
    drop_row["strided"] = split["dropout"]
    say(json.dumps({"kernels": [
        row("group_norm_act", "cuda", "psld_tpu_torch/csrc/group_norm_fwd.cu",
            "psld_tpu/ops/group_norm.py:67", fwd + "; bit_equal_share: the "
            "least share of bit-equal elements under gn_bf16 over the "
            "compared cases", redesigned_in=6),
        row("group_norm_act_bwd", "cuda",
            "psld_tpu_torch/csrc/group_norm_bwd.cu",
            "psld_tpu/ops/group_norm.py:125",
            "bf16: device ms summed over the calls of one network backward "
            "at the path's batch (likelihood, vp_likelihood: the input-only "
            "mode, dx alone, at B=64; legacy: NCSNv2's encoder with the "
            "GroupNorm normalizer, no activation, at 128); max_abs_err is "
            "the largest |kernel - plain| over dx, dscale and dbias against "
            "autograd through the "
            "plain version's gn_bf16 chain (dscale sums 131,072 x 64 terms "
            "at B=128, so it is large in absolute terms); max_err_of_scale "
            "is that error over each gradient's largest magnitude, which "
            "the phase holds under 1e-2", redesigned_in=5),
        row("attention", "cuda", "psld_tpu_torch/csrc/attention.cu",
            "psld_tpu/ops/attention.py:34", fwd, redesigned_in=5),
        drop_row,
        *[row(f"group_norm_split_{k}", "cuda",
              f"psld_tpu_torch/csrc/group_norm_{src}.cu",
              f"psld_tpu/ops/group_norm.py:{line}", split_basis,
              redesigned_in=pr)
          for k, src, line, pr in (("stats", "fwd", 67, 15),
                                   ("apply", "fwd", 67, 17),
                                   ("partials", "split_bwd", 125, 16),
                                   ("dx", "split_bwd", 125, 16))],
        row("fused_leaky_relu", "cuda", "psld_tpu_torch/csrc/fused_act.cu",
            "psld_tpu/ops/fused_act.py:23", fused_basis, fused["fwd"]),
        row("fused_leaky_relu_bwd", "cuda",
            "psld_tpu_torch/csrc/fused_act.cu",
            "psld_tpu/ops/fused_act.py:28", fused_basis, fused["bwd"]),
    ]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
