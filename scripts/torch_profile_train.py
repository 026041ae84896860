"""Where a training step of the port's flagship goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_train.py [--batch 128] [--steps 3]
        [--events-only] [--no-graph] [--sample-forward 64]

Builds the flagship CIFAR-10 NCSN++ of ``chip_smoke.py`` (random init from
a seed), takes warm-up steps at the training point (bf16 compute on float32
master weights, hash dropout 0.15, HSM loss, Adam, clip, EMA) on synthetic
data, then:

1. times forward+loss, backward and optimizer+EMA of a step with CUDA
   events (one sync at the end of each of ``--steps`` steps);
2. traces ``--steps`` steps with ``torch.profiler`` (device activity
   only: tracing the host's operators as well slows the host many times
   over) and prints device time by kind of kernel (convolutions, the
   port's own kernels by name, matrix products, elementwise and the
   rest), the union of GPU spans against the wall of that same traced
   window (idle share), and the top kernels by device time. The traced
   window's wall stands beside the untraced steps' of part 1, so the
   tracing's own cost can be read off.
3. captures one whole step (forward, backward, clip, Adam, EMA, with its
   random draws fixed) into one CUDA graph and times its replays against
   the same step called eagerly, in this process and untraced: the
   replay is the device's work alone, the eager step adds the host's
   launches, and 1 - replay / eager is the device's idle share of an
   eager step.
4. with ``--sample-forward B``: one bf16 forward of the same network at
   batch B, as the samplers call it (no gradient), replayed from one CUDA
   graph against the same forward called eagerly.

Prints the card's name and power limit beside the numbers. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import FLAGSHIP_ARGS, TRAIN_ARGS  # noqa: E402

KINDS = [  # (label, substrings of the kernel's name), first match wins
    ("GroupNorm forward kernel (CUDA C++)", ("gn_fwd_kernel",
                                             "gn_fwd_warp_kernel")),
    ("GroupNorm backward kernel (CUDA C++)", ("gn_bwd_kernel",)),
    ("hash dropout kernel (Triton)", ("_hash_dropout",)),
    ("attention kernel (CUDA C++)", ("attention_bf16_kernel",
                                     "attention_f32_kernel")),
    ("convolutions (cuDNN, incl. layout transforms)",
     ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "nhwc", "nchw",
      "sm90_xmma", "cutlass_cudnn")),
    ("matrix products (cuBLAS)", ("gemm", "cublas", "cutlass", "bmm")),
    ("optimizer and EMA (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "cat", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for label, keys in KINDS:
        if any(k in low for k in keys):
            return label
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--events-only", action="store_true",
                    help="skip the profiler trace and the graph replay")
    ap.add_argument("--no-graph", action="store_true",
                    help="skip the graph replay")
    ap.add_argument("--sample-forward", type=int, default=0, metavar="B",
                    help="also replay one bf16 forward at batch B")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.train import state as tstate
    from psld_tpu_torch.train import steps as tsteps
    from psld_tpu_torch.train.loop import (build_score_model, build_sde,
                                           init_score_params)

    def say(*parts):
        print(*parts, flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = bootstrap(FLAGSHIP_ARGS + TRAIN_ARGS).dataset.diffusion
    net = build_score_model(cfg)
    sde = build_sde(cfg)
    crit = get_module("losses", cfg.training.loss.name)(cfg, sde)
    params = init_score_params(net, 0, "cuda")
    step, opt = tsteps.make_train_step(net, sde, crit, cfg)
    state = tstate.init_state(params, opt)
    rng = tsteps.StepRandom(0, "cuda")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (args.batch, 32, 32, 3)).astype(np.float32)).cuda()
    for _ in range(3):
        state, m = step(state, x, rng)
    torch.cuda.synchronize()

    # 1. forward / backward / optimizer by CUDA events: the step's parts
    # are split by wrapping the two calls the step makes
    marks = {}
    real_grad, real_update = torch.autograd.grad, opt.update_

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_grad(*a, **k):
        marks["fwd_end"] = ev()
        out = real_grad(*a, **k)
        marks["bwd_end"] = ev()
        return out

    def timed_update(*a, **k):
        marks["opt_start"] = ev()
        return real_update(*a, **k)

    torch.autograd.grad, opt.update_ = timed_grad, timed_update
    rows = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        marks["start"] = ev()
        state, m = step(state, x, rng)
        marks["end"] = ev()
        torch.cuda.synchronize()
        rows.append((marks["start"].elapsed_time(marks["fwd_end"]),
                     marks["fwd_end"].elapsed_time(marks["bwd_end"]),
                     marks["opt_start"].elapsed_time(marks["end"]),
                     marks["start"].elapsed_time(marks["end"]),
                     (time.perf_counter() - t0) * 1e3))
    torch.autograd.grad, opt.update_ = real_grad, real_update
    say(f"train step at batch {args.batch}, bf16, hash dropout 0.15; {card}")
    for f, b, o, tot, wall in rows:
        say(f"  events: forward+loss {f:.2f} ms, backward {b:.2f} ms, "
            f"clip+Adam+EMA {o:.2f} ms, step {tot:.2f} ms (host wall "
            f"{wall:.2f} ms)")

    if args.events_only:
        return 0

    # 2. profiler: device time by kind of kernel, and the device's idle
    # share of the traced window itself
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the wall of the traced steps alone: the profiler's start, a
        # first step that absorbs what the tracer sets up at the first
        # launch, and its reading of the trace at the end stay out
        state, m = step(state, x, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, x, rng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    spans, by_kind, by_name, calls = [], {}, {}, {}
    device = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    # every step launches the same work: the absorbing step's events are
    # the first 1 / (steps + 1) of the trace
    first = len(device) // (args.steps + 1)
    if first * (args.steps + 1) != len(device):
        say(f"  profiler: {len(device)} device events are no multiple of "
            f"{args.steps + 1} steps; the split of the first step is off "
            f"by under one step's share")
    for e in device[first:]:
        dur = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        k = kind_of(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        calls[k] = calls.get(k, 0) + 1
    if not spans:
        say("  profiler: no device events recorded")
    else:
        spans.sort()
        union, (lo, hi) = 0.0, spans[0]
        for a, b in spans[1:]:
            if a > hi:
                union += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        union += hi - lo
        n = args.steps
        total = sum(by_kind.values())
        untraced = float(np.median([r[4] for r in rows]))
        say(f"  profiler (device activity only), per step over {n} traced "
            f"steps: wall {wall_ms:.2f} ms (untraced steps above: median "
            f"{untraced:.2f} ms), union of GPU spans {union / 1e3 / n:.2f} "
            f"ms, idle share of the traced window "
            f"{1 - union / 1e3 / n / wall_ms:.4f}, sum of kernel times "
            f"{total / 1e3 / n:.2f} ms")
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            say(f"    {v / 1e3 / n:8.3f} ms  {v / total:6.1%}  "
                f"{calls[k] // n:5d} launches  {k}")
        say("  top kernels by device time, ms per step:")
        for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
            say(f"    {v / 1e3 / n:8.3f}  {name[:110]}")
    say(f"  peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"loss {float(m['loss']):.4f}")
    if args.no_graph:
        return 0

    # 3. one step replayed from a CUDA graph against the same step eager.
    # The draws are fixed and on the device, so nothing in the step reads
    # the host's generator or copies from the host; the learning rate and
    # Adam's bias corrections are host numbers and freeze in the graph,
    # which leaves the work the same.
    t = (torch.rand(args.batch, dtype=torch.float64) * (1 - 1e-5)
         + 1e-5).cuda()
    eps = torch.randn(args.batch, 32, 32, 6, device="cuda")
    seeds = rng.seed_words(net.dropout_sites)

    def fixed():
        return step(state, x, None, t=t, eps=eps, dropout_seeds=seeds)

    n = max(args.steps, 5)
    for e_ms, r_ms in replay_against_eager(fixed, n):
        say(f"  one step, {n} calls each: eager {e_ms:.2f} ms, replayed from "
            f"one CUDA graph {r_ms:.2f} ms, idle share of the eager step "
            f"{1 - r_ms / e_ms:.4f}")
    say(f"  finite after the replays: "
        f"{all(bool(torch.isfinite(v).all()) for v in state.params.values())}")
    if args.sample_forward:
        sample_forward(cfg, args.sample_forward, card, say)
    return 0


def replay_against_eager(fn, n: int):
    """[(eager ms, replayed ms)] of ``fn``, three readings in turns (eager,
    replay, eager, replay, ...): ``n`` eager calls timed by the host
    around a sync, and the same call captured once into a CUDA graph and
    replayed ``n`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    readings = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        e_ms = (time.perf_counter() - t0) * 1e3 / n
        t0 = time.perf_counter()
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
        readings.append((e_ms, (time.perf_counter() - t0) * 1e3 / n))
    return readings


def sample_forward(cfg, batch: int, card: str, say) -> None:
    """One bf16 forward of the flagship as the samplers call it, replayed
    against eager."""
    from psld_tpu_torch.eval.generate import build_score_model, make_score_fn

    net = build_score_model(cfg).eval().cuda()
    score = make_score_fn(net, bf16=True)
    z = torch.randn(batch, 32, 32, 6, device="cuda")
    t = torch.full((batch,), 0.5, device="cuda")
    with torch.inference_mode():
        readings = replay_against_eager(lambda: score(z, t), 10)
    say(f"sampling forward at batch {batch}, bf16; {card}")
    for e_ms, r_ms in readings:
        say(f"  one forward, 10 calls each: eager {e_ms:.2f} ms, replayed "
            f"from one CUDA graph {r_ms:.2f} ms, idle share of the eager "
            f"forward {1 - r_ms / e_ms:.4f}")


if __name__ == "__main__":
    sys.exit(main())
