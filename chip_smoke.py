"""Smoke test of the PyTorch/CUDA port (``psld_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: a CUDA device must be present; its name and power limit are
   printed as ``nvidia-smi`` reports them.
2. build: the CUDA C++ kernels are compiled from ``psld_tpu_torch/csrc``
   with nvcc for sm_90a (the Triton kernel compiles at its first launch).
3. gn: the Triton GroupNorm+act kernel against its plain PyTorch version at
   the eight (H*W, C) shapes of a flagship forward, batch 64.
4. attention: the CUDA C++ attention kernel against its plain version at
   the two attention shapes of a flagship forward, batch 64.
5. net: the flagship CIFAR-10 NCSN++ (97.6M parameters, weights drawn as
   N(0, 1) * 0.02 from a numpy seed): float32 forward on the card against
   the same forward on the CPU, with the kernel launch counts of one
   forward; then a 3-step Euler-Maruyama trajectory on the card against the
   CPU with the same injected noise.
6. sample: ``psld_tpu_torch.cli.sample`` with the flagship's settings
   (batch 64, bf16 network, gn_bf16, 100-NFE EM with denoise) writes 64
   PNGs; every GroupNorm and attention call of that run must have gone
   through the kernels.

Float32 comparisons run with TF32 off. The second-to-last line is a JSON
object listing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the port itself: outside a checkout of the repo this import fails, and
# the script ends before it has looked for a card
import psld_tpu_torch  # noqa: E402,F401

import numpy as np  # noqa: E402
import torch  # noqa: E402

BATCH = 64
SAMPLE_NFE = 100

# (H*W, C, calls per flagship forward) of every GroupNorm and attention
GN_CALLS = [(1024, 128, 1), (1024, 256, 27), (1024, 384, 1), (1024, 512, 8),
            (256, 256, 38), (256, 512, 9), (64, 256, 32), (64, 512, 9)]
ATTN_CALLS = [(256, 256, 9), (64, 256, 1)]
GN_PER_FWD = sum(n for _, _, n in GN_CALLS)
ATTN_PER_FWD = sum(n for _, _, n in ATTN_CALLS)

# the flagship option set of psld_tpu/eval/bench.py
FLAGSHIP_ARGS = [
    "+dataset=cifar10/cifar10_psld",
    "dataset.diffusion.data.root=/unused",
    "dataset.diffusion.model.score_fn.nf=128",
    "dataset.diffusion.model.score_fn.ch_mult=[2,2,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=8",
    "dataset.diffusion.model.score_fn.attn_resolutions=[16]",
    "dataset.diffusion.model.score_fn.dropout=0.15",
    "dataset.diffusion.model.score_fn.progressive_input=residual",
    "dataset.diffusion.model.score_fn.fir=True",
    "dataset.diffusion.model.score_fn.embedding_type=fourier",
    "+dataset.diffusion.model.score_fn.gn_bf16=True",
    "dataset.diffusion.model.sde.nu=4.02",
    "dataset.diffusion.model.sde.gamma=0.02",
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
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
    build.load("attention.cu")
    say(f"[build] nvcc sm_90a: attention.cu in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {src}: {line.strip()}")


def phase_gn(card):
    from psld_tpu_torch.ops import group_norm_act, group_norm_act_plain

    rng = np.random.default_rng(0)
    rows, errs = [], {}
    kernel_fwd = plain_fwd = 0.0
    t0 = time.perf_counter()
    for hw, c, calls in GN_CALLS:
        s = int(round(hw ** 0.5))
        g = min(c // 4, 32)
        x32 = torch.from_numpy((rng.standard_normal((BATCH, s, s, c)) * 2.0
                                + 0.5).astype(np.float32)).cuda()
        sc32 = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        bi32 = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
            np.float32)).cuda()
        acts = ["none", "swish"] + (["relu", "elu", "lrelu", "silu"]
                                    if (hw, c) == (1024, 256) else [])
        for act in acts:
            for dt, gn16, tol in ((torch.float32, False, 1e-5),
                                  (torch.bfloat16, False, 1e-2),
                                  (torch.bfloat16, True, 3e-2)):
                x, sc, bi = x32.to(dt), sc32.to(dt), bi32.to(dt)
                set_gn_bf16(gn16)
                got = group_norm_act(x, sc, bi, g, 1e-6, act)
                want = group_norm_act_plain(x, sc, bi, g, 1e-6, act)
                torch.cuda.synchronize()
                err = assert_close(got, want, tol, tol,
                                   f"gn {hw}x{c} {act} {dt} gn_bf16={gn16}")
                mode = f"{str(dt)[6:]}{'+gn_bf16' if gn16 else ''}"
                errs[mode] = max(errs.get(mode, 0.0), err)
        # time the main path's case: bf16, swish, gn_bf16 on
        x, sc, bi = x32.bfloat16(), sc32.bfloat16(), bi32.bfloat16()
        set_gn_bf16(True)
        k_ms = cuda_ms(lambda: group_norm_act(x, sc, bi, g, 1e-6, "swish"))
        p_ms = cuda_ms(lambda: group_norm_act_plain(x, sc, bi, g, 1e-6,
                                                    "swish"))
        kernel_fwd += calls * k_ms
        plain_fwd += calls * p_ms
        gbytes = 2 * x.numel() * x.element_size() / 1e9
        rows.append((hw, c, calls, k_ms, p_ms, gbytes / (k_ms / 1e3)))
    os.environ.pop("PSLD_GN_BF16")
    say(f"[gn] Triton kernel == plain at all {len(GN_CALLS)} shapes, B={BATCH}"
        f" (f32 tol 1e-5; bf16 tol 1e-2; bf16+gn_bf16 tol 3e-2) in "
        f"{time.perf_counter() - t0:.1f} s; max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    say(f"[gn] times: bf16 swish, {card}")
    for hw, c, calls, k_ms, p_ms, gbps in rows:
        say(f"[gn]   HW={hw:5d} C={c:3d} x{calls:2d}/fwd: kernel {k_ms:.4f} ms"
            f" ({gbps:.0f} GB/s read+write), plain {p_ms:.4f} ms")
    say(f"[gn]   per flagship forward ({GN_PER_FWD} calls): kernel "
        f"{kernel_fwd:.3f} ms, plain {plain_fwd:.3f} ms")
    return {"max_abs_err": errs["bfloat16+gn_bf16"], "ms": kernel_fwd,
            "plain_ms": plain_fwd}


def phase_attention(card):
    from psld_tpu_torch.ops import attention, attention_plain

    rng = np.random.default_rng(1)
    rows, errs = [], {}
    kernel_fwd = plain_fwd = 0.0
    for n, c, calls in ATTN_CALLS:
        qkv32 = [torch.from_numpy(rng.standard_normal((BATCH, n, c)).astype(
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
        k_ms = cuda_ms(lambda: attention(q, k, v, scale))
        p_ms = cuda_ms(lambda: attention_plain(q, k, v, scale))
        kernel_fwd += calls * k_ms
        plain_fwd += calls * p_ms
        tflops = BATCH * 4 * n * n * c / (k_ms / 1e3) / 1e12
        rows.append((n, c, calls, k_ms, p_ms, tflops))
    say(f"[attention] CUDA kernel == plain at {len(ATTN_CALLS)} shapes, "
        f"B={BATCH} (f32 tol 1e-5; bf16 tol 1e-2); max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    say(f"[attention] times: bf16, {card}")
    for n, c, calls, k_ms, p_ms, tflops in rows:
        say(f"[attention]   N={n:3d} C={c} x{calls}/fwd: kernel {k_ms:.4f} ms "
            f"({tflops:.1f} TFLOP/s), plain {p_ms:.4f} ms")
    say(f"[attention]   per flagship forward ({ATTN_PER_FWD} calls): kernel "
        f"{kernel_fwd:.3f} ms, plain {plain_fwd:.3f} ms")
    return {"max_abs_err": errs["bfloat16"], "ms": kernel_fwd,
            "plain_ms": plain_fwd}


def reset_counts():
    from psld_tpu_torch.ops import attention, group_norm_act

    group_norm_act.launches = 0
    attention.launches = 0


def counts():
    from psld_tpu_torch.ops import attention, group_norm_act

    return group_norm_act.launches, attention.launches


def flagship_weights(net, seed: int = 0) -> dict:
    """Every parameter N(0, 1) * 0.02 from a numpy seed, in key order."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape))
                                 * 0.02).astype(np.float32))
            for k, v in sorted(net.state_dict().items())}


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
    check((n_gn, n_attn) == (GN_PER_FWD, ATTN_PER_FWD),
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


def phase_sample(card, weights):
    import shutil

    from psld_tpu_torch.cli import sample as sample_cli

    work = os.path.join(REPO, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "flagship_random.pt")
    torch.save({"params": weights, "ema_params": weights, "step": 10**6},
               ckpt)
    out_dir = os.path.join(work, "samples")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches = sample_cli.main(FLAGSHIP_ARGS + [
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.save_path={out_dir}",
        f"dataset.diffusion.evaluation.batch_size={BATCH}",
        f"dataset.diffusion.evaluation.n_samples={BATCH}",
        f"dataset.diffusion.evaluation.n_discrete_steps={SAMPLE_NFE}",
        "+dataset.diffusion.evaluation.bf16=True",
        "+dataset.diffusion.evaluation.device=cuda",
    ])
    wall = time.perf_counter() - t0
    n_gn, n_attn = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = [f for f in os.listdir(os.path.join(out_dir, "images"))
            if f.endswith(".png")]
    check(len(batches) == 1, f"sample drew {len(batches)} batches")
    row = batches[0]
    check(row["samples"] == BATCH and len(pngs) == BATCH,
          f"sample wrote {row['samples']} samples, {len(pngs)} PNGs")
    check(row["nonfinite"] == 0, f"{row['nonfinite']} non-finite values")
    check(row["nfe"] == SAMPLE_NFE, f"sampled with {row['nfe']} NFE")
    check((n_gn, n_attn) == (GN_PER_FWD * SAMPLE_NFE,
                             ATTN_PER_FWD * SAMPLE_NFE),
          f"sampling launched {n_gn} GN and {n_attn} attention kernels for "
          f"{SAMPLE_NFE} NFE")
    ms_nfe = row["seconds"] / SAMPLE_NFE * 1e3
    img_s = BATCH / row["seconds"]
    say(f"[sample] cli.sample: {len(pngs)} PNGs, finite, batch {BATCH}, "
        f"{SAMPLE_NFE}-NFE EM (bf16 net, gn_bf16): {ms_nfe:.2f} ms/NFE, "
        f"{img_s:.3f} img/s at {SAMPLE_NFE} NFE (trajectory "
        f"{row['seconds']:.2f} s, entry point {wall:.2f} s), peak "
        f"{peak_gb:.2f} GB allocated; {card}")
    say(f"[sample] kernel launches in the run: GN {n_gn} "
        f"({GN_PER_FWD}/NFE), attention {n_attn} ({ATTN_PER_FWD}/NFE)")
    return n_gn, n_attn


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from psld_tpu_torch.cli._common import bootstrap

    card = phase_device()
    phase_build()
    gn = phase_gn(card)
    attn = phase_attention(card)
    cfg = bootstrap(FLAGSHIP_ARGS).dataset.diffusion
    weights, _ = phase_net(card, cfg)
    n_gn, n_attn = phase_sample(card, weights)
    basis = (f"bf16, batch {BATCH}: ms summed over the calls of one "
             "flagship forward; max_abs_err of the bf16 kernel against "
             "the plain version (GroupNorm: its gn_bf16 chain)")
    say(json.dumps({"kernels": [
        {"name": "group_norm_act", "route": "triton",
         "source": "psld_tpu_torch/ops/group_norm.py",
         "replaces": "psld_tpu/ops/group_norm.py:67", "launches": n_gn,
         **gn, "basis": basis},
        {"name": "attention", "route": "cuda",
         "source": "psld_tpu_torch/csrc/attention.cu",
         "replaces": "psld_tpu/ops/attention.py:34", "launches": n_attn,
         **attn, "basis": basis},
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
