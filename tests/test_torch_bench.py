"""The port's benchmark entry, ``psld_tpu_torch.eval.bench`` (CPU).

Its JSON line carries the JAX bench's keys (read from
``psld_tpu/eval/bench.py``'s source), with the two MFU keys renamed for
the H100 and two keys added: ``device`` and ``flops_counted``. Its FLOP count (convolutions and
matrix products through the plain versions, 2 a multiply-add) is linear
in the batch and equals, at the bench's own configuration at width 8,
the ``conv_general_dilated`` and ``dot_general`` FLOPs of the JAX
forward's jaxpr, counted the same way. The JAX forward's FIR upsampling
is a convolution with input dilation; it is counted without the inserted
zeros, per input pixel, the way PyTorch counts the port's transposed
convolution. The test allows 2% and finds no difference
(338,043,584 FLOPs each).
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import ast
import json
import math
import os

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import pytest
import torch

import psld_tpu
from psld_tpu.config import compose as j_compose
from psld_tpu.train.loop import build_score_model as j_build_score_model
from psld_tpu_torch.eval import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"mfu_vs_v5e_bf16_peak": "mfu_vs_h100_bf16_peak",
           "train_mfu_vs_v5e_bf16_peak": "train_mfu_vs_h100_bf16_peak"}


def jax_bench_keys() -> set:
    """The keys ``run_bench`` of the JAX package puts into its line: the
    ``out = {...}`` literal and every ``out["key"] = ...``."""
    with open(os.path.join(REPO, "psld_tpu", "eval", "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_bench")
    keys = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == "out" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(target, ast.Subscript) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id == "out":
                keys.add(target.slice.value)
    return keys


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench at width 8 and train batch 2, on one PyTorch thread."""
    monkeypatch.setenv("PSLD_BENCH_NF", "8")
    monkeypatch.setenv("PSLD_BENCH_TRAIN_BATCH", "2")
    # two timed steps: the line's keys and numbers, not their precision
    monkeypatch.setattr(bench, "TRAIN_TIMED", 2)
    for var in ("PSLD_BENCH_TRAIN", "PSLD_BENCH_F32", "PSLD_GN_BF16"):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_line_has_the_jax_keys(tiny_bench):
    line = bench.run_bench(batch=2, nfe=3, device="cpu")
    want = {RENAMED.get(k, k) for k in jax_bench_keys()} | {
        "device", "flops_counted"}
    assert len(want) == 18
    assert set(line) == want
    json.loads(json.dumps(line))
    assert line["metric"] == "CIFAR-10 img/sec/chip at 3-NFE EM sampling"
    assert line["device"] == "cpu"
    assert line["flops_counted"] == "conv+matmul"
    assert line["baseline_is_estimate"] is True
    assert (line["bf16"], line["gn_bf16"], line["train_bf16"]) == \
        (True, True, True)
    assert line["train_batch"] == 2
    assert line["train_dropout_impl"] == "hw_inline"
    for key in ("value", "vs_baseline", "model_tflops_per_fwd",
                "program_tflops", "mfu_vs_h100_bf16_peak", "train_img_per_s",
                "train_step_tflops", "train_mfu_vs_h100_bf16_peak"):
        assert line[key] > 0 and math.isfinite(line[key]), key
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.25)
    assert line["program_tflops"] == pytest.approx(
        3 * line["model_tflops_per_fwd"])
    assert line["model_tflops_per_fwd"] == pytest.approx(
        2 * bench.count_flops(bench.flagship_config(8, True)) / 1e12)


@pytest.mark.parametrize("train", [False, True])
def test_flop_count_is_linear_in_the_batch(train):
    cfg = bench.flagship_config(8, True, train=train)
    one, two = (bench.count_flops(cfg, b, train=train) for b in (1, 2))
    assert one > 0 and two == 2 * one
    if train:  # a forward and a backward of about twice its cost
        fwd = bench.count_flops(bench.flagship_config(8, True))
        assert 2.9 < one / fwd < 3.1


def _jaxpr_flops(jaxpr) -> int:
    """2 x the multiply-adds of every conv_general_dilated and dot_general
    of ``jaxpr`` and the jaxprs inside its equations."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name != "pallas_call"  # on the CPU attention is jnp
        if name == "conv_general_dilated":
            lhs, rhs = (v.aval for v in eqn.invars[:2])
            out = eqn.outvars[0].aval
            dn = eqn.params["dimension_numbers"]
            taps = math.prod(rhs.shape[d] for d in dn.rhs_spec[2:])
            c_in, c_out = rhs.shape[dn.rhs_spec[1]], rhs.shape[dn.rhs_spec[0]]
            # input dilation: per input pixel, as PyTorch counts a
            # transposed convolution (no inserted zeros)
            shape, spec = ((lhs.shape, dn.lhs_spec)
                           if max(eqn.params["lhs_dilation"]) > 1
                           else (out.shape, dn.out_spec))
            pixels = shape[spec[0]] * math.prod(shape[d] for d in spec[2:])
            total += 2 * pixels * taps * c_in * c_out
        elif name == "dot_general":
            (_, rc), (_, rb) = eqn.params["dimension_numbers"]
            lhs, rhs = (v.aval for v in eqn.invars[:2])
            total += 2 * math.prod(lhs.shape) * math.prod(
                n for d, n in enumerate(rhs.shape) if d not in rc + rb)
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += _jaxpr_flops(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    total += _jaxpr_flops(sub)
    return total


def test_flop_count_matches_the_jax_jaxpr():
    """The bench's sampling configuration at width 8, batch 1."""
    psld_tpu.import_modules_into_registry()
    cfg = j_compose(bench.FLAGSHIP_ARGS + [
        "dataset.diffusion.model.score_fn.nf=8",
        "dataset.diffusion.model.sde.nu=4.02",
        "dataset.diffusion.model.sde.gamma=0.02"]).dataset.diffusion
    net = j_build_score_model(cfg)
    x = jnp.zeros((1, 32, 32, 6), jnp.float32)
    t = jnp.full((1,), 0.5, jnp.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), x, t)
    jaxpr = jax.make_jaxpr(lambda p, xx, tt: net.apply(p, xx, tt))(
        shapes, x, t)
    want = _jaxpr_flops(jaxpr.jaxpr)
    got = bench.count_flops(bench.flagship_config(8, True))
    assert want > 0
    assert abs(got - want) <= 0.02 * want, (got, want)


def test_bench_refuses_to_measure_the_cpu_silently(monkeypatch):
    """No card and no ``device``: the bench raises before it measures
    anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(batch=2, nfe=3)
