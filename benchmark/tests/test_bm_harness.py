"""The harness on the CPU: the spec's form, files found by name, the import
rule, the counters at both cells' shapes, whole runs at tiny sizes, and
the check failing on each planted fault and on the control.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import time

import pytest
import torch

from benchmark import counts, harness, tracing
from benchmark.plants import PLANTS
from benchmark.reference.ncsnpp import NCSNpp
from benchmark.run import execute

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keeps_the_contract():
    spec = tiny.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    for group in (names, cells, [m["name"] for m in spec["end_to_end"]
                                 + spec["per_layer"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) \
        == len(cells)
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(tiny.ROOT, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.find_cell(tiny.ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer and all(m["moves"] in reported
                                      for m in cell.per_layer)
    layers = {}
    for m in spec["per_layer"]:
        assert os.path.isfile(os.path.join(tiny.BENCH, "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A later change adds a cell, a configuration and a per-layer metric
    by adding files and entries: the harness finds each by its name."""
    root = tiny.checkout(tmp_path)
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(bench, "configs", "cifar10-psld.json"),
                os.path.join(bench, "configs", "cifar10-psld-b.json"))
    with open(os.path.join(bench, "traffic", "em20-b4.json"), "w") as f:
        json.dump(dict(tiny.TRAFFIC["em1000-b512"], batch=4, nfe=20), f)
    with open(os.path.join(bench, "limits", "cifar10-psld-b.em20-b4.json"),
              "w") as f:
        json.dump({"step_gap": 0.5}, f)
    with open(os.path.join(bench, "metrics", "nfe_count.sample.py"),
              "w") as f:
        f.write("def read(ctx):\n    return float(ctx.units)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(dict(spec["configs"][0], name="cifar10-psld-b",
                                file="benchmark/configs/cifar10-psld-b.json"))
    spec["workloads"].append({"name": "cifar10-psld-b.em20-b4",
                              "config": "cifar10-psld-b",
                              "traffic": "em20-b4", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "nfe_count.sample", "unit": "1",
                              "better": "higher", "source": "device_trace",
                              "layer": "samplers",
                              "moves": "sample_img_per_s",
                              "workloads": ["cifar10-psld-b.em20-b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = harness.find_cell(root, "cifar10-psld-b.em20-b4")
    assert cell.traffic["nfe"] == 20 and cell.limits == {"step_gap": 0.5}
    assert cell.config["name"] == "cifar10-psld-b"
    assert [m["name"] for m in cell.per_layer] == ["nfe_count.sample"]
    read = harness.metric_reader("nfe_count.sample", root)
    assert read(type("Ctx", (), {"units": 3})()) == 3.0


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Whole top-level names: ``psld_tpu_torch`` is the port, ``psld_tpu``
    the JAX package; the reference imports nothing of the port."""
    for dirpath, _, files in os.walk(tiny.BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "psld_tpu_torch" not in tops, path
                assert all(m.startswith("benchmark.reference")
                           for m in _imports(path)
                           if m.split(".")[0] == "benchmark"), path


def test_counts_at_the_cells_shapes():
    """The counters at both cells' shapes; they read the reference's
    calls, so they move only if the reference does."""
    cfg = {c["name"]: json.load(open(os.path.join(tiny.ROOT, c["file"])))
           for c in tiny.spec()["configs"]}
    cifar, celeb = cfg["cifar10-psld"], cfg["celebahq256-psld"]
    assert counts.flops(cifar, 512, False) == 39_130_752_974_848
    assert counts.flops(cifar, 64, False) == 4_891_344_121_856
    assert counts.flops(celeb, 32, True) == 51_155_255_033_856
    assert counts.flops(celeb, 8, True) == 12_788_813_758_464
    assert counts.gn_bytes(cifar, 512, False) == 33_353_260_032
    assert counts.gn_bytes(celeb, 32, True) == 63_980_520_960
    bound = sum(max(f / 989e12, b / 3.35e12)
                for f, b in counts.conv_costs(cifar, 512, False))
    assert bound == pytest.approx(40.7385e-3, rel=1e-5)
    bound = sum(max(f / 989e12, b / 3.35e12)
                for f, b in counts.conv_costs(celeb, 32, True))
    assert bound == pytest.approx(59.7954e-3, rel=1e-5)
    assert sum(1 for c in counts.calls(celeb, 1) if c[0] == "gn") == 109
    assert sum(1 for c in counts.calls(cifar, 1) if c[0] == "gn") == 125
    for c, n in ((cifar, 97_627_910), (celeb, 65_623_338)):
        shapes = NCSNpp(c["model"], c["image_size"]).shapes
        assert sum(torch.Size(s).numel() for s in shapes.values()) == n \
            == c["parameters"]


def _run(root, workload, plant=None, seconds=4.0):
    return execute(root, tiny.Args(workload, seconds=seconds),
                   time.perf_counter(), device="cpu", plant=plant)


@pytest.mark.parametrize("workload", [tiny.SAMPLE, tiny.TRAIN])
def test_a_sound_run_is_correct(tmp_path, workload):
    line = _run(tiny.checkout(tmp_path), workload)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in tiny.spec()[
        "end_to_end"] if "workloads" not in m or workload in m["workloads"]
        } - {"sample_img_per_s", "nfe_ms_p95"}  # CUDA events alone


@pytest.mark.parametrize("plant", sorted(PLANTS["em_sample"]))
def test_sampling_check_fails(tmp_path, plant):
    """Each fault, and the control, in the program's place: the check
    reads it as not correct."""
    line = _run(tiny.checkout(tmp_path), tiny.SAMPLE,
                PLANTS["em_sample"][plant])
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.parametrize("plant", sorted(PLANTS["train"]))
def test_training_check_fails(tmp_path, plant):
    line = _run(tiny.checkout(tmp_path), tiny.TRAIN, PLANTS["train"][plant])
    assert not line["correct"] and line["failed"] > 0


def test_ema_left_unchanged_fails_the_ema_gap_alone(tmp_path):
    line = _run(tiny.checkout(tmp_path), tiny.TRAIN,
                PLANTS["train"]["ema_unchanged"])
    failing = {k for k, c in line["checks"].items()
               if not c["value"] <= c["limit"]}
    assert failing == {"ema_gap"}
    assert line["checks"]["ema_gap"]["value"] == pytest.approx(1.0)


class _Event:
    """A profiler event as ``reduce_events`` reads it."""

    def __init__(self, name, a, b, self_us=0.0, children=(), cuda=False,
                 kernel="kernel"):
        self.name, self.cpu_children = name, list(children)
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.device_type = torch.autograd.DeviceType.CUDA if cuda \
            else torch.autograd.DeviceType.CPU
        self.kernels = [type("K", (), {"name": kernel,
                                       "duration": self_us})()] \
            if self_us else []
        self.device_time_total = self_us + sum(c.device_time_total
                                               for c in self.cpu_children)


def test_conv_time_leaves_out_the_bias_passes():
    """``conv_us`` takes the kernels that the convolution operators launch
    through any operator but the bias's add and sum, once: not the copies
    the profiler hangs on a runtime event."""
    fwd = _Event("aten::convolution", 10, 20, 0.0, [
        _Event("aten::_convolution", 10, 20, 0.0, [
            _Event("aten::cudnn_convolution", 11, 15, 7.0,
                   kernel="sm90_xmma_fprop_implicit_gemm"),
            _Event("Command Buffer Full", 12, 13, 7.0,
                   kernel="sm90_xmma_fprop_implicit_gemm"),
            _Event("aten::add_", 15, 19, 5.0)])])
    bwd = _Event("aten::convolution_backward", 30, 40, 6.0, [
        _Event("aten::sum", 31, 33, 2.0),
        _Event("aten::empty", 33, 34, 0.0)], kernel="nvjet")
    other = _Event("aten::add_", 50, 55, 4.0)
    window = _Event(tracing.WINDOW, 0, 100)
    kernels = [_Event("sm90_xmma_fprop_implicit_gemm", 12, 19, cuda=True),
               _Event("elementwise_kernel", 60, 64, cuda=True)]
    events = [window, fwd] + fwd.cpu_children + \
        fwd.cpu_children[0].cpu_children + [bwd] + bwd.cpu_children + \
        [other] + kernels
    s = tracing.reduce_events(events)
    assert s["conv_us"] == 13.0
    assert s["conv_unnamed_us"] == {"nvjet": 6.0}
    assert s["op_device_us"]["aten::convolution"] == 19.0
    assert s["conv_kernels_us"] == 7 and s["busy_us"] == 11


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    """Both cells as committed, a short window each (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in (tiny.SAMPLE, tiny.TRAIN):
        line = execute(tiny.ROOT, tiny.Args(w, seconds=3.0),
                       time.perf_counter())
        assert line["correct"], line["checks"]
