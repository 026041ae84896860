"""A bounded ``torch.profiler`` capture of a few steady units of work, and
its reduction to what the per-layer metrics read.

The capture (after ``BoundedTrace`` of ``psld_tpu_torch/utils/profiling.py``)
traces CPU and CUDA activity. One unit runs first and absorbs what the
tracer sets up at its first launches; the window is a ``record_function``
range around the next units, opened and closed on a device sync, so every
kernel of those units falls inside it. The idle share is the union of the
device's spans against the window's wall (as ``scripts/torch_profile_train.py``
takes it)."""

from __future__ import annotations

import re

import torch

WINDOW = "benchmark.window"
# the convolution operators, and the operators they call for the bias
# (the cuDNN path adds it to the output in a pass of its own, and sums the
# output's gradient for its gradient): those passes are not convolution
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
BIAS_PASSES = ("aten::add_", "aten::add", "aten::sum")
# cuDNN's convolution kernels by name (forward, data and weight gradients,
# the grouped direct kernel of the FIR filters): a cross-check of
# ``conv_us``, logged beside it
CONV_KERNEL = re.compile(r"fprop|dgrad|wgrad|conv", re.IGNORECASE)


def _own_kernels(e) -> list:
    """The kernels ``(name, us)`` that operator ``e`` and the ``aten::``
    operators it calls launch, less the subtrees of its bias passes. The
    profiler also lists runtime events among the children (a launch that
    waited for a full queue shows as "Command Buffer Full") and gives them
    copies of their operator's kernels: they are not descended into."""
    out = [(k.name, k.duration) for k in e.kernels]
    for c in e.cpu_children:
        if c.name.startswith("aten::") and c.name not in BIAS_PASSES:
            out += _own_kernels(c)
    return out


def _union(spans):
    """Total length of the union of (start, end) spans, and its pieces."""
    pieces = []
    for a, b in sorted(spans):
        if pieces and a <= pieces[-1][1]:
            pieces[-1][1] = max(pieces[-1][1], b)
        else:
            pieces.append([a, b])
    return sum(b - a for a, b in pieces), pieces


class Traced:
    """``with Traced(device) as tr: absorb(); tr.open(); work(); tr.close()``;
    then ``tr.summary``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.summary = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        return self

    def open(self):
        self._sync()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def close(self):
        self._sync()
        self._range.__exit__(None, None, None)

    def __exit__(self, *exc):
        self.prof.stop()
        if exc[0] is None:
            self.summary = reduce_events(self.prof.events())
        return False


def reduce_events(events) -> dict:
    """What the metrics read, from the profiler's events: the window's
    wall (us), its kernels ``(name, start, end)``, the union of their spans
    (us), the device time of each aten operator the window called, that of
    the convolutions' own kernels (``conv_us``: :data:`CONV_OPS` less their
    bias passes), and the CPU operators (for the idle gaps' labels)."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window")
    w0, w1 = win[-1].time_range.start, win[-1].time_range.end
    kernels, ops, cpu, conv_own = [], {}, [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # the window's own range shows on the device's timeline too
            if e.name != WINDOW and a >= w0 and b <= w1:
                kernels.append((e.name, a, b))
            continue
        if a < w0 or b > w1 or e.name == WINDOW:
            continue
        cpu.append((e.name, a, b))
        if e.name.startswith("aten::"):
            ops[e.name] = ops.get(e.name, 0.0) + e.device_time_total
        if e.name in CONV_OPS:
            conv_own += _own_kernels(e)
    busy, pieces = _union((a, b) for _, a, b in kernels)
    conv = sum(b - a for name, a, b in kernels if CONV_KERNEL.search(name))
    # the convolution operators' kernels that the names above miss
    unnamed = {}
    for name, us in conv_own:
        if not CONV_KERNEL.search(name):
            unnamed[name] = unnamed.get(name, 0.0) + us
    return {"window_us": w1 - w0, "w0": w0, "w1": w1, "kernels": kernels,
            "busy_us": busy, "pieces": pieces, "op_device_us": ops,
            "cpu": cpu, "conv_us": sum(us for _, us in conv_own),
            "conv_kernels_us": conv, "conv_unnamed_us": unnamed}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host operator running where it
    starts; seconds."""
    by_name = {}
    for name, a, b in summary["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [summary["w0"]]
    for a, b in summary["pieces"]:
        edges += [a, b]
    edges.append(summary["w1"])
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    out = []
    for length, at in gaps:
        label, start = "host", None
        for name, a, b in summary["cpu"]:
            if a <= at <= b and (start is None or a >= start):
                label, start = name, a
        out.append([label, length / 1e6])
    return {"device_ops": [[n[:160], v / 1e6] for n, v in ops],
            "idle_gaps": out}
