"""Tracing, timing and metrics of the training loops
(``psld_tpu/utils/profiling.py``): a wall-clock aggregator per phase, a
JSONL metrics stream, and a ``torch.profiler`` capture bounded to the
first steps of a run.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class StepTimer:
    """Wall-clock totals per named phase (``data``, ``step``, ``ckpt``)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        """Per phase: total seconds, count and mean milliseconds."""
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name]
                                 / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }


class MetricsLogger:
    """Append-only JSONL metrics stream: one header record, then one
    object per logged step. An empty ``path`` writes nothing (a rank
    other than 0)."""

    def __init__(self, path: str):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def _write(self, rec: dict) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def header(self, **fields) -> None:
        self._write({"header": True, "time": time.time(), **fields})

    def log(self, step: int, **metrics) -> None:
        self._write({"step": int(step), "time": time.time(),
                     **{k: float(v) for k, v in metrics.items()}})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class BoundedTrace:
    """A ``torch.profiler`` capture of the first ``n_steps`` steps of a
    loop, written as one Chrome trace into ``log_dir`` (an unbounded
    multi-epoch trace would grow without end in host memory). CPU
    activity always, CUDA activity when ``device`` is a card. An empty
    ``log_dir`` does nothing.

    Usage::

        bt = BoundedTrace(log_dir, n_steps, device)  # starts here
        for ...: step(); bt.maybe_stop(steps_taken)
        ...
        finally: bt.stop()
    """

    def __init__(self, log_dir: str | None, n_steps: int, device="cpu"):
        self.log_dir = log_dir or None
        self.n_steps = int(n_steps)
        self.cuda = str(device).startswith("cuda")
        self.path = None
        self._prof = None
        if self.log_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def maybe_stop(self, step: int) -> bool:
        """Stop once ``step`` reaches the bound; True if it stopped on
        this call."""
        if not self.active or step < self.n_steps:
            return False
        self.stop()
        return True

    def stop(self) -> None:
        """Wait for the device's work, stop, and write the trace (a run
        that ends before the bound writes what it captured)."""
        if not self.active:
            return
        import torch

        prof, self._prof = self._prof, None
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
        prof.export_chrome_trace(self.path)
