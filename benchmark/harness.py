"""Finds a cell's files by the names in ``BENCHMARK.json``, runs the cell's
traffic kind, reads the per-layer metrics, and assembles the result line.

Where things are, under this folder:

- ``configs/<config>.json``: a configuration (see ``program.port_config``);
- ``traffic/<traffic>.json``: a traffic mix; its ``kind`` names the module
  ``kinds/<kind>.py`` that drives it;
- ``limits/<workload>.json``: each number the cell's check compares, with
  its limit;
- ``metrics/<name>.py``: a per-layer metric, a function ``read(ctx)`` that
  returns its value or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys

# top-level module names that no process of the benchmark may hold: JAX
# and the JAX package (the port's name starts with the latter's, so names
# are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "psld_tpu")


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the spec with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(root: str, name: str, spec: dict | None = None) -> Cell:
    """The workload ``name`` of ``root``'s spec, with its configuration,
    traffic mix, limits and metrics."""
    spec = spec or load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = dict(_json(root, configs[w["config"]]["file"]))
    cfg["name"] = w["config"]
    bench = os.path.join(root, "benchmark")
    traffic = _json(bench, os.path.join("traffic", w["traffic"] + ".json"))
    limits = _json(bench, os.path.join("limits", name + ".json"))
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), cfg, traffic, limits, e2e, layer)


def kind_module(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metric_reader(name: str, root: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py`` under ``root``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def checks_line(checks: dict) -> dict:
    """The compared numbers, each with its limit, in the line's form."""
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def judge(checks: dict) -> bool:
    """Correct: there are numbers, and each is at most its limit."""
    return bool(checks) and all(v <= lim for v, lim in checks.values())


# published peaks of the card (NVIDIA's H100 SXM data sheet, dense): bf16
# tensor-core FLOP/s and device-memory bytes/s
PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}


def peaks_of(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


class Reading:
    """What a per-layer metric reads: the cell, the kind's output (its
    ``trace`` summary, ``units`` traced, and the counts of one unit), and
    the card's peaks (None off the card)."""

    def __init__(self, cell: Cell, out: dict, device):
        import torch

        self.cell, self.out = cell, out
        self.trace = out.get("trace")
        self.units = out.get("units")
        self.peaks = peaks_of(torch.cuda.get_device_name(device)) \
            if device.type == "cuda" else None
