"""A checkout of the benchmark at tiny sizes, for the CPU tests: the real
configurations with the widths and depth cut, small traffic mixes, and the
real limits and metric readers."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SAMPLE, TRAIN = "cifar10-psld.em1000-b512", "celebahq256-psld.train-b32"

TINY_MODEL = {"nf": 16, "ch_mult": [1, 2, 2], "num_res_blocks": 1,
              "attn_resolutions": [8]}
TRAFFIC = {
    "em1000-b512": {"kind": "em_sample", "batch": 6, "nfe": 40,
                    "eval_eps": 0.001, "warmup_nfe": 3, "tail_nfe": [4, 8],
                    "check": {"rows": 4, "random": 2, "within": 12},
                    "trace": {"absorb": 1, "units": 2}},
    "train-b32": {"kind": "train", "batch": 4, "check_steps": 3,
                  "reference_rows": 2, "trace": {"absorb": 1, "units": 1}},
}


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def checkout(tmp) -> str:
    """A root with ``BENCHMARK.json`` and the benchmark's data files, the
    configurations cut to 16x16 images and tiny widths."""
    root = str(tmp)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for sub in ("limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub),
                        os.path.join(root, "benchmark", sub))
    os.makedirs(os.path.join(root, "benchmark", "configs"))
    os.makedirs(os.path.join(root, "benchmark", "traffic"))
    for c in spec()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["image_size"] = 16
        cfg["model"].update(TINY_MODEL)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name, t in TRAFFIC.items():
        with open(os.path.join(root, "benchmark", "traffic",
                               name + ".json"), "w") as f:
            json.dump(t, f)
    return root


class Args:
    def __init__(self, workload, seed=7, seconds=1.0, trace=0):
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace
