"""Readings that set the check's limits: for each seed, one run of a cell
with its window for each plant named (``none``: the program as it is; the
others from ``benchmark/plants.py``, put in the program's place), each
judged by the cell's own check; one JSON line a run, with ``correct`` and
every number compared beside its limit.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --plants none,control --seconds <s>

Run on the card, one process for all runs; the benchmark's own runs do
not run it."""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import harness, run  # noqa: E402
from benchmark.plants import PLANTS  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--plants", default="none,control")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run._caches(ROOT)
    kind = harness.find_cell(ROOT, args.workload).kind
    # each run starts with the process's precision flags, as a run of its
    # own would: the check and the control turn TF32 off
    b = torch.backends
    flags = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.plants.split(","):
            b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = flags[:2]
            torch.set_float32_matmul_precision(flags[2])
            plant = None if name == "none" else PLANTS[kind][name]
            a = argparse.Namespace(workload=args.workload, seed=seed,
                                   seconds=args.seconds, trace=0)
            t0 = time.perf_counter()
            line = run.execute(ROOT, a, t0, plant=plant)
            print(json.dumps({"seed": seed, "plant": name,
                              "correct": line["correct"],
                              "attempted": line["attempted"],
                              "seconds": time.perf_counter() - t0,
                              "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
