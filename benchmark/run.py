"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. With ``--trace
0`` the line's metrics are the cell's end-to-end metrics; with ``--trace
1`` a few units of work before the window are traced with
``torch.profiler`` and the metrics are the cell's per-layer ones. Every
run checks what its window produced against the plain float32 reference;
the numbers compared, each with its limit, are the last lines on standard
error and the last key of the line. Without as many CUDA devices as the
cell asks for, or with JAX or the JAX package loaded, it prints no line
and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this folder heads the path: its modules must not stand
# in for top-level ones
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402


def _caches(root: str) -> None:
    """Every build and kernel cache at a fixed directory of the checkout
    (the port's nvcc builds go to ``build/kernels`` by themselves)."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("PSLD_GN_BF16", None)  # the configuration decides


class Run:
    """What a traffic kind gets: the cell, the arguments, and the
    services every kind uses."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, t0: float, plant=None):
        import torch

        self.torch = torch
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t0 = t0
        self._plant = plant
        self._setup_peak = 0

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def stage(self, what: str) -> None:
        """Log how far set-up has come."""
        self.log(f"{time.perf_counter() - self.t0:8.3f} s  {what}")

    def plant(self, *objects):
        """A fault or the control (``benchmark/plants.py``) put in the
        program's place; none in a real run."""
        return self._plant(self, *objects) if self._plant else None

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def setup_done(self) -> float:
        """Set-up ends: the seconds since the process started; the memory
        peak so far is kept and the window's starts afresh."""
        self.sync()
        if self.device.type == "cuda":
            self._setup_peak = self.torch.cuda.max_memory_allocated(
                self.device)
            self.torch.cuda.reset_peak_memory_stats(self.device)
        return time.perf_counter() - self.t0

    def memory_peak(self) -> tuple:
        """(window peak, set-up peak) in bytes; zeros on the CPU."""
        if self.device.type != "cuda":
            return 0, 0
        return (int(self.torch.cuda.max_memory_allocated(self.device)),
                int(self._setup_peak))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def _readers(cell, root):
    from benchmark import harness

    return {m["name"]: harness.metric_reader(m["name"], root)
            for m in cell.per_layer}


def execute(root: str, args, t0: float, device=None, plant=None) -> dict:
    """The result line of one run (see the module's docstring); ``device``
    defaults to the card, and without enough cards this raises."""
    import torch

    from benchmark import harness

    cell = harness.find_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise SystemExit(
                f"{cell.name} needs {cell.chips} CUDA device(s); this "
                f"machine has {torch.cuda.device_count()}: no result")
        device = "cuda"
    readers = _readers(cell, root) if args.trace else {}
    rc = Run(cell, args.seed, args.seconds, args.trace, device, t0, plant)
    out = harness.kind_module(cell.kind).run(rc)
    peak_window, peak_setup = out["memory_peak_bytes"]
    correct = harness.judge(out["checks"])
    metrics = {}
    if args.trace:
        ctx = harness.Reading(cell, out, rc.device)
        for m in cell.per_layer:
            v = readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out)
        values["peak_mem_gib"] = peak_window / 2 ** 30
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = rc.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": max(peak_window, peak_setup)}
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_info}
    if args.trace and out.get("trace"):
        from benchmark.tracing import breakdown

        s = out["trace"]
        ops = s["op_device_us"]
        aten = ops.get("aten::convolution", 0.0) \
            + ops.get("aten::convolution_backward", 0.0)
        rc.log(f"convolutions' device time in the trace: the operators' own "
               f"kernels {s['conv_us'] / 1e3:.3f} ms (read by conv_roofline), "
               f"with their bias passes {aten / 1e3:.3f} ms, cuDNN's kernels "
               f"by name {s['conv_kernels_us'] / 1e3:.3f} ms; the operators' "
               f"kernels the names miss: "
               + "; ".join(f"{n[:100]} {us / 1e3:.3f} ms" for n, us in sorted(
                   s["conv_unnamed_us"].items(), key=lambda kv: -kv[1])[:4]))
        device_info["busy_s"] = s["busy_us"] / 1e6
        device_info["window_s"] = s["window_us"] / 1e6
        line["breakdown"] = breakdown(s)
    rc.log(f"window {out['window_s']:.3f} s, {out['attempted']} units, "
           f"set-up {out['setup_s']:.3f} s; "
           + ", ".join(f"{k} {v}" for k, v in sorted(out.items())
                       if k in ("nfe_ms_median", "nfe_ms_p95")))
    line["checks"] = harness.checks_line(out["checks"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    line = execute(ROOT, args, T0)
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] refused: the process holds {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"[bench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[bench] correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
