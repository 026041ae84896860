"""The benchmark of the PyTorch/CUDA port (``psld_tpu_torch``).

Run one cell from the root of a checkout::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells; configurations, traffic
mixes and per-layer metrics are files here, found by their names.
"""
