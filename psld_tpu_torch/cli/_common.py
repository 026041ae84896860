"""Shared CLI bootstrap: registry, logging, config, process group."""

from __future__ import annotations

import logging
import sys


def _devices(node, found: list) -> list:
    """Every ``device`` set under a ``training`` or ``evaluation`` node of
    the composed config."""
    for key, value in node.items():
        if not hasattr(value, "items"):
            continue
        if key in ("training", "evaluation") and "device" in value:
            found.append(str(value["device"]))
        _devices(value, found)
    return found


def run_device(cfg) -> str:
    """The kind of device the run works on: ``cpu`` when every device
    the config sets is the CPU, else ``cuda`` (the default of every
    entry point)."""
    named = _devices(cfg, [])
    if named and all(d.split(":")[0] == "cpu" for d in named):
        return "cpu"
    return "cuda"


def bootstrap(argv=None):
    """Fill the registry, set up logging, compose the Hydra-style config
    from ``argv`` (default ``sys.argv[1:]``), and join the process group
    when a launcher asks for one (``parallel.distributed``: NCCL for a run
    on cards, gloo for one on the CPU)."""
    import psld_tpu_torch

    psld_tpu_torch.import_modules_into_registry()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from psld_tpu_torch.config import compose
    from psld_tpu_torch.parallel.distributed import maybe_initialize

    cfg = compose(sys.argv[1:] if argv is None else list(argv))
    maybe_initialize(run_device(cfg))
    return cfg
