"""Shared CLI bootstrap: registry, logging, config."""

from __future__ import annotations

import logging
import sys


def bootstrap(argv=None):
    """Fill the registry, set up logging, and compose the Hydra-style
    config from ``argv`` (default ``sys.argv[1:]``)."""
    import psld_tpu_torch

    psld_tpu_torch.import_modules_into_registry()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from psld_tpu.config import compose

    return compose(sys.argv[1:] if argv is None else list(argv))

