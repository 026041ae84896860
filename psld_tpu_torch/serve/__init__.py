"""Sampler serving of the port (``psld_tpu/serve``)."""

from psld_tpu_torch.serve.client import request  # noqa: F401
from psld_tpu_torch.serve.server import (SamplerService,  # noqa: F401
                                         serve_unix)
