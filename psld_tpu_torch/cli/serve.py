"""Sampler serving entry point of the port: load a checkpoint, build the
network and sampler ONCE on ``evaluation.device``, and answer sample
requests over a Unix socket (JSON lines; protocol in
``psld_tpu_torch/serve/server.py``).

Usage::

    python -m psld_tpu_torch.cli.serve --socket /tmp/psld.sock \\
        +dataset=cifar10/cifar10_psld \\
        dataset.diffusion.evaluation.chkpt_path=ckpt.pt <overrides>

    # then, from any process:
    python - <<'PY'
    from psld_tpu_torch.serve import request
    print(request("/tmp/psld.sock",
                  {"cmd": "sample", "n": 64, "seed": 1, "out": "out"}))
    PY

``--socket`` defaults to ``psld.sock`` in the temporary directory.
"""

from __future__ import annotations

import os
import sys
import tempfile


def main(argv=None, ready_callback=None) -> int:
    """Serve until a ``shutdown`` request; returns the requests served.
    ``ready_callback(service)`` runs once the socket listens."""
    argv = list(sys.argv[1:] if argv is None else argv)
    socket_path = os.path.join(tempfile.gettempdir(), "psld.sock")
    if "--socket" in argv:
        i = argv.index("--socket")
        socket_path = argv[i + 1]
        del argv[i:i + 2]

    from psld_tpu_torch.cli._common import bootstrap

    cfg = bootstrap(argv)

    from psld_tpu_torch.serve.server import serve_unix

    return serve_unix(cfg.dataset.diffusion, socket_path,
                      ready_callback=ready_callback)


if __name__ == "__main__":
    main()
