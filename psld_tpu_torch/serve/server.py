"""Sampler serving (``psld_tpu/serve/server.py``).

``SamplerService`` builds the network, its score function and the
sampler once, through ``eval.generate.build_unguided`` (the set-up of
``cli.sample``), on ``evaluation.device``; it then answers sample
requests of any size through ``cli.sample``'s batch loop
(``eval.generate._run_sampler``): full batches of
``evaluation.batch_size``, a partial last batch drawn full-width and
sliced on the host, batch ``k`` of a request seeded ``s`` drawn from
``batch_generator(s, k, device)``, each batch written before the next is
drawn. A request of ``n`` samples seeded ``s`` therefore equals
``cli.sample`` with ``evaluation.seed=s`` and ``n_samples=n`` on the same
device, bit for bit; its request id goes into the file names, so
requests into one directory never overwrite each other.

``serve_unix`` exposes the service over a Unix domain socket with a
line-delimited JSON protocol:

    {"cmd": "ping"}      -> {"ok": true, "pong": <host time>}
    {"cmd": "info"}      -> {"ok": true, <sampler, steps, batch, ...>}
    {"cmd": "sample", "n": 64, "seed": 1, "out": DIR}
                         -> {"ok": true, "written": 64, "img_per_s": ...}
    {"cmd": "shutdown"}  -> {"ok": true}

Use :func:`psld_tpu_torch.serve.client.request` or any socket client.
``evaluation.nfe_per_dispatch`` is accepted and has no effect, as in
``eval/generate.py``.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
import types

import torch

from psld_tpu_torch.eval import generate

logger = logging.getLogger(__name__)

# warmup draws one batch and writes nothing
_NO_WRITER = types.SimpleNamespace(write_batch=lambda *a, **k: None)


class SamplerService:
    """Checkpoint -> one network and sampler on the device, reused per
    request."""

    def __init__(self, config):
        self.config = config
        ecfg = config.evaluation
        # fail fast -- before loading a 100M-parameter checkpoint
        if str(ecfg.sampler.name) == "bb_ode":
            raise ValueError(
                "serving requires an on-device sampler (em_sde, sscs_sde, "
                "sscs2m_sde, rk_ode, adaptive_ode, ei_ode); bb_ode runs a "
                "SciPy host loop")
        self.sde, self.sampler, self.batch_at, self.device = \
            generate.build_unguided(config)
        self.n_steps = int(ecfg.n_discrete_steps)
        self.per_step = int(ecfg.batch_size)
        self.compiled = False
        self.warmup_s = None
        # monotonically increasing request id, the file names' tag, so
        # repeated requests into the same out dir never overwrite each other
        self._request_id = 0

    def _run(self, n: int, seed: int, writer, file_tag: int) -> list:
        with torch.inference_mode():
            return generate._run_sampler(
                self.config, self.sde, lambda _: self.sampler, writer,
                self.batch_at, self.device, n_samples=n, seed=seed,
                file_tag=file_tag)

    def warmup(self) -> float:
        """Run one batch (it builds the kernels if nothing has yet);
        returns its wall seconds."""
        t0 = time.perf_counter()
        self._run(1, 0, _NO_WRITER, 0)
        self.compiled = True
        self.warmup_s = time.perf_counter() - t0
        return self.warmup_s

    def sample_to_dir(self, n: int, seed: int, out_dir: str) -> dict:
        """Generate n samples into out_dir (``evaluation.save_mode``,
        the writer layout of ``cli.sample``). ``trajectory_s`` and
        ``write_s`` split the request's time between the batches'
        trajectories (with their copies to the host) and their writes."""
        rid = self._request_id
        self._request_id += 1
        t0 = time.perf_counter()
        batches = self._run(n, seed, generate._writer(
            self.config, save_path=out_dir), rid)
        elapsed = time.perf_counter() - t0
        written = sum(b["samples"] for b in batches)
        return {"written": written, "batches": len(batches),
                "request_id": rid,
                "elapsed_s": elapsed,
                "img_per_s": written / elapsed if elapsed else None,
                "trajectory_s": sum(b["seconds"] for b in batches),
                "write_s": sum(b["write_seconds"] for b in batches),
                "out": os.path.abspath(out_dir)}

    def info(self) -> dict:
        ecfg = self.config.evaluation
        return {"sampler": str(ecfg.sampler.name),
                "n_discrete_steps": self.n_steps,
                "denoise": bool(ecfg.denoise),
                "per_dispatch_batch": self.per_step,
                "devices": 1,
                "chkpt_path": str(ecfg.chkpt_path),
                "compiled": self.compiled}


def _handle(svc: SamplerService, req: dict) -> tuple[dict, bool]:
    cmd = req.get("cmd", "sample")
    if cmd == "ping":
        return {"ok": True, "pong": time.time()}, False
    if cmd == "info":
        return {"ok": True, **svc.info()}, False
    if cmd == "shutdown":
        return {"ok": True}, True
    if cmd == "sample":
        n = int(req.get("n", svc.per_step))
        seed = int(req.get("seed", 0))
        out = req.get("out")
        if not out:
            return {"ok": False, "error": "sample requires `out` dir"}, False
        return {"ok": True, **svc.sample_to_dir(n, seed, out)}, False
    return {"ok": False, "error": f"unknown cmd `{cmd}`"}, False


def serve_unix(config, socket_path: str, ready_callback=None) -> int:
    """Run the sampler service on a Unix socket. Blocks until a shutdown
    request; returns the requests served. ``ready_callback(service)``
    runs once the socket listens."""
    svc = SamplerService(config)
    logger.info("warming up the sampler (%s, %d steps)...",
                svc.info()["sampler"], svc.n_steps)
    secs = svc.warmup()
    logger.info("warm in %.1fs; serving on %s", secs, socket_path)

    if os.path.exists(socket_path):
        os.unlink(socket_path)
    served = 0
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as srv:
        srv.bind(socket_path)
        try:
            srv.listen(8)
            if ready_callback is not None:
                ready_callback(svc)
            stop = False
            while not stop:
                conn, _ = srv.accept()
                with conn:
                    # bound the read so a silent client cannot wedge the
                    # single-threaded accept loop
                    conn.settimeout(30.0)
                    buf = b""
                    try:
                        while not buf.endswith(b"\n"):
                            chunk = conn.recv(65536)
                            if not chunk:
                                break
                            buf += chunk
                    except (TimeoutError, ConnectionError):
                        logger.warning("client recv failed; dropping")
                        continue
                    if not buf.strip():
                        continue
                    try:
                        reply, stop = _handle(svc, json.loads(buf.decode()))
                    except Exception as e:  # keep serving on bad requests
                        logger.exception("request failed")
                        reply, stop = {"ok": False, "error": repr(e)}, False
                    try:
                        conn.sendall((json.dumps(reply) + "\n").encode())
                    except OSError:
                        # the client gave up (e.g. a short timeout on a
                        # big job) -- the server and its network survive
                        logger.warning("client disconnected before reply")
                    served += 1
        finally:
            os.unlink(socket_path)
    return served
