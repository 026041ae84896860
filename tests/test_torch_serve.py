"""The port's sampler serving (``psld_tpu_torch/serve/``, ``cli.serve``),
on the CPU.

The server runs in a thread on the tiny network of tests/test_serve.py
(16 x 16, nf 8, 4 NFE, batches of 2) and is driven request for request
as the JAX package's server is there; a served request is held bit-equal
to ``cli.sample`` of the same seed and count.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import contextlib
import glob
import os
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from psld_tpu_torch.cli import sample as sample_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_serve.py's tiny network and sampler, on the CPU
TINY = [
    "+dataset=cifar10/cifar10_psld",
    "dataset.diffusion.data.root=/unused",
    "dataset.diffusion.data.name=synthetic",
    "dataset.diffusion.data.image_size=16",
    "dataset.diffusion.model.score_fn.nf=8",
    "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=1",
    "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
    "dataset.diffusion.evaluation.batch_size=2",
    "dataset.diffusion.evaluation.n_discrete_steps=4",
    "dataset.diffusion.evaluation.sample_from=target",
]
CPU = ["+dataset.diffusion.evaluation.device=cpu"]


@contextlib.contextmanager
def socket_dir():
    """A fresh directory in the temporary directory, removed afterwards,
    whose socket path fits AF_UNIX's 108 bytes (pytest's tmp_path can
    exceed them)."""
    with tempfile.TemporaryDirectory(prefix="ps") as d:
        if len(d) > 90:
            raise RuntimeError(f"the temporary directory {d!r} is too long "
                               "for a Unix socket path: set a shorter "
                               "TMPDIR")
        yield d


def compose(args):
    from psld_tpu_torch.cli._common import bootstrap

    return bootstrap(args).dataset.diffusion


def write_checkpoint(path):
    """A checkpoint of the tiny network, seeded init, step 0."""
    from psld_tpu_torch.train import checkpoint as ckpt
    from psld_tpu_torch.train.loop import (build_score_model,
                                           init_score_params)
    from psld_tpu_torch.train.state import init_state, make_optimizer

    cfg = compose(TINY)
    state = init_state(init_score_params(build_score_model(cfg), 0),
                       make_optimizer(cfg.training.optimizer))
    return ckpt.save_checkpoint(os.path.dirname(path),
                                os.path.basename(path), state)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A live server in a thread, on a fresh (untrained) checkpoint."""
    from psld_tpu_torch.serve import request
    from psld_tpu_torch.serve.server import serve_unix

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("serve")
    path = write_checkpoint(str(root / "ckpt"))
    cfg = compose(TINY + CPU + [
        f"dataset.diffusion.evaluation.chkpt_path={path}"])
    ready = threading.Event()
    out: dict = {}
    with socket_dir() as d:
        sock = os.path.join(d, "psld.sock")

        def run():
            out["served"] = serve_unix(
                cfg, sock, ready_callback=lambda svc: ready.set())

        th = threading.Thread(target=run, daemon=True)
        th.start()
        assert ready.wait(timeout=120), "server did not come up"
        yield sock, root, out
        if th.is_alive():
            try:
                request(sock, {"cmd": "shutdown"}, timeout=60)
            except OSError:
                pass
        th.join(timeout=60)
    torch.set_num_threads(n_threads)


def pngs(d):
    return sorted(glob.glob(os.path.join(d, "**", "*.png"), recursive=True))


def test_ping_and_info(served):
    """``info`` has the JAX server's keys (one device: the dispatch is the
    batch)."""
    from psld_tpu.serve.server import SamplerService as JSamplerService
    from psld_tpu_torch.serve import request

    sock, _, _ = served
    assert request(sock, {"cmd": "ping"})["ok"]
    info = request(sock, {"cmd": "info"})
    assert info["ok"] and info["compiled"]
    assert info["sampler"] == "em_sde" and info["n_discrete_steps"] == 4
    assert info["per_dispatch_batch"] == 2 and info["devices"] == 1
    fake = types.SimpleNamespace(
        config=compose(TINY + ["dataset.diffusion.evaluation.chkpt_path=c"]),
        n_steps=4, denoise=True, per_step=2,
        mesh=types.SimpleNamespace(devices=np.zeros(1)), compiled=True)
    assert set(info) == {"ok"} | set(JSamplerService.info(fake))


def test_sample_request_writes_pngs(served):
    from psld_tpu_torch.serve import request

    sock, root, _ = served
    out_dir = str(root / "req1")
    r = request(sock, {"cmd": "sample", "n": 3, "seed": 7, "out": out_dir})
    assert r["ok"] and r["written"] == 3 and r["batches"] == 2
    assert r["out"] == os.path.abspath(out_dir) and r["img_per_s"] > 0
    assert 0 < r["trajectory_s"] and 0 < r["write_s"]
    assert r["trajectory_s"] + r["write_s"] <= r["elapsed_s"]
    assert len(pngs(out_dir)) == 3


def test_sample_larger_than_dispatch_loops(served):
    from psld_tpu_torch.serve import request

    sock, root, _ = served
    out_dir = str(root / "req2")
    n = 2 * 2 + 1  # 2 full dispatches + a partial one, sliced
    r = request(sock, {"cmd": "sample", "n": n, "seed": 8, "out": out_dir})
    assert r["ok"] and r["written"] == n and r["batches"] == 3
    files = pngs(out_dir)
    assert len(files) == n
    assert sum(os.path.basename(f).startswith(f"output_tpu_{r['request_id']}"
                                              "_2_") for f in files) == 1


def test_seed_determinism(served):
    from PIL import Image

    from psld_tpu_torch.serve import request

    sock, root, _ = served
    d1, d2, d3 = (str(root / f"det{i}") for i in range(3))
    request(sock, {"cmd": "sample", "n": 2, "seed": 5, "out": d1})
    request(sock, {"cmd": "sample", "n": 2, "seed": 5, "out": d2})
    request(sock, {"cmd": "sample", "n": 2, "seed": 6, "out": d3})

    def load(d):
        return [np.asarray(Image.open(f)) for f in pngs(d)]

    a, b, c = load(d1), load(d2), load(d3)
    assert len(a) == len(b) == len(c) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any((x != y).any() for x, y in zip(a, c))


def test_bad_request_keeps_serving(served):
    import socket

    from psld_tpu_torch.serve import request

    sock, _, _ = served
    r = request(sock, {"cmd": "sample"})  # missing out dir
    assert not r["ok"] and "out" in r["error"]
    r = request(sock, {"cmd": "nope"})
    assert not r["ok"] and "nope" in r["error"]
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(60)
        s.connect(sock)
        s.sendall(b"not json\n")
        reply = s.recv(65536)
    assert b'"ok": false' in reply
    # a client that connects and leaves without a word
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock)
    assert request(sock, {"cmd": "ping"})["ok"]  # still alive


def test_repeat_requests_same_dir_accumulate(served):
    """Two requests into one out dir must not overwrite each other (the
    writer rank is the per-request id)."""
    from psld_tpu_torch.serve import request

    sock, root, _ = served
    out_dir = str(root / "accum")
    r1 = request(sock, {"cmd": "sample", "n": 2, "seed": 1, "out": out_dir})
    r2 = request(sock, {"cmd": "sample", "n": 2, "seed": 2, "out": out_dir})
    assert r1["ok"] and r2["ok"]
    assert r2["request_id"] == r1["request_id"] + 1
    assert len(pngs(out_dir)) == 4


def test_shutdown(served):
    from psld_tpu_torch.serve import request

    sock, _, out = served
    assert request(sock, {"cmd": "shutdown"})["ok"]
    for _ in range(100):
        if not os.path.exists(sock) and "served" in out:
            break
        time.sleep(0.1)
    assert not os.path.exists(sock)  # the server loop exited, socket gone
    assert out["served"] >= 12


@pytest.mark.parametrize("sampler", [
    [],
    # an adaptive ODE counts its own NFE and logs its mean after sampling
    ["dataset.diffusion.evaluation.sampler.name=adaptive_ode",
     "+dataset.diffusion.evaluation.sampler.rtol=1e-3",
     "+dataset.diffusion.evaluation.sampler.atol=1e-3",
     "+dataset.diffusion.evaluation.sampler.max_steps=3"],
], ids=["em_sde", "adaptive_ode"])
def test_served_request_equals_cli_sample(tmp_path, sampler):
    """A request of n samples seeded s writes exactly what ``cli.sample``
    writes with ``evaluation.seed=s, n_samples=n`` (``save_mode=np``:
    the float samples themselves), a sliced tail batch included."""
    from psld_tpu_torch.serve.server import SamplerService

    path = write_checkpoint(str(tmp_path / "ckpt"))
    args = TINY + CPU + sampler + [
        f"dataset.diffusion.evaluation.chkpt_path={path}",
        "dataset.diffusion.evaluation.save_mode=np"]
    torch.set_num_threads(1)
    svc = SamplerService(compose(args))
    r = svc.sample_to_dir(3, seed=11, out_dir=str(tmp_path / "served"))
    assert r["written"] == 3 and r["request_id"] == 0
    sample_cli.main(args + [
        "dataset.diffusion.evaluation.seed=11",
        "dataset.diffusion.evaluation.n_samples=3",
        f"dataset.diffusion.evaluation.save_path={tmp_path / 'sampled'}"])
    served = sorted(os.listdir(tmp_path / "served" / "images"))
    assert served == sorted(os.listdir(tmp_path / "sampled" / "images"))
    assert len(served) == 3
    for f in served:
        a = np.load(tmp_path / "served" / "images" / f)
        b = np.load(tmp_path / "sampled" / "images" / f)
        assert a.shape == (16, 16, 3) and np.isfinite(a).all()
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("extra,error,match", [
    (["dataset.diffusion.evaluation.sampler.name=bb_ode"] + CPU, ValueError,
     "on-device sampler"),
    (["dataset.diffusion.evaluation.sampler.name=cc_em_sde"] + CPU,
     ValueError, "guided"),
    (["+dataset.diffusion.evaluation.spatial=2"] + CPU, NotImplementedError,
     "one device"),
])
def test_refusals_come_before_the_checkpoint_is_read(tmp_path, extra,
                                                     error, match):
    """bb_ode (a SciPy host loop), a guided sampler and spatial fan-out
    are refused before the (here missing) checkpoint is opened."""
    from psld_tpu_torch.serve.server import SamplerService

    cfg = compose(TINY + extra + [
        f"dataset.diffusion.evaluation.chkpt_path={tmp_path}/none.pt"])
    with pytest.raises(error, match=match):
        SamplerService(cfg)


def test_no_card_no_cpu_fallback(tmp_path):
    """Without ``evaluation.device=cpu`` the server wants the card: with
    none it raises before reading the checkpoint."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from psld_tpu_torch.serve.server import SamplerService

    cfg = compose(TINY + [
        f"dataset.diffusion.evaluation.chkpt_path={tmp_path}/none.pt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplerService(cfg)


_NO_JAX = """
import os, sys, threading
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from test_torch_serve import CPU, TINY, socket_dir, write_checkpoint
from psld_tpu_torch.cli import convert_checkpoint, export_checkpoint, serve
from psld_tpu_torch.serve import request
with socket_dir() as d:
    path = write_checkpoint(d + "/ckpt")
    lit = export_checkpoint.main([path, d + "/ref.ckpt"] + TINY)
    conv = convert_checkpoint.main([lit, d + "/conv.pt"] + TINY)
    sock = os.path.join(d, "s.sock")
    ready = threading.Event()
    th = threading.Thread(target=serve.main, args=(
        ["--socket", sock] + TINY + CPU
        + ["dataset.diffusion.evaluation.chkpt_path=" + conv],
        lambda svc: ready.set()))
    th.start()
    assert ready.wait(120)
    r = request(sock, {{"cmd": "sample", "n": 3, "seed": 1, "out": d + "/o"}})
    print("SERVED", r["written"], r["batches"])
    request(sock, {{"cmd": "shutdown"}})
    th.join(60)
    assert not th.is_alive()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "psld_tpu", "triton"))
print("IMPORTED", bad)
"""


def test_entry_points_import_no_jax():
    """``cli.export_checkpoint``, ``cli.convert_checkpoint`` and
    ``cli.serve`` run end to end in a fresh process (export a port
    checkpoint, convert it back, serve it, one request) and leave no
    ``psld_tpu`` module, nothing of JAX and no Triton in
    ``sys.modules``."""
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(
            tests=os.path.join(REPO, "tests"))],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "SERVED 3 2" in r.stdout, r.stdout
    assert "IMPORTED []" in r.stdout, r.stdout
