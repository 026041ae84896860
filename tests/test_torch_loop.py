"""The port's training-loop remainder against the JAX package (CPU):
``auto_resume`` and ``restore_path=latest`` with the JAX test's step
counts, graceful shutdown on SIGTERM, ``AsyncSaver``, ``prefetch_iter``,
``BoundedTrace`` and per-resblock ``remat``.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import json
import os
import signal
import threading

import pytest
import torch

from psld_tpu.utils.pipeline import prefetch_iter as j_prefetch_iter
from psld_tpu_torch.cli import train_sde as train_cli
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.interrupt import GracefulShutdown
from psld_tpu_torch.train.loop import build_score_model
from psld_tpu_torch.train.state import init_state, make_optimizer
from psld_tpu_torch.train.steps import StepRandom, make_train_step
from psld_tpu_torch.utils.pipeline import prefetch_iter
from psld_tpu_torch.utils.profiling import BoundedTrace, StepTimer
from test_torch_loss import MICRO
from test_torch_train import step_cfg


@pytest.fixture(autouse=True)
def one_thread():
    """The entry points run at tiny shapes here, where PyTorch's
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base_args(results):
    """tests/test_checkpoint.py's run: an epoch of the 512 synthetic
    images is 8 steps there (batch 8 over 8 devices); batch 64 on one
    device gives the same 8."""
    return [
        "+dataset=cifar10/cifar10_psld",
        "dataset.diffusion.data.name=synthetic",
        "dataset.diffusion.data.root=/unused",
        "dataset.diffusion.data.image_size=16",
        "dataset.diffusion.model.score_fn.nf=8",
        "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
        "dataset.diffusion.model.score_fn.num_res_blocks=1",
        "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
        "dataset.diffusion.training.batch_size=64",
        "dataset.diffusion.training.chkpt_interval=1",
        f"dataset.diffusion.training.results_dir={results}",
        "+dataset.diffusion.training.device=cpu",
    ]


def test_restore_path_latest_and_auto_resume(tmp_path, one_thread):
    """``tests/test_checkpoint.py::test_restore_path_latest_and_auto_resume``
    for the port: ``restore_path=latest`` starts fresh without a
    checkpoint (8 steps), a relaunch with more epochs continues (16), and
    ``auto_resume=true`` with the recipe's empty ``restore_path`` does the
    same (24); each run trains only the epochs after the newest
    checkpoint's."""
    base = base_args(tmp_path / "results")
    latest = ["dataset.diffusion.training.restore_path=latest"]
    state, stats = train_cli.main(base + latest + [
        "dataset.diffusion.training.epochs=1"])
    assert state.step == 8 and {r["epoch"] for r in stats} == {0}
    state, stats = train_cli.main(base + latest + [
        "dataset.diffusion.training.epochs=2"])
    assert state.step == 16 and {r["epoch"] for r in stats} == {1}
    state, stats = train_cli.main(base + [
        "dataset.diffusion.training.epochs=3",
        "+dataset.diffusion.training.auto_resume=true"])
    assert state.step == 24 and {r["epoch"] for r in stats} == {2}
    assert stats[0]["step"] == 17


def test_auto_resume_without_a_checkpoint_starts_fresh(tmp_path, caplog,
                                                       one_thread):
    caplog.set_level("INFO")
    state, _ = train_cli.main(base_args(tmp_path) + [
        "dataset.diffusion.training.epochs=1",
        "+dataset.diffusion.training.auto_resume=true",
        "+dataset.diffusion.training.prefetch=0"])
    assert state.step == 8
    assert any("auto_resume=true: no score checkpoint" in r.getMessage()
               for r in caplog.records)


class _SignalAt:
    """Wraps a dataset: sends ``signum`` to this process when the
    ``at``-th batch is read (prefetch 0: on the main thread, before the
    step that batch feeds)."""

    def __init__(self, dataset, at, signum=signal.SIGTERM):
        self.dataset, self.at, self.signum, self.reads = dataset, at, \
            signum, 0

    def __len__(self):
        return len(self.dataset)

    def batch(self, idxs):
        self.reads += 1
        if self.reads == self.at:
            os.kill(os.getpid(), self.signum)
        return self.dataset.batch(idxs)


def test_sigterm_checkpoints_and_the_epoch_is_replayed(tmp_path,
                                                       monkeypatch,
                                                       one_thread):
    """SIGTERM during the third step's batch: the step runs, the loop
    stops at its boundary and writes a checkpoint marked incomplete at
    step 3, and the run returns (the process would exit 0). A relaunch
    with ``auto_resume`` restores step 3 and replays epoch 0 whole, then
    epoch 1: 3 + 16 steps. The handler is gone after the run."""
    assert threading.current_thread() is threading.main_thread()
    from psld_tpu_torch.train import loop

    real = loop.get_dataset
    monkeypatch.setattr(loop, "get_dataset",
                        lambda cfg: _SignalAt(real(cfg), 3))
    args = base_args(tmp_path) + [
        "dataset.diffusion.training.epochs=2",
        "+dataset.diffusion.training.prefetch=0",
        "+dataset.diffusion.training.auto_resume=true"]
    before = signal.getsignal(signal.SIGTERM)
    state, stats = train_cli.main(args)
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 3 and [r["epoch"] for r in stats] == [0] * 3
    path = ckpt.latest_checkpoint(f"{tmp_path}/checkpoints")
    meta = json.load(open(path + ".meta.json"))
    assert meta["epoch"] == 0 and meta["complete"] is False
    assert ckpt.resume_epoch(path) == 0
    assert torch.load(path, weights_only=True)["step"] == 3

    monkeypatch.setattr(loop, "get_dataset", real)
    state, stats = train_cli.main(args)
    assert state.step == 19
    assert [r["epoch"] for r in stats] == [0] * 8 + [1] * 8
    assert stats[0]["step"] == 4


def test_second_sigint_raises_keyboard_interrupt():
    with GracefulShutdown() as stop:
        os.kill(os.getpid(), signal.SIGINT)
        assert stop.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


def _state(value: float, n: int = 3):
    params = {f"w{i}": torch.full((4, 5), value + i) for i in range(n)}
    state = init_state(params, make_optimizer(step_cfg().training.optimizer))
    state.step = int(value)
    return state


def test_async_saver_writes_the_state_of_save(tmp_path, monkeypatch):
    """The state changed in place after ``save()`` (as the next step
    changes it) still writes the values it had at ``save()``; the write
    goes through a temporary name, and while it is in flight the newest
    complete file stays ``latest``, with no sidecar beside the file in
    flight."""
    first = ckpt.save_checkpoint(str(tmp_path), "psld-x-epoch=0001-loss=1",
                                 _state(1.0))
    gate, entered = threading.Event(), threading.Event()
    real_save = torch.save

    def slow_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        entered.set()
        gate.wait(10)
        real_save(obj, path)

    monkeypatch.setattr(ckpt.torch, "save", slow_save)
    state = _state(2.0)
    with ckpt.AsyncSaver() as saver:
        path = saver.save(str(tmp_path), "psld-x-epoch=0002-loss=1", state,
                          meta={"epoch": 2, "complete": True})
        assert entered.wait(10)
        assert not os.path.exists(path + ".meta.json")
        for tree in (state.params, state.ema_params, state.opt_state["mu"]):
            for v in tree.values():
                v.add_(100.0)
        state.step = 99
        assert ckpt.latest_checkpoint(str(tmp_path)) == first
        assert any(f.endswith(".tmp") for f in os.listdir(tmp_path))
        gate.set()
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    assert ckpt.resume_epoch(path) == 3
    raw = torch.load(path, weights_only=True)
    assert raw["step"] == 2
    want = _state(2.0)
    for k, v in want.params.items():
        assert torch.equal(raw["params"][k], v)
        assert torch.equal(raw["ema_params"][k], v)
        assert not raw["opt_state"]["mu"][k].any()


def test_async_saver_close_reraises_once_and_is_idempotent(tmp_path,
                                                          monkeypatch):
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    saver = ckpt.AsyncSaver()
    path = saver.save(str(tmp_path), "psld-x-epoch=0001-loss=1", _state(1.0),
                      meta={"epoch": 1, "complete": True})
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    saver.close()  # the error was raised once; nothing is left to wait for
    assert not os.path.exists(path)
    assert not os.path.exists(path + ".meta.json")
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(RuntimeError):
        saver.save(str(tmp_path), "psld-x-epoch=0002-loss=1", _state(2.0))


class _FailAt:
    """Wraps a dataset: the ``at``-th batch read raises."""

    def __init__(self, dataset, at):
        self.dataset, self.at, self.reads = dataset, at, 0

    def __len__(self):
        return len(self.dataset)

    def batch(self, idxs):
        self.reads += 1
        if self.reads == self.at:
            raise RuntimeError("the loop's own error")
        return self.dataset.batch(idxs)


def test_a_failed_write_does_not_hide_the_loops_error(tmp_path, monkeypatch,
                                                      caplog, one_thread):
    """Epoch 0's checkpoint write fails on the saver's thread, then epoch
    1's second batch raises: the loop's error propagates, the write's is
    logged, the timing summary is still logged, and no sidecar is left
    without its checkpoint."""
    from psld_tpu_torch.train import loop

    def broken(obj, path):
        raise OSError("disk full")

    real = loop.get_dataset
    monkeypatch.setattr(loop, "get_dataset", lambda cfg: _FailAt(real(cfg),
                                                                 10))
    monkeypatch.setattr(ckpt.torch, "save", broken)
    caplog.set_level("INFO")
    with pytest.raises(RuntimeError, match="the loop's own error"):
        train_cli.main(base_args(tmp_path) + [
            "dataset.diffusion.training.epochs=2",
            "+dataset.diffusion.training.prefetch=0"])
    said = [r.getMessage() for r in caplog.records]
    assert "checkpoint write failed" in said
    assert any(m.startswith("timing: ") for m in said)
    assert os.listdir(tmp_path / "checkpoints") == []


def test_async_saver_waits_for_the_write_in_flight(tmp_path):
    """A second ``save()`` waits for the first write; both files hold
    their own states."""
    with ckpt.AsyncSaver() as saver:
        a = saver.save(str(tmp_path), "psld-x-epoch=0001-loss=1", _state(1.0))
        b = saver.save(str(tmp_path), "psld-x-epoch=0002-loss=1", _state(2.0))
    assert torch.load(a, weights_only=True)["step"] == 1
    assert torch.load(b, weights_only=True)["step"] == 2


def test_prefetch_iter_matches_jax_order_errors_and_abandonment():
    """Order and a producer's error as the JAX package's; a consumer that
    stops early stops the producer."""
    items = list(range(37))
    assert list(prefetch_iter(iter(items), depth=3)) == items == list(
        j_prefetch_iter(iter(items), depth=3))

    def failing():
        yield from range(3)
        raise ValueError("bad batch")

    for fn in (prefetch_iter, j_prefetch_iter):
        got = []
        with pytest.raises(ValueError, match="bad batch"):
            for x in fn(failing(), depth=2):
                got.append(x)
        assert got == [0, 1, 2]

    produced, closed = [], threading.Event()

    def endless():
        try:
            i = 0
            while True:
                produced.append(i)
                yield i
                i += 1
        finally:
            closed.set()

    it = prefetch_iter(endless(), depth=2)
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    it.close()
    assert closed.wait(5)
    assert len(produced) <= 4 + 2 + 1


def test_prefetch_run_equals_the_unprefetched_run(tmp_path, one_thread):
    """``training.prefetch=2`` reads the same batches in the same order as
    ``prefetch=0``: two runs end bit-equal."""
    out = {}
    for depth in (0, 2):
        state, stats = train_cli.main(base_args(tmp_path / str(depth)) + [
            "dataset.diffusion.training.epochs=1",
            "dataset.diffusion.training.batch_size=128",
            "+dataset.diffusion.data.hflip=true",
            f"+dataset.diffusion.training.prefetch={depth}"])
        out[depth] = (state, [r["loss"] for r in stats])
    assert out[0][1] == out[2][1] and len(out[0][1]) == 4
    for k, v in out[0][0].params.items():
        assert torch.equal(v, out[2][0].params[k])


def test_bounded_trace_stops_after_n_steps_and_writes_one_trace(tmp_path):
    x = torch.randn(64, 64)
    trace = BoundedTrace(str(tmp_path / "trace"), 2)
    assert trace.active
    stopped = []
    for step in range(1, 6):
        with torch.profiler.record_function(f"step{step}"):
            x = torch.tanh(x @ x)
        stopped.append(trace.maybe_stop(step))
    trace.stop()
    assert stopped == [False, True, False, False, False]
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and trace.path.endswith(files[0])
    events = json.load(open(trace.path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"step1", "step2"} <= names and "step3" not in names
    off = BoundedTrace("", 2)
    assert not off.active and not off.maybe_stop(5)
    off.stop()


def test_step_timer_sums_phases():
    timer = StepTimer()
    for _ in range(3):
        with timer.phase("data"):
            pass
    with timer.phase("step"):
        pass
    s = timer.summary()
    assert s["data"]["count"] == 3 and s["step"]["count"] == 1
    assert set(s["data"]) == {"total_s", "count", "mean_ms"}


@pytest.mark.parametrize("impl", ["hw", "save_mask"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_remat_keeps_the_loss_and_gradients(impl, bf16):
    """Per-resblock recomputation: every resblock runs twice (forward and
    recompute), and the loss and every gradient equal those without it,
    bit for bit, with either dropout (the hash op takes its site's seed
    words again, the saved-mask one replays its generator) and under
    ``bf16`` (the recompute runs on the bf16 copies)."""
    out = {}
    for remat in (False, True):
        cfg = step_cfg()
        cfg.training["bf16"] = bf16
        cfg.training["grad_accum"] = 1
        sde = PSLD(cfg)
        net = NCSNpp(**{**MICRO, "dropout": 0.3, "dropout_impl": impl,
                        "remat": remat})
        calls = []
        # a pre-hook: a recompute stops once it has what the backward
        # needs, before a forward hook would run
        net.ResnetBlockBigGAN_0.register_forward_pre_hook(
            lambda *a: calls.append(1))
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in net.parameters():
                p.normal_(generator=gen).mul_(0.25)
        step, opt = make_train_step(net, sde, PSLDScoreLoss(cfg, sde), cfg)
        state = init_state(dict(net.named_parameters()), opt)
        x = torch.rand(4, 8, 8, 3, generator=gen) * 2 - 1
        state, m = step(state, x, StepRandom(3))
        out[remat] = (float(m["loss"]), dict(state.opt_state["mu"]),
                      len(calls))
    assert out[False][2] == 1 and out[True][2] == 2
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k


def test_training_remat_is_authoritative():
    """``training.remat`` sets the network's flag either way, over
    ``model.score_fn.remat``; absent, the model's key stands."""
    from psld_tpu_torch.cli._common import bootstrap

    args = ["+dataset=cifar10/cifar10_psld",
            "dataset.diffusion.data.root=/unused",
            "dataset.diffusion.model.score_fn.nf=8",
            "dataset.diffusion.model.score_fn.ch_mult=[1]",
            "dataset.diffusion.model.score_fn.num_res_blocks=1"]
    for model, train, want in ((None, None, False), ("true", None, True),
                               ("true", "false", False),
                               (None, "true", True)):
        extra = []
        if model is not None:
            extra.append(f"+dataset.diffusion.model.score_fn.remat={model}")
        if train is not None:
            extra.append(f"+dataset.diffusion.training.remat={train}")
        cfg = bootstrap(args + extra).dataset.diffusion
        assert build_score_model(cfg).remat is want, (model, train)
