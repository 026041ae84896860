"""The port's entry points (sampling, SSCS-2M sampling, classifier
training, guided sampling, inpainting, editing, the bench), their files
and log lines, and what they import (CPU)."""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from psld_tpu.eval.writers import SimpleImageWriter as JWriter
from psld_tpu.utils.images import to_uint8 as j_to_uint8
from psld_tpu_torch.cli import class_cond_sample as guided_cli
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.cli import train_clf as train_clf_cli
from psld_tpu_torch.cli import train_sde as train_sde_cli
from psld_tpu_torch.train.checkpoint import latest_checkpoint
from psld_tpu_torch.eval.writers import SimpleImageWriter
from psld_tpu_torch.utils.images import save_as_images
from test_torch_ncsnpp import tiny_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_ncsnpp.py's FLAGSHIP_TINY as config overrides
TINY_ARGS = [
    "dataset.diffusion.data.image_size=16",
    "dataset.diffusion.model.score_fn.nf=16",
    "dataset.diffusion.model.score_fn.ch_mult=[2,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=1",
    "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
    "dataset.diffusion.model.score_fn.dropout=0.15",
    "dataset.diffusion.model.score_fn.fir=true",
    "dataset.diffusion.model.score_fn.embedding_type=fourier",
    "dataset.diffusion.model.score_fn.progressive_input=residual",
    "dataset.diffusion.model.sde.nu=4.02",
    "dataset.diffusion.model.sde.gamma=0.02",
]


@pytest.fixture
def one_thread():
    """The entry points run at tiny shapes here, where PyTorch's
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(d):
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d))


def test_sample_cli_writes_the_jax_writers_files(tmp_path, one_thread):
    """``cli.sample.main`` on a ``.pt`` checkpoint of converted weights:
    5 samples in batches of 2 (the tail batch is drawn full-width and
    sliced), written under the names the JAX package's writer gives."""
    _, _, net = tiny_pair()
    sd = net.state_dict()
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"params": sd, "ema_params": sd, "step": 10**6}, ckpt)
    out = tmp_path / "out"
    batches = sample_cli.main([
        "+dataset=cifar10/cifar10_psld",
        "dataset.diffusion.data.root=/unused", *TINY_ARGS,
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        f"dataset.diffusion.evaluation.save_path={out}",
        "dataset.diffusion.evaluation.n_samples=5",
        "dataset.diffusion.evaluation.batch_size=2",
        "dataset.diffusion.evaluation.n_discrete_steps=3",
        "+dataset.diffusion.evaluation.device=cpu",
    ])
    assert [b["samples"] for b in batches] == [2, 2, 1]
    assert all(b["nfe"] == 3 and b["nonfinite"] == 0 for b in batches)

    ref = tmp_path / "ref"  # the JAX writer, fed batches of the same sizes
    jw = JWriter(str(ref), sample_prefix="tpu", save_mode="np")
    for b_idx, take in enumerate((2, 2, 1)):
        jw.write_batch(np.zeros((take, 16, 16, 6), np.float32), 0, b_idx)
    assert _names(out / "images") == _names(ref / "images")
    assert len(_names(out / "images")) == 5
    for f in os.listdir(out / "images"):
        img = np.asarray(Image.open(out / "images" / f))
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("overrides,error", [
    pytest.param(["+dataset.diffusion.evaluation.spatial=2"], ValueError,
                 id="+dataset.diffusion.evaluation.spatial=2"),
    pytest.param(["+dataset.diffusion.evaluation.num_processes=2",
                  "+dataset.diffusion.evaluation.rank=2"], ValueError,
                 id="+dataset.diffusion.evaluation.num_processes=2"),
])
def test_sample_refuses_what_is_not_ported(overrides, error):
    """Spatial parallelism in one process (it needs a spatial group of
    ranks: ``test_torch_spatial``), and per-rank fan-out with a rank
    outside ``num_processes`` (``test_torch_fanout`` holds the fan-out
    itself): the entry point raises before it loads anything.
    (Correctors are ported: ``test_torch_corrector``.)"""
    with pytest.raises(error):
        sample_cli.main(["+dataset=cifar10/cifar10_psld",
                         "dataset.diffusion.data.root=/unused", *overrides,
                         "dataset.diffusion.evaluation.chkpt_path=/unused"])


def test_png_pixels_match_the_jax_conversion(tmp_path):
    """The standard-library PNG encoder stores exactly the JAX package's
    uint8 conversion, for RGB and gray images."""
    rng = np.random.default_rng(0)
    for c in (3, 1):
        batch = rng.uniform(-1.2, 1.2, (2, 5, 7, c)).astype(np.float32)
        save_as_images(batch, str(tmp_path / f"img{c}"))
        want = j_to_uint8(batch)
        for i in range(2):
            got = np.asarray(Image.open(tmp_path / f"img{c}_{i}.png"))
            np.testing.assert_array_equal(got.reshape(want[i].shape),
                                          want[i])


def test_writer_keeps_only_the_x_half(tmp_path):
    w = SimpleImageWriter(str(tmp_path), sample_prefix="p", path_prefix="q",
                          save_mode="np", is_norm=False)
    w.write_batch(np.ones((1, 4, 4, 6), np.float32), rank=3, batch_idx=4)
    arr = np.load(tmp_path / "q" / "images" / "output_p_3_4_0.npy")
    assert arr.shape == (4, 4, 3)


_IMPORT_ALL = """
import math, os, pkgutil, sys, tempfile
import torch
torch.set_num_threads(1)  # tiny shapes: threads only contend with others
import psld_tpu_torch
for m in pkgutil.walk_packages(psld_tpu_torch.__path__, "psld_tpu_torch."):
    __import__(m.name)
from psld_tpu_torch.cli._common import bootstrap
from psld_tpu_torch.cli import (class_cond_sample, edit, fid, inpaint,
                                likelihood, sample, train_clf, train_sde)
from psld_tpu_torch.eval import bench
from psld_tpu_torch.train.checkpoint import latest_checkpoint
bootstrap(["+dataset=cifar10/cifar10_psld"])
tiny, clf, guided, vp = {tiny!r}, {clf!r}, {guided!r}, {vp!r}
with tempfile.TemporaryDirectory() as d:
    state, stats = train_sde.main(tiny + [
        "dataset.diffusion.training.results_dir=" + d + "/results"])
    score = latest_checkpoint(d + "/results/checkpoints")
    batches = sample.main(tiny + [
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "dataset.diffusion.evaluation.save_path=" + d + "/out"])
    batches += sample.main(tiny + [
        "dataset.diffusion.evaluation.sampler.name=sscs2m_sde",
        "dataset.diffusion.evaluation.stride_type=quadratic",
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "dataset.diffusion.evaluation.save_path=" + d + "/sscs"])
    clf_state, _ = train_clf.main(tiny + clf + [
        "dataset.clf.training.results_dir=" + d + "/clf"])
    batches += class_cond_sample.main(tiny + clf + guided + [
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "dataset.clf.evaluation.chkpt_path="
        + latest_checkpoint(d + "/clf/checkpoints"),
        "dataset.diffusion.evaluation.save_path=" + d + "/guided"])
    batches += inpaint.main(tiny + [
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "dataset.diffusion.evaluation.save_path=" + d + "/inpaint"])
    batches += edit.main(tiny + [
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "dataset.diffusion.evaluation.save_path=" + d + "/edit"])
    ode = sample.main(tiny + [
        "dataset.diffusion.evaluation.sampler.name=ei_ode",
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "dataset.diffusion.evaluation.save_path=" + d + "/ode"])
    bpd, nll = likelihood.main(tiny + [
        "dataset.diffusion.evaluation.chkpt_path=" + score,
        "+dataset.diffusion.evaluation.likelihood.n_steps=2",
        "+dataset.diffusion.evaluation.likelihood.solver=heun"])
    vp_state, _ = train_sde.main(vp + [
        "dataset.diffusion.training.results_dir=" + d + "/vp"])
    vp_batches = sample.main(vp + [
        "dataset.diffusion.evaluation.chkpt_path="
        + latest_checkpoint(d + "/vp/checkpoints"),
        "dataset.diffusion.evaluation.save_path=" + d + "/vp_out"])
    scores = fid.main(["--input1", d + "/vp_out/images", "--input2",
                       d + "/out/images", "--kid", "--isc", "--kid-subsets",
                       "2", "--kid-subset-size", "2", "--isc-splits", "2",
                       "--device", "cpu"])
    import numpy as np
    from psld_tpu_torch.utils.images import save_as_images
    for sub in ("male", "female"):
        os.makedirs(d + "/hq/train/" + sub)
        save_as_images(np.zeros((2, 8, 8, 3)), d + "/hq/train/" + sub + "/i")
    folder_state, _ = train_sde.main(tiny + [
        "dataset.diffusion.data.name=celebahq",
        "dataset.diffusion.data.root=" + d + "/hq",
        "dataset.diffusion.training.results_dir=" + d + "/hq_results"])
print("FOLDER", folder_state.step)
print("RAN", state.step, clf_state.step, sum(b["samples"] for b in batches))
print("VP", vp_state.step, [(b["samples"], b["nfe"], b["nonfinite"])
                            for b in vp_batches])
print("FID", sorted(scores), all(math.isfinite(v) for v in scores.values()))
print("ODE", [(b["samples"], b["nfe"], b["nonfinite"]) for b in ode])
print("NLL", [(b["samples"], b["nfe"], b["nonfinite"]) for b in nll],
      bpd == nll[0]["bits_per_dim"] and math.isfinite(bpd))
os.environ.update(PSLD_BENCH_NF="8", PSLD_BENCH_TRAIN_BATCH="1")
bench.TRAIN_TIMED = 1  # one timed step: the line, not its precision
line = bench.run_bench(batch=1, nfe=2, device="cpu")
print("BENCH", len(line), line["device"])
from psld_tpu_torch.models import legacy_layers, normalization
from psld_tpu_torch.utils import legacy
block = legacy_layers.ConditionalResidualBlock(
    4, 8, len(legacy.get_sigmas(0.01, 1.0, 3)),
    normalization=normalization.ConditionalInstanceNorm2dPlus)
print("LEGACY", tuple(block(torch.zeros(2, 4, 4, 4),
                            torch.tensor([0, 2])).shape))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "psld_tpu", "triton"))
print("IMPORTED", bad)
"""

# a train of 2 steps and a sample of 2 images, on the CPU, at 8x8
_TINY_RUN = ["+dataset=cifar10/cifar10_psld",
             "dataset.diffusion.data.root=/unused",
             "dataset.diffusion.data.name=synthetic", *TINY_ARGS,
             "dataset.diffusion.data.image_size=8",
             "dataset.diffusion.model.score_fn.nf=8",
             "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
             "dataset.diffusion.model.score_fn.attn_resolutions=[4]",
             "+dataset.diffusion.model.score_fn.dropout_impl=hw",
             "dataset.diffusion.training.batch_size=256",
             "dataset.diffusion.training.epochs=1",
             "+dataset.diffusion.training.device=cpu",
             "dataset.diffusion.evaluation.n_samples=2",
             "dataset.diffusion.evaluation.batch_size=2",
             "dataset.diffusion.evaluation.n_discrete_steps=3",
             "dataset.diffusion.evaluation.sample_from=source",
             "+dataset.diffusion.evaluation.device=cpu"]
# the shipped classifier's options at 8x8 and nf 8: 2 steps of batch 256
_CLF_RUN = ["dataset.clf.data.root=/unused",
            "dataset.clf.data.name=synthetic",
            "dataset.clf.data.image_size=8",
            "dataset.clf.model.clf_fn.n_cls=10",
            "dataset.clf.model.clf_fn.nf=8",
            "dataset.clf.model.clf_fn.ch_mult=[1,2]",
            "dataset.clf.model.clf_fn.num_res_blocks=1",
            "dataset.clf.model.clf_fn.attn_resolutions=[4]",
            "+dataset.clf.model.clf_fn.dropout_impl=hw",
            "dataset.clf.training.batch_size=256",
            "dataset.clf.training.epochs=1",
            "+dataset.clf.training.device=cpu"]
# the VP-SDE baseline's options at 8x8 and nf 8: 2 steps of batch 256,
# then 3-NFE EM, as _TINY_RUN
_VP_RUN = ["+dataset=cifar10/cifar10_vpsde",
           "dataset.diffusion.data.root=/unused",
           "dataset.diffusion.data.name=synthetic",
           "dataset.diffusion.data.image_size=8",
           "dataset.diffusion.model.score_fn.nf=8",
           "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
           "dataset.diffusion.model.score_fn.num_res_blocks=1",
           "dataset.diffusion.model.score_fn.attn_resolutions=[4]",
           "+dataset.diffusion.model.score_fn.dropout_impl=hw",
           *_TINY_RUN[-8:]]
# guided EM, two labels over two batches of 2
_GUIDED_RUN = ["dataset.diffusion.evaluation.sampler.name=cc_em_sde",
               "dataset.diffusion.evaluation.n_samples=4",
               "dataset.clf.evaluation.label_to_sample=1,4"]


def test_importing_the_port_pulls_in_no_jax():
    """Every module of the port imported in a fresh process, a config
    composed by ``bootstrap``, and a tiny run of each entry point
    (``cli.train_sde``, ``cli.sample`` with EM, SSCS-2M and ``ei_ode``,
    ``cli.train_clf``, ``cli.class_cond_sample``, ``cli.inpaint``,
    ``cli.edit``, ``cli.likelihood`` (two Heun steps, one batch of 2),
    the bench on the CPU at width 8, a VP-SDE ``cli.train_sde`` and
    ``cli.sample``, ``cli.fid`` (KID and ISC, random Inception
    weights) on the samples, ``cli.train_sde`` from a CelebA-HQ folder
    of PNGs, read through the native codec, and a conditional NCSNv2
    residual block of the legacy modules) leave no module
    named ``psld_tpu`` or ``psld_tpu.*``, nothing of JAX and no Triton in
    ``sys.modules``."""
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(
            tiny=_TINY_RUN, clf=_CLF_RUN, guided=_GUIDED_RUN, vp=_VP_RUN)],
        cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "RAN 2 2 12" in r.stdout, r.stdout
    assert "ODE [(2, 3, 0)]" in r.stdout, r.stdout
    assert "NLL [(2, 4, 0)] True" in r.stdout, r.stdout
    assert "BENCH 18 cpu" in r.stdout, r.stdout
    assert "VP 2 [(2, 3, 0)]" in r.stdout, r.stdout
    assert ("FID ['inception_score_mean', 'inception_score_std', "
            "'kernel_inception_distance_mean', "
            "'kernel_inception_distance_std'] True") in r.stdout, r.stdout
    assert "FOLDER 1" in r.stdout, r.stdout
    assert "LEGACY (2, 8, 4, 4)" in r.stdout, r.stdout
    assert "IMPORTED []" in r.stdout, r.stdout


def test_a_distributed_worker_imports_no_jax(tmp_path):
    """The same check in the ranks of a process group: two gloo workers
    of ``cli.train_sde`` (tests/test_torch_parallel.py's, joined through
    ``bootstrap`` under ``PSLD_MULTIHOST=1``; one epoch of 2 steps at
    8x8, 128 images a rank) each leave nothing of JAX and no module of
    ``psld_tpu`` in ``sys.modules``."""
    from test_torch_parallel import TRAIN_RUN, launch, line

    args = [a for a in TRAIN_RUN if "epochs=" not in a
            and "batch_size=" not in a] + [
        "dataset.diffusion.training.epochs=1",
        "dataset.diffusion.training.batch_size=128",
        f"dataset.diffusion.training.results_dir={tmp_path / 'results'}"]
    outs = launch(tmp_path, "train", {"min_size": 256, "kill_rank": -1,
                                      "train_args": args})
    assert [line(out, "TRAINED")["step"] for out in outs] == [2, 2]
    assert all("IMPORTED []" in out for out in outs)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: the smoke exits non-zero and prints no result,
    from the repo and from a directory holding only the script."""
    alone = tmp_path / "alone"
    alone.mkdir()
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (alone / "chip_smoke.py").write_text(f.read())
    runs = [subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=cwd,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for cwd in (REPO, alone)]
    for r in runs:
        out, _ = r.communicate(timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in out


def _pngs(d):
    return sorted(f for f in os.listdir(d / "images") if f.endswith(".png"))


def test_train_clf_then_guided_and_sscs2m_sampling(tmp_path, caplog,
                                                   one_thread):
    """A tiny ``cli.train_clf`` on synthetic labelled data writes a
    classifier checkpoint and its sidecar; ``cli.class_cond_sample`` loads
    it beside a score checkpoint and writes each batch under its label's
    prefix; ``cli.sample`` with SSCS-2M writes its images. Both trainers
    name the TPU-only keys they were given in one log line; ``prefetch``
    and ``profile_dir`` are honoured, not named (a trace is written)."""
    caplog.set_level("INFO")
    state, stats = train_sde_cli.main(_TINY_RUN + [
        f"dataset.diffusion.training.results_dir={tmp_path}/score",
        "+dataset.diffusion.training.steps_per_dispatch=4",
        f"+dataset.diffusion.training.profile_dir={tmp_path}/trace"])
    assert len(os.listdir(tmp_path / "trace")) == 1
    score = latest_checkpoint(f"{tmp_path}/score/checkpoints")
    clf_state, clf_stats = train_clf_cli.main(_TINY_RUN + _CLF_RUN + [
        f"dataset.clf.training.results_dir={tmp_path}/clf",
        "+dataset.clf.training.prefetch=2",
        "+dataset.clf.training.optimizer.flatten=true"])
    lines = [r.getMessage() for r in caplog.records
             if "accepted and ignored" in r.getMessage()]
    assert lines == [
        "accepted and ignored (TPU-only, no effect in the port): "
        "training.steps_per_dispatch=4",
        "accepted and ignored (TPU-only, no effect in the port): "
        "clf.training.optimizer.flatten=True"]
    assert clf_state.step == 2 and len(clf_stats) == 2
    assert all(np.isfinite(r["loss"]) and 0 <= r["top1"] <= 1
               for r in clf_stats)
    clf = latest_checkpoint(f"{tmp_path}/clf/checkpoints")
    assert os.path.basename(clf).startswith("clf-psld-epoch=0000-loss=")
    assert os.path.exists(clf + ".meta.json")
    saved = torch.load(clf, weights_only=True)
    assert saved["step"] == 2 and "Dense_2.weight" in saved["params"]

    batches = guided_cli.main(_TINY_RUN + _CLF_RUN + _GUIDED_RUN + [
        f"dataset.diffusion.evaluation.chkpt_path={score}",
        f"dataset.clf.evaluation.chkpt_path={clf}",
        f"dataset.diffusion.evaluation.save_path={tmp_path}/guided"])
    assert [(b["label"], b["samples"], b["nonfinite"]) for b in batches] \
        == [(1, 2, 0), (4, 2, 0)]
    assert _pngs(tmp_path / "guided") == [
        "output_tpuy1_0_0_0.png", "output_tpuy1_0_0_1.png",
        "output_tpuy4_0_1_0.png", "output_tpuy4_0_1_1.png"]

    batches = sample_cli.main(_TINY_RUN + [
        "dataset.diffusion.evaluation.sampler.name=sscs2m_sde",
        "dataset.diffusion.evaluation.stride_type=quadratic",
        f"dataset.diffusion.evaluation.chkpt_path={score}",
        f"dataset.diffusion.evaluation.save_path={tmp_path}/sscs"])
    assert [(b["samples"], b["nfe"], b["nonfinite"]) for b in batches] \
        == [(2, 3, 0)]
    assert len(_pngs(tmp_path / "sscs")) == 2


@pytest.mark.parametrize("entry,sampler", [("guided", "em_sde"),
                                           ("sample", "cc_em_sde"),
                                           ("guided", "ei_ode"),
                                           ("sample", "cc_ei_ode")])
def test_guided_and_unguided_entry_points_refuse_each_others_sampler(
        entry, sampler):
    argv = _TINY_RUN + _CLF_RUN + [
        f"dataset.diffusion.evaluation.sampler.name={sampler}",
        "dataset.diffusion.evaluation.chkpt_path=/unused",
        "dataset.clf.evaluation.chkpt_path=/unused"]
    main = guided_cli.main if entry == "guided" else sample_cli.main
    with pytest.raises(ValueError, match="guided"):
        main(argv)
