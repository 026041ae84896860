"""The port's sampling entry point, its image files, and what it imports
(CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from psld_tpu.eval.writers import SimpleImageWriter as JWriter
from psld_tpu.utils.images import to_uint8 as j_to_uint8
from psld_tpu_torch.cli import sample as sample_cli
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


def _names(d):
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d))


def test_sample_cli_writes_the_jax_writers_files(tmp_path):
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


@pytest.mark.parametrize("override", [
    "+dataset.diffusion.evaluation.sampler.corrector=langevin",
    "+dataset.diffusion.evaluation.spatial=2",
    "+dataset.diffusion.evaluation.num_processes=2",
])
def test_sample_refuses_what_is_not_ported(override):
    """Correctors and multi-device fan-out are not ported: asked for, the
    entry point raises before it loads anything."""
    with pytest.raises(NotImplementedError):
        sample_cli.main(["+dataset=cifar10/cifar10_psld",
                         "dataset.diffusion.data.root=/unused", override,
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
import pkgutil, sys
import psld_tpu_torch
for m in pkgutil.walk_packages(psld_tpu_torch.__path__, "psld_tpu_torch."):
    __import__(m.name)
from psld_tpu_torch.cli._common import bootstrap
bootstrap(["+dataset=cifar10/cifar10_psld"])
allowed = {"psld_tpu", "psld_tpu.config", "psld_tpu.registry"}
bad = sorted(m for m in sys.modules if m not in allowed and
             m.split(".")[0] in ("jax", "jaxlib", "flax", "psld_tpu",
                                 "triton"))
print("IMPORTED", bad)
"""


def test_importing_the_port_pulls_in_no_jax():
    """Every module of the port, imported in a fresh process, and a config
    composed through the JAX package's jax-free ``psld_tpu.config``, leave
    JAX, the rest of the JAX package and Triton out of ``sys.modules``."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "IMPORTED []" in r.stdout, r.stdout


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
