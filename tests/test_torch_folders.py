"""The port's native PNG codec, image-folder datasets and one CelebA-HQ
layout training step against the JAX package (CPU).

The codec's reader is held bit for bit to ``psld_tpu.native``'s on the
same files and raises on the same corrupt or unsupported ones; each
folder dataset gives the JAX package's paths, arrays and labels through
the native path (PNGs at size) and the resize path (Pillow); one float32
step of a tiny network of ``celebahq256_psld``'s layout, reading its batch
from a PNG folder through both packages with the flax weights converted,
gives the loss within 1e-5 relative and every gradient within 1e-4 of
its scale.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from psld_tpu import native as jnative
from psld_tpu.config import compose as j_compose
from psld_tpu.data import datasets as jdatasets
from psld_tpu.losses.score import PSLDScoreLoss as JLoss
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch import native
from psld_tpu_torch.cli._common import bootstrap
from psld_tpu_torch.data import datasets
from psld_tpu_torch.data.loader import get_dataset
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              load_flax_params)
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.sde.psld import PSLD
from test_torch_loss import jax_draws
from test_torch_ncsnpp import jit_o0, random_flax_params


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _png(path, ihdr, idat=b"", extra=b""):
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                + _chunk(b"IDAT", zlib.compress(idat)) + _chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """PNGs of every kind the reader takes, written by Pillow (all five
    row filters, palette, gray, gray+alpha, RGBA) and by both writers."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (4, 9, 11, 3), np.uint8)
    files = {}
    native.write_png_batch(rgb, str(d / "port"))
    jnative.write_png_batch(rgb, str(d / "jax"))
    files["rgb"] = [str(d / f"port_{i}.png") for i in range(4)]
    smooth = (np.add.outer(np.arange(9), np.arange(11))[..., None]
              * np.array([3, 5, 7])).astype(np.uint8)
    Image.fromarray(smooth).save(d / "filtered.png", optimize=True)
    Image.fromarray(rgb[0]).convert("P").save(d / "palette.png")
    Image.fromarray(rgb[0, ..., 0]).save(d / "gray.png")
    Image.fromarray(rgb[0, ..., :2].copy(), "LA").save(d / "gray_alpha.png")
    Image.fromarray(np.concatenate([rgb[0], rgb[1, ..., :1]], -1),
                    "RGBA").save(d / "rgba.png")
    for k in ("filtered", "palette", "gray", "gray_alpha", "rgba"):
        files[k] = [str(d / f"{k}.png")]
    return d, rgb, files


def test_writer_bytes_equal_the_jax_writer(pngs):
    d, rgb, _ = pngs
    for i in range(4):
        assert open(d / f"port_{i}.png", "rb").read() == \
            open(d / f"jax_{i}.png", "rb").read()
    assert np.array_equal(np.asarray(Image.open(d / "port_2.png")), rgb[2])


@pytest.mark.parametrize("kind", ["rgb", "filtered", "palette", "gray",
                                  "gray_alpha", "rgba"])
def test_reader_matches_jax_bit_for_bit(pngs, kind):
    _, _, files = pngs
    for path in files[kind]:
        info = native.read_png_info(path)
        assert info == jnative.read_png_info(path)
        got = native.read_png_batch([path], *info)[0]
        assert got.dtype == np.uint8 and np.array_equal(
            got, jnative.read_png(path))
    h, w, c = native.read_png_info(files[kind][0])
    got = native.read_png_batch(files[kind], h, w, c, threads=2)
    assert np.array_equal(got, jnative.read_png_batch(files[kind], h, w, c))


def test_reader_raises_where_jax_raises(tmp_path, pngs):
    """16-bit and interlaced PNGs and a transparency chunk: UnsupportedPng;
    a file that is no PNG: OSError; a batch of another shape: ValueError;
    both packages alike."""
    deep = str(tmp_path / "deep.png")
    _png(deep, struct.pack(">IIBBBBB", 8, 8, 16, 0, 0, 0, 0), bytes(136))
    laced = str(tmp_path / "laced.png")
    _png(laced, struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1), bytes(64))
    trns = str(tmp_path / "trns.png")
    _png(trns, struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0), bytes(6),
         extra=_chunk(b"tRNS", b"\x00\x00"))
    junk = str(tmp_path / "junk.png")
    with open(junk, "wb") as f:
        f.write(b"not a png at all")
    def read_one(mod, path):
        return mod.read_png_batch([path], *mod.read_png_info(path))[0]

    for mod in (native, jnative):
        for path in (deep, laced, trns):
            with pytest.raises(mod.UnsupportedPng):
                read_one(mod, path)
        with pytest.raises(OSError):
            read_one(mod, junk)
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.read_png_batch(pngs[2]["rgb"], 16, 16, 3)


def test_build_is_named_by_its_source_and_flags(monkeypatch):
    """The library carries a hash of the source and the flags: other
    flags name another file."""
    path = native.build()
    assert os.path.exists(path) and path == native._library()
    assert os.path.dirname(path) == native.BUILD_DIR
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native._library() != path


def _write(dirpath, imgs, names=None, fmt="png"):
    os.makedirs(dirpath, exist_ok=True)
    for i, img in enumerate(imgs):
        name = names[i] if names else f"img{i:03d}"
        Image.fromarray(img).save(os.path.join(dirpath, f"{name}.{fmt}"))


LAYOUTS = {
    "celeba64": ("", ),
    "celebahq": ("train/male", "train/female"),
    "afhqv2": ("train/cat", "train/dog", "train/wild"),
}
CLASSES = {"celeba64": datasets.CelebADataset,
           "celebahq": datasets.CelebAHQDataset,
           "afhqv2": datasets.AFHQv2Dataset}
J_CLASSES = {"celeba64": jdatasets.CelebADataset,
             "celebahq": jdatasets.CelebAHQDataset,
             "afhqv2": jdatasets.AFHQv2Dataset}


@pytest.mark.parametrize("path", ["native", "resize", "jpeg"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_folder_dataset_matches_jax(tmp_path, name, path):
    """Paths, sort order, arrays (``batch`` and single items) and labels
    equal to the JAX package's: PNGs at size through the native codec,
    PNGs of another size and JPEGs through Pillow's bilinear resize."""
    size = 8
    rng = np.random.default_rng(1)
    src = size if path == "native" else 12
    for j, sub in enumerate(LAYOUTS[name]):
        n = 3 + j
        # names out of order on disk: the datasets sort them
        names = [f"{c}{j}" for c in "cab"[:n]] + [f"z{k}" for k in
                                                  range(n - 3)]
        _write(os.path.join(tmp_path, sub),
               rng.integers(0, 256, (n, src, src, 3), np.uint8), names,
               fmt="jpg" if path == "jpeg" else "png")
    kw = dict(image_size=size, norm=True)
    if name == "afhqv2":
        kw["return_target"] = True
    ds, jds = CLASSES[name](str(tmp_path), **kw), \
        J_CLASSES[name](str(tmp_path), **kw)
    assert ds.paths == jds.paths and len(ds) == len(jds)
    idxs = np.array([len(ds) - 1, 0, 2, 1])
    got, want = ds.batch(idxs), jds.batch(idxs)
    assert ds.native == (path == "native")
    if name == "afhqv2":
        assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int32
        assert np.array_equal(ds.targets, jds.targets)
        got, want = got[0], want[0]
    assert got.dtype == np.float32 and got.shape == (4, size, size, 3)
    assert np.array_equal(got, want)
    one, jone = ds[1], jds[1]
    if name == "afhqv2":
        assert one[1] == jone[1]
        one, jone = one[0], jone[0]
    assert np.array_equal(one, jone)


def test_registry_builds_the_folder_datasets(tmp_path):
    _write(str(tmp_path / "train" / "male"),
           np.zeros((2, 8, 8, 3), np.uint8))
    _write(str(tmp_path / "train" / "cat"), np.zeros((2, 8, 8, 3), np.uint8))
    for name, cls in CLASSES.items():
        root = tmp_path / "train" / "male" if name == "celeba64" \
            else tmp_path
        cfg = bootstrap(["+dataset=cifar10/cifar10_psld",
                         f"dataset.diffusion.data.root={root}",
                         f"dataset.diffusion.data.name={name}",
                         "dataset.diffusion.data.image_size=8"]
                        ).dataset.diffusion
        assert type(get_dataset(cfg)) is cls
    with pytest.raises(ValueError):
        datasets.CelebAHQDataset(str(tmp_path / "nothing"))


def test_a_mixed_folder_reads_through_pillow(tmp_path, caplog):
    """One image of another size among PNGs at size: the whole folder goes
    to Pillow, decided once from every header and logged with the file
    that decided it, and equals the JAX package's."""
    caplog.set_level("INFO", logger=datasets.__name__)
    rng = np.random.default_rng(2)
    _write(str(tmp_path), rng.integers(0, 256, (3, 8, 8, 3), np.uint8))
    _write(str(tmp_path), rng.integers(0, 256, (1, 12, 12, 3), np.uint8),
           ["zz"])
    ds = datasets.CelebADataset(str(tmp_path), image_size=8)
    jds = jdatasets.CelebADataset(str(tmp_path), image_size=8)
    idxs = np.arange(4)
    assert np.array_equal(ds.batch(idxs), jds.batch(idxs))
    assert ds.native is False
    said = [r.getMessage() for r in caplog.records
            if r.name == datasets.__name__]
    assert len(said) == 1 and "read by Pillow" in said[0] \
        and "zz.png is (h, w, c) (12, 12, 3)" in said[0]


HQ_TINY = [
    "+dataset=celebahq/celebahq256_psld",
    "dataset.diffusion.data.image_size=64",
    "dataset.diffusion.model.score_fn.nf=8",
    "dataset.diffusion.model.score_fn.ch_mult=[1,1,2,2,2]",
    "dataset.diffusion.training.results_dir=/unused",
]


def test_celebahq_layout_training_step_matches_jax(tmp_path):
    """The slice as a whole: ``celebahq256_psld`` cut to nf 8 and ch_mult
    [1,1,2,2,2] at 64 x 64 (attention at 16 x 16, output_skip and
    input_skip, FIR, Fourier embedding, 2 blocks a level kept). A batch
    of two is read from a CelebA-HQ folder of PNGs by both packages'
    datasets through the native codec; the flax weights are converted;
    with the same t and the JAX loss's own draws injected, the float32
    HSM loss agrees within 1e-5 relative and every parameter's gradient
    within 1e-4 of its scale (floored at 1e-3 of the largest gradient, as
    ``test_torch_loss`` holds them)."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (4, 64, 64, 3), np.uint8)
    os.makedirs(tmp_path / "train" / "male")
    os.makedirs(tmp_path / "train" / "female")
    native.write_png_batch(imgs[:2], str(tmp_path / "train" / "male" / "a"))
    native.write_png_batch(imgs[2:], str(tmp_path / "train" / "female" / "b"))
    args = HQ_TINY + [f"dataset.diffusion.data.root={tmp_path}"]
    cfg = bootstrap(args).dataset.diffusion
    jcfg = j_compose(args).dataset.diffusion
    ds, jds = get_dataset(cfg), jdatasets.CelebAHQDataset(
        str(tmp_path), image_size=64)
    idxs = np.array([3, 0])
    x0, jx0 = ds.batch(idxs), jds.batch(idxs)
    assert ds.native and np.array_equal(x0, jx0)

    jnet = JNCSNpp.from_config(jcfg)
    kw = {"image_size": 64, "in_ch": 6}
    params = random_flax_params(jnet, kw, seed=4, scale=0.1)
    net = load_flax_params(NCSNpp.from_config(cfg), params)
    crit, jcrit = PSLDScoreLoss(cfg, PSLD(cfg)), JLoss(jcfg, JPSLD(jcfg))
    t = np.array([0.3, 0.8])
    key = jax.random.PRNGKey(5)
    m0, eps = jax_draws(key, x0.shape)

    def j_loss(p):
        return jcrit(jnp.asarray(jx0), jnp.asarray(t),
                     lambda z, tt: jnet.apply(p, z, tt, train=True,
                                              rngs={"dropout": key}), key)

    want, jgrads = jit_o0(jax.value_and_grad(j_loss), params)
    loss = crit(torch.from_numpy(x0), torch.from_numpy(t),
                lambda z, tt: net(z, tt, train=True),
                eps=torch.from_numpy(eps), m0=torch.from_numpy(m0))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    names = [k for k, p in net.named_parameters() if p.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [p for p in net.parameters() if p.requires_grad])))
    jgrads = flax_to_state_dict(jax.device_get(jgrads), net)
    assert set(jgrads) - set(grads) == {"GaussianFourierProjection_0.W"}
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for k, g in grads.items():
        w = jgrads[k]
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-4 * max(float(w.abs().max()), 1e-3 * scale), err_msg=k)
