"""The port's inpainting and SDEdit editing against the JAX package's
(CPU): the ``ip_em_sde`` and ``edit_em_sde`` trajectories, ``edit_t0``
validation, ``InpaintDataset``'s masks, ``InpaintingImageWriter``'s files,
and the ``cli.inpaint`` / ``cli.edit`` entry points.

Trajectories run on the one-level NCSN++ of ``test_torch_sscs`` with
converted weights, float32, 4 NFE (three noisy rows and the mean-only
denoise). JAX's threefry and PyTorch's generators give different numbers,
so the test regenerates the JAX samplers' draws from their key splits and
hands them to the port by name (``psld_tpu_torch.samplers.sde_samplers``
names them). Tolerance: 1e-4 of the sample's largest magnitude, as for
the EM trajectory of ``test_torch_sampler``. Masks and written arrays are
numpy on both sides and must match bit for bit.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.data.datasets import InpaintDataset as JInpaintDataset
from psld_tpu.data.datasets import SyntheticDataset as JSynthetic
from psld_tpu.eval.writers import InpaintingImageWriter as JInpaintWriter
from psld_tpu.samplers import sde_samplers as jsamplers
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.cli import edit as edit_cli
from psld_tpu_torch.cli import inpaint as inpaint_cli
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.data.datasets import InpaintDataset, SyntheticDataset
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.eval.writers import InpaintingImageWriter
from psld_tpu_torch.samplers import (EditEulerMaruyamaSampler,
                                     EulerMaruyamaInpainter, make_timesteps)
from psld_tpu_torch.sde.psld import PSLD
from test_torch_ncsnpp import assert_close_to_scale, jit_o0
from test_torch_sscs import nano_pair, sde_cfg

B, S, C, EPS = 2, 8, 3, 1e-3
N_STEPS = 4  # evaluation.n_discrete_steps; denoise takes the last one


def cfg_of(name, mode="hsm", edit_t0=None, root="/unused"):
    cfg = sde_cfg(n_steps=N_STEPS, name=name)
    cfg["training"] = {"mode": mode}
    cfg["data"] = {"image_size": S, "root": root}
    cfg["evaluation"]["n_samples"] = 8
    if edit_t0 is not None:
        cfg["evaluation"]["sampler"]["edit_t0"] = edit_t0
    return cfg


def guide(seed=6):
    """Images in [-1, 1] and a binary mask with 1 on the known pixels."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (B, S, S, C)).astype(np.float32)
    mask = np.repeat((rng.random((B, S, S, 1)) < 0.5).astype(np.float32),
                     C, axis=-1)
    return x0, mask


def _jax_run(name, cfg, stride, x0, mask):
    """(draws by the port's names, final sample) of the JAX sampler."""
    jnet, params, _ = nano_pair()
    jcfg = JConfigDict(cfg)
    jsde = JPSLD(jcfg)
    n_eff = N_STEPS - 1
    ts = j_make_timesteps(n_eff, EPS, stride_type=stride)
    names = []
    two_c = (B, S, S, 2 * C)

    def normal(k, shape, name, out):
        names.append(name)
        out.append(jax.random.normal(k, shape, jnp.float32))

    def perturb_draws(k, tag, out):
        k_m, k_eps = jax.random.split(k)
        if cfg["training"]["mode"] == "dsm":
            normal(k_m, x0.shape, tag[0], out)
        normal(k_eps, two_c, tag[1], out)

    def run(p, key, x_0, m):
        names.clear()
        score = lambda zz, tt: jnet.apply(p, zz, tt)  # noqa: E731
        draws = []
        if name == "ip_em_sde":
            sampler = jsamplers.EulerMaruyamaInpainter(jcfg, jsde, score)
            out = sampler.sample(key, (x_0, m), ts, n_eff, denoise=True,
                                 eps=EPS)
            k, k_prior, k_init = jax.random.split(key, 3)
            kx, km = jax.random.split(k_prior)
            normal(kx, x0.shape, "prior_x", draws)
            normal(km, x0.shape, "prior_m", draws)
            perturb_draws(k_init, ("init_m", "init_eps"), draws)
            for i in range(n_eff + 1):
                k, k_step, k_perturb = jax.random.split(k, 3)
                normal(k_step, two_c, i, draws)
                perturb_draws(k_perturb, (("known_m", i), ("known_eps", i)),
                              draws)
        else:
            sampler = jsamplers.EditEulerMaruyamaSampler(jcfg, jsde, score)
            out = sampler.sample(key, x_0, ts, n_eff, denoise=True, eps=EPS)
            k, k_init = jax.random.split(key)
            perturb_draws(k_init, ("init_m", "init_eps"), draws)
            for i in range(n_eff + 1):
                k, sub = jax.random.split(k)
                normal(sub, two_c, i, draws)
        return draws, out

    draws, out = jit_o0(run, params, jax.random.PRNGKey(17),
                        jnp.asarray(x0), jnp.asarray(x0 if mask is None
                                                     else mask))
    return dict(zip(names, (np.array(d) for d in draws))), np.asarray(out)


def _port_run(cls, cfg, stride, batch, draws):
    _, _, net = nano_pair()
    cfg = ConfigDict(cfg)
    sampler = cls(cfg, PSLD(cfg), make_score_fn(net))
    used = []

    def noise(k, like):
        used.append(k)
        assert tuple(like.shape) == draws[k].shape, k
        return torch.from_numpy(draws[k])

    with torch.inference_mode():
        out = sampler.sample(None, batch, make_timesteps(
            N_STEPS - 1, EPS, stride_type=stride), N_STEPS - 1,
            denoise=True, eps=EPS, noise=noise)
    # the denoise row draws no EM noise in the port (JAX multiplies its
    # draw by 0)
    assert sorted(map(str, used)) == sorted(
        str(k) for k in draws if k != N_STEPS - 1)
    return out


@pytest.mark.parametrize("mode,stride", [("hsm", "uniform"),
                                         ("dsm", "quadratic")])
def test_inpainting_trajectory_matches_jax(mode, stride):
    """The prior with the forward-diffused known region stitched in, EM
    steps each followed by the re-stitched known region; the known region
    of the result is the guide (the denoise row stitches the kernel's mean
    at t = eps, within 1e-2 of x_0, as ``tests/test_samplers.py`` holds
    the JAX sampler)."""
    cfg = cfg_of("ip_em_sde", mode)
    x0, mask = guide()
    draws, want = _jax_run("ip_em_sde", cfg, stride, x0, mask)
    got = _port_run(EulerMaruyamaInpainter, cfg, stride,
                    (torch.from_numpy(x0), torch.from_numpy(mask)), draws)
    assert got.shape == (B, S, S, 2 * C) and np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)
    known = mask == 1
    np.testing.assert_allclose(got.numpy()[..., :C][known], x0[known],
                               atol=1e-2)
    assert np.abs(got.numpy()[..., :C][~known] - x0[~known]).max() > 0.1


@pytest.mark.parametrize("mode,stride", [("hsm", "uniform"),
                                         ("dsm", "quadratic")])
def test_editing_trajectory_matches_jax(mode, stride):
    """The guide forward-diffused to edit_t0 = 0.4, then EM over the grid
    mapped onto [T - 0.4, T - eps]."""
    cfg = cfg_of("edit_em_sde", mode, edit_t0=0.4)
    x0, _ = guide()
    draws, want = _jax_run("edit_em_sde", cfg, stride, x0, None)
    got = _port_run(EditEulerMaruyamaSampler, cfg, stride,
                    torch.from_numpy(x0), draws)
    assert got.shape == (B, S, S, 2 * C) and np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("stride", ["uniform", "quadratic"])
def test_edit_grid_matches_jax(stride):
    cfg = cfg_of("edit_em_sde", edit_t0=0.3)
    got = EditEulerMaruyamaSampler(ConfigDict(cfg), PSLD(ConfigDict(cfg)),
                                   None)._edit_ts(
        make_timesteps(9, EPS, stride_type=stride), EPS)
    want = jsamplers.EditEulerMaruyamaSampler(
        JConfigDict(cfg), JPSLD(JConfigDict(cfg)), None)._edit_ts(
        j_make_timesteps(9, EPS, stride_type=stride), EPS)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=0)
    assert abs(float(got[0]) - 0.7) < 1e-12
    assert abs(float(got[-1]) - (1 - EPS)) < 1e-12


@pytest.mark.parametrize("t0,ok", [(0.0, False), (-0.1, False),
                                   (1.5, False), (1e-3, True), (1.0, True)])
def test_edit_t0_is_validated(t0, ok):
    """edit_t0 must lie in (0, T]: both packages accept and refuse the
    same values."""
    cfg = cfg_of("edit_em_sde", edit_t0=t0)
    builders = [
        lambda: EditEulerMaruyamaSampler(ConfigDict(cfg),
                                         PSLD(ConfigDict(cfg)), None),
        lambda: jsamplers.EditEulerMaruyamaSampler(
            JConfigDict(cfg), JPSLD(JConfigDict(cfg)), None)]
    for build in builders:
        if ok:
            assert build().edit_t0 == t0
        else:
            with pytest.raises(ValueError, match="edit_t0"):
                build()


def _write_mnist(root, n=5, seed=0):
    """A tiny MNIST train-images idx file."""
    rng = np.random.default_rng(seed)
    digits = (rng.random((n, 28, 28)) < 0.3).astype(np.uint8) * 255
    os.makedirs(root, exist_ok=True)
    header = (2051).to_bytes(4, "big") + n.to_bytes(4, "big") \
        + (28).to_bytes(4, "big") * 2
    with open(os.path.join(root, "train-images-idx3-ubyte"), "wb") as f:
        f.write(header + digits.tobytes())


@pytest.mark.parametrize("masks,size", [("square", 32), ("square", 8),
                                        ("mnist", 32), ("mnist", 16)])
def test_inpaint_dataset_matches_jax(tmp_path, masks, size):
    """Square masks where MNIST is absent, MNIST digit masks from an idx
    file where it is present: images and masks bit-equal to the JAX
    package's, 1 on the known region."""
    root = str(tmp_path)
    if masks == "mnist":
        _write_mnist(os.path.join(root, "MNIST", "raw"))
    cfg = cfg_of("ip_em_sde", root=root)
    cfg["data"]["image_size"] = size
    ours = InpaintDataset(ConfigDict(cfg), SyntheticDataset(
        image_size=size, n=16))
    theirs = JInpaintDataset(JConfigDict(cfg), JSynthetic(
        image_size=size, n=16))
    assert ours.mask_mode == theirs.mask_mode == masks
    assert len(ours) == len(theirs) == 8
    idxs = np.array([0, 3, 7, 12])
    (img, mask), (jimg, jmask) = ours.batch(idxs), theirs.batch(idxs)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.shape == (4, size, size, 3) and mask.dtype == np.float32
    assert set(np.unique(mask)) <= {0.0, 1.0} and 0 < mask.mean() < 1
    for i in (0, 5):
        np.testing.assert_array_equal(ours[i][1], theirs[i][1])


def test_inpainting_writer_matches_jax(tmp_path):
    """Samples under ``images/``, the ground truth under ``batch/`` and
    the masked input under ``corrupt/``, under the JAX writer's names and
    with its arrays."""
    rng = np.random.default_rng(1)
    samples = rng.uniform(-1, 1, (3, 4, 4, 6)).astype(np.float32)
    img = rng.uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    mask = (rng.random((3, 4, 4, 3)) < 0.5).astype(np.float32)
    # the JAX writer writes the batch only when built with save_batch;
    # the port's whenever it is given one
    for cls, d, extra in ((InpaintingImageWriter, "ours", {}),
                          (JInpaintWriter, "theirs", {"save_batch": True})):
        w = cls(str(tmp_path / d), sample_prefix="p", path_prefix="q",
                save_mode="np", **extra)
        w.write_batch(samples, rank=0, batch_idx=2, batch=(img, mask))
    for sub in ("images", "batch", "corrupt"):
        ours = sorted(os.listdir(tmp_path / "ours" / "q" / sub))
        assert ours == sorted(os.listdir(tmp_path / "theirs" / "q" / sub))
        assert ours == [f"output_p_0_2_{i}.npy" for i in range(3)]
        for f in ours:
            np.testing.assert_array_equal(
                np.load(tmp_path / "ours" / "q" / sub / f),
                np.load(tmp_path / "theirs" / "q" / sub / f))


NANO_ARGS = ["+dataset=cifar10/cifar10_psld",
             "dataset.diffusion.data.root=/unused",
             "dataset.diffusion.data.name=synthetic",
             "dataset.diffusion.data.image_size=8",
             "dataset.diffusion.model.score_fn.nf=16",
             "dataset.diffusion.model.score_fn.ch_mult=[1]",
             "dataset.diffusion.model.score_fn.num_res_blocks=1",
             "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
             "dataset.diffusion.model.score_fn.dropout=0.0",
             "dataset.diffusion.model.score_fn.fir=true",
             "dataset.diffusion.model.score_fn.embedding_type=fourier",
             "dataset.diffusion.model.score_fn.progressive_input=residual",
             "dataset.diffusion.evaluation.n_samples=3",
             "dataset.diffusion.evaluation.batch_size=2",
             "dataset.diffusion.evaluation.n_discrete_steps=3",
             "+dataset.diffusion.evaluation.device=cpu"]


def _names(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_inpaint_and_edit_entry_points(tmp_path):
    """``cli.inpaint`` (square masks: no MNIST under ``data.root``) and
    ``cli.edit`` on the synthetic set: 3 samples in batches of 2, the tail
    drawn full-width and sliced, written under the JAX writers' names;
    inpainting also writes ``batch/`` and ``corrupt/``, whose arrays are
    the dataset's images and masks."""
    _, _, net = nano_pair()
    sd = net.state_dict()
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"params": sd, "ema_params": sd, "step": 10**6}, ckpt)
    common = NANO_ARGS + [f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
                          "dataset.diffusion.evaluation.save_mode=np",
                          f"dataset.diffusion.data.root={tmp_path}/data"]
    rows = inpaint_cli.main(common + [
        f"dataset.diffusion.evaluation.save_path={tmp_path}/ip"])
    assert [(r["samples"], r["nfe"], r["nonfinite"]) for r in rows] == \
        [(2, 3, 0), (1, 3, 0)]
    rows = edit_cli.main(common + [
        f"dataset.diffusion.evaluation.save_path={tmp_path}/ed",
        "+dataset.diffusion.evaluation.sampler.edit_t0=0.3"])
    assert [(r["samples"], r["nonfinite"]) for r in rows] == [(2, 0), (1, 0)]

    ref = tmp_path / "ref"
    jw = JInpaintWriter(str(ref), sample_prefix="tpu", save_mode="np",
                        save_batch=True)
    for b_idx, take in enumerate((2, 1)):
        z = np.zeros((take, S, S, C), np.float32)
        jw.write_batch(np.zeros((take, S, S, 6), np.float32), 0, b_idx,
                       batch=(z, z))
    for sub in ("images", "batch", "corrupt"):
        assert _names(tmp_path / "ip" / sub) == _names(ref / sub)
    assert len(_names(ref / "images")) == 3
    assert _names(tmp_path / "ed" / "images") == _names(ref / "images")
    assert _names(tmp_path / "ed" / "batch") == []

    cfg = ConfigDict({"data": {"image_size": S, "root": f"{tmp_path}/data"},
                      "evaluation": {"n_samples": 3}})
    img, mask = InpaintDataset(cfg, SyntheticDataset(image_size=S)).batch(
        np.array([2]))
    np.testing.assert_array_equal(
        np.load(tmp_path / "ip" / "batch" / "output_tpu_0_1_0.npy"),
        img[0] * 0.5 + 0.5)
    np.testing.assert_array_equal(
        np.load(tmp_path / "ip" / "corrupt" / "output_tpu_0_1_0.npy"),
        (img[0] * 0.5 + 0.5) * mask[0])
