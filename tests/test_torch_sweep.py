"""The port's host-side evaluation tools against the JAX package's (CPU):
the image reader, the pixel statistics, the sliced Wasserstein distance,
``cli.pixel_stats``, and the FID-against-NFE sweep
(``cli.sweep_fid_nfe``) on a tiny VP-SDE checkpoint.

The tools are NumPy on the host in both packages, the same code on the
same decoded pixels, so their numbers are held equal. The sweep samples
with the port's generators, so its records are held to the JAX package's
quality function applied to the port's own sample directories: the same
record keys, the same pixel statistics and SWD, KID within 1e-4
relative, and the moments handed to the Frechet distance (a 2048-wide
square root costs ~20 s on one CPU core, so both packages'
``frechet_distance`` is replaced by a recorder here; the distance itself
is held by ``test_torch_fid``) as ``test_torch_fid`` holds the saved
stats: means within 1e-4 of their scale, covariances within 1e-4 of the
squared mean's.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from psld_tpu.cli import pixel_stats as jpixel_cli
from psld_tpu.eval import fid as jfid
from psld_tpu.eval import pixel_stats as jpixel
from psld_tpu.eval import swd as jswd
from psld_tpu.eval import sweep as jsweep
from psld_tpu.utils.images import load_images_rgb as j_load_images_rgb
from psld_tpu_torch.cli import pixel_stats as pixel_cli
from psld_tpu_torch.cli import sweep_fid_nfe as sweep_cli
from psld_tpu_torch.eval import fid
from psld_tpu_torch.eval import pixel_stats, swd
from psld_tpu_torch.eval.sweep import run_sweep
from psld_tpu_torch.utils.images import load_images_rgb, save_as_images
from test_torch_ncsnpp import assert_close_to_scale


def _write(path, imgs, fmt="png"):
    path.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(imgs):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            path / f"img_{i}.{fmt}")
    return str(path)


def _textured(seed, n, size=32, freq=2.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    return [np.stack([0.5 + 0.4 * np.sin(freq * 2 * np.pi * (xx + yy) + p)
                      + 0.05 * rng.standard_normal((size, size))
                      for p in rng.uniform(0, 2 * np.pi, 3)], axis=-1)
            for _ in range(n)]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaldirs")
    rng = np.random.default_rng(0)
    return {
        "a": _write(root / "a", _textured(1, 6)),
        "b": _write(root / "b", _textured(2, 6, freq=3.0)),
        "noise": _write(root / "noise", [rng.uniform(size=(32, 32, 3))
                                         for _ in range(5)]),
        "jpeg": _write(root / "jpeg", _textured(3, 2), fmt="jpg"),
    }


def test_load_images_rgb_matches_jax(tmp_path, dirs):
    """RGB, gray and RGBA PNGs and JPEGs, decoded to (N, H, W, 3) uint8
    as the JAX package decodes them."""
    rng = np.random.default_rng(1)
    files = []
    for mode, shape in (("RGB", (6, 5, 3)), ("L", (6, 5)),
                        ("RGBA", (6, 5, 4))):
        p = tmp_path / f"{mode}.png"
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8),
                        mode).save(p)
        files.append(str(p))
    for group in (files, files[:1] * 3, pixel_stats.image_files(
            dirs["jpeg"])):
        got, want = load_images_rgb(group), j_load_images_rgb(group)
        assert got.dtype == np.uint8 and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)
    assert load_images_rgb([]).shape == (0, 0, 0, 3)


@pytest.mark.parametrize("pair,limit", [(("a", "b"), None),
                                        (("a", "noise"), 3)])
def test_compare_dirs_matches_jax(dirs, pair, limit):
    got = pixel_stats.compare_dirs(dirs[pair[0]], dirs[pair[1]], limit)
    want = jpixel.compare_dirs(dirs[pair[0]], dirs[pair[1]], limit)
    assert got == want


def test_dir_stats_match_jax(dirs):
    got = pixel_stats.compute_dir_stats(dirs["noise"])
    want = jpixel.compute_dir_stats(dirs["noise"])
    assert (got.n, got.mean, got.std, got.tv, got.diversity) == \
        (want.n, want.mean, want.std, want.tv, want.diversity)
    np.testing.assert_array_equal(got.hist, want.hist)
    with pytest.raises(ValueError, match="no images"):
        pixel_stats.compute_dir_stats(str(dirs["a"]) + "/none")


def test_swd_pieces_match_jax():
    x = np.random.default_rng(3).random((2, 32, 32, 3))
    for got, want in zip(swd.laplacian_pyramid(x, 8),
                         jswd.laplacian_pyramid(x, 8)):
        np.testing.assert_array_equal(got, want)
    a, b = (np.random.default_rng(s).standard_normal((50, 12))
            for s in (4, 5))
    assert swd.sliced_wasserstein(a, b, 16, 2, np.random.default_rng(0)) == \
        jswd.sliced_wasserstein(a, b, 16, 2, np.random.default_rng(0))


@pytest.mark.parametrize("min_res", [16, 8])
def test_swd_dirs_match_jax(dirs, min_res):
    kw = dict(patches_per_image=8, min_res=min_res, n_proj=32, repeats=2)
    got = swd.swd_dirs(dirs["a"], dirs["b"], **kw)
    assert got == jswd.swd_dirs(dirs["a"], dirs["b"], **kw)
    assert set(got) == ({"32x32", "16x16", "avg"} if min_res == 16
                        else {"32x32", "16x16", "8x8", "avg"})


def test_pixel_stats_cli_matches_jax(dirs, capsys):
    argv = ["--input1", dirs["a"], "--input2", dirs["noise"], "--limit",
            "4", "--swd"]
    got = pixel_cli.main(argv)
    printed = json.loads(capsys.readouterr().out)
    jpixel_cli.main(argv)
    want = json.loads(capsys.readouterr().out)
    assert got == printed == want and "swd" in got


# -- the sweep -----------------------------------------------------------------

VP_TINY = ["+dataset=cifar10/cifar10_vpsde",
           "dataset.diffusion.data.root=/unused",
           "dataset.diffusion.data.image_size=8",
           "dataset.diffusion.model.score_fn.nf=8",
           "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
           "dataset.diffusion.model.score_fn.num_res_blocks=1",
           "dataset.diffusion.model.score_fn.attn_resolutions=[4]",
           "dataset.diffusion.evaluation.n_samples=3",
           "dataset.diffusion.evaluation.batch_size=2",
           "dataset.diffusion.evaluation.sample_from=source",
           "+dataset.diffusion.evaluation.device=cpu"]
RECORD_KEYS = {"sampler", "nfe", "stride", "n_samples", "elapsed_s",
               "img_per_s", "includes_compile"}


def jax_feature_fn(params):
    """The JAX package's features with the params as an argument of the
    program, not constants folded into it: one compile a batch shape (the
    sweep reads 8 directories of the same size)."""
    extract = jax.jit(jfid.extract_features)
    return lambda imgs: extract(params, jnp.asarray(imgs))


def _vp_checkpoint(path):
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.train.loop import build_score_model, \
        init_score_params

    cfg = bootstrap(VP_TINY).dataset.diffusion
    net = build_score_model(cfg)
    sd = {k: v.detach() for k, v in init_score_params(net, 0).items()}
    torch.save({"params": sd, "ema_params": sd, "step": 10 ** 6}, path)
    return str(path)


def test_sweep_cli_records_match_jax_quality(tmp_path, monkeypatch):
    """``cli.sweep_fid_nfe`` over em_sde and ei_ode at 3 and 4 NFE on
    both grids, 3 samples a point, with FID, KID
    and SWD against a reference directory and the fake Inception
    checkpoint: one JSONL line a point with the JAX package's keys and
    the JAX quality function's numbers on the same sample directories."""
    from inception_oracle import random_state_dict

    weights = tmp_path / "pt_inception-2015-12-05-test.pth"
    torch.save(random_state_dict(seed=1), weights)
    ref = tmp_path / "ref"
    ref.mkdir()
    save_as_images(np.random.default_rng(2).uniform(
        -1, 1, (4, 8, 8, 3)).astype(np.float32), str(ref / "img"))
    ckpt = _vp_checkpoint(tmp_path / "vp.pt")
    handed = []

    def recorder(mu1, cov1, mu2, cov2):
        handed.append((mu1, cov1, mu2, cov2))
        return float(np.sum((mu1 - mu2) ** 2) + np.trace(cov1 + cov2))

    monkeypatch.setattr(fid, "frechet_distance", recorder)
    monkeypatch.setattr(jfid, "frechet_distance", recorder)
    monkeypatch.setattr(jfid, "make_feature_fn", jax_feature_fn)
    out = tmp_path / "sweep"
    with pytest.warns(UserWarning, match="clamped"):
        records = sweep_cli.main([
            "--samplers", "em_sde,ei_ode", "--nfes", "3,4", "--strides",
            "uniform,quadratic", "--out-dir", str(out), "--ref-dir",
            str(ref), "--weights", str(weights), "--fid-batch", "4",
            "--swd", "--kid"] + VP_TINY + [
            f"dataset.diffusion.evaluation.chkpt_path={ckpt}"])
    lines = [json.loads(x) for x in open(out / "sweep.jsonl")]
    assert lines == records and len(records) == 8
    assert [(r["sampler"], r["nfe"], r["stride"], r["includes_compile"])
            for r in records[:4]] == [
        ("em_sde", 3, "uniform", True), ("em_sde", 3, "quadratic", False),
        ("em_sde", 4, "uniform", True), ("em_sde", 4, "quadratic", False)]
    port_handed, handed[:] = list(handed), []
    quality = jsweep._make_quality_fn(str(ref), None, str(weights), 4,
                                      swd=True, kid=True)
    for rec, got_fid in zip(records, port_handed):
        assert set(rec) == RECORD_KEYS | {"pixel_stats", "swd", "fid", "kid",
                                          "kid_std"}
        assert rec["n_samples"] == 3 and rec["img_per_s"] > 0
        gen = out / f"{rec['sampler']}_nfe{rec['nfe']}_{rec['stride']}"
        assert len(list((gen / "images").iterdir())) == 3
        with pytest.warns(UserWarning, match="clamped"):
            want = quality(str(gen / "images"))
        assert set(want) == set(rec) - RECORD_KEYS
        assert rec["pixel_stats"] == want["pixel_stats"]
        assert rec["swd"] == want["swd"]
        np.testing.assert_allclose(rec["kid"], want["kid"], rtol=1e-4)
        (mu1, cov1, mu2, cov2), (jmu1, jcov1, jmu2, jcov2) = \
            got_fid, handed[-1]
        for g, w, mu in ((mu1, jmu1, None), (mu2, jmu2, None),
                         (cov1, jcov1, jmu1), (cov2, jcov2, jmu2)):
            if mu is None:
                assert_close_to_scale(g, w, 1e-4)
            else:  # second moments that cancel: error scales with mu^2
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=1e-4 * float(np.abs(mu).max()) ** 2)
        assert rec["fid"] == recorder(*got_fid)


def test_sweep_quality_error_is_recorded(tmp_path, monkeypatch):
    """A quality computation that raises goes into its record as
    ``quality_error``, as in the JAX package, and the sweep goes on."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.eval import pixel_stats as port_pixel

    ckpt = _vp_checkpoint(tmp_path / "vp.pt")
    cfg = bootstrap(VP_TINY + [
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}"]).dataset.diffusion

    def broken(*args, **kwargs):
        raise RuntimeError("no pixels")

    monkeypatch.setattr(port_pixel, "compare_dirs", broken)
    recs = run_sweep(cfg, ["em_sde"], [3], ["uniform"], str(tmp_path / "s"),
                     ref_dir=str(tmp_path))
    assert len(recs) == 1 and recs[0]["quality_error"] == "no pixels"
    cfg.evaluation.save_mode = "np"
    with pytest.raises(ValueError, match="save_mode"):
        run_sweep(cfg, ["em_sde"], [3], ["uniform"], str(tmp_path / "t"))
