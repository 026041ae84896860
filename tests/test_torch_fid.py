"""The port's FID pipeline against the JAX package's (CPU): InceptionV3's
features and logits, the checkpoint loader's BatchNorm folding, the
converter of the JAX package's Inception params, the metrics (feature
moments, Frechet distance, KID, ISC), the stats files, and ``cli.fid``.

Parameters are drawn from a numpy seed in the JAX package's layout (HWIO
kernels, nonzero biases) and converted with
``interop.from_flax.inception_state_dict``; the fake checkpoint is the
``pt_inception-2015-12-05`` state_dict of ``tests/inception_oracle.py``
(BatchNorm included, random values).

Tolerances:

* features and logits: 1e-4 of their largest magnitude. Float32
  convolutions through ~95 layers summed in another order by XLA and by
  PyTorch's CPU kernels, and the resize of two libraries (the measured
  disagreement is ~1e-6 of scale).
* the folded checkpoint: 1e-6 of each tensor's largest magnitude, the
  same float32 arithmetic in two libraries (a bias is a difference that
  can cancel, so a last-bit difference is relative to its terms).
* the metrics on the same float64 features: 1e-10 relative, the same
  NumPy/SciPy code on the same numbers.
* ``cli.fid``: the saved means within 1e-4 of their scale, as the
  features, and the covariances within 1e-4 of the squared mean's scale
  (a difference of second moments that cancel); KID and ISC within 1e-4
  relative.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from psld_tpu.cli import fid as jfid_cli
from psld_tpu.eval import fid as jfid
from psld_tpu_torch.cli import fid as fid_cli
from psld_tpu_torch.eval import fid
from psld_tpu_torch.interop.from_flax import inception_state_dict
from test_torch_ncsnpp import assert_close_to_scale, jit_o0

N_IMAGES = 4


def numpy_params(seed=0, with_fc=True):
    """The JAX package's param layout, from a numpy seed: He-scaled HWIO
    kernels and biases of 0.1 N(0, 1), so every ReLU passes signal."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (i, o, (kh, kw), _, _) in jfid.inception.all_conv_specs(
            ).items():
        params[name] = {
            "w": (rng.standard_normal((kh, kw, i, o))
                  * np.sqrt(2.0 / (i * kh * kw))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
    if with_fc:
        params["fc"] = {
            "w": (rng.standard_normal((fid.FID_DIM, fid.N_LOGITS))
                  / np.sqrt(fid.FID_DIM)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(fid.N_LOGITS)).astype(
                np.float32)}
    return params


_NETS = {}


def nets():
    """(JAX params, port network) on the same numbers, built once."""
    if not _NETS:
        p = numpy_params()
        _NETS["pair"] = (p, fid.FIDInception.from_params(
            inception_state_dict(p), device="cpu"))
    return _NETS["pair"]


def test_conv_table_matches_jax():
    got, want = fid.inception.all_conv_specs(), \
        jfid.inception.all_conv_specs()
    assert got == want and len(got) == 94


@pytest.mark.parametrize("shape,resize", [((2, 75, 75, 3), False),
                                          ((1, 32, 32, 3), True)])
def test_features_match_jax(shape, resize):
    """75x75 without the resize (the smallest input the stem takes), and
    32x32 resized to 299x299 (bilinear, half-pixel centres)."""
    params, net = nets()
    x = np.random.default_rng(7).random(shape, dtype=np.float32)
    want = np.asarray(jit_o0(lambda p, i: jfid.extract_features(
        p, i, resize=resize), params, jnp.asarray(x)))
    got = fid.extract_features(net, torch.from_numpy(x), resize=resize)
    assert got.shape == (shape[0], fid.FID_DIM) and got.dtype == torch.float32
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    assert_close_to_scale(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("unbiased", [True, False])
def test_logits_match_jax(unbiased):
    params, net = nets()
    feats = np.random.default_rng(8).random((3, fid.FID_DIM),
                                            dtype=np.float32)
    want = np.asarray(jfid.logits_from_features(params, jnp.asarray(feats),
                                                unbiased=unbiased))
    got = fid.logits_from_features(net, torch.from_numpy(feats),
                                   unbiased=unbiased)
    assert got.shape == (3, fid.N_LOGITS)
    assert_close_to_scale(got.numpy(), want, 1e-4)


def test_logits_need_the_fc_head():
    net = fid.FIDInception.from_params(
        inception_state_dict(numpy_params(with_fc=False)), device="cpu")
    with pytest.raises(ValueError, match="fc head"):
        fid.logits_from_features(net, torch.zeros(1, fid.FID_DIM))


@pytest.fixture(scope="module")
def fake_checkpoint(tmp_path_factory):
    from inception_oracle import random_state_dict

    path = tmp_path_factory.mktemp("inception") / \
        "pt_inception-2015-12-05-test.pth"
    torch.save(random_state_dict(seed=0), path)
    return str(path)


def test_checkpoint_folding_matches_jax(fake_checkpoint):
    """BatchNorm (eps 1e-3) folded into each convolution, the fc head
    kept: the port's state_dict against the JAX loader's params,
    converted."""
    got = fid.load_torch_checkpoint(fake_checkpoint)
    want = inception_state_dict(jax.device_get(
        jfid.load_torch_checkpoint(fake_checkpoint)))
    assert set(got) == set(want)
    assert "fc.weight" in got and len(got) == 2 * 94 + 2
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()),
                                   err_msg=k)
    net = fid.FIDInception.from_params(got, device="cpu")
    assert not any(p.requires_grad for p in net.parameters())


def test_random_params_are_reproducible_and_scaled():
    a = fid.random_params(torch.Generator().manual_seed(0), with_fc=True)
    b = fid.random_params(torch.Generator().manual_seed(0), with_fc=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    w = a["Mixed_7c.branch3x3dbl_2.weight"]  # 448 x 3 x 3 fan-in
    assert w.shape == (384, 448, 3, 3)
    np.testing.assert_allclose(float(w.std()), (448 * 9) ** -0.5, rtol=0.02)
    assert not a["Mixed_7c.branch3x3dbl_2.bias"].any()
    assert "fc.weight" not in fid.random_params(
        torch.Generator().manual_seed(0))


# -- the metrics ---------------------------------------------------------------

def _feats(seed, n=40, d=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 \
        + rng.standard_normal(d)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-10, atol=0)


def test_feature_moments_match_jax():
    x = _feats(0)
    got = fid.FeatureMoments.zeros(16)
    want = jfid.FeatureMoments.zeros(16)
    for chunk in np.split(x, 4):
        got, want = got.update(chunk), want.update(chunk)
    other = _feats(1, n=8)
    got = got.merge(fid.FeatureMoments.zeros(16).update(other))
    want = want.merge(jfid.FeatureMoments.zeros(16).update(other))
    assert got.count == want.count == 48
    for g, w in zip(got.finalize(), want.finalize()):
        _close(g, w)


def test_frechet_distance_matches_jax():
    a, b = _feats(2), _feats(3)
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in (a, b)]
    got = fid.frechet_distance(*stats[0], *stats[1])
    want = jfid.frechet_distance(*stats[0], *stats[1])
    assert want > 0
    _close(got, want)
    assert abs(fid.frechet_distance(*stats[0], *stats[0])) < 1e-8


def test_kid_matches_jax():
    a, b = _feats(4, n=30), _feats(5, n=30)
    for kw in ({"subsets": 5, "subset_size": 20},
               {"subsets": 3, "subset_size": 12, "degree": 2, "seed": 4}):
        _close(fid.kid_from_features(a, b, **kw),
               jfid.kid_from_features(a, b, **kw))
    with pytest.warns(UserWarning, match="clamped"):
        got = fid.kid_from_features(a, b, subsets=2, subset_size=100)
    with pytest.warns(UserWarning, match="clamped"):
        want = jfid.kid_from_features(a, b, subsets=2, subset_size=100)
    _close(got, want)


def test_isc_matches_jax():
    logits = np.random.default_rng(6).standard_normal((23, 1008)) * 3.0
    for splits in (1, 5, 10):
        _close(fid.isc_from_logits(logits, splits=splits),
               jfid.isc_from_logits(logits, splits=splits))
    with pytest.raises(ValueError, match="ISC"):
        fid.isc_from_logits(logits[:4])


def test_stats_files_load_in_either_package(tmp_path):
    m = fid.FeatureMoments.zeros(16).update(_feats(7))
    jm = jfid.FeatureMoments.zeros(16).update(_feats(7))
    fid.save_stats(str(tmp_path / "port.npz"), m)
    jfid.save_stats(str(tmp_path / "jax.npz"), jm)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["count", "mu", "sigma"]
    for path in ("port.npz", "jax.npz"):
        for g, w in zip(fid.load_stats(str(tmp_path / path)),
                        jfid.load_stats(str(tmp_path / path))):
            _close(g, w)
    _close(fid.load_stats(str(tmp_path / "port.npz"))[1], m.finalize()[1])


# -- the entry point -----------------------------------------------------------

def _write_dir(d, seed, shift=0):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(N_IMAGES):
        img = (rng.integers(0, 175, (8, 8, 3)) + shift).astype(np.uint8)
        Image.fromarray(img).save(d / f"{i}.png")
    return str(d)


def test_fid_cli_matches_jax(tmp_path, fake_checkpoint, monkeypatch):
    """``--fid --kid --isc`` with the fake checkpoint on two directories
    of four 8x8 PNGs (one batch each, one compile of the JAX side): the
    moments of ``--save-stats1``/``--save-stats2``, KID and ISC as the
    JAX CLI's (recomputed from the features and logits its ``collect``
    returned). A 2048-wide FID costs a matrix square root of ~20 s on one
    CPU core, so both packages' ``frechet_distance`` is replaced by a
    recorder: each CLI must hand it its directories' moments (those it
    saved) and print what it returns; the distance itself is held by
    ``test_frechet_distance_matches_jax``."""
    a = _write_dir(tmp_path / "a", 0)
    b = _write_dir(tmp_path / "b", 1, shift=60)
    common = ["--input1", a, "--input2", b, "--batch", str(N_IMAGES),
              "--weights", fake_checkpoint, "--fid", "--kid", "--isc",
              "--kid-subsets", "3", "--kid-subset-size", "3",
              "--isc-splits", "2"]
    def feature_logits_fn(params):  # compiled as jit_o0 compiles
        def run(p, imgs):
            feats = jfid.extract_features(p, imgs)
            return feats, jfid.logits_from_features(p, feats)

        return lambda imgs: jit_o0(run, params, jnp.asarray(imgs))

    monkeypatch.setattr(jfid, "make_feature_logits_fn", feature_logits_fn)
    handed = {}

    def recorder(who):
        def frechet(mu1, cov1, mu2, cov2):
            handed[who] = (mu1, cov1, mu2, cov2)
            return float(np.sum((mu1 - mu2) ** 2) + np.trace(cov1 + cov2))

        return frechet

    monkeypatch.setattr(jfid, "frechet_distance", recorder("j"))
    monkeypatch.setattr(fid, "frechet_distance", recorder("p"))
    collected = []
    j_collect = jfid_cli.collect
    monkeypatch.setattr(jfid_cli, "collect", lambda *a, **k: collected.append(
        j_collect(*a, **k)) or collected[-1])
    want_fid = jfid_cli.main(common + [
        "--save-stats1", str(tmp_path / "j1.npz"),
        "--save-stats2", str(tmp_path / "j2.npz")])
    got = fid_cli.main(common + [
        "--device", "cpu",
        "--save-stats1", str(tmp_path / "p1.npz"),
        "--save-stats2", str(tmp_path / "p2.npz")])
    for side in ("1", "2"):
        (mu, sigma), (jmu, jsigma) = (fid.load_stats(str(
            tmp_path / f"{who}{side}.npz")) for who in ("p", "j"))
        assert_close_to_scale(mu, jmu, 1e-4)
        # a difference of second moments: its error scales with mu^2
        scale = float(np.abs(jmu).max()) ** 2
        np.testing.assert_allclose(sigma, jsigma, rtol=1e-4,
                                   atol=1e-4 * scale)
    for who, fid_value in (("p", got["frechet_inception_distance"]),
                           ("j", want_fid)):
        saved = [fid.load_stats(str(tmp_path / f"{who}{side}.npz"))
                 for side in ("1", "2")]
        for h, w in zip(handed[who], (*saved[0], *saved[1])):
            np.testing.assert_allclose(h, w, rtol=1e-12, atol=0)
        assert fid_value == recorder(who)(*handed[who]) > 0
    # KID and ISC of the JAX CLI, from what its collect returned
    (_, f1, l1), (_, f2, _) = collected
    kid = jfid.kid_from_features(f1, f2, subsets=3, subset_size=3)
    isc = jfid.isc_from_logits(l1, splits=2)
    np.testing.assert_allclose(
        [got["kernel_inception_distance_mean"], got["inception_score_mean"]],
        [kid[0], isc[0]], rtol=1e-4)
    # the std of two split scores ~1: a difference of equal numbers
    assert abs(got["inception_score_std"] - isc[1]) < 1e-6
    assert set(got) == {"frechet_inception_distance",
                        "kernel_inception_distance_mean",
                        "kernel_inception_distance_std",
                        "inception_score_mean", "inception_score_std"}


def test_fid_cli_refuses_what_the_jax_cli_refuses(tmp_path):
    for argv in (["--input1", "x"], ["--input1", "x.npz", "--input2", "y",
                                     "--kid"]):
        for main in (fid_cli.main, jfid_cli.main):
            with pytest.raises(SystemExit):
                main(argv)
