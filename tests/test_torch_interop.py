"""The port's reference-checkpoint interop (``train/torch_import.py``,
``train/torch_export.py``, ``cli.convert_checkpoint``,
``cli.export_checkpoint``) held to the JAX package's, bit for bit (CPU).

Every parameter is drawn from a seeded numpy normal (shapes from
``jax.eval_shape`` of the JAX ``init``, no compile); the JAX package's
export of that tree is the reference-layout (Lightning) state_dict both
sides read. Conversion only moves and permutes values, so import and
export must agree with the JAX package exactly; the forward of an
imported network is compared within 1e-5 of the output's scale (the
same f32 arithmetic, summed in another order by XLA and by PyTorch).
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.models.ncsnpp import NCSNppClassifier as JNCSNppClassifier
from psld_tpu.models.ncsnpp import _model_kwargs as j_model_kwargs
from psld_tpu.models.ncsnpp import _model_kwargs_clf as j_model_kwargs_clf
from psld_tpu.train import torch_export as jte
from psld_tpu.train import torch_import as jti
from psld_tpu_torch.cli import convert_checkpoint as convert_cli
from psld_tpu_torch.cli import export_checkpoint as export_cli
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.interop.from_flax import flax_to_state_dict
from psld_tpu_torch.models.ncsnpp import NCSNpp, NCSNppClassifier
from psld_tpu_torch.train import torch_export as te
from psld_tpu_torch.train import torch_import as ti
from test_torch_import import SCORE_CASES, make_cfg
from test_torch_ncsnpp import jit_o0

# the score cases of tests/test_torch_import.py, and the classifier
CASES = [f"score{i}" for i in range(len(SCORE_CASES))] + ["clf"]
CLF_CASE = dict(fir=True, embedding_type="fourier")


def _case(name):
    """(JAX config, port config, JAX net, port net, flax params, flax EMA
    params) of one case; params N(0, 0.25^2) from a numpy seed."""
    clf = name == "clf"
    over = CLF_CASE if clf else SCORE_CASES[int(name[5:])]
    jcfg = make_cfg(clf=clf, **over)
    pcfg = ConfigDict(jcfg.to_dict())
    kw = (j_model_kwargs_clf if clf else j_model_kwargs)(jcfg)
    jnet = (JNCSNppClassifier if clf else JNCSNpp)(**kw)
    s, c = kw["image_size"], kw["in_ch"]
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, s, s, c), jnp.float32),
                            jnp.full((1,), 0.5, jnp.float32))
    rng = np.random.default_rng(CASES.index(name))

    def draw(_):
        return jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 0.25).astype(
                np.float32), shapes)

    net = (NCSNppClassifier if clf else NCSNpp).from_config(pcfg).eval()
    return jcfg, pcfg, jnet, net, draw(0), draw(1)


def _jax_export(name, jcfg, params, ema):
    if name == "clf":
        return jte.export_clf_state_dict(params, jcfg)
    return jte.export_score_state_dict(params, ema, jcfg)


def _assert_equal_sd(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k]
        assert g.dtype == torch.float32 and g.is_contiguous(), k
        assert np.array_equal(g.numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("name", CASES)
def test_import_equals_flax_to_state_dict(name):
    """The JAX-exported Lightning state_dict imports to exactly what
    ``flax_to_state_dict`` makes of the same flax tree (EMA included)."""
    jcfg, pcfg, _, net, params, ema = _case(name)
    ref = {k: torch.from_numpy(v)
           for k, v in _jax_export(name, jcfg, params, ema).items()}
    if name == "clf":
        got = ti.convert_clf_state_dict(ref, pcfg)
        _assert_equal_sd(got, flax_to_state_dict(params, net))
    else:
        got, got_ema = ti.convert_score_state_dict(ref, pcfg)
        _assert_equal_sd(got, flax_to_state_dict(params, net))
        _assert_equal_sd(got_ema, flax_to_state_dict(ema, net))


@pytest.mark.parametrize("name", CASES)
def test_export_equals_jax_export(name):
    """The port's export of ``flax_to_state_dict``'s state_dicts equals
    the JAX export of the flax trees, key for key and bit for bit (the
    classifier's head permutation included)."""
    jcfg, pcfg, _, net, params, ema = _case(name)
    want = _jax_export(name, jcfg, params, ema)
    sd = flax_to_state_dict(params, net)
    if name == "clf":
        got = te.export_clf_state_dict(sd, pcfg)
    else:
        got = te.export_score_state_dict(sd, flax_to_state_dict(ema, net),
                                         pcfg)
    _assert_equal_sd(got, want)


@pytest.mark.parametrize("name", ["score1", "clf"])
def test_lightning_files_round_trip_both_ways(name, tmp_path):
    """A ``.ckpt`` the port writes loads through the JAX package's
    ``load_lightning_state_dict`` unchanged, and one the JAX package
    writes converts through the port's file API to the port's
    state_dicts."""
    jcfg, pcfg, _, net, params, ema = _case(name)
    want = _jax_export(name, jcfg, params, ema)
    sd = flax_to_state_dict(params, net)
    if name == "clf":
        got = te.export_clf_state_dict(sd, pcfg)
    else:
        got = te.export_score_state_dict(sd, flax_to_state_dict(ema, net),
                                         pcfg)
    ours = str(tmp_path / "port.ckpt")
    te.save_lightning_checkpoint(ours, got, step=7)
    back = jti.load_lightning_state_dict(ours)
    assert sorted(back) == sorted(want)
    for k in want:
        assert np.array_equal(back[k], want[k]), k
    assert torch.load(ours, weights_only=True)["global_step"] == 7

    theirs = str(tmp_path / "jax.ckpt")
    jte.save_lightning_checkpoint(theirs, want, step=9)
    if name == "clf":
        _assert_equal_sd(ti.convert_clf_checkpoint(theirs, pcfg), sd)
    else:
        p, e = ti.convert_score_checkpoint(theirs, pcfg)
        _assert_equal_sd(p, sd)
        _assert_equal_sd(e, flax_to_state_dict(ema, net))


@pytest.mark.parametrize("name", ["score1", "clf"])
def test_imported_forward_matches_jax(name):
    """One f32 forward of the imported port network against the JAX
    forward of the flax tree, within 1e-5 of the output's scale."""
    jcfg, pcfg, jnet, net, params, ema = _case(name)
    ref = {k: torch.from_numpy(v)
           for k, v in _jax_export(name, jcfg, params, ema).items()}
    sd = (ti.convert_clf_state_dict(ref, pcfg) if name == "clf"
          else ti.convert_score_state_dict(ref, pcfg)[0])
    net.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    want = np.asarray(jit_o0(jnet.apply, params, jnp.asarray(x),
                             jnp.asarray(t)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), torch.from_numpy(t)).float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def _kw(**over):
    kw = dict(image_size=16, in_ch=2, out_ch=2, nonlinearity="swish", nf=8,
              ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
              dropout=0.0, resamp_with_conv=True, noise_cond=True,
              fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True,
              resblock_type="biggan", progressive="none",
              progressive_input="none", progressive_combine="sum",
              embedding_type="positional", init_scale=0.0,
              fourier_scale=16.0)
    kw.update(over)
    return kw


def test_module_count_mismatch_is_loud():
    kw = _kw()
    names = ti.score_module_walk(kw)
    sd = {"all_modules.0.weight": torch.zeros(8, 2, 3, 3)}
    with pytest.raises(ValueError, match="module-count mismatch"):
        ti._convert(sd, names, kw)
    # a checkpoint of 2 blocks a level read with a config of 1
    jcfg, _, _, _, params, ema = _case("score0")
    ref = {k: torch.from_numpy(v)
           for k, v in _jax_export("score0", jcfg, params, ema).items()}
    fewer = ConfigDict(make_cfg(**SCORE_CASES[0], num_res_blocks=1)
                       .to_dict())
    with pytest.raises(ValueError, match="module-count mismatch"):
        ti.convert_score_state_dict(ref, fewer)


def test_state_dict_mismatch_is_loud():
    """``verify_state_dict`` names every missing, unexpected and misshapen
    key; the export refuses a state_dict that is not the model's."""
    _, pcfg, _, net, params, _ = _case("score0")
    sd = flax_to_state_dict(params, net)
    want = net.state_dict()
    bad = dict(sd)
    dropped = sorted(bad)[0]
    del bad[dropped]
    bad["extra.weight"] = torch.zeros(1)
    key = sorted(bad)[1]
    bad[key] = torch.zeros(3, 3)
    with pytest.raises(ValueError) as e:
        ti.verify_state_dict(bad, want)
    msg = str(e.value)
    assert f"missing: {dropped}" in msg and "unexpected: extra.weight" in msg
    assert f"shape: {key}" in msg
    with pytest.raises(ValueError, match="does not match the model"):
        te.export_score_state_dict(bad, sd, pcfg)


def test_noise_cond_false_export_is_loud():
    kw = _kw(noise_cond=False)
    with pytest.raises(ValueError, match="noise_cond"):
        te._export({}, ti.score_module_walk(kw), kw)


def test_noise_cond_false_import_drops_the_dead_temb_dense():
    """The reference builds each resblock's temb Dense even without noise
    conditioning; the import drops it, as the JAX package's does."""
    kw = _kw(noise_cond=False)
    names = ti.score_module_walk(kw)
    i = names.index("ResnetBlockBigGAN_0")
    sd = {f"all_modules.{j}.bias": torch.zeros(1) for j in range(len(names))}
    sd[f"all_modules.{i}.Dense_0.weight"] = torch.zeros(8, 32)
    out = ti._convert(sd, names, kw)
    assert not any(".Dense_0." in k for k in out)


def test_cli_arg_split_handles_lightning_default_names(tmp_path):
    """Lightning's DEFAULT checkpoint filename (`epoch=0-step=999.ckpt`)
    and the port's `...-epoch=0042-...pt` files parse as positionals,
    overrides as overrides."""
    pos, ovr = convert_cli._split_args([
        "epoch=0-step=999.ckpt", "outdir", "+dataset=cifar10/cifar10_psld",
        "a.b_c=1"])
    assert pos == ["epoch=0-step=999.ckpt", "outdir"]
    assert ovr == ["+dataset=cifar10/cifar10_psld", "a.b_c=1"]

    f = tmp_path / "psld-score-epoch=0042"
    f.write_text("")
    pos, ovr = convert_cli._split_args([str(f), "out.ckpt", "x.y=2"])
    assert pos == [str(f), "out.ckpt"] and ovr == ["x.y=2"]
    with pytest.raises(SystemExit):
        convert_cli.main(["only-one.ckpt"])


# an 8 x 8 network of the flagship's options, on the CPU
_TINY = ["+dataset=cifar10/cifar10_psld",
         "dataset.diffusion.data.root=/unused",
         "dataset.diffusion.data.image_size=8",
         "dataset.diffusion.model.score_fn.nf=8",
         "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
         "dataset.diffusion.model.score_fn.num_res_blocks=1",
         "dataset.diffusion.model.score_fn.attn_resolutions=[4]",
         "dataset.diffusion.model.score_fn.fir=true",
         "dataset.diffusion.model.score_fn.embedding_type=fourier",
         "dataset.diffusion.model.score_fn.progressive_input=residual"]
_TINY_CLF = ["dataset.clf.data.root=/unused",
             "dataset.clf.data.image_size=8",
             "dataset.clf.model.clf_fn.n_cls=10",
             "dataset.clf.model.clf_fn.nf=8",
             "dataset.clf.model.clf_fn.ch_mult=[1,2]",
             "dataset.clf.model.clf_fn.num_res_blocks=1",
             "dataset.clf.model.clf_fn.attn_resolutions=[4]"]


def _random_sd(net, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.1)
                                .astype(np.float32))
            for k, v in net.state_dict().items()}


def test_full_circle_through_the_clis(tmp_path):
    """A reference-layout ``.ckpt`` (named as Lightning names them) goes
    through ``cli.convert_checkpoint`` into a port checkpoint that
    ``cli.sample`` reads on the CPU, with the same samples as the original
    weights give, and that restores as ``training.restore_path`` does;
    ``cli.export_checkpoint`` gives the ``.ckpt`` back bit for bit, for
    the score network and (``--clf``) the classifier."""
    from psld_tpu_torch.cli._common import bootstrap
    from psld_tpu_torch.train import checkpoint as ckpt
    from psld_tpu_torch.train.loop import build_score_model
    from psld_tpu_torch.train.state import init_state, make_optimizer

    torch.set_num_threads(1)
    cfg = bootstrap(_TINY + _TINY_CLF).dataset
    net = build_score_model(cfg.diffusion)
    params, ema = _random_sd(net, 0), _random_sd(net, 1)
    ref = te.export_score_state_dict(params, ema, cfg.diffusion)
    src = str(tmp_path / "epoch=0-step=999.ckpt")
    te.save_lightning_checkpoint(src, ref, step=999)

    out = convert_cli.main([src, str(tmp_path / "conv"), *_TINY])
    assert out == str(tmp_path / "conv.pt")
    conv = torch.load(out, weights_only=True)
    assert conv["step"] == 0 and conv["opt_state"]["count"] == 0
    _assert_equal_sd(conv["params"], params)
    _assert_equal_sd(conv["ema_params"], ema)
    assert all(not v.any() for v in conv["opt_state"]["mu"].values())

    state = init_state(_random_sd(net, 5),
                       make_optimizer(cfg.diffusion.training.optimizer))
    state = ckpt.restore_checkpoint(out, state)
    _assert_equal_sd(state.ema_params, ema)

    orig = str(tmp_path / "orig.pt")
    torch.save({"params": params, "ema_params": ema, "step": 10**6}, orig)
    runs = {}
    for tag, path in (("orig", orig), ("conv", out)):
        runs[tag] = sample_cli.main(_TINY + [
            f"dataset.diffusion.evaluation.chkpt_path={path}",
            f"dataset.diffusion.evaluation.save_path={tmp_path / tag}",
            "dataset.diffusion.evaluation.n_samples=3",
            "dataset.diffusion.evaluation.batch_size=2",
            "dataset.diffusion.evaluation.n_discrete_steps=3",
            "dataset.diffusion.evaluation.sample_from=source",
            "dataset.diffusion.evaluation.save_mode=np",
            "+dataset.diffusion.evaluation.device=cpu"])
    assert [b["samples"] for b in runs["conv"]] == [2, 1]
    assert all(b["nonfinite"] == 0 for b in runs["conv"])
    names = sorted(os.listdir(tmp_path / "conv" / "images"))
    assert names == sorted(os.listdir(tmp_path / "orig" / "images"))
    assert len(names) == 3
    for f in names:
        assert np.array_equal(np.load(tmp_path / "conv" / "images" / f),
                              np.load(tmp_path / "orig" / "images" / f))

    back = export_cli.main([out, str(tmp_path / "back.ckpt"), *_TINY])
    lit = torch.load(back, weights_only=True)
    assert lit["global_step"] == 0 and lit["epoch"] == 0
    _assert_equal_sd(lit["state_dict"], ref)

    # the classifier: port checkpoint -> .ckpt -> port checkpoint
    clf = NCSNppClassifier.from_config(cfg.clf)
    cparams = _random_sd(clf, 2)
    csrc = str(tmp_path / "clf.pt")
    torch.save({"params": cparams, "ema_params": cparams, "step": 16}, csrc)
    cck = export_cli.main([csrc, str(tmp_path / "clf.ckpt"), "--clf",
                           *_TINY, *_TINY_CLF])
    clit = torch.load(cck, weights_only=True)
    assert clit["global_step"] == 16
    assert all(k.startswith("clf_fn.all_modules.") for k in clit["state_dict"])
    cout = convert_cli.main([cck, str(tmp_path / "clf_conv.pt"), "--clf",
                             *_TINY, *_TINY_CLF])
    cconv = torch.load(cout, weights_only=True)
    _assert_equal_sd(cconv["params"], cparams)
    _assert_equal_sd(cconv["ema_params"], cparams)
