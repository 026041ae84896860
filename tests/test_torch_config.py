"""What the port builds from each shipped dataset config (CPU).

The port composes its configs with its own copy of the composer
(``psld_tpu_torch/config.py``) and of the YAML tree
(``psld_tpu_torch/configs``). These tests hold every composed tree equal
to the JAX package's, so the two copies cannot drift, and hold what the
port makes of every shipped config, PSLD's and the VP-SDE's (its score
network's constructor arguments, the network itself, the SDE, and where
the config has a ``clf`` tree the classifier's arguments) to what the
JAX package makes of the same config.

Tolerance of the SDE comparison: 1e-6 of the tensor's largest magnitude,
as in ``test_torch_sde`` (float64 coefficients rounded once to float32).
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu import knobs as jknobs
from psld_tpu import config as jconfig
from psld_tpu.models.ncsnpp import _model_kwargs as j_model_kwargs
from psld_tpu.models.ncsnpp import _model_kwargs_clf as j_model_kwargs_clf
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu.sde.vpsde import VPSDE as JVPSDE
from psld_tpu_torch import config as tconfig
from psld_tpu_torch import knobs
from psld_tpu_torch.config import compose
from psld_tpu_torch.eval.generate import build_score_model, build_sde
from psld_tpu_torch.models.ncsnpp import _model_kwargs, _model_kwargs_clf
from psld_tpu_torch.train.loop import build_clf_model

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "psld_tpu", "configs", "dataset")
GROUPS = sorted(f"{d}/{os.path.splitext(f)[0]}" for d in os.listdir(CONFIGS)
                for f in os.listdir(os.path.join(CONFIGS, d))
                if f.endswith(".yaml"))
PSLD_GROUPS = [g for g in GROUPS if g.endswith("_psld")]
VP_GROUPS = [g for g in GROUPS if not g.endswith("_psld")]
TS = np.array([1e-3, 0.1, 0.5, 0.999])


def diffusion_cfg(group):
    return compose([f"+dataset={group}",
                    "dataset.diffusion.data.root=/unused"]).dataset.diffusion


@pytest.fixture
def latched_knobs(monkeypatch):
    """Building a model latches its config's knobs process-globally in
    both packages; put them back afterwards."""
    monkeypatch.setattr(knobs, "_gn_bf16", knobs._gn_bf16)
    monkeypatch.setattr(jknobs, "_state", dict(jknobs._state))


def test_every_shipped_config_is_covered():
    assert "cifar10/cifar10_psld" in PSLD_GROUPS and len(PSLD_GROUPS) == 4
    assert VP_GROUPS and all(g.endswith("_vpsde") for g in VP_GROUPS)
    own = os.path.join(os.path.dirname(tconfig.__file__), "configs",
                       "dataset")
    assert sorted(f"{d}/{os.path.splitext(f)[0]}" for d in os.listdir(own)
                  for f in os.listdir(os.path.join(own, d))) == GROUPS


OVERRIDES = ["dataset.diffusion.data.root='/data dir'",
             "dataset.diffusion.model.score_fn.ch_mult=[2,2,2]",
             "dataset.diffusion.training.optimizer.lr=1e-3",
             "+dataset.diffusion.training.bf16=True",
             "+dataset.diffusion.model.score_fn.dropout_impl=hw"]


@pytest.mark.parametrize("group", GROUPS)
def test_composed_tree_equals_the_jax_packages(group):
    """The port's YAML copy and composer give the JAX package's tree, bare
    and under overrides of every kind (quoted string, list, float, added
    keys); mandatory ``???`` fields raise and are listed alike."""
    for argv in ([f"+dataset={group}"], [f"+dataset={group}", *OVERRIDES]):
        got, want = tconfig.compose(argv), jconfig.compose(argv)
        assert got.to_dict() == want.to_dict()
        assert tconfig.validate_no_missing(got) == \
            jconfig.validate_no_missing(want)
    bare = tconfig.compose([f"+dataset={group}"])
    assert "dataset.diffusion.data.root" in tconfig.validate_no_missing(bare)
    with pytest.raises(tconfig.MissingMandatoryValue):
        bare.dataset.diffusion.data.root


def test_composer_refuses_what_the_jax_composer_refuses():
    for argv, err in ((["+dataset=cifar10/nope"], FileNotFoundError),
                      (["dataset"], ValueError),
                      (["+dataset=cifar10/cifar10_psld",
                        "dataset.diffusion.nope=1"], KeyError)):
        for mod in (tconfig, jconfig):
            with pytest.raises(err):
                mod.compose(argv)


@pytest.mark.parametrize("group", GROUPS)
def test_score_net_of_config_matches_jax(group, latched_knobs):
    """The same constructor arguments as the JAX package, and a network
    built from them (on the meta device: no memory, full size)."""
    cfg = diffusion_cfg(group)
    assert _model_kwargs(cfg) == j_model_kwargs(cfg)
    with torch.device("meta"):
        net = build_score_model(cfg)
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params > 0
    if group == "cifar10/cifar10_vpsde":  # the VP-SDE baseline's network
        assert n_params == 61_804_419


@pytest.mark.parametrize("group", GROUPS)
def test_sde_of_config_matches_jax(group):
    """PSLD's drift and diffusion on the (x, m) state of 6 channels, the
    VP-SDE's on x alone."""
    cfg = diffusion_cfg(group)
    sde = build_sde(cfg)
    jsde = (JPSLD if group.endswith("_psld") else JVPSDE)(cfg)
    assert type(sde).__name__ == type(jsde).__name__
    assert sde.is_augmented == jsde.is_augmented \
        == bool(cfg.model.sde.is_augmented)
    z = np.random.default_rng(0).standard_normal(
        (len(TS), 4, 4, 6 if sde.is_augmented else 3)).astype(np.float32)
    for got, want in zip(sde.sde(torch.from_numpy(z), torch.from_numpy(TS)),
                         jsde.sde(jnp.asarray(z), jnp.asarray(TS))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("impl,hashed", [("save_mask", False), ("hw", True),
                                         ("hw_inline", True),
                                         ("remat", False)])
def test_dropout_impl_names_select_two_behaviours(impl, hashed, monkeypatch):
    """The JAX package's four names are kept as they are (a run's metadata
    shows the configured one) and select the hash op or a saved mask; the
    JAX package's env overrides switch nothing here."""
    from psld_tpu_torch.models import layers

    monkeypatch.setenv("PSLD_DROPOUT_PALLAS", "0" if hashed else "1")
    monkeypatch.setenv("PSLD_DROPOUT_REMAT", "1")
    assert layers.resolve_dropout_impl(impl) == impl
    assert layers.dropout_is_hashed(impl) is hashed
    assert layers.DropoutSites(0.0, impl).hashed is hashed
    cfg = compose(["+dataset=cifar10/cifar10_psld",
                   "dataset.diffusion.data.root=/unused",
                   f"+dataset.diffusion.model.score_fn.dropout_impl={impl}"])
    cfg = cfg.dataset.diffusion
    assert _model_kwargs(cfg)["dropout_impl"] == impl
    assert knobs.resolved(cfg)["dropout_impl"] == impl


def test_unknown_dropout_impl_is_refused():
    from psld_tpu_torch.models import layers

    assert layers.resolve_dropout_impl() == "save_mask"
    for bad in ("pallas", "", "HW"):
        with pytest.raises(ValueError, match="dropout_impl"):
            layers.resolve_dropout_impl(bad)
        with pytest.raises(ValueError, match="dropout_impl"):
            layers.dropout_is_hashed(bad)


CLF_GROUPS = [g for g in PSLD_GROUPS
              if "clf" in tconfig.compose([f"+dataset={g}"]).dataset]


def test_classifier_configs_are_covered():
    assert "cifar10/cifar10_psld" in CLF_GROUPS


@pytest.mark.parametrize("group", CLF_GROUPS)
def test_classifier_of_config_matches_jax(group, latched_knobs):
    """The classifier's constructor arguments equal the JAX package's,
    ``n_cls: ???`` raises in both until it is set, and at the shipped
    CIFAR-10 width the classifier (built on the meta device) has
    15,262,848 parameters and a bias-free head."""
    bare = compose([f"+dataset={group}",
                    "dataset.clf.data.root=/unused"]).dataset.clf
    for kwargs_of in (_model_kwargs_clf, j_model_kwargs_clf):
        with pytest.raises((tconfig.MissingMandatoryValue,
                            jconfig.MissingMandatoryValue)):
            kwargs_of(bare)
    ccfg = compose([f"+dataset={group}", "dataset.clf.data.root=/unused",
                    "dataset.clf.model.clf_fn.n_cls=10"]).dataset.clf
    assert _model_kwargs_clf(ccfg) == j_model_kwargs_clf(ccfg)
    with torch.device("meta"):
        net = build_clf_model(ccfg, device="meta")
    assert net.Dense_2.bias is None
    if group == "cifar10/cifar10_psld":
        assert sum(p.numel() for p in net.parameters()) == 15_262_848
