"""What the port builds from each shipped dataset config (CPU).

The port composes its configs with the JAX package's ``psld_tpu.config``
and the YAML tree under ``psld_tpu/configs``. These tests hold what the
port makes of every shipped PSLD config (its score network's constructor
arguments, the network itself, the SDE) to what the JAX package makes of
the same config, and check that the configs of SDEs the port does not
have yet are refused.

Tolerance of the SDE comparison: 1e-6 of the tensor's largest magnitude,
as in ``test_torch_sde`` (float64 coefficients rounded once to float32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu import knobs as jknobs
from psld_tpu.config import compose
from psld_tpu.models.ncsnpp import _model_kwargs as j_model_kwargs
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch import knobs
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.eval.generate import build_score_model, build_sde
from psld_tpu_torch.models.ncsnpp import _model_kwargs

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "psld_tpu", "configs", "dataset")
GROUPS = sorted(f"{d}/{os.path.splitext(f)[0]}" for d in os.listdir(CONFIGS)
                for f in os.listdir(os.path.join(CONFIGS, d))
                if f.endswith(".yaml"))
PSLD_GROUPS = [g for g in GROUPS if g.endswith("_psld")]
OTHER_GROUPS = [g for g in GROUPS if not g.endswith("_psld")]
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
    assert OTHER_GROUPS and all(g.endswith("_vpsde") for g in OTHER_GROUPS)


@pytest.mark.parametrize("group", PSLD_GROUPS)
def test_score_net_of_config_matches_jax(group, latched_knobs):
    """The same constructor arguments as the JAX package, and a network
    built from them (on the meta device: no memory, full size)."""
    cfg = diffusion_cfg(group)
    assert _model_kwargs(cfg) == j_model_kwargs(cfg)
    with torch.device("meta"):
        net = build_score_model(cfg)
    assert sum(p.numel() for p in net.parameters()) > 0


@pytest.mark.parametrize("group", PSLD_GROUPS)
def test_sde_of_config_matches_jax(group):
    cfg = diffusion_cfg(group)
    sde, jsde = build_sde(cfg), JPSLD(cfg)
    z = np.random.default_rng(0).standard_normal(
        (len(TS), 4, 4, 6)).astype(np.float32)
    for got, want in zip(sde.sde(torch.from_numpy(z), torch.from_numpy(TS)),
                         jsde.sde(jnp.asarray(z), jnp.asarray(TS))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("group", OTHER_GROUPS)
def test_sample_refuses_an_sde_not_ported(group):
    """The entry point raises, naming the SDE, before it loads a
    checkpoint."""
    with pytest.raises(ValueError, match="No module named `vpsde`"):
        sample_cli.main([f"+dataset={group}",
                         "dataset.diffusion.data.root=/unused",
                         "dataset.diffusion.evaluation.chkpt_path=/unused",
                         "+dataset.diffusion.evaluation.device=cpu"])
