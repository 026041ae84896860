"""The port's PSLD score loss against the JAX package (CPU).

The JAX criterion draws its noise from a key; the test derives the same
key's draws (``split``, then ``normal``) and hands them to the port as
``eps`` and ``m0``, with the same ``t``. Loss values are held to 1e-5
relative on a stand-in score function (float32 sums in another order);
loss and parameter gradients on a small NCSN++ with converted weights to
1e-4 of each gradient's scale, the forward's tolerance carried through
the backward pass.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict
from psld_tpu.losses.score import PSLDScoreLoss as JLoss
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              load_flax_params)
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.sde.psld import PSLD
from test_torch_ncsnpp import jit_o0, random_flax_params

# the flagship option set at the smallest size that keeps every block kind
MICRO = dict(image_size=8, in_ch=6, out_ch=6, nf=16, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(4,), dropout=0.0, fir=True,
             embedding_type="fourier", progressive_input="residual")


def loss_cfg(nu=4.02, gamma=0.02, decomp="lower", mode="hsm",
             reduce_mean=True, **training):
    return ConfigDict({
        "model": {"sde": {
            "beta_min": 8.0, "beta_max": 8.0, "nu": nu, "gamma": gamma,
            "kappa": 0.04, "decomp_mode": decomp, "numerical_eps": 1e-9,
            "n_timesteps": 1000, "is_augmented": True}},
        "training": {"mode": mode, "loss": {
            "name": "psld_score_loss", "l_type": "l2", "weighting": "fid",
            "reduce_mean": reduce_mean}, **training}})


def jax_draws(key, x_shape):
    """(m0, eps) as ``PSLDScoreLoss.__call__`` draws them from ``key``;
    m0 is the standard normal, before its scaling."""
    k_m, k_eps = jax.random.split(key)
    m0 = jax.random.normal(k_m, x_shape, jnp.float32)
    eps = jax.random.normal(k_eps, x_shape[:-1] + (2 * x_shape[-1],),
                            jnp.float32)
    return np.array(m0), np.array(eps)  # writable copies


def batch(b=4, s=8, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, b)
    return x0, t


@pytest.mark.parametrize("reduce_mean", [True, False])
@pytest.mark.parametrize("mode", ["hsm", "dsm"])
@pytest.mark.parametrize("nu,gamma,decomp,c_out", [
    (4.02, 0.02, "lower", 6),   # score_xm: the whole eps
    (4.02, 0.02, "upper", 6),
    (4.0, 0.0, "lower", 3),     # score_m + lower: eps_m only
    (0.0, 4.0, "upper", 3),     # score_x + upper: eps_x only
])
def test_loss_value_matches_jax(nu, gamma, decomp, c_out, mode, reduce_mean):
    cfg = loss_cfg(nu, gamma, decomp, mode, reduce_mean)
    crit, jcrit = PSLDScoreLoss(cfg, PSLD(cfg)), JLoss(cfg, JPSLD(cfg))
    x0, t = batch()
    key = jax.random.PRNGKey(3)
    m0, eps = jax_draws(key, x0.shape)

    def j_score(z, tt):
        return jnp.tanh(z[..., :c_out]) * tt[:, None, None, None]

    def t_score(z, tt):
        assert z.dtype == torch.float32 and tt.dtype == torch.float32
        return torch.tanh(z[..., :c_out]) * tt[:, None, None, None]

    want = float(jcrit(jnp.asarray(x0), jnp.asarray(t), j_score, key))
    got = crit(torch.from_numpy(x0), torch.from_numpy(t), t_score,
               eps=torch.from_numpy(eps), m0=torch.from_numpy(m0))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_loss_draws_from_the_rng_in_a_fixed_order():
    """Without injected draws the criterion takes m0 (DSM only), then eps,
    from the run's random source: the same seed gives the same loss, and
    handing in what the source would have drawn gives it too."""
    from psld_tpu_torch.train.steps import StepRandom

    cfg = loss_cfg(mode="dsm")
    crit = PSLDScoreLoss(cfg, PSLD(cfg))
    x0, t = (torch.from_numpy(a) for a in batch())

    def score(z, tt):
        return torch.tanh(z)

    a = crit(x0, t, score, StepRandom(5))
    rng = StepRandom(5)
    m0 = rng.normal(x0.shape)
    eps = rng.normal(x0.shape[:-1] + (6,))
    assert float(a) == float(crit(x0, t, score, eps=eps, m0=m0))
    assert float(a) != float(crit(x0, t, score, StepRandom(6)))


def test_loss_refuses_what_the_jax_criterion_asserts():
    cfg = loss_cfg()
    with pytest.raises(TypeError):
        PSLDScoreLoss(cfg, object())
    bad = loss_cfg(mode="ism")
    with pytest.raises(ValueError):
        PSLDScoreLoss(bad, PSLD(bad))


@pytest.mark.parametrize("mode", ["hsm", "dsm"])
def test_loss_and_param_gradients_match_jax(mode):
    cfg = loss_cfg(mode=mode)
    jnet = JNCSNpp(**MICRO)
    params = random_flax_params(jnet, MICRO, seed=1)
    net = load_flax_params(NCSNpp(**MICRO), params)
    crit, jcrit = PSLDScoreLoss(cfg, PSLD(cfg)), JLoss(cfg, JPSLD(cfg))
    x0, t = batch()
    key = jax.random.PRNGKey(4)
    m0, eps = jax_draws(key, x0.shape)

    def j_loss(p):
        return jcrit(jnp.asarray(x0), jnp.asarray(t),
                     lambda z, tt: jnet.apply(p, z, tt, train=True,
                                              rngs={"dropout": key}), key)

    want, jgrads = jit_o0(jax.value_and_grad(j_loss), params)
    loss = crit(torch.from_numpy(x0), torch.from_numpy(t),
                lambda z, tt: net(z, tt, train=True),
                eps=torch.from_numpy(eps), m0=torch.from_numpy(m0))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    names = [k for k, p in net.named_parameters() if p.requires_grad]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [p for p in net.parameters() if p.requires_grad])))
    jgrads = flax_to_state_dict(jax.device_get(jgrads), net)
    assert set(jgrads) - set(grads) == {"GaussianFourierProjection_0.W"}
    assert not jgrads["GaussianFourierProjection_0.W"].any()
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for k, g in grads.items():
        w = jgrads[k]
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-4 * max(float(w.abs().max()), 1e-3 * scale), err_msg=k)
