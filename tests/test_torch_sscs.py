"""The port's SSCS and SSCS-2M samplers against the JAX package's (CPU).

``sscs_transition`` is held in float64 to 1e-12 relative over a (t, dt)
grid and the (nu, gamma) grid of ``tests/test_sde_psld.py``: the same
float64 formulas, evaluated by two libraries.

Trajectories run on a one-level NCSN++ with converted weights, float32.
JAX's threefry and PyTorch's generators give different numbers, so the
test regenerates the JAX sampler's draws (per step ``key, sub =
split(key)``, ``k1, k2 = split(sub)``, one normal from each) and hands
them to the port as draws 2i and 2i+1. Tolerance: 1e-4 of the sample's
largest magnitude, as for the EM trajectory of ``test_torch_sampler``:
each step carries the forward's ~1e-6 disagreement.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.samplers import sde_samplers as jsamplers
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.interop.from_flax import load_flax_params
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.samplers import SSCS2MSampler, SSCSSampler
from psld_tpu_torch.samplers.base import make_timesteps
from psld_tpu_torch.sde.psld import PSLD
from test_torch_loss import MICRO
from test_torch_ncsnpp import assert_close_to_scale, jit_o0, \
    random_flax_params

# (nu, gamma) of tests/test_sde_psld.py
PARAM_GRID = [(4.01, 0.01), (4.02, 0.02), (4.005, 0.005), (4.0, 0.0),
              (1.0, 2.0)]
NANO = {**MICRO, "ch_mult": (1,), "attn_resolutions": (8,)}
B, S = 2, 8


def sde_cfg(nu=4.02, gamma=0.02, decomp="lower", n_steps=4, name="sscs_sde"):
    return {"model": {"sde": {
        "beta_min": 8.0, "beta_max": 8.0, "nu": nu, "gamma": gamma,
        "kappa": 0.04, "decomp_mode": decomp, "numerical_eps": 1e-9,
        "n_timesteps": 1000, "is_augmented": True}},
        "evaluation": {"n_discrete_steps": n_steps,
                       "sampler": {"name": name}}}


@pytest.mark.parametrize("decomp", ["lower", "upper"])
@pytest.mark.parametrize("nu,gamma", PARAM_GRID)
def test_sscs_transition_matches_jax(nu, gamma, decomp):
    cfg = sde_cfg(nu, gamma, decomp)
    sde, jsde = PSLD(ConfigDict(cfg)), JPSLD(JConfigDict(cfg))
    t = np.array([0.0, 1e-3, 0.1, 0.5, 0.9, 0.998])
    for dt in (5e-4, 1e-3 / 2, 0.01, 0.1, 0.249):
        got_m, got_v = sde.sscs_transition(torch.from_numpy(t), dt)
        want_m, want_v = jsde.sscs_transition(jnp.asarray(t), dt)
        for g, w in zip((*got_m, *got_v), (*want_m, *want_v)):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-300)
        # the triangular factor of the tiny half-step covariance
        for g, w in zip(sde.get_coeff(got_v), jsde.get_coeff(want_v)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-300)


_PAIR = {}


def nano_pair():
    """(JAX net, flax params, port net with those params), built once."""
    if not _PAIR:
        jnet = JNCSNpp(**NANO)
        params = random_flax_params(jnet, NANO, seed=1)
        _PAIR["pair"] = (jnet, params,
                         load_flax_params(NCSNpp(**NANO), params).eval())
    return _PAIR["pair"]


def _jax_run(name, n_steps, stride, denoise):
    """(prior, per-draw noise, final sample) of the JAX sampler."""
    jnet, params, _ = nano_pair()
    cfg = JConfigDict(sde_cfg(n_steps=n_steps, name=name))
    jsde = JPSLD(cfg)
    cls = {"sscs_sde": jsamplers.SSCSSampler,
           "sscs2m_sde": jsamplers.SSCS2MSampler}[name]
    n_eff = n_steps - 1 if denoise else n_steps
    ts = j_make_timesteps(n_eff, 1e-3, stride_type=stride)

    def run(p, key):
        z = jsde.prior_sampling(jax.random.fold_in(key, 0), (B, S, S, 3))
        sampler = cls(cfg, jsde, lambda zz, tt: jnet.apply(p, zz, tt))
        out = sampler.sample(key, z, ts, n_eff, denoise=denoise, eps=1e-3)
        noise, k = [], key
        for _ in range(n_eff):  # the scan body's splits
            k, sub = jax.random.split(k)
            for kk in jax.random.split(sub):
                noise.append(jax.random.normal(kk, z.shape, z.dtype))
        return z, noise, out

    z, noise, out = jit_o0(run, params, jax.random.PRNGKey(11))
    return np.array(z), [np.array(n) for n in noise], np.asarray(out), n_eff


@pytest.mark.parametrize("name,stride,denoise", [
    ("sscs_sde", "uniform", True),
    ("sscs_sde", "quadratic", False),
    ("sscs2m_sde", "uniform", False),
    ("sscs2m_sde", "quadratic", True),
])
def test_trajectory_matches_jax_with_injected_noise(name, stride, denoise):
    z, noise, want, n_eff = _jax_run(name, 4, stride, denoise)
    _, _, net = nano_pair()
    cfg = ConfigDict(sde_cfg(n_steps=4, name=name))
    cls = {"sscs_sde": SSCSSampler, "sscs2m_sde": SSCS2MSampler}[name]
    sampler = cls(cfg, PSLD(cfg), make_score_fn(net))
    used = []

    def draw(k, x):
        used.append(k)
        return torch.from_numpy(noise[k])

    with torch.inference_mode():
        got = sampler.sample(None, torch.from_numpy(z),
                             make_timesteps(n_eff, 1e-3, stride_type=stride),
                             n_eff, denoise=denoise, eps=1e-3, noise=draw)
    assert used == list(range(2 * n_eff))
    assert got.shape == (B, S, S, 6) and got.dtype == torch.float32
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


def test_sscs2m_single_interval_is_sscs():
    """With no history the first interval is exactly one SSCS step: the
    same draws give the same state, bit for bit; a second interval
    differs."""
    _, _, net = nano_pair()
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, S, 6)).astype(np.float32))
    out = {}
    for n in (1, 2):
        for cls in (SSCSSampler, SSCS2MSampler):
            cfg = ConfigDict(sde_cfg(n_steps=n + 1))
            sampler = cls(cfg, PSLD(cfg), make_score_fn(net))
            with torch.inference_mode():
                out[n, cls] = sampler.sample(
                    torch.Generator().manual_seed(5), z,
                    make_timesteps(n, 1e-3), n, denoise=True, eps=1e-3)
    assert torch.isfinite(out[1, SSCSSampler]).all()
    assert torch.equal(out[1, SSCSSampler], out[1, SSCS2MSampler])
    assert not torch.equal(out[2, SSCSSampler], out[2, SSCS2MSampler])
