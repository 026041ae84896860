"""The port's Euler--Maruyama sampler against the JAX package's (CPU).

A 10-NFE trajectory (9 noisy steps and the mean-only denoise step) on the
tiny flagship-option NCSN++ of ``test_torch_ncsnpp``, float32. JAX's
threefry and PyTorch's generators give different numbers, so the test
regenerates the JAX sampler's per-step draws (``key, sub = split(key)``;
``normal(sub)``) as numpy and hands them to the port's sampler, and both
start from the same prior draw.

Tolerance: 1e-4 of the sample's largest magnitude. Each step adds the
forward's ~1e-6 disagreement (see ``test_torch_ncsnpp``), and the
trajectory carries it through ten steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict
from psld_tpu.samplers import sde_samplers as jsamplers
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.samplers.base import make_timesteps
from psld_tpu_torch.samplers.sde_samplers import (EulerMaruyamaSampler,
                                                  _step_grid)
from psld_tpu_torch.sde.psld import PSLD
from test_torch_ncsnpp import assert_close_to_scale, jit_o0, tiny_pair

N_STEPS = 10  # evaluation.n_discrete_steps; denoise takes the last one
EPS = 1e-3
B = 2
CFG = {"model": {"sde": {
    "beta_min": 8.0, "beta_max": 8.0, "nu": 4.02, "gamma": 0.02,
    "kappa": 0.04, "decomp_mode": "lower", "numerical_eps": 1e-9,
    "n_timesteps": 1000, "is_augmented": True}},
    "evaluation": {"n_discrete_steps": N_STEPS}}


def _jax_run():
    """(prior, per-row noise, final sample) of the JAX sampler, from one
    compiled program."""
    jnet, params, _ = tiny_pair()
    cfg = ConfigDict(CFG)
    jsde = JPSLD(cfg)
    ts = j_make_timesteps(N_STEPS - 1, EPS)

    def run(p, key):
        z = jsde.prior_sampling(jax.random.fold_in(key, 0), (B, 16, 16, 3))
        sampler = jsamplers.EulerMaruyamaSampler(
            cfg, jsde, lambda zz, tt: jnet.apply(p, zz, tt))
        out = sampler.sample(key, z, ts, N_STEPS - 1, denoise=True, eps=EPS)
        noise, k = [], key
        for _ in range(N_STEPS):  # one split per grid row, as the scan body
            k, sub = jax.random.split(k)
            noise.append(jax.random.normal(sub, z.shape, z.dtype))
        return z, noise, out

    z, noise, out = jit_o0(run, params, jax.random.PRNGKey(7))
    return np.array(z), [np.array(n) for n in noise], np.asarray(out)


def _port_sampler():
    _, _, net = tiny_pair()
    return EulerMaruyamaSampler(ConfigDict(CFG), PSLD(ConfigDict(CFG)),
                                make_score_fn(net))


def test_em_trajectory_matches_jax_with_injected_noise():
    z, noise, want = _jax_run()
    sampler = _port_sampler()
    with torch.inference_mode():
        got = sampler.sample(None, torch.from_numpy(z),
                             make_timesteps(N_STEPS - 1, EPS), N_STEPS - 1,
                             denoise=True, eps=EPS,
                             noise=lambda i, x: torch.from_numpy(noise[i]))
    assert got.shape == (B, 16, 16, 6) and got.dtype == torch.float32
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("denoise", [True, False])
def test_step_grid_matches_jax(denoise):
    sde = PSLD(ConfigDict(CFG))
    ts = make_timesteps(N_STEPS - 1, EPS)
    rows = np.asarray(_step_grid(sde, ts, denoise, EPS))
    want = np.stack([np.asarray(a) for a in jsamplers._step_grid(
        JPSLD(ConfigDict(CFG)), j_make_timesteps(N_STEPS - 1, EPS),
        denoise, EPS)], axis=1)
    np.testing.assert_allclose(rows, want, rtol=1e-12, atol=1e-15)


def test_generator_noise_is_reproducible():
    """Without injected noise the trajectory draws from the generator it
    is given: the same seed gives the same samples, another seed others."""
    sampler = _port_sampler()
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 16, 16, 6)).astype(np.float32))
    ts = make_timesteps(3, EPS)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            return sampler.sample(gen, z, ts, 3, denoise=True, eps=EPS)

    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
