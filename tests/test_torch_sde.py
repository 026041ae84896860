"""The port's PSLD SDE and time grid against the JAX package (CPU).

Per-batch coefficients are float64 in both packages (the JAX side runs
under x64, as every entry point does) and are cast to the tensor dtype at
the edge, so:

* float64 coefficient pipelines (covariance, inverse factor) agree to
  1e-12 relative: the same formulas, evaluated by two libms;
* float32 tensors (score, drift, diffusion) agree to 1e-6 of the
  tensor's largest magnitude: each element is one float64 coefficient
  rounded to float32, then a few float32 products and a difference that
  can cancel, so the error is relative to the terms, not to the result;
* the time grid agrees to 1e-12 relative (``np.linspace`` against
  ``jnp.linspace``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.samplers.base import make_timesteps
from psld_tpu_torch.sde.psld import PSLD, join_xm, split_xm

# the (nu, gamma) grid of tests/test_sde_psld.py
PARAM_GRID = [(4.01, 0.01), (4.02, 0.02), (4.005, 0.005), (4.0, 0.0),
              (1.0, 2.0)]
TS = np.array([1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.35, 0.7, 0.999, 1.0])
F64 = dict(rtol=1e-12, atol=1e-300)


def assert_f32_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _sde_cfg(nu, gamma, decomp):
    return {"model": {"sde": {
        "beta_min": 8.0, "beta_max": 8.0, "nu": nu, "gamma": gamma,
        "kappa": 0.04, "decomp_mode": decomp, "numerical_eps": 1e-9,
        "n_timesteps": 1000, "is_augmented": True}}}


def make_pair(nu, gamma, decomp="lower"):
    cfg = _sde_cfg(nu, gamma, decomp)
    return PSLD(ConfigDict(cfg)), JPSLD(ConfigDict(cfg))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("decomp", ["lower", "upper"])
@pytest.mark.parametrize("nu,gamma", PARAM_GRID)
def test_cov_and_inverse_factor_match_jax(nu, gamma, decomp):
    sde, jsde = make_pair(nu, gamma, decomp)
    t, jt = torch.from_numpy(TS), jnp.asarray(TS)
    for xx0, mm0 in [(0.0, sde.mm_0), (0.3, 0.7)]:
        var, jvar = sde._cov(xx0, mm0, t), jsde._cov(xx0, mm0, jt)
        for g, w in zip(var, jvar):
            np.testing.assert_allclose(_np(g), _np(w), **F64)
        for g, w in zip(sde.get_inv_coeff(var), jsde.get_inv_coeff(jvar)):
            np.testing.assert_allclose(_np(g), _np(w), **F64)


@pytest.mark.parametrize("decomp", ["lower", "upper"])
@pytest.mark.parametrize("nu,gamma", PARAM_GRID)
def test_get_score_matches_jax(nu, gamma, decomp):
    sde, jsde = make_pair(nu, gamma, decomp)
    b = len(TS)
    # reduced-output modes hand the score net's C-channel output in
    reduced = (decomp, sde.mode) in (("lower", "score_m"),
                                     ("upper", "score_x"))
    eps = rand((b, 4, 4, 3 if reduced else 6), 1)
    got = sde.get_score(torch.from_numpy(eps), 0.0, sde.mm_0,
                        torch.from_numpy(TS))
    want = jsde.get_score(jnp.asarray(eps), 0.0, jsde.mm_0, jnp.asarray(TS))
    assert got.dtype == torch.float32 and got.shape == (b, 4, 4, 6)
    assert_f32_close(_np(got), _np(want))


@pytest.mark.parametrize("nu,gamma", PARAM_GRID)
def test_sde_and_reverse_sde_match_jax(nu, gamma):
    sde, jsde = make_pair(nu, gamma)
    b = len(TS)
    z = rand((b, 4, 4, 6), 2)
    tz, jz = torch.from_numpy(z), jnp.asarray(z)
    for got, want in zip(sde.sde(tz, torch.from_numpy(TS)),
                         jsde.sde(jz, jnp.asarray(TS))):
        assert_f32_close(_np(got), _np(want))

    # a score net stand-in: the same smooth function of (z, t) on each
    # side, with C output channels in the reduced score_m mode
    c_out = 3 if sde.mode == "score_m" else 6

    def t_score(z_, t_):
        assert z_.dtype == torch.float32 and t_.dtype == torch.float32
        return torch.tanh(z_[..., :c_out]) * t_[:, None, None, None]

    def j_score(z_, t_):
        return jnp.tanh(z_[..., :c_out]) * t_[:, None, None, None]

    ts = 1.0 - TS  # sampler time, measured from the prior end
    for pf in (False, True):
        got = sde.reverse_sde(tz, torch.from_numpy(ts), t_score, pf)
        want = jsde.reverse_sde(jz, jnp.asarray(ts), j_score, pf)
        for g, w in zip(got, want):
            assert_f32_close(_np(g), _np(w))


def test_split_join_roundtrip():
    z = torch.from_numpy(rand((2, 4, 4, 6), 3))
    x, m = split_xm(z)
    assert x.shape == m.shape == (2, 4, 4, 3)
    assert torch.equal(join_xm(x, m), z)


def test_prior_sampling_shape_and_scale():
    """x ~ N(0, 1) and m ~ N(0, M) on the generator's device."""
    sde, _ = make_pair(4.01, 0.01)
    gen = torch.Generator().manual_seed(0)
    z = sde.prior_sampling(gen, (64, 8, 8, 3))
    assert z.shape == (64, 8, 8, 6) and z.dtype == torch.float32
    x, m = split_xm(z)
    assert abs(float(x.std()) - 1.0) < 0.02
    assert abs(float(m.std()) / np.sqrt(sde.m) - 1.0) < 0.02


@pytest.mark.parametrize("stride", ["uniform", "quadratic"])
@pytest.mark.parametrize("n", [9, 999])
def test_make_timesteps_matches_jax(n, stride):
    got = make_timesteps(n, 1e-3, 1.0, stride)
    want = j_make_timesteps(n, 1e-3, 1.0, stride)
    assert got.dtype == torch.float64 and got.shape == (n + 1,)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=1e-15)
