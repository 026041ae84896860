"""The port's probability-flow likelihood against the JAX package's (CPU).

Draws are injected: the momentum of the variational bound and the
Hutchinson probes come from a numpy seed (or are regenerated from the JAX
side's keys) and go to both sides.

Tolerances:

* float64 (analytic score, ``prior_logp``, the bound): 1e-9 relative;
  the same float64 arithmetic in another order. ``prior_logp`` of a
  float32 state: 1e-6 relative (its squared norms sum in float32 in
  another order).
* the one-level NCSN++ of ``test_torch_clf`` in float32: the state and
  the divergence within 1e-4 of their scale, as the EM trajectory of
  ``test_torch_sampler`` (the divergence sums 384 products of the
  forward's and the backward's ~1e-6 disagreements), so ``logp`` and
  bits/dim within 1e-6 relative.
* the closed-form joint Gaussian NLL of PSLD: 1e-3 nats absolute, as
  ``tests/test_likelihood.py`` holds the JAX package's.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.eval import likelihood as jlik
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.config import ConfigDict, compose
from psld_tpu_torch.eval import likelihood as lik
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.sde.psld import PSLD, join_xm, split_xm
from psld_tpu_torch.utils.numerics import bcast_right
from test_torch_clf import SCORE, pair
from test_torch_ncsnpp import assert_close_to_scale, jit_o0
from test_torch_ode import cfg, j_exact_score, t_exact_score

SIGMA0 = 0.6
EPS = 1e-5


def sdes(nu=4.01, gamma=0.01):
    d = cfg("em_sde", nu=nu, gamma=gamma)
    return JPSLD(JConfigDict(d)), PSLD(ConfigDict(d))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_prior_logp_matches_jax(dtype):
    jsde, sde = sdes()
    z = np.random.default_rng(0).standard_normal((3, 4, 4, 6)).astype(dtype)
    z[..., 3:] *= 0.5
    want = np.asarray(jsde.prior_logp(jnp.asarray(z)))
    got = sde.prior_logp(torch.from_numpy(z))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=1e-9 if dtype == np.float64 else 1e-6)
    for g, w in zip(sde.likelihood_weighting(torch.tensor(
            [0.2, 0.9], dtype=torch.float64)),
                    jsde.likelihood_weighting(jnp.asarray([0.2, 0.9]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_bits_per_dim_matches_jax():
    d = 3072
    # density 1/2 a dimension on [-1, 1] is 8-bit uniform data: 8 bits/dim
    assert lik.bits_per_dim(d * math.log(2.0), d) == pytest.approx(8.0)
    nll = np.array([1234.5, 6789.0, -10.0])
    np.testing.assert_allclose(lik.bits_per_dim(nll, 48, n_bits=5),
                               np.asarray(jlik.bits_per_dim(nll, 48, 5)),
                               rtol=1e-12)
    jsde, sde = sdes()
    assert lik.augmented_entropy_q(sde, (2, 8, 8, 3)) == pytest.approx(
        jlik.augmented_entropy_q(jsde, (2, 8, 8, 3)), rel=1e-12)


def test_divergence_exact_and_hutchinson_on_a_linear_drift():
    """An elementwise linear drift: the Jacobian is diagonal, so the
    trace is the sum of the coefficients and Rademacher Hutchinson is
    exact; every row chunk (one, a ragged one, all rows) gives it."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((3, 2, 3, 2)))
    z = torch.from_numpy(rng.standard_normal((3, 2, 3, 2)))
    want = a.sum((1, 2, 3))

    def drift(zz):  # the exact trace hands in copies of the batch
        return a.repeat(zz.shape[0] // 3, 1, 1, 1) * zz

    for chunk in (1, 5, 12, 32):
        got = lik._divergence_exact(drift, z, row_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    probes = lik.rademacher(torch.Generator().manual_seed(0), 4, z)
    assert set(probes.unique().tolist()) == {-1.0, 1.0}
    drift, div = lik._divergence_hutchinson(drift, z, probes)
    np.testing.assert_allclose(drift.numpy(), (a * z).numpy())
    np.testing.assert_allclose(div.numpy(), want.numpy(), rtol=1e-12)


def test_divergence_exact_matches_jax_on_a_coupled_drift():
    """A drift that mixes elements (a dense matrix on the flattened
    sample, then tanh): the trace against the JAX package's."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((12, 12)) / 4
    z = rng.standard_normal((2, 2, 3, 2))

    def j_f(zz):
        return jnp.tanh(zz.reshape(2, 12) @ w).reshape(zz.shape)

    tw = torch.from_numpy(w)

    def t_f(zz):
        return torch.tanh(zz.reshape(zz.shape[0], 12) @ tw).reshape(zz.shape)

    want = np.asarray(jlik._divergence_exact(j_f, jnp.asarray(z)))
    for chunk in (32, 5):
        got = lik._divergence_exact(t_f, torch.from_numpy(z), chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def psld_gaussian_score(sde, sigma0):
    """The port's copy of ``tests/test_likelihood.py``'s exact
    eps-prediction for z0 = (x0, m0), x0 ~ N(0, sigma0^2), m0 ~ N(0,
    mm_0), in float64."""
    def score_fn(z, t):
        t, z = t.double(), z.double()
        xx, xm, mm = sde._cov(sigma0 ** 2, sde.mm_0, t)
        det = xx * mm - xm * xm
        x, m = split_xm(z)

        def c(v):
            return bcast_right(v, x.ndim)

        s_x = -(c(mm) * x - c(xm) * m) / c(det)
        s_m = -(-c(xm) * x + c(xx) * m) / c(det)
        l11, l12, l21, l22 = sde.get_coeff(sde._cov(0.0, sde.mm_0, t))
        return join_xm(-(c(l11) * s_x + c(l21) * s_m),
                       -(c(l12) * s_x + c(l22) * s_m))

    return score_fn


def test_psld_joint_exact_gaussian_nll():
    """With the exact score of a Gaussian the probability-flow ODE is
    exact, and the joint log-density of (x, m) at t = eps is the
    Gaussian's, to the RK4 grid's error."""
    _, sde = sdes()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 4, 4, 1)) * SIGMA0
    m = rng.standard_normal((6, 4, 4, 1)) * np.sqrt(sde.mm_0)
    z = torch.from_numpy(np.concatenate([x, m], axis=-1))
    fn = lik.make_likelihood_fn(sde, psld_gaussian_score(sde, SIGMA0),
                                n_steps=128, eps=EPS, method="rk4",
                                exact_div=True)
    out = fn(None, z)
    xx, xm, mm = (float(v) for v in sde._cov(SIGMA0 ** 2, sde.mm_0,
                                              torch.tensor([EPS])))
    det = xx * mm - xm * xm
    quad = (mm * (x * x).sum((1, 2, 3)) - 2 * xm * (x * m).sum((1, 2, 3))
            + xx * (m * m).sum((1, 2, 3))) / det
    d = 16
    want = -d * np.log(2 * np.pi) - 0.5 * d * np.log(det) - 0.5 * quad
    assert out["logp"].dtype == torch.float64 and out["nfe"] == 4 * 128
    np.testing.assert_allclose(out["logp"].numpy(), want, rtol=0, atol=1e-3)


def test_augmented_bound_matches_jax_with_its_draws():
    """``augmented_nll_bound`` on the analytic score, Hutchinson with two
    probes, Heun: the JAX package's momentum and probes are regenerated
    from its key and handed to the port."""
    jsde, sde = sdes()
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(3).standard_normal((4, 2, 2, 3)) * SIGMA0
    kw = dict(n_steps=6, eps=EPS, method="heun", n_probes=2)
    jfn = jlik.make_likelihood_fn(jsde, j_exact_score(jsde, SIGMA0), **kw)
    want, jout = jit_o0(lambda xx: jlik.augmented_nll_bound(
        jsde, jfn, key, xx), jnp.asarray(x))
    k_m, k_l = jax.random.split(key)
    m = np.asarray(jax.random.normal(k_m, x.shape, jnp.float64)) \
        * np.sqrt(jsde.mm_0)
    probes = np.asarray(jax.random.rademacher(
        k_l, (2, 4, 2, 2, 6), jnp.int8)).astype(np.float64)
    fn = lik.make_likelihood_fn(sde, t_exact_score(sde, SIGMA0), **kw)
    got, out = lik.augmented_nll_bound(
        sde, fn, None, torch.from_numpy(x), m=torch.from_numpy(m),
        probes=torch.from_numpy(probes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    for k in ("logp", "prior_logp", "delta_logp", "z_T"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    assert out["nfe"] == int(jout["nfe"]) == 2 * 2 * 6


# -- the network, float32 ----------------------------------------------------
B = 2
N_STEPS = 1
NET_EPS = 0.05  # the random network's drift is O(1 / sqrt(t)) near 0
_COMPILED = {}


def _jax_rk4(jsde, z, probes):
    """One RK4 step of the JAX package's integral on the one-level
    NCSN++ over [NET_EPS, T], the probes placed in the carry: (logp,
    delta_logp, z_T). Compiled once for the process; the network is a
    jitted function of its own, so its four forwards and pullbacks are
    traced once, which halves the compile."""
    jnet, params, _ = pair(SCORE, (JNCSNpp, NCSNpp))
    apply = jax.jit(jnet.apply)

    def run(p, zz, pr):
        fn = jlik.make_likelihood_fn(
            jsde, lambda a, t: apply(p, a, t), n_steps=N_STEPS,
            eps=NET_EPS, method="rk4", n_probes=pr.shape[0])
        ts = fn.segment_ts()
        carry = (zz, jnp.zeros((zz.shape[0],), jnp.float64), pr)
        carry, _ = fn.segment_body(carry, (ts[0], ts[1]))
        out = fn.segment_finalize(carry)
        return out["logp"], out["delta_logp"], out["z_T"]

    args = (params, jnp.asarray(z), jnp.asarray(probes))
    if "rk4" not in _COMPILED:
        _COMPILED["rk4"] = jax.jit(run).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    return [np.asarray(a) for a in _COMPILED["rk4"](*args)]


def _draws(seed, x_shape, n_probes=1):
    """A momentum draw of q and Rademacher probes of the joint state,
    float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal(x_shape) * np.sqrt(0.04 * 0.25)).astype(
        np.float32)
    probes = rng.choice([-1.0, 1.0], (n_probes,) + x_shape[:-1]
                        + (2 * x_shape[-1],)).astype(np.float32)
    return m, probes


def test_hutchinson_rhs_and_rk4_step_on_the_network_match_jax():
    jsde, sde = sdes()
    jnet, params, net = pair(SCORE, (JNCSNpp, NCSNpp))
    rng = np.random.default_rng(4)
    z = rng.standard_normal((B, 8, 8, 6)).astype(np.float32)
    _, probes = _draws(5, (B, 8, 8, 3), n_probes=2)
    score = make_score_fn(net)

    # the right-hand side at one time: the drift and the divergence
    t = 0.3
    j_drift = lambda zz: jlik._pf_drift(  # noqa: E731
        jsde, lambda a, tt: jnet.apply(params, a, tt), zz, t)
    want_drift, want_div = jit_o0(lambda zz, pr: (
        j_drift(zz), jlik._divergence_hutchinson(j_drift, zz, pr)),
        jnp.asarray(z), jnp.asarray(probes))
    with torch.no_grad():
        drift, div = lik._divergence_hutchinson(
            lambda zz: lik._pf_drift(sde, score, zz, t), torch.from_numpy(z),
            torch.from_numpy(probes))
    assert_close_to_scale(drift.numpy(), want_drift, 1e-4)
    assert_close_to_scale(div.numpy(), want_div, 1e-4)

    # one RK4 step (4 right-hand sides) and the prior at its end
    logp, delta, z_t = _jax_rk4(jsde, z, probes[:1])
    fn = lik.make_likelihood_fn(sde, score, n_steps=N_STEPS, eps=NET_EPS,
                                method="rk4")
    with torch.no_grad():
        out = fn(None, torch.from_numpy(z), probes=torch.from_numpy(
            probes[:1]))
    assert out["nfe"] == 4
    assert_close_to_scale(out["z_T"].numpy(), z_t, 1e-4)
    assert_close_to_scale(out["delta_logp"].numpy(), delta, 1e-4)
    np.testing.assert_allclose(out["logp"].numpy(), logp, rtol=1e-6)


def test_evaluate_nll_matches_jax(tmp_path, monkeypatch):
    """``evaluate_nll`` from a ``.pt`` checkpoint of the converted
    one-level NCSN++ on the synthetic set at 8x8: two unshuffled batches
    of 2 (``n_samples`` 5 caps three to two), one RK4 step, against the
    JAX package's integral and bound on the same images with the same
    momentum and probes, injected by batch."""
    _, _, net = pair(SCORE, (JNCSNpp, NCSNpp))
    sd = net.state_dict()
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"params": sd, "ema_params": sd, "step": 10 ** 6}, ckpt)
    config = compose([
        "+dataset=cifar10/cifar10_psld", "dataset.diffusion.data.root=/unused",
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
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        "dataset.diffusion.evaluation.batch_size=2",
        "dataset.diffusion.evaluation.n_samples=5",
        f"+dataset.diffusion.evaluation.likelihood.n_steps={N_STEPS}",
        f"+dataset.diffusion.evaluation.likelihood.eps={NET_EPS}",
        "+dataset.diffusion.evaluation.likelihood.solver=rk4",
        "+dataset.diffusion.evaluation.likelihood.steps_per_dispatch=4",
        "+dataset.diffusion.evaluation.device=cpu",
    ]).dataset.diffusion
    draws = [_draws(10 + i, (B, 8, 8, 3)) for i in range(2)]
    calls = iter(range(2))
    batch_of = {}

    def draw(sde_, gen, x, m=None):
        batch_of["i"] = next(calls)
        return torch.cat([x, torch.from_numpy(draws[batch_of["i"]][0])], -1)

    def probes(gen, n_probes, like):
        return torch.from_numpy(draws[batch_of["i"]][1])

    monkeypatch.setattr(lik, "augmented_draw", draw)
    monkeypatch.setattr(lik, "rademacher", probes)
    bpd, batches = lik.evaluate_nll(config)

    from psld_tpu_torch.data.loader import get_dataset

    images = get_dataset(config).batch(np.arange(4)).astype(np.float32)
    jsde = JPSLD(JConfigDict(config.to_dict()))
    h = jlik.augmented_entropy_q(jsde, (B, 8, 8, 3))
    want = []
    for i, (m, probes) in enumerate(draws):
        z = np.concatenate([images[2 * i: 2 * i + 2], m], axis=-1)
        logp, _, _ = _jax_rk4(jsde, z, probes)
        want.append(np.asarray(jlik.bits_per_dim(-logp - h, 8 * 8 * 3)))
    assert [(b["batch"], b["samples"], b["nfe"], b["nonfinite"])
            for b in batches] == [(0, 2, 4, 0), (1, 2, 4, 0)]
    for b, w in zip(batches, want):
        np.testing.assert_allclose(b["bits_per_dim"], w.mean(), rtol=1e-6)
    np.testing.assert_allclose(bpd, np.concatenate(want).mean(), rtol=1e-6)
