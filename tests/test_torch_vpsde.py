"""The port's VP-SDE baseline against the JAX package's (CPU): the SDE,
the score loss, one training step, the samplers that run it (EM with and
without the Langevin corrector, editing, ``ei_ode`` orders 1-3,
``rk_ode``, ``adaptive_ode``, ``cc_ei_ode``) and the likelihood's
non-augmented NLL through ``evaluate_nll``.

Draws are injected: JAX's threefry and PyTorch's generators differ, so
each test regenerates the JAX side's draws from its keys (or draws them
from a numpy seed) and hands them to the port.

Tolerances:

* SDE methods: float64 coefficients within 1e-12 relative (the same
  formulas, two libms); float32 tensors within 1e-6 of their largest
  magnitude (one float64 coefficient rounded to float32, then a few
  float32 operations).
* the score loss on a stand-in score function: 1e-5 relative (float32
  sums in another order).
* one training step of the one-level VP NCSN++ (the shipped VP option
  set: positional embedding, no FIR, BigGAN blocks, 3 channels) with
  converted weights: the loss within 1e-5 relative, every parameter's
  gradient (Adam's first moment after a step at learning rate 0) within
  1e-4 of the larger of its own scale and 1e-3 of the largest one, as
  ``test_torch_loss`` holds PSLD's.
* trajectories: on that network in float32, 1e-4 of their scale, as the
  EM trajectory of ``test_torch_sampler``; on the analytic score of
  Gaussian data in float64 (the ODE samplers), 1e-9 of scale, and the
  adaptive solver 1e-6 with the same number of steps (``test_torch_ode``
  says why); ``ei_ode``'s tables 1e-12.
* the NLL and bits/dim of ``evaluate_nll``: 1e-5 relative (the state and
  the divergence within 1e-4 of their scale).
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
from psld_tpu.losses.score import ScoreLoss as JScoreLoss
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.samplers import correctors as jcorrectors
from psld_tpu.samplers import ode as jode
from psld_tpu.samplers import sde_samplers as jsamplers
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.vpsde import VPSDE as JVPSDE
from psld_tpu.train.state import init_state as j_init_state
from psld_tpu.train.steps import make_train_step as j_make_train_step
from psld_tpu.train.steps import sample_times as j_sample_times
from psld_tpu.utils.numerics import bcast_right as j_bcast_right
from psld_tpu_torch.config import ConfigDict, compose
from psld_tpu_torch.eval import likelihood as lik
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              load_flax_params)
from psld_tpu_torch.losses.score import ScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.registry import get_module
from psld_tpu_torch.samplers import (EditEulerMaruyamaSampler,
                                     EulerMaruyamaInpainter,
                                     EulerMaruyamaSampler, SSCS2MSampler,
                                     SSCSSampler, build_corrector,
                                     make_timesteps)
from psld_tpu_torch.sde.vpsde import VPSDE
from psld_tpu_torch.train.state import init_state
from psld_tpu_torch.train.steps import make_train_step
from psld_tpu_torch.utils.numerics import bcast_right
from test_torch_ncsnpp import assert_close_to_scale, jit_o0, \
    random_flax_params
from test_torch_train import adam_state, assert_states_close

TS = np.array([1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.35, 0.7, 0.999, 1.0])
B, S, C, EPS = 2, 8, 3, 1e-3
F64_TOL = 1e-9
# the shipped VP option set (cifar10_vpsde.yaml) at one level of 8x8
VP_NANO = dict(image_size=S, in_ch=C, out_ch=C, nf=16, ch_mult=(1,),
               num_res_blocks=1, attn_resolutions=(8,), dropout=0.0,
               fir=False, embedding_type="positional",
               progressive_input="none")
SIGMA0 = 0.6


def vp_cfg(name="em_sde", n_steps=3, weighting="fid", l_type="l2",
           reduce_mean=True, **sampler):
    return {
        "model": {"sde": {"name": "vpsde", "beta_min": 0.1,
                          "beta_max": 20.0, "n_timesteps": 1000,
                          "is_augmented": False}},
        "training": {
            "train_eps": 1e-5, "use_ema": True, "ema_decay": 0.9,
            "loss": {"name": "score_loss", "l_type": l_type,
                     "weighting": weighting, "reduce_mean": reduce_mean},
            "optimizer": {"name": "Adam", "lr": 1e-2, "beta_1": 0.9,
                          "beta_2": 0.999, "weight_decay": 0, "eps": 1e-8,
                          "warmup": 2, "grad_clip": 1.0}},
        "evaluation": {"n_discrete_steps": n_steps,
                       "sampler": {"name": name, **sampler}}}


def sdes(d=None):
    d = d or vp_cfg()
    return JVPSDE(JConfigDict(d)), VPSDE(ConfigDict(d))


_PAIR = {}


def vp_pair():
    """(JAX net, flax params, port net) of the one-level VP NCSN++, built
    once for the test process."""
    if not _PAIR:
        jnet = JNCSNpp(**VP_NANO)
        params = random_flax_params(jnet, VP_NANO, seed=3)
        _PAIR["pair"] = (jnet, params,
                         load_flax_params(NCSNpp(**VP_NANO), params).eval())
        _PAIR["apply"] = jax.jit(jnet.apply)
    return _PAIR["pair"]


def j_score(p):
    """The JAX network's eps-prediction on ``p``. Its apply is jitted once
    for the module, and JAX keeps the traced network by input shape, so
    the programs of the trajectories reuse it rather than trace the
    network again."""
    vp_pair()
    return lambda z, t: _PAIR["apply"](p, z, t)


def rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def assert_f32_close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# -- the SDE -----------------------------------------------------------------

def _method_pairs(name):
    """(port value, JAX value) pairs of one method at ``TS``."""
    jsde, sde = sdes()
    jt, t = jnp.asarray(TS), torch.from_numpy(TS)
    x = rand((len(TS), 4, 4, C), 0)
    eps = rand((len(TS), 4, 4, C), 1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    je, te = jnp.asarray(eps), torch.from_numpy(eps)

    def score(z, tt):  # a stand-in eps network, float32 in and out
        return torch.tanh(z) * (1.0 + tt[:, None, None, None])

    def jscore(z, tt):
        return jnp.tanh(z) * (1.0 + tt[:, None, None, None])

    if name == "coefficients":
        return [(sde.beta_t(t), jsde.beta_t(jt)),
                (sde._log_mean_coeff(t), jsde._log_mean_coeff(jt)),
                (sde._std(t), jsde._std(jt))]
    if name == "get_score":
        return [(sde.get_score(te, t), jsde.get_score(je, jt))]
    if name == "cond_marginal_prob":
        return list(zip(sde.cond_marginal_prob(tx, t),
                        jsde.cond_marginal_prob(jx, jt)))
    if name == "perturb_data":
        return [(sde.perturb_data(tx, t, te), jsde.perturb_data(jx, jt, je))]
    if name == "sde":
        return list(zip(sde.sde(tx, t), jsde.sde(jx, jt)))
    if name in ("reverse_sde", "reverse_sde_pf"):
        # sampler time: the physical times TS, away from std(0) = 0
        pf = name == "reverse_sde_pf"
        return list(zip(sde.reverse_sde(tx, 1.0 - t, score,
                                        probability_flow=pf),
                        jsde.reverse_sde(jx, 1.0 - jt, jscore,
                                         probability_flow=pf)))
    if name == "prior_logp":
        return [(sde.prior_logp(tx), jsde.prior_logp(jx))]
    assert name == "likelihood_weighting"
    return [(sde.likelihood_weighting(t), jsde.likelihood_weighting(jt))]


@pytest.mark.parametrize("name", [
    "coefficients", "get_score", "cond_marginal_prob", "perturb_data", "sde",
    "reverse_sde", "reverse_sde_pf", "prior_logp", "likelihood_weighting"])
def test_vpsde_method_matches_jax(name):
    for got, want in _method_pairs(name):
        want = np.asarray(want)
        assert str(got.dtype) == f"torch.{want.dtype}", (got.dtype,
                                                          want.dtype)
        if name == "prior_logp":  # float32 squared norms, float64 sums
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        elif want.dtype == np.float64:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-300)
        else:
            assert_f32_close(got, want)


def test_std_keeps_its_digits_near_zero():
    """The expm1 form: std(1e-5) ~ 1e-3 to float64's precision, where
    ``sqrt(1 - exp(...))`` in float32 is off in the third digit."""
    _, sde = sdes()
    t = torch.tensor([1e-5, 1e-3], dtype=torch.float64)
    lmc = sde._log_mean_coeff(t)
    want = np.sqrt(-np.expm1(2 * lmc.numpy()))
    np.testing.assert_allclose(sde._std(t).numpy(), want, rtol=1e-15)
    naive = float(torch.sqrt(1 - torch.exp(2 * lmc.float()))[0])
    assert abs(naive / want[0] - 1) > 1e-3
    assert sde.T == 1.0 and sde.type == "vpsde" and not sde.is_augmented


def test_prior_sampling_and_timestep_vector():
    _, sde = sdes()
    a = sde.prior_sampling(torch.Generator().manual_seed(0), (2, 4, 4, C))
    b = sde.prior_sampling(torch.Generator().manual_seed(0), (2, 4, 4, C))
    assert a.shape == (2, 4, 4, C) and a.dtype == torch.float32
    assert torch.equal(a, b)
    tv = sde.timestep_vector(0.25, 3)
    assert tv.dtype == torch.float64 and tv.tolist() == [0.25] * 3


# -- the loss and a training step ---------------------------------------------

@pytest.mark.parametrize("weighting,l_type,reduce_mean", [
    ("fid", "l2", True), ("fid", "l1", False), ("nll", "l2", True)])
def test_score_loss_matches_jax(weighting, l_type, reduce_mean):
    d = vp_cfg(weighting=weighting, l_type=l_type, reduce_mean=reduce_mean)
    jsde, sde = sdes(d)
    crit = ScoreLoss(ConfigDict(d), sde)
    jcrit = JScoreLoss(JConfigDict(d), jsde)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (4, S, S, C)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, 4)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, x0.shape, jnp.float32))

    want = jcrit(jnp.asarray(x0), jnp.asarray(t),
                 lambda z, tt: jnp.tanh(z) * tt[:, None, None, None], key)
    got = crit(torch.from_numpy(x0), torch.from_numpy(t),
               lambda z, tt: torch.tanh(z) * tt[:, None, None, None],
               eps=torch.from_numpy(eps))
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_score_loss_refuses_what_the_jax_criterion_refuses():
    d = vp_cfg(weighting="nll", l_type="l1")
    jsde, sde = sdes(d)
    with pytest.raises(ValueError, match="l2"):
        ScoreLoss(ConfigDict(d), sde)
    with pytest.raises(ValueError, match="l2"):
        JScoreLoss(JConfigDict(d), jsde)
    bad = vp_cfg(weighting="other")
    with pytest.raises(ValueError, match="weighting"):
        ScoreLoss(ConfigDict(bad), sde)


def test_training_step_matches_jax():
    """One step of the JAX package's train step from a fresh state, and
    the port's with the step's t and eps: the loss, every parameter's
    gradient (Adam's first moment: the first step's learning rate is 0
    under warmup, so the moment is (1 - beta_1) times the clipped
    gradient) and the whole state."""
    d = vp_cfg()
    jcfg, cfg = JConfigDict(d), ConfigDict(d)
    jnet, params, _ = vp_pair()
    jsde, sde = sdes(d)
    j_step, j_opt = j_make_train_step(jnet, jsde, JScoreLoss(jcfg, jsde),
                                      jcfg, donate=False)
    net = load_flax_params(NCSNpp(**VP_NANO), params)
    step, opt = make_train_step(net, sde, ScoreLoss(cfg, sde), cfg)
    x = np.random.default_rng(1).uniform(-1, 1, (B, S, S, C)).astype(
        np.float32)

    def jax_side(p, xx, rng):
        """The fresh state's step and the draws it makes, in one program."""
        k_t, k_loss = jax.random.split(jax.random.fold_in(rng, 0))
        return (j_sample_times(k_t, B, 1e-5),
                jax.random.normal(k_loss, xx.shape, jnp.float32),
                *j_step(j_init_state(p, j_opt), xx, rng))

    t, eps, jstate, jm = jit_o0(jax_side, params, jnp.asarray(x),
                                jax.random.PRNGKey(0))
    t, eps = np.array(t), np.array(eps)

    state = init_state(dict(net.named_parameters()), opt)
    state, m = step(state, torch.from_numpy(x), t=torch.from_numpy(t),
                    eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    mu = flax_to_state_dict(jax.device_get(
        adam_state(jstate.opt_state).mu), net)
    scale = max(float(v.abs().max()) for v in mu.values())
    assert scale > 0
    for k, want in mu.items():
        np.testing.assert_allclose(
            state.opt_state["mu"][k].numpy(), want.numpy(), rtol=1e-4,
            atol=1e-4 * max(float(want.abs().max()), 1e-3 * scale),
            err_msg=k)
    assert_states_close(state, jstate, net, "after one step")


# -- SDE samplers on the network -------------------------------------------------

def _jax_em(corrector: bool):
    """(prior, predictor draws, corrector draws, final sample) of 3 NFE of
    JAX EM with denoise, with a Langevin step after each noisy row or
    without."""
    _, params, _ = vp_pair()
    extra = dict(corrector="langevin", corrector_snr=0.16,
                 corrector_steps=1) if corrector else {}
    jcfg = JConfigDict(vp_cfg(**extra))
    jsde = JVPSDE(jcfg)
    ts = j_make_timesteps(2, EPS)

    def run(p, key):
        z = jsde.prior_sampling(jax.random.fold_in(key, 0), (B, S, S, C))
        score = j_score(p)
        sampler = jsamplers.EulerMaruyamaSampler(
            jcfg, jsde, score, corrector_fn=jcorrectors.build_corrector(
                jcfg, jsde, score))
        out = sampler.sample(key, z, ts, 2, denoise=True, eps=EPS)
        pred, corr, k = [], {}, key
        for i in range(3):  # the scan runs the denoise row too
            if corrector:
                k, sub, csub = jax.random.split(k, 3)
                _, kc = jax.random.split(csub)
                corr[i] = jax.random.normal(kc, z.shape, z.dtype)
            else:
                k, sub = jax.random.split(k)
            pred.append(jax.random.normal(sub, z.shape, z.dtype))
        return z, pred, corr, out

    z, pred, corr, out = jit_o0(run, params, jax.random.PRNGKey(13))
    return (np.array(z), [np.array(v) for v in pred],
            {k: np.array(v) for k, v in corr.items()}, np.asarray(out))


@pytest.mark.parametrize("corrector", [False, True])
def test_em_trajectory_matches_jax(corrector):
    """3 NFE: two noisy rows and the mean-only denoise row; with the
    corrector one Langevin step after each noisy row (the whole state is
    live: the VP-SDE has no reduced modes)."""
    z, pred, corr, want = _jax_em(corrector)
    _, _, net = vp_pair()
    extra = dict(corrector="langevin", corrector_snr=0.16,
                 corrector_steps=1) if corrector else {}
    cfg = ConfigDict(vp_cfg(**extra))
    sde = VPSDE(cfg)
    score = make_score_fn(net)
    sampler = EulerMaruyamaSampler(cfg, sde, score, corrector_fn=(
        build_corrector(cfg, sde, score)))
    used = []

    def noise(k, like):
        used.append(k)
        return torch.from_numpy(corr[k[1]] if isinstance(k, tuple)
                                else pred[k])

    with torch.inference_mode():
        got = sampler.sample(None, torch.from_numpy(z),
                             make_timesteps(2, EPS), 2, denoise=True,
                             eps=EPS, noise=noise)
    assert used == ([0, ("corrector", 0, 0), 1, ("corrector", 1, 0)]
                    if corrector else [0, 1])
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


def test_editing_trajectory_matches_jax():
    """The guide forward-diffused to edit_t0 = 0.4 with one eps draw (C
    channels, no momentum), then EM over the mapped grid."""
    _, params, net = vp_pair()
    d = vp_cfg("edit_em_sde", n_steps=4, edit_t0=0.4)
    jcfg, cfg = JConfigDict(d), ConfigDict(d)
    x0 = np.random.default_rng(6).uniform(-1, 1, (B, S, S, C)).astype(
        np.float32)
    ts = j_make_timesteps(3, EPS)

    def run(p, key, x_0):
        sampler = jsamplers.EditEulerMaruyamaSampler(
            jcfg, JVPSDE(jcfg), j_score(p))
        out = sampler.sample(key, x_0, ts, 3, denoise=True, eps=EPS)
        k, k_init = jax.random.split(key)
        draws = [jax.random.normal(k_init, x_0.shape, jnp.float32)]
        for _ in range(4):
            k, sub = jax.random.split(k)
            draws.append(jax.random.normal(sub, x_0.shape, jnp.float32))
        return draws, out

    listed, want = jit_o0(run, params, jax.random.PRNGKey(17),
                          jnp.asarray(x0))
    draws = dict(zip(["init_eps", 0, 1, 2, 3], listed))
    sampler = EditEulerMaruyamaSampler(cfg, VPSDE(cfg), make_score_fn(net))
    used = []

    def noise(k, like):
        used.append(k)
        assert tuple(like.shape) == (B, S, S, C)
        return torch.from_numpy(np.array(draws[k]))

    with torch.inference_mode():
        got = sampler.sample(None, torch.from_numpy(x0),
                             make_timesteps(3, EPS), 3, denoise=True,
                             eps=EPS, noise=noise)
    assert used == ["init_eps", 0, 1, 2]
    want = np.asarray(want)
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("cls", [SSCSSampler, SSCS2MSampler,
                                 EulerMaruyamaInpainter])
def test_phase_space_samplers_refuse_the_vpsde(cls):
    """SSCS, SSCS-2M and inpainting act on PSLD's momentum half, as in
    the JAX package: the VP-SDE is refused where the sampler is built."""
    cfg = ConfigDict(vp_cfg())
    with pytest.raises(ValueError, match="momentum"):
        cls(cfg, VPSDE(cfg), None)


# -- ODE samplers --------------------------------------------------------------

def _exact(jsde_or_sde, use_jax):
    """The exact eps-prediction of N(0, SIGMA0^2 I) data through the VP
    kernel, computed in float64 from the float32 state and time the
    sampler hands it: eps* = std x / (a^2 SIGMA0^2 + std^2)."""
    xp = jnp if use_jax else torch

    def fn(z, t):
        if use_jax:
            t64, z64 = t.astype(jnp.float64), z.astype(jnp.float64)
            bc = j_bcast_right
        else:
            t64, z64 = t.double(), z.double()
            bc = bcast_right
        a2 = xp.exp(2.0 * jsde_or_sde._log_mean_coeff(t64))
        std = jsde_or_sde._std(t64)
        return bc(std / (a2 * SIGMA0 ** 2 + std * std), z.ndim) * z64

    return fn


def _ode_pair(name, **sampler):
    d = vp_cfg(name, **sampler)
    jsde, sde = sdes(d)
    jcls = {"rk_ode": jode.RKODESampler, "ei_ode": jode.EIODESampler,
            "adaptive_ode": jode.AdaptiveODESampler}[name]
    return (jcls(JConfigDict(d), jsde, _exact(jsde, True)),
            get_module("samplers", name)(ConfigDict(d), sde,
                                         _exact(sde, False)))


def _prior64(seed=0):
    return np.random.default_rng(seed).standard_normal((12, 2, 2, 1))


def assert_f64_close(got, want, tol=F64_TOL):
    want = np.asarray(want)
    assert got.dtype == torch.float64 and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _run_both(js, ts_, n, stride="uniform"):
    z = _prior64()
    want = jit_o0(lambda zz: js.sample(
        None, zz, j_make_timesteps(n, EPS, stride_type=stride), n,
        denoise=True, eps=EPS), jnp.asarray(z))
    got = ts_.sample(None, torch.from_numpy(z),
                     make_timesteps(n, EPS, stride_type=stride), n,
                     denoise=True, eps=EPS)
    return got, want


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ei_ode_matches_jax(order):
    """The scalar tables (E, Psi0..Psi2 at entry [0], zeros elsewhere) to
    1e-12 and a 12-step trajectory to 1e-9 of scale."""
    js, ts_ = _ode_pair("ei_ode", order=order)
    grid = make_timesteps(12, EPS, stride_type="quadratic")
    for got, want in zip(ts_._tables(grid), js._tables(jnp.asarray(
            grid.numpy()))):
        want = np.asarray(want)
        assert got.shape == want.shape and not got[:, 1:].any()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(want).max()))
    got, want = _run_both(js, ts_, 12, "quadratic")
    assert_f64_close(got, want)
    assert ts_.nfe == 13


def test_rk_ode_matches_jax():
    js, ts_ = _ode_pair("rk_ode", solver="heun")
    got, want = _run_both(js, ts_, 6)
    assert_f64_close(got, want)
    assert ts_.nfe == 2 * 6 + 1


def test_adaptive_ode_matches_jax():
    js, ts_ = _ode_pair("adaptive_ode", rtol=1e-4, atol=1e-4)
    got, want = _run_both(js, ts_, 1)
    assert ts_.nfe > 14
    assert_f64_close(got, want, tol=1e-6)


def _clf(xp):
    """A stand-in classifier of 3 classes, a smooth function of x and t in
    both packages."""
    def fn(x, t):
        return xp.tanh(x).mean(axis=(1, 2)) * (1.0 + t[:, None])

    if xp is torch:
        return lambda x, t: fn(x, t).float()
    return fn


def test_cc_ei_ode_matches_jax():
    """Two guided order-2 steps (eps_eff = eps - std * grad, the guidance
    of the stand-in classifier's class 1 at temperature 1.5) and the
    unguided denoise microstep."""
    d = vp_cfg("cc_ei_ode", order=2)
    d["clf"] = {"evaluation": {"label_to_sample": 1, "clf_temp": 1.5}}
    jsde, sde = sdes(d)
    js = jode.ClassCondEIODESampler(JConfigDict(d), jsde, _exact(jsde, True),
                                    clf_fn=_clf(jnp))
    ts_ = get_module("samplers", "cc_ei_ode")(
        ConfigDict(d), sde, _exact(sde, False), clf_fn=_clf(torch))
    z = rand((B, 4, 4, C), 2).astype(np.float64)
    want = jit_o0(lambda zz: js.sample(None, zz, j_make_timesteps(2, EPS), 2,
                                       denoise=True, eps=EPS),
                  jnp.asarray(z))
    with torch.no_grad():
        got = ts_.sample(None, torch.from_numpy(z), make_timesteps(2, EPS),
                         2, denoise=True, eps=EPS)
    assert ts_.nfe == 3
    plain = get_module("samplers", "ei_ode")(ConfigDict(d), sde,
                                             _exact(sde, False)).sample(
        None, torch.from_numpy(z), make_timesteps(2, EPS), 2, eps=EPS)
    assert float((got - plain).abs().max()) > 1e-3  # the guidance acts
    assert_close_to_scale(got.numpy(), np.asarray(want), 1e-4)


def test_ei_ode_on_the_network_matches_jax():
    """Order 2, 3 NFE, float32 on the one-level VP NCSN++."""
    _, params, net = vp_pair()
    d = vp_cfg("ei_ode", order=2)
    jcfg, cfg = JConfigDict(d), ConfigDict(d)
    z = rand((B, S, S, C), 4)
    ts = j_make_timesteps(2, EPS)

    def run(p, zz):
        s = jode.EIODESampler(jcfg, JVPSDE(jcfg),
                              j_score(p))
        return s.sample(None, zz, ts, 2, denoise=True, eps=EPS)

    want = np.asarray(jit_o0(run, params, jnp.asarray(z)))
    s = get_module("samplers", "ei_ode")(cfg, VPSDE(cfg), make_score_fn(net))
    with torch.inference_mode():
        got = s.sample(None, torch.from_numpy(z), make_timesteps(2, EPS), 2,
                       denoise=True, eps=EPS)
    assert got.shape == (B, S, S, C) and np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


# -- the likelihood ------------------------------------------------------------

def test_evaluate_nll_matches_jax(tmp_path, monkeypatch):
    """``evaluate_nll`` on the VP-SDE from a ``.pt`` checkpoint of the
    converted network, synthetic set at 8x8, one batch of 2, one Euler
    step and one probe: the NLL is ``-logp`` (no momentum, no entropy), held
    to the JAX package's integral with the same probes."""
    _, params, net = vp_pair()
    sd = net.state_dict()
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"params": sd, "ema_params": sd, "step": 10 ** 6}, ckpt)
    config = compose([
        "+dataset=cifar10/cifar10_vpsde", "dataset.diffusion.data.root=/unused",
        "dataset.diffusion.data.name=synthetic",
        f"dataset.diffusion.data.image_size={S}",
        "dataset.diffusion.model.score_fn.nf=16",
        "dataset.diffusion.model.score_fn.ch_mult=[1]",
        "dataset.diffusion.model.score_fn.num_res_blocks=1",
        "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
        "dataset.diffusion.model.score_fn.dropout=0.0",
        f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
        "dataset.diffusion.evaluation.batch_size=2",
        "dataset.diffusion.evaluation.n_samples=2",
        "+dataset.diffusion.evaluation.likelihood.n_steps=1",
        "+dataset.diffusion.evaluation.likelihood.eps=1e-3",
        "+dataset.diffusion.evaluation.likelihood.solver=euler",
        "+dataset.diffusion.evaluation.device=cpu",
    ]).dataset.diffusion
    probes = np.random.default_rng(5).choice(
        [-1.0, 1.0], (1, B, S, S, C)).astype(np.float32)
    monkeypatch.setattr(lik, "augmented_draw", None)  # must not be called
    monkeypatch.setattr(lik, "rademacher",
                        lambda gen, n, like: torch.from_numpy(probes))
    bpd, batches = lik.evaluate_nll(config)

    from psld_tpu_torch.data.loader import get_dataset

    x = get_dataset(config).batch(np.arange(B)).astype(np.float32)
    jsde = JVPSDE(JConfigDict(config.to_dict()))

    def run(p, xx, pr):
        fn = jlik.make_likelihood_fn(
            jsde, j_score(p), n_steps=1, eps=1e-3,
            method="euler", n_probes=1)
        ts = fn.segment_ts()
        carry = (xx, jnp.zeros((B,), jnp.float64), pr)
        carry, _ = fn.segment_body(carry, (ts[0], ts[1]))
        return fn.segment_finalize(carry)["logp"]

    nll = -np.asarray(jit_o0(run, params, jnp.asarray(x),
                             jnp.asarray(probes)))
    want = np.asarray(jlik.bits_per_dim(nll, S * S * C))
    assert np.isfinite(want).all()
    assert [(b["batch"], b["samples"], b["nfe"], b["nonfinite"])
            for b in batches] == [(0, B, 1, 0)]
    np.testing.assert_allclose(batches[0]["bits_per_dim"], want.mean(),
                               rtol=1e-5)
    np.testing.assert_allclose(bpd, want.mean(), rtol=1e-5)
    # the NLL itself: bits/dim is affine in it
    got_nll = (bpd - 7.0) * S * S * C * math.log(2.0)
    np.testing.assert_allclose(got_nll, nll.mean(), rtol=1e-5)
