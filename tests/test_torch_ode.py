"""The port's probability-flow ODE samplers against the JAX package's (CPU).

Analytic score, float64: the exact eps-prediction of a Gaussian data
distribution through the PSLD kernel (``psld_exact_score_fn`` of
``tests/test_samplers.py``, computed in float64 from the float32 state
and time the SDE hands it, and returned in float64), a torch copy on the
port's side. Both packages then run the same float64 arithmetic on the
same inputs, in another order: fixed-grid trajectories agree to 1e-9
of their scale and the quadrature tables of ``ei_ode`` to 1e-12. The
adaptive solvers take the same number of steps and agree to 1e-6 of
scale: their step sizes follow the error norm continuously, and the
stiff end of the interval amplifies last-digit differences (the JAX
package's own jitted and eager ``adaptive_ode`` runs of the case below
differ by 5e-8 of scale).

Network, float32: the one-level NCSN++ (and the micro classifier) of
``test_torch_clf`` with converted weights; trajectories within 1e-4 of
their scale, as the EM trajectory of ``test_torch_sampler``.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.samplers import ode as jode
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu.sde.psld import join_xm as j_join_xm
from psld_tpu.sde.psld import split_xm as j_split_xm
from psld_tpu.utils.numerics import bcast_right as j_bcast_right
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.registry import get_module
from psld_tpu_torch.samplers import ode
from psld_tpu_torch.samplers.base import make_timesteps
from psld_tpu_torch.sde.psld import PSLD, join_xm, split_xm
from psld_tpu_torch.utils.numerics import bcast_right
from test_torch_clf import CLF, SCORE, cfg_dict, merged, pair
from test_torch_ncsnpp import assert_close_to_scale, jit_o0

S0 = 0.7
EPS = 1e-3
F64_TOL = 1e-9
ADAPTIVE_TOL = 1e-6


def cfg(name, nu=4.01, gamma=0.01, **sampler):
    return {"model": {"sde": {
        "beta_min": 8.0, "beta_max": 8.0, "nu": nu, "gamma": gamma,
        "kappa": 0.04, "decomp_mode": "lower", "numerical_eps": 1e-9,
        "n_timesteps": 1000, "is_augmented": True}},
        "evaluation": {"sampler": {"name": name, **sampler}},
        "training": {"mode": "hsm"}}


def j_exact_score(sde, s0=S0):
    """The JAX side: eps* = -L_model^T Sigma_true^{-1} z, in float64."""
    def score_fn(z, t_phys):
        t64 = t_phys.astype(jnp.float64)
        z = z.astype(jnp.float64)
        xx, xm, mm = sde._cov(s0 * s0, sde.mm_0, t64)
        det = xx * mm - xm * xm
        i11, i12, i22 = mm / det, -xm / det, xx / det
        l11, _, l21, l22 = sde.get_coeff(sde._cov(0.0, sde.mm_0, t64))
        x, m = j_split_xm(z)

        def c(v):
            return j_bcast_right(v, x.ndim)

        s_x = -(c(i11) * x + c(i12) * m)
        s_m = -(c(i12) * x + c(i22) * m)
        return j_join_xm(-(c(l11) * s_x + c(l21) * s_m), -(c(l22) * s_m))

    return score_fn


def t_exact_score(sde, s0=S0):
    """The port's copy of :func:`j_exact_score`."""
    def score_fn(z, t_phys):
        t64 = t_phys.double()
        z = z.double()
        xx, xm, mm = sde._cov(s0 * s0, sde.mm_0, t64)
        det = xx * mm - xm * xm
        i11, i12, i22 = mm / det, -xm / det, xx / det
        l11, _, l21, l22 = sde.get_coeff(sde._cov(0.0, sde.mm_0, t64))
        x, m = split_xm(z)

        def c(v):
            return bcast_right(v, x.ndim)

        s_x = -(c(i11) * x + c(i12) * m)
        s_m = -(c(i12) * x + c(i22) * m)
        return join_xm(-(c(l11) * s_x + c(l21) * s_m), -(c(l22) * s_m))

    return score_fn


def prior(shape=(12, 2, 2, 1), seed=0):
    """A float64 prior draw: x ~ N(0, I), m ~ N(0, M I) at M = 1/(
    (gamma - nu)^2 / 4) of (4.01, 0.01)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    m = rng.standard_normal(shape) / np.sqrt((0.01 - 4.01) ** 2 / 4.0)
    return np.concatenate([x, m], axis=-1)


def samplers(d):
    """(JAX sampler, port sampler) of config ``d``."""
    jcfg, tcfg = JConfigDict(d), ConfigDict(d)
    jsde, tsde = JPSLD(jcfg), PSLD(tcfg)
    name = d["evaluation"]["sampler"]["name"]
    jfn, tfn = j_exact_score(jsde), t_exact_score(tsde)
    if jsde.mode == "score_m":  # the network predicts eps_m alone
        jfull, tfull = jfn, tfn
        jfn = lambda z, t: j_split_xm(jfull(z, t))[1]  # noqa: E731
        tfn = lambda z, t: split_xm(tfull(z, t))[1]  # noqa: E731
    jcls = {"rk_ode": jode.RKODESampler, "ei_ode": jode.EIODESampler,
            "adaptive_ode": jode.AdaptiveODESampler,
            "bb_ode": jode.BBODESampler}[name]
    return jcls(jcfg, jsde, jfn), get_module("samplers", name)(tcfg, tsde,
                                                                tfn)


def assert_f64_close(got, want, tol=F64_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == np.float64 and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def run_fixed(js, ts_, n, z, stride, denoise=True):
    """Both samplers over the same ``n``-step grid from ``z``."""
    jts = j_make_timesteps(n, EPS, stride_type=stride)
    want = jit_o0(lambda zz: js.sample(None, zz, jts, n, denoise=denoise,
                                       eps=EPS), jnp.asarray(z))
    got = ts_.sample(None, torch.from_numpy(z),
                     make_timesteps(n, EPS, stride_type=stride), n,
                     denoise=denoise, eps=EPS)
    return got, want


@pytest.mark.parametrize("solver,stride", [("euler", "uniform"),
                                           ("heun", "quadratic"),
                                           ("rk4", "uniform")])
def test_rk_ode_matches_jax(solver, stride):
    js, ts_ = samplers(cfg("rk_ode", solver=solver))
    got, want = run_fixed(js, ts_, 10, prior(), stride)
    assert_f64_close(got, want)
    per_step = {"euler": 1, "heun": 2, "rk4": 4}[solver]
    assert ts_.nfe == per_step * 10 + 1


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("stride", ["quadratic", "uniform"])
def test_ei_ode_matches_jax(order, stride):
    js, ts_ = samplers(cfg("ei_ode", order=order))
    got, want = run_fixed(js, ts_, 12, prior(seed=order), stride)
    assert_f64_close(got, want)
    assert ts_.nfe == 13


def test_ei_ode_reduced_mode_score_m_matches_jax():
    """gamma = 0: the network predicts eps_m alone, the sampler pads the
    x half with zeros, and the W entries never read it."""
    js, ts_ = samplers(cfg("ei_ode", nu=4.0, gamma=0.0, order=2))
    assert ts_.sde.mode == "score_m"
    got, want = run_fixed(js, ts_, 12, prior(seed=5), "quadratic",
                          denoise=False)
    assert_f64_close(got, want)


def test_adaptive_ode_matches_jax_with_the_same_nfe():
    js, ts_ = samplers(cfg("adaptive_ode", rtol=1e-5, atol=1e-5))
    z = prior(seed=7)
    want, nfe = jit_o0(lambda zz: js.sample_with_nfe(None, zz, eps=EPS),
                       jnp.asarray(z))
    got = ts_.sample(None, torch.from_numpy(z), None, None, eps=EPS)
    assert_f64_close(got, want, ADAPTIVE_TOL)
    assert ts_.nfe == int(nfe) > 20
    assert ts_.mean_nfe == ts_.nfe
    # without the denoise step: one NFE fewer, the same trajectory
    ts_.sample(None, torch.from_numpy(z), None, None, denoise=False,
               eps=EPS)
    assert ts_.nfe == 2 * int(nfe) - 1


def test_adaptive_ode_max_steps_stops_early():
    js, ts_ = samplers(cfg("adaptive_ode", rtol=1e-5, atol=1e-5,
                           max_steps=2))
    z = prior(seed=8)
    want, nfe = jit_o0(lambda zz: js.sample_with_nfe(None, zz, eps=EPS),
                       jnp.asarray(z))
    got = ts_.sample(None, torch.from_numpy(z), None, None, eps=EPS)
    assert ts_.nfe == int(nfe) == 2 + 2 * 6 + 1
    assert_f64_close(got, want, ADAPTIVE_TOL)


def test_bb_ode_matches_jax():
    js, ts_ = samplers(cfg("bb_ode", rtol=1e-3, atol=1e-3))
    z = prior(seed=9)
    want = js.sample(None, jnp.asarray(z), None, None, eps=EPS)
    got = ts_.sample(None, torch.from_numpy(z), None, None, eps=EPS)
    assert_f64_close(got, want, ADAPTIVE_TOL)
    assert ts_.nfe == js.nfe > 10 and ts_.mean_nfe == js.mean_nfe


def test_bb_ode_without_scipy_raises(monkeypatch):
    """No fallback: without SciPy ``bb_ode`` raises, and never runs
    another solver."""
    import sys

    _, ts_ = samplers(cfg("bb_ode", rtol=1e-3, atol=1e-3))
    monkeypatch.setitem(sys.modules, "scipy.integrate", None)
    with pytest.raises(ImportError, match="SciPy"):
        ts_.sample(None, torch.from_numpy(prior()), None, None)
    assert ts_.nfe == 0


def test_gl_panel_grid_matches_jax():
    for panels, nodes in ((6, 16), (1, 3), (4, 5)):
        for got, want in zip(ode._gl_panel_grid(panels, nodes),
                             jode._gl_panel_grid(panels, nodes)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("order,nu,gamma,stride", [
    (2, 4.01, 0.01, "quadratic"), (3, 4.02, 0.02, "uniform"),
    (2, 4.0, 0.0, "quadratic"), (3, 1.0, 2.0, "quadratic")])
def test_ei_tables_match_jax(order, nu, gamma, stride):
    """E, Psi0, Psi1 (and Psi2) of a grid, float64, over the (nu, gamma)
    rows of ``tests/test_sde_psld.py``, score_m among them."""
    js, ts_ = samplers(cfg("ei_ode", nu=nu, gamma=gamma, order=order,
                           quad_panels=3, quad_nodes=8))
    want = js._tables(j_make_timesteps(20, EPS, stride_type=stride))
    got = ts_._tables(make_timesteps(20, EPS, stride_type=stride))
    assert len(got) == len(want) == order + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (20, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(w).max()))


# -- the network, float32 ----------------------------------------------------
B = 3


def net_prior(seed=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, 8, 8, 6)).astype(np.float32)


def _jax_net_run(name, n, **sampler):
    jnet, params, _ = pair(SCORE, (JNCSNpp, NCSNpp))
    d = cfg(name, nu=4.02, gamma=0.02, **sampler)
    jcfg = JConfigDict(d)
    jsde = JPSLD(jcfg)
    ts_j = j_make_timesteps(n, EPS)
    cls = {"rk_ode": jode.RKODESampler, "ei_ode": jode.EIODESampler}[name]
    apply = jax.jit(jnet.apply)  # traced once for all the NFE

    def run(p, z):
        s = cls(jcfg, jsde, lambda zz, tt: apply(p, zz, tt))
        return s.sample(None, z, ts_j, n, denoise=True, eps=EPS)

    return d, np.asarray(jit_o0(run, params, jnp.asarray(net_prior())))


@pytest.mark.parametrize("name,n,sampler", [
    ("ei_ode", 3, {"order": 2}), ("rk_ode", 2, {"solver": "heun"})])
def test_trajectory_on_the_network_matches_jax(name, n, sampler):
    d, want = _jax_net_run(name, n, **sampler)
    _, _, net = pair(SCORE, (JNCSNpp, NCSNpp))
    tcfg = ConfigDict(d)
    s = get_module("samplers", name)(tcfg, PSLD(tcfg), make_score_fn(net))
    with torch.inference_mode():
        got = s.sample(None, torch.from_numpy(net_prior()),
                       make_timesteps(n, EPS), n, denoise=True, eps=EPS)
    assert got.shape == (B, 8, 8, 6) and got.dtype == torch.float32
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


def test_cc_ei_ode_on_the_network_matches_jax():
    """Two guided order-2 steps and the unguided denoise microstep with
    the micro classifier, label 7, diffusion-time convention."""
    jscore, sparams, score = pair(SCORE, (JNCSNpp, NCSNpp))
    jclf, cparams, clf = pair(CLF)
    d = merged(cfg_dict(label=7, n_steps=3))
    d["evaluation"]["sampler"].update(name="cc_ei_ode", order=2)
    jcfg, tcfg = JConfigDict(d), ConfigDict(d)
    jsde = JPSLD(jcfg)
    ts_j = j_make_timesteps(2, EPS)

    score_apply, clf_apply = jax.jit(jscore.apply), jax.jit(jclf.apply)

    def run(sp, cp, z):
        s = jode.ClassCondEIODESampler(
            jcfg, jsde, lambda zz, tt: score_apply(sp, zz, tt),
            clf_fn=lambda zz, tt: clf_apply(cp, zz, tt))
        return s.sample(None, z, ts_j, 2, denoise=True, eps=EPS)

    want = np.asarray(jit_o0(run, sparams, cparams,
                             jnp.asarray(net_prior(6))))
    clf.requires_grad_(False)
    s = get_module("samplers", "cc_ei_ode")(
        tcfg, PSLD(tcfg), make_score_fn(score), clf_fn=make_score_fn(clf))
    assert s.guided and (s.y, s.clf_temp) == (7, 1.5)
    with torch.no_grad():
        got = s.sample(None, torch.from_numpy(net_prior(6)),
                       make_timesteps(2, EPS), 2, denoise=True, eps=EPS)
    assert np.isfinite(want).all() and s.nfe == 3
    assert_close_to_scale(got.numpy(), want, 1e-4)
