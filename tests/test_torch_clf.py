"""The port's guidance classifier, its loss, its train step and the
classifier-guided EM sampler against the JAX package's (CPU).

Parameters are drawn from a seeded numpy normal (``random_flax_params``),
the bias-free head included: a zero head (``init_scale`` has none, but a
trained head differs from a converted one only in its values) would hide
a flatten in the wrong order. Random draws of the JAX side (t, m0, eps,
the trajectory's normals) are regenerated from its keys and handed to the
port.

Tolerances, relative to the largest magnitude of the compared tensor:

* forward, loss gradients, guidance gradient: 1e-4, as for the score
  network (``test_torch_ncsnpp``): float32 through ~15 layers with sums
  in another order; the gradient carries it back through the backward.
  A parameter gradient is held to 1e-4 of the larger of its own scale
  and 1e-3 of the largest one, as in ``test_torch_loss``.
* loss and top-1: 1e-5 relative; top-1 exactly.
* three optimizer steps: rtol 1e-5 on params and Adam moments with a
  floor of 1e-5 of the tree's scale, as ``test_torch_train``.
* a guided trajectory: 1e-4, as the EM trajectory of
  ``test_torch_sampler``.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.eval.generate import _parse_label_spec as j_parse_label_spec
from psld_tpu.losses.score import PSLDTimeCELoss as JLoss
from psld_tpu.models.ncsnpp import NCSNppClassifier as JClassifier
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.samplers import sde_samplers as jsamplers
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu.train.state import init_state as j_init_state
from psld_tpu.train.steps import make_clf_train_step as j_make_step
from psld_tpu.train.steps import sample_times as j_sample_times
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.eval.generate import _parse_label_spec, make_score_fn
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              load_flax_params)
from psld_tpu_torch.losses.score import PSLDTimeCELoss
from psld_tpu_torch.models.ncsnpp import NCSNpp, NCSNppClassifier
from psld_tpu_torch.samplers import ClassCondEulerMaruyamaSampler
from psld_tpu_torch.samplers.base import make_timesteps
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train.steps import make_clf_train_step
from test_torch_loss import MICRO, jax_draws
from test_torch_ncsnpp import assert_close_to_scale, jit_o0, \
    random_flax_params
from test_torch_train import adam_state, assert_states_close, to_port

# the shipped classifier's option set (positional embedding, no FIR,
# BigGAN blocks, attention at one level) at 8x8: its middle block attends
# over a 4x4 map, N = 16 tokens, as the shipped one does
CLF = dict(image_size=8, in_ch=6, out_ch=6, nf=16, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(8,), dropout=0.0,
           n_cls=10)
# the optimizer test's classifier: one level
CLF_NANO = {**CLF, "ch_mult": (1,)}
# the guided trajectory's score network
SCORE = {**MICRO, "ch_mult": (1,), "attn_resolutions": (8,)}
B = 3


def cfg_dict(mode="hsm", label=3, convention="diffusion", n_steps=3,
             **clf_training):
    sde = {"beta_min": 8.0, "beta_max": 8.0, "nu": 4.02, "gamma": 0.02,
           "kappa": 0.04, "decomp_mode": "lower", "numerical_eps": 1e-9,
           "n_timesteps": 1000, "is_augmented": True}
    opt = {"name": "Adam", "lr": 1e-2, "beta_1": 0.9, "beta_2": 0.999,
           "weight_decay": 0, "eps": 1e-8, "warmup": 2}
    return {
        "diffusion": {
            "model": {"sde": sde},
            "training": {"mode": mode, "train_eps": 1e-5, "loss": {
                "name": "psld_score_loss", "l_type": "l2",
                "weighting": "fid", "reduce_mean": True}},
            "evaluation": {"n_discrete_steps": n_steps, "sampler": {
                "name": "cc_em_sde", "clf_time_convention": convention}}},
        "clf": {"training": {"optimizer": opt, **clf_training},
                "evaluation": {"label_to_sample": label, "clf_temp": 1.5}}}


def merged(d):
    """The guided sampler's view: the diffusion tree with ``clf`` beside
    it."""
    return {**d["diffusion"], "clf": d["clf"]}


_PAIRS = {}


def pair(kw, cls_pair=(JClassifier, NCSNppClassifier), seed=1):
    key = (tuple(sorted(kw.items())), cls_pair)
    if key not in _PAIRS:
        jnet = cls_pair[0](**kw)
        params = random_flax_params(jnet, kw, seed=seed)
        _PAIRS[key] = (jnet, params,
                       load_flax_params(cls_pair[1](**kw), params).eval())
    return _PAIRS[key]


def inputs(b=B, s=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, 6)).astype(np.float32)
    t = np.linspace(0.1, 0.9, b).astype(np.float32)
    return x, t


def test_classifier_forward_matches_jax():
    jnet, params, net = pair(CLF)
    head = params["params"]["Dense_2"]["kernel"]
    assert head.shape == (16 * 2 * 4 * 4, 10) and np.abs(head).min() > 0
    assert not hasattr(net.Dense_2, "bias") or net.Dense_2.bias is None
    x, t = inputs()
    want = jit_o0(jnet.apply, params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (B, 10) and got.dtype == torch.float32
    assert_close_to_scale(got.numpy(), want, 1e-4)


def test_classifier_train_mode_hash_dropout_matches_jax(monkeypatch):
    """Train mode with ``hw`` dropout: the JAX side runs eagerly with
    ``hw_dropout`` wrapped to record each site's seed words; the port is
    handed them."""
    import psld_tpu.ops as jops

    kw = {**CLF_NANO, "dropout": 0.1, "dropout_impl": "hw"}
    _, params, _ = pair(CLF_NANO)
    seeds, real = [], jops.hw_dropout

    def recording(x_, seed, rate, use_pallas=None):
        seeds.append(tuple(int(w) for w in np.asarray(seed)))
        return real(x_, seed, rate, False)

    monkeypatch.setattr(jops, "hw_dropout", recording)
    x, t = inputs()
    want = JClassifier(**kw).apply(params, jnp.asarray(x), jnp.asarray(t),
                                   train=True,
                                   rngs={"dropout": jax.random.PRNGKey(4)})
    net = load_flax_params(NCSNppClassifier(**kw), params)
    assert len(seeds) == net.dropout_sites == 3
    got = net(torch.from_numpy(x), torch.from_numpy(t), train=True,
              dropout_seeds=seeds)
    assert_close_to_scale(got.detach().numpy(), want, 1e-4)
    with torch.no_grad():
        ev = net(torch.from_numpy(x), torch.from_numpy(t))
    assert float((got.detach() - ev).abs().max()) > 1e-3 * float(
        ev.abs().max())


@pytest.mark.parametrize("mode", ["hsm", "dsm"])
def test_tce_loss_top1_and_gradients_match_jax(mode):
    jnet, params, net = pair(CLF_NANO)
    d = cfg_dict(mode)
    jcrit = JLoss(JConfigDict(d), JPSLD(JConfigDict(d["diffusion"])))
    crit = PSLDTimeCELoss(ConfigDict(d), PSLD(ConfigDict(d["diffusion"])))
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32)
    y = np.array([3, 0, 7])
    t = rng.uniform(1e-5, 1.0, B)
    key = jax.random.PRNGKey(9)
    m0, eps = jax_draws(key, x0.shape)

    def jloss(p):
        return jcrit(jnp.asarray(x0), jnp.asarray(y), jnp.asarray(t),
                     lambda z, tt: jnet.apply(p, z, tt), key)

    (jl, jacc), jgrads = jit_o0(jax.value_and_grad(jloss, has_aux=True),
                                params)
    p = dict(net.named_parameters())
    for v in p.values():
        v.grad = None
    loss, top1 = crit(torch.from_numpy(x0), torch.from_numpy(y),
                      torch.from_numpy(t),
                      lambda z, tt: net(z, tt), eps=torch.from_numpy(eps),
                      m0=torch.from_numpy(m0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(top1) == float(jacc)
    want = flax_to_state_dict(jax.device_get(jgrads), net)
    # a gradient that is zero in exact arithmetic (a bias ahead of a
    # GroupNorm) is held to the floor of 1e-3 of the largest gradient,
    # as in test_torch_loss
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(
            p[k].grad.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-4 * max(float(w.abs().max()), 1e-3 * scale), err_msg=k)


def test_three_classifier_steps_match_jax():
    """Adam with warmup 2 and no clip (the classifier's optimizer config
    has no ``grad_clip``), no EMA, from a state with non-zero moments: one
    JAX step is taken first and its state converted. Dropout rate 0 keeps
    the two dropout streams out of it."""
    d = cfg_dict()
    # Adam's eps at 1e-4, not the config's 1e-8: the key projection's bias
    # of an attention block has a gradient that is zero in exact
    # arithmetic (softmax ignores a shift shared by all keys), ~1e-9 in
    # float32, and Adam with eps 1e-8 turns that noise into steps of up
    # to lr whose sign differs between the two frameworks
    d["clf"]["training"]["optimizer"]["eps"] = 1e-4
    jnet, params, _ = pair(CLF_NANO)
    jcfg, cfg = JConfigDict(d), ConfigDict(d)
    jsde, sde = JPSLD(jcfg.diffusion), PSLD(cfg.diffusion)
    j_step, j_opt = j_make_step(jnet, jsde, JLoss(jcfg, jsde), jcfg,
                                donate=False)
    net = NCSNppClassifier(**CLF_NANO)
    step, opt = make_clf_train_step(net, sde, PSLDTimeCELoss(cfg, sde), cfg)
    assert opt.grad_clip == 0
    rng = jax.random.PRNGKey(0)
    data = np.random.default_rng(0).uniform(-1, 1, (4, B, 8, 8, 3)).astype(
        np.float32)
    labels = np.random.default_rng(1).integers(0, 10, (4, B))

    jstate = j_init_state(params, j_opt)
    # one compile at XLA's lowest optimization level serves all four steps
    j_step = j_step.lower(jstate, jnp.asarray(data[0]),
                          jnp.asarray(labels[0]), rng).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    jstate, _ = j_step(jstate, jnp.asarray(data[0]), jnp.asarray(labels[0]),
                       rng)
    state = to_port(net, jstate)
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    for i in (1, 2, 3):
        k_t, k_loss = jax.random.split(jax.random.fold_in(
            rng, int(jstate.step)))
        t = np.array(j_sample_times(k_t, B, 1e-5))
        m0, eps = jax_draws(k_loss, data[i].shape)
        jstate, jm = j_step(jstate, jnp.asarray(data[i]),
                            jnp.asarray(labels[i]), rng)
        state, m = step(state, torch.from_numpy(data[i]),
                        torch.from_numpy(labels[i]),
                        t=torch.from_numpy(t), eps=torch.from_numpy(eps),
                        m0=torch.from_numpy(m0))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["top1"]) == float(jm["top1"])
        assert_states_close(state, jstate, net, f"after step {i}")
    assert all(torch.equal(ema0[k], v) for k, v in state.ema_params.items())
    assert adam_state(jax.device_get(jstate).opt_state).count == 4


def _guided_pair(convention="diffusion", n_steps=3, label=3):
    d = cfg_dict(label=label, convention=convention, n_steps=n_steps)
    jcfg, cfg = JConfigDict(merged(d)), ConfigDict(merged(d))
    return d, jcfg, cfg


def test_guidance_gradient_matches_jax():
    """``clf_temp`` times the gradient of the summed log-probability of the
    label into the input, through a frozen classifier, at two times."""
    jclf, cparams, clf = pair(CLF)
    _, jcfg, cfg = _guided_pair()
    js = jsamplers.ClassCondEulerMaruyamaSampler(
        jcfg, JPSLD(jcfg), None,
        clf_fn=lambda z, t: jclf.apply(cparams, z, t))
    clf.requires_grad_(False)
    ts = ClassCondEulerMaruyamaSampler(cfg, PSLD(cfg), None,
                                       clf_fn=make_score_fn(clf))
    assert (ts.y, ts.clf_temp) == (3, 1.5)
    x, _ = inputs(seed=6)
    fn = jax.jit(js._guidance).lower(jnp.asarray(x), 0.5).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for t in (0.3, 0.7):
        want = fn(jnp.asarray(x), t)
        with torch.no_grad():
            got = ts._guidance(torch.from_numpy(x), t)
        assert got.shape == x.shape and float(np.abs(want).max()) > 0
        assert_close_to_scale(got.numpy(), want, 1e-4)
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
        ts._guidance(torch.from_numpy(x), 0.3)


@pytest.mark.parametrize("convention", ["diffusion", "reference"])
def test_guided_step_conditions_the_classifier_as_jax(convention):
    """The time each guided row hands the classifier: ``T - t`` under
    ``diffusion``, the sampler's ``t`` under ``reference``, on the noisy
    rows and the denoise row alike. Both samplers run their step with a
    zero score and a recording guidance."""
    _, jcfg, cfg = _guided_pair(convention)
    jsde, sde = JPSLD(jcfg), PSLD(cfg)
    seen = {"jax": [], "port": []}

    def record(key):
        def guidance(x, t):
            seen[key].append(float(t))
            return x * 0
        return guidance

    js = jsamplers.ClassCondEulerMaruyamaSampler(
        jcfg, jsde, lambda z, t: jnp.zeros_like(z), clf_fn=None)
    js._guidance = record("jax")
    ts = ClassCondEulerMaruyamaSampler(
        cfg, sde, lambda z, t: torch.zeros_like(z), clf_fn=None)
    ts._guidance = record("port")
    x = np.zeros((1, 2, 2, 6), np.float32)
    rows = jsamplers._step_grid(jsde, j_make_timesteps(2, 1e-3), True, 1e-3)
    key = jax.random.PRNGKey(0)
    for t, dt, flag in zip(*(np.asarray(r) for r in rows)):
        js.segment_body((jnp.asarray(x), key), (t, dt, flag))
        ts._step(torch.from_numpy(x), float(t), float(dt),
                 torch.zeros(x.shape) if flag else None, float(flag))
    assert len(seen["port"]) == 3
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=1e-12)
    want_first = 0.0 if convention == "reference" else 1.0
    assert seen["port"][0] == want_first


def test_guided_trajectory_matches_jax_with_injected_noise():
    """Two noisy guided steps and the guided mean-only denoise step."""
    jclf, cparams, clf = pair(CLF)
    jscore, sparams, score = pair(SCORE, (JNCSNpp, NCSNpp))
    _, jcfg, cfg = _guided_pair(n_steps=3, label=7)
    jsde = JPSLD(jcfg)
    ts_j = j_make_timesteps(2, 1e-3)

    def run(sp, cp, key):
        z = jsde.prior_sampling(jax.random.fold_in(key, 0), (B, 8, 8, 3))
        sampler = jsamplers.ClassCondEulerMaruyamaSampler(
            jcfg, jsde, lambda zz, tt: jscore.apply(sp, zz, tt),
            clf_fn=lambda zz, tt: jclf.apply(cp, zz, tt))
        out = sampler.sample(key, z, ts_j, 2, denoise=True, eps=1e-3)
        noise, k = [], key
        for _ in range(3):  # one split per grid row, as the scan body
            k, sub = jax.random.split(k)
            noise.append(jax.random.normal(sub, z.shape, z.dtype))
        return z, noise, out

    z, noise, want = jit_o0(run, sparams, cparams, jax.random.PRNGKey(3))
    clf.requires_grad_(False)
    sampler = ClassCondEulerMaruyamaSampler(
        cfg, PSLD(cfg), make_score_fn(score), clf_fn=make_score_fn(clf))
    assert sampler.y == 7
    with torch.no_grad():
        got = sampler.sample(None, torch.from_numpy(np.array(z)),
                             make_timesteps(2, 1e-3), 2, denoise=True,
                             eps=1e-3,
                             noise=lambda i, x: torch.from_numpy(
                                 np.array(noise[i])))
    want = np.asarray(want)
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("spec,want", [("all", list(range(10))),
                                       ("4", [4]), ("2,5,", [2, 5]),
                                       (3, [3])])
def test_label_spec_matches_jax(spec, want):
    assert _parse_label_spec(spec, 10) == j_parse_label_spec(spec, 10) \
        == want


@pytest.mark.parametrize("spec", ["10", "1,-1"])
def test_label_spec_out_of_range_raises(spec):
    for parse in (_parse_label_spec, j_parse_label_spec):
        with pytest.raises(ValueError, match="out of range"):
            parse(spec, 10)
