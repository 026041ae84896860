"""The port's Langevin corrector and predictor--corrector sampling
against the JAX package's (CPU).

Networks are the one-level NCSN++ of ``test_torch_sscs`` with converted
weights, float32 (and, for the reduced-output ``score_m`` mode, the same
net with 3 output channels). JAX's threefry and PyTorch's generators give
different numbers, so each test regenerates the JAX side's draws and
hands them to the port by name: the corrector splits its key once a step
(``key, k = split(key)``, one normal from ``k``); with a corrector the EM
and SSCS-2M scan bodies split each step's key three ways (``key, sub,
csub``), the predictor drawing from ``sub`` as it does without one and
the corrector from ``csub``.

Tolerance: 1e-4 of the largest magnitude, as for the trajectories of
``test_torch_sampler`` and ``test_torch_sscs``: each network evaluation
carries the forward's ~1e-6 disagreement.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.samplers import correctors as jcorrectors
from psld_tpu.samplers import sde_samplers as jsamplers
from psld_tpu.samplers.base import make_timesteps as j_make_timesteps
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu_torch.cli import class_cond_sample as guided_cli
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.cli import train_clf as train_clf_cli
from psld_tpu_torch.cli import train_sde as train_sde_cli
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.interop.from_flax import load_flax_params
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.samplers import (EulerMaruyamaSampler, LangevinCorrector,
                                     SSCS2MSampler, SSCSSampler,
                                     build_corrector, make_timesteps)
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train.checkpoint import latest_checkpoint
from test_torch_cli import _CLF_RUN, _GUIDED_RUN, _TINY_RUN, one_thread  # noqa: F401
from test_torch_ncsnpp import assert_close_to_scale, jit_o0, \
    random_flax_params
from test_torch_sscs import NANO, nano_pair, sde_cfg

B, S, EPS = 2, 8, 1e-3
_OUT3 = {}


def pair(out_ch):
    """(JAX net, flax params, port net) of the one-level NCSN++ with 6 or
    3 output channels."""
    if out_ch == 6:
        return nano_pair()
    if not _OUT3:
        kw = {**NANO, "out_ch": 3}
        jnet = JNCSNpp(**kw)
        params = random_flax_params(jnet, kw, seed=2)
        _OUT3["pair"] = (jnet, params,
                         load_flax_params(NCSNpp(**kw), params).eval())
    return _OUT3["pair"]


def pc_cfg(nu=4.02, gamma=0.02, name="em_sde", n_steps=3, steps=1,
           snr=0.16):
    cfg = sde_cfg(nu, gamma, n_steps=n_steps, name=name)
    cfg["evaluation"]["sampler"].update(
        corrector="langevin", corrector_snr=snr, corrector_steps=steps)
    return cfg


def _named(pred, corr, used):
    """The port's ``noise(k, like)`` over the JAX draws: integer names
    from ``pred``, ``("corrector", i, j)`` from ``corr``."""
    def draw(k, like):
        used.append(k)
        return torch.from_numpy(corr[k[1:]] if isinstance(k, tuple)
                                else pred[k])
    return draw


def _corrector_draws(csub, steps, shape):
    out = []
    for _ in range(steps):
        csub, k = jax.random.split(csub)
        out.append(jax.random.normal(k, shape, jnp.float32))
    return out


@pytest.mark.parametrize("nu,gamma,out_ch", [(4.0, 0.0, 3),
                                             (4.02, 0.02, 6)])
def test_langevin_step_matches_jax(nu, gamma, out_ch):
    """Two corrector steps at t = 0.3 from a random state. In the
    ``score_m`` mode (gamma = 0) the live mask keeps the x half exactly."""
    jnet, params, net = pair(out_ch)
    cfg = pc_cfg(nu, gamma, steps=2)
    u = np.random.default_rng(4).standard_normal((B, S, S, 6)).astype(
        np.float32)
    jsde = JPSLD(JConfigDict(cfg))

    def run(p, key, uu):
        corr = jcorrectors.LangevinCorrector(
            JConfigDict(cfg), jsde, lambda zz, tt: jnet.apply(p, zz, tt))
        out = corr(uu, jnp.asarray(0.3, jnp.float64),
                   jnp.asarray(0.01, jnp.float64), key)
        return out, _corrector_draws(key, 2, uu.shape)

    (want, want_mean), draws = jit_o0(run, params, jax.random.PRNGKey(5),
                                      jnp.asarray(u))
    corr = LangevinCorrector(ConfigDict(cfg), PSLD(ConfigDict(cfg)),
                             make_score_fn(net))
    with torch.inference_mode():
        got, got_mean = corr(torch.from_numpy(u), 0.3, 0.01,
                             lambda j, like: torch.from_numpy(
                                 np.array(draws[j])))
    assert np.isfinite(np.asarray(want)).all()
    assert_close_to_scale(got.numpy(), np.asarray(want), 1e-4)
    assert_close_to_scale(got_mean.numpy(), np.asarray(want_mean), 1e-4)
    moved = np.abs(got.numpy() - u).max(axis=(0, 1, 2))
    if gamma == 0.0:
        assert torch.equal(got[..., :3], torch.from_numpy(u[..., :3]))
        assert (moved[3:] > 0).all()
    else:
        assert (moved > 0).all()


def _jax_pc_run(name, n_steps, steps):
    """(prior, predictor draws, corrector draws by (i, j), final sample)
    of the JAX sampler with a Langevin corrector, denoise on."""
    jnet, params, _ = nano_pair()
    cfg = JConfigDict(pc_cfg(name=name, n_steps=n_steps, steps=steps))
    jsde = JPSLD(cfg)
    cls = {"em_sde": jsamplers.EulerMaruyamaSampler,
           "sscs2m_sde": jsamplers.SSCS2MSampler}[name]
    n_eff = n_steps - 1
    ts = j_make_timesteps(n_eff, EPS)

    def run(p, key):
        z = jsde.prior_sampling(jax.random.fold_in(key, 0), (B, S, S, 3))
        score = lambda zz, tt: jnet.apply(p, zz, tt)  # noqa: E731
        sampler = cls(cfg, jsde, score, corrector_fn=jcorrectors
                      .build_corrector(cfg, jsde, score))
        out = sampler.sample(key, z, ts, n_eff, denoise=True, eps=EPS)
        pred, corr, k = [], {}, key
        # EM's scan runs the denoise row too; SSCS-2M's only the steps
        for i in range(n_eff + (name == "em_sde")):
            k, sub, csub = jax.random.split(k, 3)
            if name == "em_sde":
                pred.append(jax.random.normal(sub, z.shape, z.dtype))
            else:
                pred += [jax.random.normal(kk, z.shape, z.dtype)
                         for kk in jax.random.split(sub)]
            for j, d in enumerate(_corrector_draws(csub, steps, z.shape)):
                corr[i, j] = d
        return z, pred, corr, out

    z, pred, corr, out = jit_o0(run, params, jax.random.PRNGKey(13))
    return (np.array(z), [np.array(d) for d in pred],
            {k: np.array(v) for k, v in corr.items()}, np.asarray(out))


@pytest.mark.parametrize("name,cls,want_used", [
    ("em_sde", EulerMaruyamaSampler,
     [0, ("corrector", 0, 0), 1, ("corrector", 1, 0)]),
    ("sscs2m_sde", SSCS2MSampler,
     [0, 1, ("corrector", 0, 0), 2, 3, ("corrector", 1, 0)]),
])
def test_pc_trajectory_matches_jax(name, cls, want_used):
    """3 NFE (two steps and the mean-only denoise) with one corrector step
    after each step; EM's denoise row runs no corrector."""
    z, pred, corr, want = _jax_pc_run(name, 3, 1)
    _, _, net = nano_pair()
    cfg = ConfigDict(pc_cfg(name=name))
    sde = PSLD(cfg)
    score = make_score_fn(net)
    sampler = cls(cfg, sde, score,
                  corrector_fn=build_corrector(cfg, sde, score))
    used = []
    with torch.inference_mode():
        got = sampler.sample(None, torch.from_numpy(z),
                             make_timesteps(2, EPS), 2, denoise=True,
                             eps=EPS, noise=_named(pred, corr, used))
    assert used == want_used
    assert np.isfinite(want).all()
    assert_close_to_scale(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("cls", [EulerMaruyamaSampler, SSCSSampler,
                                 SSCS2MSampler])
def test_plain_stream_is_untouched(cls):
    """Without a corrector a sampler asks for its integer draws alone;
    with one it asks for the same integers in the same order, the
    corrector's draws between them. The same seed, no corrector, gives
    the same sample as a sampler built without the argument."""
    _, _, net = nano_pair()
    cfg = ConfigDict(pc_cfg(n_steps=4))
    sde = PSLD(cfg)
    score = make_score_fn(net)
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, S, 6)).astype(np.float32))
    ts = make_timesteps(3, EPS)

    def names(corrector):
        used = []

        def draw(k, like):
            used.append(k)
            return torch.zeros_like(like)

        with torch.inference_mode():
            cls(cfg, sde, score, corrector_fn=corrector).sample(
                None, z, ts, 3, noise=draw)
        return used

    plain = names(None)
    assert all(isinstance(k, int) for k in plain)
    assert plain == list(range(len(plain))) and plain
    with_pc = names(build_corrector(cfg, sde, score))
    assert [k for k in with_pc if isinstance(k, int)] == plain
    assert len(with_pc) - len(plain) == 3  # one a step, 3 steps
    with torch.inference_mode():
        a = cls(cfg, sde, score).sample(torch.Generator().manual_seed(1), z,
                                        ts, 3)
        b = cls(cfg, sde, score, corrector_fn=None).sample(
            torch.Generator().manual_seed(1), z, ts, 3)
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_reference_three_argument_corrector():
    """A corrector ``(x, t, dt) -> (x, x_mean)`` of the reference's form
    is called without a draw, after every noisy EM row."""
    _, _, net = nano_pair()
    cfg = ConfigDict(pc_cfg(n_steps=3))
    calls = []

    def corrector(x, t, dt):
        calls.append((t, dt))
        return x * 0.5, x

    sampler = EulerMaruyamaSampler(cfg, PSLD(cfg), make_score_fn(net),
                                   corrector_fn=corrector)
    z = torch.ones(B, S, S, 6)
    with torch.inference_mode():
        sampler.sample(torch.Generator().manual_seed(0), z,
                       make_timesteps(2, EPS), 2)
    ts = make_timesteps(2, EPS).tolist()
    assert calls == [(ts[0], ts[1] - ts[0]), (ts[1], ts[2] - ts[1])]


@pytest.mark.parametrize("sampler", ["em_sde", "sscs2m_sde"])
def test_sample_entry_point_takes_a_corrector(tmp_path, sampler):
    """``cli.sample`` with ``corrector=langevin`` (refused before the
    corrector was ported) samples finite images with EM and SSCS-2M; the
    corrector changes the samples."""
    _, _, net = nano_pair()
    sd = net.state_dict()
    ckpt = tmp_path / "ckpt.pt"
    torch.save({"params": sd, "ema_params": sd, "step": 10**6}, ckpt)
    args = ["+dataset=cifar10/cifar10_psld",
            "dataset.diffusion.data.root=/unused",
            "dataset.diffusion.data.image_size=8",
            "dataset.diffusion.model.score_fn.nf=16",
            "dataset.diffusion.model.score_fn.ch_mult=[1]",
            "dataset.diffusion.model.score_fn.num_res_blocks=1",
            "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
            "dataset.diffusion.model.score_fn.dropout=0.0",
            "dataset.diffusion.model.score_fn.fir=true",
            "dataset.diffusion.model.score_fn.embedding_type=fourier",
            "dataset.diffusion.model.score_fn.progressive_input=residual",
            f"dataset.diffusion.evaluation.sampler.name={sampler}",
            f"dataset.diffusion.evaluation.chkpt_path={ckpt}",
            "dataset.diffusion.evaluation.save_path=" + str(tmp_path),
            "dataset.diffusion.evaluation.save_mode=np",
            "dataset.diffusion.evaluation.n_samples=2",
            "dataset.diffusion.evaluation.batch_size=2",
            "dataset.diffusion.evaluation.n_discrete_steps=3",
            "+dataset.diffusion.evaluation.device=cpu"]
    out = {}
    for pc in ("none", "langevin"):
        rows = sample_cli.main(args + [
            f"+dataset.diffusion.evaluation.sampler.corrector={pc}",
            "+dataset.diffusion.evaluation.sampler.corrector_steps=1",
            f"dataset.diffusion.evaluation.path_prefix={pc}"])
        assert [(r["samples"], r["nonfinite"]) for r in rows] == [(2, 0)]
        out[pc] = np.load(tmp_path / pc / "images" / "output_tpu_0_0_0.npy")
    assert not np.array_equal(out["none"], out["langevin"])


def test_guided_entry_point_takes_a_corrector(tmp_path, one_thread):
    """``cli.class_cond_sample`` with ``corrector=langevin``, from tiny
    score and classifier checkpoints: finite guided samples."""
    train_sde_cli.main(_TINY_RUN + [
        f"dataset.diffusion.training.results_dir={tmp_path}/score"])
    train_clf_cli.main(_TINY_RUN + _CLF_RUN + [
        f"dataset.clf.training.results_dir={tmp_path}/clf"])
    rows = guided_cli.main(_TINY_RUN + _CLF_RUN + _GUIDED_RUN + [
        "dataset.diffusion.evaluation.chkpt_path="
        + latest_checkpoint(f"{tmp_path}/score/checkpoints"),
        "dataset.clf.evaluation.chkpt_path="
        + latest_checkpoint(f"{tmp_path}/clf/checkpoints"),
        f"dataset.diffusion.evaluation.save_path={tmp_path}/guided",
        "+dataset.diffusion.evaluation.sampler.corrector=langevin"])
    assert [(r["label"], r["samples"], r["nonfinite"]) for r in rows] == \
        [(1, 2, 0), (4, 2, 0)]
