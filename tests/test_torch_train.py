"""The port's optimizer, train step, data pipeline, checkpoints and
training entry point against the JAX package (CPU).

The JAX train step draws t and eps from keys derived from (rng, step);
the test derives the same keys' draws and hands them to the port's step.
After each of three steps the parameters, the EMA and the Adam moments of
both states are held to rtol 1e-5 with an absolute floor of 1e-5 of the
tree's largest magnitude plus 1e-8: float32 gradients summed in another
order, through Adam's division by a root that is small where a gradient
is.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psld_tpu.data.datasets import SyntheticDataset as JSynthetic
from psld_tpu.data.loader import EpochLoader as JLoader
from psld_tpu.losses.score import PSLDScoreLoss as JLoss
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu.train import checkpoint as jckpt
from psld_tpu.train.state import init_state as j_init_state
from psld_tpu.train.steps import make_train_step as j_make_train_step
from psld_tpu.train.steps import sample_times as j_sample_times
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.cli import train_sde as train_cli
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.data.datasets import SyntheticDataset
from psld_tpu_torch.data.loader import EpochLoader
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              train_state_from_flax)
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.state import (Optimizer, init_state,
                                        make_optimizer)
from psld_tpu_torch.train.steps import (StepRandom, make_train_step,
                                        sample_times)
from test_torch_loss import MICRO, jax_draws, loss_cfg
from test_torch_ncsnpp import compile_o0, random_flax_params

ACCUM = 2
# the optimizer tests' network: one level, one block, attention at its
# only resolution. The JAX step compiles in a third of MICRO's time; the
# whole network's gradients are held in test_torch_loss.py
NANO = {**MICRO, "ch_mult": (1,), "attn_resolutions": (8,)}


def step_cfg(**optimizer):
    opt = {"name": "Adam", "lr": 1e-2, "beta_1": 0.9, "beta_2": 0.999,
           "weight_decay": 0, "eps": 1e-8, "warmup": 2, "grad_clip": 0.05,
           **optimizer}
    return loss_cfg(train_eps=1e-5, use_ema=True, ema_decay=0.9,
                    grad_accum=ACCUM, optimizer=opt)


def adam_state(opt_state):
    """optax's ScaleByAdamState inside a chain's state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def to_port(net, jstate):
    s = jax.device_get(jstate)
    adam = adam_state(s.opt_state)
    return train_state_from_flax(net, s.params, s.ema_params, adam.mu,
                                 adam.nu, int(adam.count), int(s.step))


def assert_states_close(state, jstate, net, what):
    s = jax.device_get(jstate)
    adam = adam_state(s.opt_state)
    assert state.step == int(s.step)
    assert state.opt_state["count"] == int(adam.count)
    for name, got, want in (("params", state.params, s.params),
                            ("ema", state.ema_params, s.ema_params),
                            ("mu", state.opt_state["mu"], adam.mu),
                            ("nu", state.opt_state["nu"], adam.nu)):
        want = flax_to_state_dict(want, net)
        floor = 1e-5 * max(float(w.abs().max()) for w in want.values())
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k].detach().numpy(), w.numpy(), rtol=1e-5,
                atol=floor + 1e-8, err_msg=f"{what}: {name} {k}")


def jax_step_draws(rng, step, x_shape, train_eps):
    """(t, m0, eps) per microbatch, as the JAX step derives them."""
    k_t, k_loss = jax.random.split(jax.random.fold_in(rng, step))
    out = []
    for i in range(ACCUM):
        t = j_sample_times(jax.random.fold_in(k_t, i), x_shape[0], train_eps)
        m0, eps = jax_draws(jax.random.fold_in(k_loss, i), x_shape)
        out.append((np.array(t), m0, eps))
    return out


@pytest.mark.parametrize("weight_decay", [
    pytest.param(0, id="adam"),
    # the JAX step compiles anew for AdamW (~20 s on one core); the cheap
    # hold of AdamW is test_adamw_updates_follow_optax
    pytest.param(0.01, id="adamw", marks=pytest.mark.slow)])
def test_three_optimizer_steps_match_jax(weight_decay):
    """Warmup 2 (learning rates 0, lr/2, lr ... read before the update), a
    clip that triggers (grad_clip 0.05 under gradient norms of ~1), EMA
    0.9 and grad_accum 2, from a state with non-zero moments: one JAX step
    is taken first and its state converted with
    ``train_state_from_flax``."""
    cfg = step_cfg(weight_decay=weight_decay)
    jnet = JNCSNpp(**NANO)
    params = random_flax_params(jnet, NANO, seed=1)
    jsde, sde = JPSLD(cfg), PSLD(cfg)
    j_step, j_opt = j_make_train_step(jnet, jsde, JLoss(cfg, jsde), cfg,
                                      donate=False)
    net = NCSNpp(**NANO)
    step, _ = make_train_step(net, sde, PSLDScoreLoss(cfg, sde), cfg)
    rng = jax.random.PRNGKey(0)
    data = np.random.default_rng(0).uniform(
        -1, 1, (4, ACCUM, 2, 8, 8, 3)).astype(np.float32)

    jstate = j_init_state(params, j_opt)
    j_step = compile_o0(j_step, jstate, jnp.asarray(data[0]), rng)
    jstate, _ = j_step(jstate, jnp.asarray(data[0]), rng)
    state = to_port(net, jstate)
    assert_states_close(state, jstate, net, "converted state")
    assert float(torch.stack([v.abs().max() for v in
                              state.opt_state["mu"].values()]).max()) > 0
    for i in (1, 2, 3):
        draws = jax_step_draws(rng, int(jstate.step), data[i][0].shape, 1e-5)
        jstate, jm = j_step(jstate, jnp.asarray(data[i]), rng)
        state, m = step(
            state, torch.from_numpy(data[i]),
            t=[torch.from_numpy(d[0]) for d in draws],
            m0=[torch.from_numpy(d[1]) for d in draws],
            eps=[torch.from_numpy(d[2]) for d in draws])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(jm["grad_norm"]) > 0.05  # the clip triggered
        assert_states_close(state, jstate, net, f"after step {i}")
    # the network the step ran on holds the state's parameters
    assert dict(net.named_parameters())["Conv_0.weight"] is \
        state.params["Conv_0.weight"]


def test_adamw_updates_follow_optax():
    """Three AdamW updates of a small tree (warmup 2, a clip that
    triggers, decay 0.01) against the JAX package's optax chain: params
    and moments within rtol 1e-6; the frozen Fourier ``W`` has a zero
    gradient, is masked out of the decay and does not move."""
    from psld_tpu.train.state import make_optimizer as j_make_optimizer

    opt_cfg = step_cfg(weight_decay=0.01).training.optimizer
    rng = np.random.default_rng(7)
    tree = {"Dense_0": {"kernel": rng.standard_normal((5, 3)),
                        "bias": rng.standard_normal(3)},
            "GaussianFourierProjection_0": {"W": rng.standard_normal(4)}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    names = {"Dense_0.weight": ("Dense_0", "kernel"),
             "Dense_0.bias": ("Dense_0", "bias"),
             "GaussianFourierProjection_0.W":
                 ("GaussianFourierProjection_0", "W")}
    j_opt = j_make_optimizer(opt_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_opt.init(j_params)
    opt = make_optimizer(opt_cfg)
    params = {k: torch.from_numpy(tree[a][b].copy())
              for k, (a, b) in names.items()}
    state = opt.init(params)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        grads["GaussianFourierProjection_0"]["W"][:] = 0
        updates, j_state = j_opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        g = {k: torch.from_numpy(grads[a][b].copy())
             for k, (a, b) in names.items()}
        norm = torch.linalg.vector_norm(torch.cat(
            [v.flatten() for v in g.values()]))
        assert float(norm) > opt.grad_clip  # the clip triggered
        opt.update_(g, state, params, norm)
        adam = adam_state(j_state)
        for k, (a, b) in names.items():
            for got, want in ((params[k], j_params[a][b]),
                              (state["mu"][k], adam.mu[a][b]),
                              (state["nu"][k], adam.nu[a][b])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-8, err_msg=k)
    assert np.array_equal(params["GaussianFourierProjection_0.W"].numpy(),
                          tree["GaussianFourierProjection_0"]["W"])
    assert state["count"] == 3


def test_optimizer_schedule_and_clip_follow_optax():
    opt = make_optimizer(step_cfg().training.optimizer)
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, 1e-2, 2), optax.constant_schedule(1e-2)],
        boundaries=[2])
    for count in range(5):
        np.testing.assert_allclose(opt.learning_rate(count),
                                   float(sched(count)), rtol=1e-6)
    assert opt.learning_rate(0) == 0.0
    assert Optimizer(1e-3, 0.9, 0.999, 1e-8).learning_rate(0) == 1e-3
    clip = optax.clip_by_global_norm(0.05)
    for scale in (1.0, 1e-3):  # above and below the threshold
        g = np.random.default_rng(1).standard_normal((3, 4)).astype(
            np.float32) * scale
        want, _ = clip.update({"g": jnp.asarray(g)}, clip.init(None))
        got = [torch.from_numpy(g.copy())]
        opt.clip_(got, torch.linalg.vector_norm(got[0]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want["g"]),
                                   rtol=1e-6)
    with pytest.raises(NotImplementedError):
        make_optimizer(ConfigDict({"name": "SGD"}))
    flat = step_cfg(flatten=True).training.optimizer
    assert make_optimizer(flat).lr == 1e-2  # accepted, no effect


def test_bf16_step_keeps_float32_master_weights():
    """``training.bf16``: the forward sees bfloat16 weights and input, the
    gradients and every tensor of the state stay float32, and the loss is
    close to the float32 step's (bf16 network: 3e-2)."""
    losses = {}
    for bf16 in (False, True):
        cfg = step_cfg()
        cfg.training["bf16"] = bf16
        cfg.training["grad_accum"] = 1
        sde = PSLD(cfg)
        net = NCSNpp(**{**MICRO, "dropout": 0.15, "dropout_impl": "hw"})
        seen = []
        net.Conv_0.register_forward_hook(
            lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        step, opt = make_train_step(net, sde, PSLDScoreLoss(cfg, sde), cfg)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in net.parameters():
                p.normal_(generator=gen).mul_(0.25)
        state = init_state(dict(net.named_parameters()), opt)
        x = torch.rand(4, 8, 8, 3, generator=gen) * 2 - 1
        state, m = step(state, x, StepRandom(3))
        losses[bf16] = float(m["loss"])
        want = torch.bfloat16 if bf16 else torch.float32
        assert seen == [(want, want)]
        assert m["loss"].dtype == torch.float32
        for tree in (state.params, state.ema_params, state.opt_state["mu"],
                     state.opt_state["nu"]):
            assert all(v.dtype == torch.float32 for v in tree.values())
        assert state.step == 1 and state.opt_state["count"] == 1
    np.testing.assert_allclose(losses[True], losses[False], rtol=3e-2)


def test_step_random_is_reproducible_and_ordered():
    a, b = StepRandom(1), StepRandom(1)
    assert torch.equal(sample_times(a, 8, 1e-5), sample_times(b, 8, 1e-5))
    assert torch.equal(a.normal((2, 3)), b.normal((2, 3)))
    words = a.seed_words(5)
    assert words == b.seed_words(5) and len(set(words)) == 5
    assert all(0 <= w < 2 ** 32 for pair in words for w in pair)
    t = sample_times(StepRandom(2), 1000, 1e-5)
    assert t.dtype == torch.float64
    assert 1e-5 <= float(t.min()) and float(t.max()) <= 1.0


def test_data_pipeline_matches_jax():
    """Same seed, same images, permutation and flips: numpy on both sides."""
    ds, jds = (cls(None, image_size=8, n=10, seed=3)
               for cls in (SyntheticDataset, JSynthetic))
    assert np.array_equal(ds.images, jds.images)
    loader = EpochLoader(ds, 4, hflip=True, seed=5)
    jloader = JLoader(jds, 4, hflip=True, seed=5)
    assert len(loader) == len(jloader) == 2
    for _ in range(2):  # two epochs: the permutation moves on
        got, want = list(loader), list(jloader)
        assert len(got) == 2
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and np.array_equal(g, w)


TINY_TRAIN = [
    "+dataset=cifar10/cifar10_psld",
    "dataset.diffusion.data.root=/unused",
    "dataset.diffusion.data.name=synthetic",
    "dataset.diffusion.data.image_size=8",
    "dataset.diffusion.model.score_fn.nf=8",
    "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=1",
    "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
    "dataset.diffusion.model.score_fn.dropout=0.15",
    "+dataset.diffusion.model.score_fn.dropout_impl=hw",
    "dataset.diffusion.training.batch_size=128",
    "dataset.diffusion.training.epochs=2",
    "dataset.diffusion.training.chkpt_interval=2",
    "dataset.diffusion.training.optimizer.warmup=2",
    "+dataset.diffusion.training.bf16=True",
    "+dataset.diffusion.training.device=cpu",
    "dataset.diffusion.evaluation.n_samples=3",
    "dataset.diffusion.evaluation.batch_size=2",
    "dataset.diffusion.evaluation.n_discrete_steps=3",
    "dataset.diffusion.evaluation.sample_from=source",
    "+dataset.diffusion.evaluation.device=cpu",
]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    results = str(tmp_path_factory.mktemp("train") / "results")
    argv = TINY_TRAIN + [f"dataset.diffusion.training.results_dir={results}"]
    state, stats = train_cli.main(argv)
    return results, argv, state, stats


def test_train_cli_writes_the_jax_packages_files(trained):
    """Two epochs of four steps on the synthetic set: one checkpoint, at
    the second epoch's end, under the JAX package's name, with its resume
    sidecar and a metrics stream whose header holds the resolved knobs."""
    results, _, state, stats = trained
    assert state.step == 8 and [r["step"] for r in stats] == list(range(1, 9))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               and r["ms"] > 0 for r in stats)
    files = sorted(os.listdir(f"{results}/checkpoints"))
    assert len(files) == 2 and files[1] == files[0] + ".meta.json"
    name = jckpt.checkpoint_name("psld-score_xm", "", 1, stats[-1]["loss"])
    assert files[0] == name + ".pt"
    assert ckpt.latest_checkpoint(f"{results}/checkpoints").endswith(files[0])
    path = f"{results}/checkpoints/{files[0]}"
    assert ckpt.resume_epoch(path) == jckpt.resume_epoch(path) == 2
    meta = json.load(open(path + ".meta.json"))
    assert meta["complete"] and meta["knobs"] == {
        "gn_bf16": False, "dropout_impl": "hw", "bf16": True}
    recs = [json.loads(line) for line in open(f"{results}/metrics.jsonl")]
    assert recs[0]["header"] is True and recs[0]["knobs"] == meta["knobs"]
    assert [r["step"] for r in recs[1:]] == list(range(1, 9))
    assert {"step", "loss", "grad_norm", "epoch"} <= recs[1].keys()


def test_checkpoint_roundtrip_and_sampling(trained, tmp_path):
    """The file holds params, EMA, step and Adam state; a fresh state
    restored from it equals the trained one; ``cli.sample`` loads it and
    writes PNGs; ``restore_path=latest`` resumes at the next epoch."""
    results, argv, state, _ = trained
    path = ckpt.latest_checkpoint(f"{results}/checkpoints")
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"params", "ema_params", "step", "opt_state"}
    assert raw["step"] == 8 and raw["opt_state"]["count"] == 8

    out = tmp_path / "samples"
    batches = sample_cli.main(argv + [
        f"dataset.diffusion.evaluation.chkpt_path={path}",
        f"dataset.diffusion.evaluation.save_path={out}"])
    assert [b["samples"] for b in batches] == [2, 1]
    assert len(glob.glob(f"{out}/images/*.png")) == 3

    more = [a for a in argv if "epochs=" not in a] + [
        "dataset.diffusion.training.epochs=3",
        "dataset.diffusion.training.chkpt_interval=1",
        "dataset.diffusion.training.restore_path=latest"]
    state2, stats2 = train_cli.main(more)
    assert [r["epoch"] for r in stats2] == [2] * 4
    assert state2.step == 12 and state2.opt_state["count"] == 12
    # the resumed run started from the trained state, not from scratch
    restored = ckpt.restore_checkpoint(path, init_state(
        {k: torch.zeros_like(v) for k, v in state.params.items()},
        make_optimizer(step_cfg().training.optimizer)))
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], raw["params"][k])
        assert torch.equal(restored.opt_state["nu"][k],
                           raw["opt_state"]["nu"][k])
    assert restored.step == 8


@pytest.mark.parametrize("override", [
    "+dataset.diffusion.training.spatial=2",
    "+dataset.diffusion.training.fsdp=true",
])
def test_train_refuses_what_is_not_ported(override, tmp_path):
    """Spatial parallelism needs a spatial group of ranks
    (tests/test_torch_spatial.py): one process asked for ``spatial=2`` is
    refused with the JAX package's message before anything is built.
    FSDP is ported (tests/test_torch_parallel.py) and does not hide that
    refusal."""
    spatial = [] if "spatial" in override \
        else ["+dataset.diffusion.training.spatial=2"]
    with pytest.raises(ValueError, match="must divide the device count 1"):
        train_cli.main(TINY_TRAIN + [
            override, *spatial,
            f"dataset.diffusion.training.results_dir={tmp_path}"])
