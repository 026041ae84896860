"""The port's multi-process data parallelism, FSDP and lockstep sampling
against the JAX package (CPU, gloo).

Ranks run as subprocess workers: a ``-c`` script that imports torch and
``psld_tpu_torch`` only (``mp.spawn`` would re-import this module, which
imports JAX), joins a gloo group over localhost, and writes ``.npz``
files the test compares; the JAX side runs here, on the 2-device CPU mesh
of ``conftest.py``. The network is ``tests/test_train_step.py``'s
``tiny_setup`` with hash dropout 0.15 on; the training states are held
to ``test_torch_train.py``'s tolerance (rtol 1e-5, floored at 1e-5 of
the tree's largest magnitude plus 1e-8).
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import glob
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psld_tpu.ops as jops
from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.data.datasets import SyntheticDataset as JSynthetic
from psld_tpu.data.loader import EpochLoader as JLoader
from psld_tpu.losses.score import PSLDScoreLoss as JLoss
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.models.ncsnpp import NCSNppClassifier as JClassifier
from psld_tpu.parallel.fsdp import fsdp_spec as j_fsdp_spec
from psld_tpu.parallel.fsdp import per_device_bytes as j_per_device_bytes
from psld_tpu.parallel.fsdp import shard_tree as j_shard_tree
from psld_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu.train.state import init_state as j_init_state
from psld_tpu.train.steps import make_train_step as j_make_train_step
from psld_tpu.train.steps import sample_times as j_sample_times
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.cli._common import bootstrap
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.data.datasets import SyntheticDataset
from psld_tpu_torch.data.loader import EpochLoader
from psld_tpu_torch.interop.from_flax import flax_to_state_dict
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.parallel.fsdp import fsdp_spec
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.loop import build_score_model, init_score_params
from psld_tpu_torch.train.state import TrainState, init_state, make_optimizer
from psld_tpu_torch.train.steps import make_train_step
from test_torch_loss import jax_draws
from test_torch_ncsnpp import random_flax_params
from test_torch_train import assert_states_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GLOBAL_B = 4
STEPS = 2
# leaves of at least this many elements shard in the FSDP cases: the tiny
# network has none of the default 2**14
MIN_SIZE = 256

CFG = {
    "data": {"image_size": 8, "num_channels": 3},
    "model": {
        "score_fn": {"name": "ncsnpp", "in_ch": 6, "out_ch": 6,
                     "nonlinearity": "swish", "nf": 8, "ch_mult": [1, 2],
                     "num_res_blocks": 1, "attn_resolutions": [4],
                     "dropout": 0.15, "dropout_impl": "hw",
                     "resamp_with_conv": True, "noise_cond": True,
                     "fir": False, "fir_kernel": [1, 3, 3, 1],
                     "skip_rescale": True, "resblock_type": "biggan",
                     "progressive": "none", "progressive_input": "none",
                     "progressive_combine": "sum",
                     "embedding_type": "positional", "init_scale": 0.0,
                     "fourier_scale": 16},
        "sde": {"name": "psld", "beta_min": 8, "beta_max": 8, "nu": 4.01,
                "gamma": 0.01, "kappa": 0.04, "decomp_mode": "lower",
                "numerical_eps": 1e-9, "n_timesteps": 1000},
    },
    "training": {"mode": "dsm", "train_eps": 1e-5, "use_ema": True,
                 "ema_decay": 0.9, "seed": 0,
                 "loss": {"name": "psld_score_loss", "l_type": "l2",
                          "reduce_mean": True, "weighting": "fid"},
                 "optimizer": {"name": "Adam", "lr": 1e-3, "beta_1": 0.9,
                               "beta_2": 0.999, "weight_decay": 0,
                               "eps": 1e-8, "warmup": 0,
                               "grad_clip": 1.0}},
}

# the lockstep case's and the SIGTERM case's runs, at 8x8
TINY_RUN = [
    "+dataset=cifar10/cifar10_psld",
    "dataset.diffusion.data.root=/unused",
    "dataset.diffusion.data.name=synthetic",
    "dataset.diffusion.data.image_size=8",
    "dataset.diffusion.model.score_fn.nf=8",
    "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=1",
    "dataset.diffusion.model.score_fn.attn_resolutions=[4]",
    "dataset.diffusion.model.score_fn.dropout=0.15",
    "+dataset.diffusion.model.score_fn.dropout_impl=hw",
    "+dataset.diffusion.training.device=cpu",
    "+dataset.diffusion.evaluation.device=cpu",
]
LOCKSTEP = [
    "dataset.diffusion.evaluation.n_samples=6",
    "dataset.diffusion.evaluation.n_discrete_steps=4",
    "dataset.diffusion.evaluation.sample_from=source",
    "+dataset.diffusion.evaluation.sampler.corrector=langevin",
]
# batch 64 a rank: an epoch of the 512 synthetic images is 4 steps
TRAIN_RUN = TINY_RUN + [
    "dataset.diffusion.training.batch_size=64",
    "dataset.diffusion.training.epochs=2",
    "dataset.diffusion.training.chkpt_interval=1",
    "dataset.diffusion.training.log_step=1",
    "+dataset.diffusion.training.prefetch=0",
    "+dataset.diffusion.training.auto_resume=true",
]
CLF_RUN = [
    "dataset.clf.data.root=/unused", "dataset.clf.data.name=synthetic",
    "dataset.clf.data.image_size=8", "dataset.clf.model.clf_fn.n_cls=10",
    "dataset.clf.model.clf_fn.nf=8", "dataset.clf.model.clf_fn.ch_mult=[1,2]",
    "dataset.clf.model.clf_fn.num_res_blocks=1",
    "dataset.clf.model.clf_fn.attn_resolutions=[4]",
    "dataset.clf.training.batch_size=128", "dataset.clf.training.epochs=1",
    "+dataset.clf.training.device=cpu",
    "+dataset.clf.training.fsdp=true",
]

WORKER = r"""
import json, os, signal, sys
rank, world, port, work, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                  WORLD_SIZE=str(world), LOCAL_RANK="0", PSLD_MULTIHOST="1")
import numpy as np
import torch
torch.set_num_threads(1)
import psld_tpu_torch
psld_tpu_torch.import_modules_into_registry()
from psld_tpu_torch.parallel import distributed, fsdp

setup = json.load(open(os.path.join(work, "setup.json")))
fsdp.DEFAULT_MIN_SIZE = setup["min_size"]


def tree_arrays(prefix, state):
    trees = {"params": state.params, "ema": state.ema_params,
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    return {f"{prefix}/{name}/{k}": v.detach().numpy()
            for name, tree in trees.items() for k, v in tree.items()}


def steps():
    from psld_tpu_torch.config import ConfigDict
    from psld_tpu_torch.losses.score import PSLDScoreLoss
    from psld_tpu_torch.models.ncsnpp import NCSNpp
    from psld_tpu_torch.sde.psld import PSLD
    from psld_tpu_torch.train import checkpoint as ckpt
    from psld_tpu_torch.train.state import init_state
    from psld_tpu_torch.train.steps import make_train_step

    distributed.maybe_initialize("cpu")
    assert distributed.process_info() == (rank, world)
    cfg = ConfigDict(setup["cfg"])
    arrays = np.load(os.path.join(work, "setup.npz"))
    sde = PSLD(cfg)
    crit = PSLDScoreLoss(cfg, sde)
    b = arrays["x0"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)

    def fresh():
        net = NCSNpp.from_config(cfg)
        net.load_state_dict({k[2:]: torch.from_numpy(arrays[k])
                             for k in arrays.files if k.startswith("p:")})
        return net, dict(net.named_parameters())

    def run(sharded):
        net, params = fresh()
        layout = fsdp.Layout(params) if sharded else None
        step, opt = make_train_step(net, sde, crit, cfg, fsdp=layout)
        state = init_state(params, opt)
        if layout is not None:
            state = fsdp.shard_state(state, layout)
        metrics = []
        for s in range(setup["steps"]):
            def local(name):
                return torch.from_numpy(arrays[f"{name}{s}"][rows])
            state, m = step(state, local("x"), None, t=local("t"),
                            m0=local("m0"), eps=local("eps"),
                            dropout_seeds=[tuple(w) for w in
                                           setup["seeds"][s]])
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        full = state if layout is None else fsdp.gather_state(state, layout)
        return full, metrics, state, layout, opt

    ddp, ddp_m, _, _, opt = run(False)
    fs, fs_m, shards, layout, _ = run(True)
    out = {**tree_arrays("ddp", ddp), **tree_arrays("fsdp", fs),
           "ddp_metrics": np.array(ddp_m), "fsdp_metrics": np.array(fs_m),
           "rank_bytes": fsdp.per_device_bytes(shards),
           "rule_bytes": layout.bytes_per_rank(),
           "sharded": np.array(sorted(layout.sharded))}

    # a checkpoint saved under FSDP restores without it, and the other way
    def restored(path, shard_it):
        net, params = fresh()
        state = ckpt.restore_checkpoint(path, init_state(params, opt))
        return fsdp.shard_state(state, layout) if shard_it else state

    if rank == 0:
        ckpt.save_checkpoint(work, "from_fsdp", fs)
        ckpt.save_checkpoint(work, "from_ddp", ddp)
    torch.distributed.barrier()
    back = restored(os.path.join(work, "from_fsdp.pt"), False)
    again = restored(os.path.join(work, "from_ddp.pt"), True)
    want = fsdp.shard_state(ddp, layout)
    for name in ("params", "ema_params"):
        got, ref = getattr(back, name), getattr(fs, name)
        assert all(torch.equal(got[k], ref[k]) for k in ref), name
        got, ref = getattr(again, name), getattr(want, name)
        assert all(torch.equal(got[k], ref[k]) for k in ref), name
    for name in ("mu", "nu"):
        assert all(torch.equal(again.opt_state[name][k], v)
                   for k, v in want.opt_state[name].items()), name
    assert back.step == again.step == setup["steps"]
    np.savez(os.path.join(work, f"steps_{rank}.npz"), **out)

    # the classifier's loop under FSDP
    from psld_tpu_torch.cli import train_clf
    clf_dir = os.path.join(work, "clf")
    state, stats = train_clf.main(setup["clf_args"] + [
        f"dataset.clf.training.results_dir={clf_dir}"])
    assert state.step == len(stats) == setup["clf_steps"], stats
    assert all(np.isfinite(r["loss"]) for r in stats)
    torch.distributed.barrier()
    path = ckpt.latest_checkpoint(os.path.join(clf_dir, "checkpoints"))
    saved = torch.load(path, weights_only=True)
    assert all(torch.equal(saved["params"][k], v)
               for k, v in state.params.items())

    # lockstep sampling, recording the rows each rank writes
    from psld_tpu_torch.cli import sample
    from psld_tpu_torch.eval.writers import SimpleImageWriter
    real = SimpleImageWriter.write_batch

    def recording(self, samples, rank, batch_idx):
        np.save(os.path.join(work, f"rows_{rank}_{batch_idx}.npy"), samples)
        return real(self, samples, rank, batch_idx)

    SimpleImageWriter.write_batch = recording
    batches = sample.main(setup["sample_args"])
    print("SAMPLED", json.dumps([b["samples"] for b in batches]))
    # bb_ode and the dataset paths refuse lockstep, as in the JAX package
    from psld_tpu_torch.cli import edit
    for main, extra in ((sample.main, [
            "dataset.diffusion.evaluation.sampler.name=bb_ode"]),
            (edit.main, [])):
        try:
            main(setup["sample_args"] + extra)
        except NotImplementedError as e:
            assert "lockstep" in str(e), e
        else:
            raise AssertionError("lockstep was not refused")


def train():
    from psld_tpu_torch.cli import train_sde
    from psld_tpu_torch.data.datasets import SyntheticDataset

    if setup["kill_rank"] == rank:
        real, calls = SyntheticDataset.batch, []

        def batch(self, idxs):
            # SIGTERM to this rank alone while it reads its third batch
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return real(self, idxs)

        SyntheticDataset.batch = batch
    state, stats = train_sde.main(setup["train_args"])
    print("TRAINED", json.dumps({
        "step": state.step, "rows": [[r["step"], r["epoch"]] for r in stats],
        "loss": [r["loss"] for r in stats]}))


{"steps": steps, "train": train}[mode]()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "psld_tpu"))
print("IMPORTED", bad, flush=True)
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def launch(work, mode: str, setup: dict) -> list:
    """Run ``WORLD`` workers of ``mode`` on ``setup``; their outputs, each
    held to exit 0 and to have imported nothing of JAX."""
    with open(os.path.join(work, "setup.json"), "w") as f:
        json.dump(setup, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), port, str(work),
         mode], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert "IMPORTED []" in out, out[-2000:]
    return outs


def line(out: str, tag: str):
    found = [x for x in out.splitlines() if x.startswith(tag + " ")]
    assert len(found) == 1, out[-3000:]
    return json.loads(found[0][len(tag) + 1:])


# -- (a) the loader's slices ------------------------------------------------
def test_loader_slices_tile_the_global_batch_as_jax():
    """Each process's slice of every global batch, over two epochs, is
    the JAX loader's: the same permutation everywhere, contiguous slices,
    and the same flip draws in every process (the JAX package's quirk)."""
    ds, jds = (cls(None, image_size=8, n=10, seed=3)
               for cls in (SyntheticDataset, JSynthetic))
    for world in (2, 3):
        loaders = [EpochLoader(ds, 9, hflip=True, seed=5, process_index=r,
                               process_count=world) for r in range(world)]
        jloaders = [JLoader(jds, 9, hflip=True, seed=5, process_index=r,
                            process_count=world) for r in range(world)]
        assert loaders[0].batch_size == jloaders[0].batch_size == 9 - 9 % world
        for _ in range(2):
            got = [list(ld) for ld in loaders]
            want = [list(ld) for ld in jloaders]
            for g, w in zip(got, want):
                assert len(g) == len(w) == 1
                assert all(np.array_equal(a, b) for a, b in zip(g, w))
            # the slices tile one global batch of distinct images
            whole = np.concatenate([g[0] for g in got])
            assert whole.shape[0] == loaders[0].batch_size
    # the quirk: a flip draw per local batch from the same seed
    one = EpochLoader(ds, 4, hflip=False, seed=5, shuffle=False,
                      process_index=1, process_count=2)
    assert np.array_equal(next(iter(one)), ds.batch(np.arange(2, 4)))


@pytest.mark.parametrize("impl", ["hw", "save_mask"])
def test_a_ranks_draws_are_rows_of_the_global_draws(impl):
    """``StepRandom`` with a shard gives rows of the global batch's times
    and normals; a dropout site under ``batch_shard`` drops its rows as
    the global batch's forward does (the hash op at the rows' offset, or
    the global saved mask's rows)."""
    from psld_tpu_torch.models.layers import DropoutSites
    from psld_tpu_torch.train.steps import StepRandom, sample_times

    whole = StepRandom(3)
    t, n = sample_times(whole, 6, 1e-5), whole.normal((6, 4, 4, 2))
    h = torch.randn(6, 5, 4, 4).to(memory_format=torch.channels_last)
    drop = DropoutSites(0.3, impl, [(1, 2)], torch.Generator().manual_seed(1))
    want = drop(h)
    for r in range(3):
        part = StepRandom(3, shard=(r, 3))
        assert torch.equal(sample_times(part, 2, 1e-5), t[2 * r: 2 * r + 2])
        assert torch.equal(part.normal((2, 4, 4, 2)), n[2 * r: 2 * r + 2])
        site = DropoutSites(0.3, impl, [(1, 2)],
                            torch.Generator().manual_seed(1), (r, 3))
        rows = h[2 * r: 2 * r + 2].contiguous(
            memory_format=torch.channels_last)
        assert torch.equal(site(rows), want[2 * r: 2 * r + 2])


def test_process_helpers_without_a_group_match_jax(monkeypatch):
    """One process: the JAX package's trivial values; the launch request
    read from ``PSLD_MULTIHOST`` or ``torchrun``'s ``WORLD_SIZE``; rows
    and padding as the JAX helpers give them."""
    from psld_tpu.parallel.distributed import local_batch_slice as j_slice
    from psld_tpu.parallel.mesh import pad_to_multiple as j_pad
    from psld_tpu_torch.parallel import distributed, mesh

    assert distributed.process_info() == (0, 1)
    assert distributed.local_batch_slice(12) == j_slice(12) == (12, 0)
    assert all(mesh.pad_to_multiple(n, k) == j_pad(n, k)
               for n in range(20) for k in (1, 3, 8))
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(torch.cat([mesh.shard_batch(x, r, 3)
                                  for r in range(3)]), x)
    with pytest.raises(ValueError):
        mesh.shard_batch(x, 0, 4)
    for env, want in (({}, False), ({"PSLD_MULTIHOST": "1"}, True),
                      ({"PSLD_MULTIHOST": "0"}, False),
                      ({"WORLD_SIZE": "1"}, False),
                      ({"WORLD_SIZE": "2"}, True)):
        for k in ("PSLD_MULTIHOST", "WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert distributed.multihost_requested() is want, env
    # nothing asked for: no group is made, and the run's device is kept
    monkeypatch.delenv("WORLD_SIZE")
    distributed.maybe_initialize("cuda")
    assert not distributed.initialized()
    assert distributed.run_device("cuda") == torch.device("cuda")


# -- (b) FSDP's choice of leaves ---------------------------------------------
def _flax_key(path) -> str:
    *mods, leaf = (p.key for p in path)
    return ".".join(mods + ["weight" if leaf == "kernel" else leaf])


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_fsdp_spec_and_sharded_leaves_match_jax(which):
    """``fsdp_spec`` is the JAX function on every leaf shape of the flax
    tree (shapes from ``jax.eval_shape``, no init), and the port's
    sharded-leaf set on its own (OIHW) shapes is the JAX set on the flax
    (HWIO) shapes, for 2, 4 and 8 shards."""
    if which == "tiny":
        cfg = JConfigDict(CFG)
    else:
        cfg = bootstrap(["+dataset=cifar10/cifar10_psld",
                         "dataset.diffusion.data.root=/unused"]
                        ).dataset.diffusion
        cfg = JConfigDict(cfg.to_dict())
    size = int(cfg.data.image_size)
    jnet = JNCSNpp.from_config(cfg)
    shapes = jax.eval_shape(
        jnet.init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, int(cfg.model.score_fn.in_ch))),
        jnp.zeros((1,)))["params"]
    flat = {_flax_key(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = NCSNpp.from_config(ConfigDict(cfg.to_dict()))
    port_shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert set(port_shapes) == set(flat)
    for n in (2, 4, 8):
        for min_size in (2 ** 14, MIN_SIZE):
            for shape in flat.values():
                assert fsdp_spec(shape, n, min_size=min_size) == tuple(
                    j_fsdp_spec(shape, n, min_size=min_size))
            want = {k for k, s in flat.items()
                    if j_fsdp_spec(s, n, min_size=min_size) != ()}
            got = {k for k, s in port_shapes.items()
                   if fsdp_spec(s, n, min_size=min_size)}
            assert got == want, (n, min_size)
    if which == "flagship":
        assert len(want) > 0


# -- (c), (d), (e): the steps, FSDP, checkpoints, lockstep sampling ----------
def tiny_cfg():
    return JConfigDict(CFG), ConfigDict(CFG)


def record_seeds(jnet, params, keys, x, t):
    """The seed words of every dropout site of a train-mode forward on
    each of ``keys`` (they depend on the key alone): one jitted program
    that returns them."""
    real = jops.hw_dropout

    def seeds_of(p, key):
        seeds = []

        def recording(x_, seed, rate, use_pallas=None):
            seeds.append(seed)
            return real(x_, seed, rate, False)

        jops.hw_dropout = recording
        try:
            jnet.apply(p, x, t, train=True, rngs={"dropout": key})
        finally:
            jops.hw_dropout = real
        return seeds

    fn = jax.jit(seeds_of)
    return [[[int(w) for w in np.asarray(s)] for s in fn(params, k)]
            for k in keys]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX step on a 2-device mesh, the port's one-process step at the
    global batch, a lockstep reference run, and the workers."""
    work = tmp_path_factory.mktemp("par")
    jcfg, cfg = tiny_cfg()
    jnet = JNCSNpp.from_config(jcfg)
    x_init = jnp.zeros((GLOBAL_B, 8, 8, 6), jnp.float32)
    params = random_flax_params(jnet, {"image_size": 8, "in_ch": 6}, seed=1,
                                scale=0.1)
    jsde = JPSLD(jcfg)
    j_step, j_opt = j_make_train_step(jnet, jsde, JLoss(jcfg, jsde), jcfg,
                                      donate=False)
    mesh = make_mesh(jax.devices()[:WORLD])
    jstate = replicate(j_init_state(params, j_opt), mesh)
    rng = jax.random.PRNGKey(7)
    data = np.random.default_rng(0).uniform(
        -1, 1, (STEPS, GLOBAL_B, 8, 8, 3)).astype(np.float32)
    arrays, keys, j_metrics = {}, [], []
    for s in range(STEPS):
        k_t, k_loss = jax.random.split(jax.random.fold_in(rng, s))
        t = j_sample_times(k_t, GLOBAL_B, 1e-5)
        m0, eps = jax_draws(k_loss, data[s].shape)
        keys.append(k_loss)
        arrays.update({f"x{s}": data[s], f"t{s}": np.array(t),
                       f"m0{s}": m0, f"eps{s}": eps})
    seeds = record_seeds(jnet, params, keys, x_init,
                         jnp.full((GLOBAL_B,), 0.5, jnp.float32))
    for s in range(STEPS):
        jstate, jm = j_step(jstate, shard_batch(jnp.asarray(data[s]), mesh),
                            rng)
        j_metrics.append([float(jm["loss"]), float(jm["grad_norm"])])
    net = NCSNpp.from_config(cfg)
    sd = flax_to_state_dict(params, net)
    arrays.update({f"p:{k}": v.numpy() for k, v in sd.items()})
    np.savez(work / "setup.npz", **arrays)

    # the port in one process at the global batch
    net.load_state_dict(sd)
    sde = PSLD(cfg)
    step, opt = make_train_step(net, sde, PSLDScoreLoss(cfg, sde), cfg)
    state = init_state(dict(net.named_parameters()), opt)
    one_metrics = []
    for s in range(STEPS):
        state, m = step(state, torch.from_numpy(data[s]), None,
                        t=torch.from_numpy(arrays[f"t{s}"]),
                        m0=torch.from_numpy(arrays[f"m0{s}"]),
                        eps=torch.from_numpy(arrays[f"eps{s}"]),
                        dropout_seeds=[tuple(w) for w in seeds[s]])
        one_metrics.append([float(m["loss"]), float(m["grad_norm"])])

    # a checkpoint to sample from, and the one-process sampling reference
    sample_cfg = bootstrap(TINY_RUN).dataset.diffusion
    ckpt_path = ckpt.save_checkpoint(str(work), "score", init_state(
        init_score_params(build_score_model(sample_cfg), 0),
        make_optimizer(sample_cfg.training.optimizer)))
    sample_args = TINY_RUN + LOCKSTEP + [
        f"dataset.diffusion.evaluation.chkpt_path={ckpt_path}"]
    from psld_tpu_torch.eval.writers import SimpleImageWriter
    real, ref_rows = SimpleImageWriter.write_batch, {}

    def recording(self, samples, rank, batch_idx):
        ref_rows[batch_idx] = np.asarray(samples)
        return real(self, samples, rank, batch_idx)

    SimpleImageWriter.write_batch = recording
    try:
        sample_cli.main(sample_args + [
            "dataset.diffusion.evaluation.batch_size=4",
            f"dataset.diffusion.evaluation.save_path={work}/one"])
    finally:
        SimpleImageWriter.write_batch = real

    outs = launch(work, "steps", {
        "cfg": CFG, "steps": STEPS, "seeds": seeds, "min_size": MIN_SIZE,
        "clf_args": ["+dataset=cifar10/cifar10_psld"] + CLF_RUN,
        "clf_steps": 512 // (128 * WORLD),
        "sample_args": sample_args + [
            "dataset.diffusion.evaluation.batch_size=2",
            f"dataset.diffusion.evaluation.save_path={work}/lock"]})
    ranks = [dict(np.load(work / f"steps_{r}.npz")) for r in range(WORLD)]
    return {"work": work, "jstate": jstate, "j_metrics": j_metrics,
            "one": state, "one_metrics": one_metrics, "ranks": ranks,
            "outs": outs, "params": params, "jnet": jnet, "mesh": mesh,
            "ref_rows": ref_rows}


def state_of(arrays, prefix, net) -> TrainState:
    """A port TrainState of a worker's trees."""
    def tree(name):
        return {k: torch.from_numpy(arrays[f"{prefix}/{name}/{k}"])
                for k in net.state_dict()}
    return TrainState(step=STEPS, params=tree("params"),
                      ema_params=tree("ema"),
                      opt_state={"mu": tree("mu"), "nu": tree("nu"),
                                 "count": STEPS})


def test_two_rank_step_matches_jax_mesh_and_one_process(run):
    """Two ranks of the port, two steps with t, eps, m0 and the dropout
    words injected, against the JAX step on a 2-device mesh and against
    the port's one-process step at the global batch; the ranks agree bit
    for bit, and report the global loss and norm."""
    net = NCSNpp.from_config(ConfigDict(CFG))
    r0, r1 = run["ranks"]
    for k in r0:
        if k.startswith("ddp/"):
            assert np.array_equal(r0[k], r1[k]), k
    state = state_of(r0, "ddp", net)
    assert_states_close(state, run["jstate"], net, "two ranks vs JAX mesh")
    for got, want in zip(r0["ddp_metrics"], run["j_metrics"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    one = run["one"]
    for name, tree in (("params", one.params), ("ema", one.ema_params),
                       ("mu", one.opt_state["mu"]),
                       ("nu", one.opt_state["nu"])):
        tree = {k: v.detach() for k, v in tree.items()}
        floor = 1e-5 * max(float(v.abs().max()) for v in tree.values())
        for k, v in tree.items():
            np.testing.assert_allclose(
                r0[f"ddp/{name}/{k}"], v.numpy(), rtol=1e-5,
                atol=floor + 1e-8, err_msg=f"{name} {k}")
    np.testing.assert_allclose(r0["ddp_metrics"], run["one_metrics"],
                               rtol=1e-5)


def test_two_rank_fsdp_step_matches_data_parallel(run):
    """The same steps under FSDP: the gathered state is the data-parallel
    one, the loss and norm agree, and the bytes a rank holds are the JAX
    package's ``per_device_bytes`` of the same trees sharded on its
    2-device mesh."""
    net = NCSNpp.from_config(ConfigDict(CFG))
    r0, r1 = run["ranks"]
    sharded = set(r0["sharded"].tolist())
    assert sharded and len(sharded) < len(net.state_dict())
    for k in r0:
        if k.startswith("fsdp/"):
            assert np.array_equal(r0[k], r1[k]), k
    for name in ("params", "ema", "mu", "nu"):
        tree = {k: r0[f"ddp/{name}/{k}"] for k in net.state_dict()}
        floor = 1e-5 * max(float(np.abs(v).max()) for v in tree.values())
        for k, v in tree.items():
            np.testing.assert_allclose(r0[f"fsdp/{name}/{k}"], v, rtol=1e-5,
                                       atol=floor + 1e-8,
                                       err_msg=f"{name} {k}")
    np.testing.assert_allclose(r0["fsdp_metrics"], r0["ddp_metrics"],
                               rtol=1e-5)
    params = run["params"]
    jtrees = [j_shard_tree(params, run["mesh"], min_size=MIN_SIZE)
              for _ in range(4)]
    want = sum(j_per_device_bytes(t) for t in jtrees)
    assert int(r0["rank_bytes"]) == int(r0["rule_bytes"]) == want
    assert int(r1["rank_bytes"]) == want


def test_lockstep_sampling_rows_match_one_process(run):
    """Two ranks of ``cli.sample`` with rank and num_processes unset:
    global batches of 2 x 2 rows with the Langevin corrector, 6 samples:
    batch 0 gives each rank 2 rows, the tail batch rank 0 alone; 6
    distinct PNGs tagged with the rank; each rank's rows are the
    one-process run's rows at batch 4."""
    from PIL import Image

    work, ref = run["work"], run["ref_rows"]
    sampled = [line(out, "SAMPLED") for out in run["outs"]]
    assert sampled == [[2, 2], [2, 0]]
    pngs = sorted(os.path.basename(p)
                  for p in glob.glob(f"{work}/lock/images/*.png"))
    assert pngs == sorted([f"output_tpu_0_0_{i}.png" for i in range(2)]
                          + [f"output_tpu_1_0_{i}.png" for i in range(2)]
                          + [f"output_tpu_0_1_{i}.png" for i in range(2)])
    imgs = [np.asarray(Image.open(f"{work}/lock/images/{p}")) for p in pngs]
    assert all(not np.array_equal(a, b) for i, a in enumerate(imgs)
               for b in imgs[i + 1:])
    for (r, k, lo) in ((0, 0, 0), (1, 0, 2), (0, 1, 0)):
        got = np.load(work / f"rows_{r}_{k}.npy")
        want = ref[k][lo: lo + 2]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"rank {r} batch {k}")


# -- (f) SIGTERM to one rank -------------------------------------------------
def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    """``cli.train_sde`` on two ranks under FSDP: rank 1 alone gets
    SIGTERM while it reads its third batch. Both ranks exit 0 after step
    3, rank 0 has written one checkpoint marked incomplete; the same
    command without FSDP resumes it, replays epoch 0 and runs to the end
    of epoch 1."""
    results = tmp_path / "results"
    args = TRAIN_RUN + [f"dataset.diffusion.training.results_dir={results}"]
    outs = launch(tmp_path, "train", {
        "min_size": MIN_SIZE, "kill_rank": 1,
        "train_args": args + ["+dataset.diffusion.training.fsdp=true"]})
    first = [line(out, "TRAINED") for out in outs]
    assert [f["step"] for f in first] == [3, 3]
    assert first[0]["rows"] == first[1]["rows"] == [[1, 0], [2, 0], [3, 0]]
    assert first[0]["loss"] == first[1]["loss"]
    files = sorted(os.listdir(results / "checkpoints"))
    assert len(files) == 2 and files[1] == files[0] + ".meta.json", files
    meta = json.load(open(results / "checkpoints" / files[1]))
    assert meta["epoch"] == 0 and meta["complete"] is False
    assert torch.load(results / "checkpoints" / files[0],
                      weights_only=True)["step"] == 3
    outs = launch(tmp_path, "train", {"min_size": MIN_SIZE, "kill_rank": -1,
                                      "train_args": args})
    second = [line(out, "TRAINED") for out in outs]
    assert [s["step"] for s in second] == [11, 11]
    assert second[0]["rows"] == [[4 + i, i // 4] for i in range(8)]
