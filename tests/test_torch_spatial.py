"""The port's spatial (height) parallelism against the JAX package and
against one process (CPU, gloo).

One spawn of four ranks runs everything that needs a group: subprocess
workers (a ``-c`` script that imports torch and ``psld_tpu_torch`` only)
join a gloo group over localhost and write ``.npz`` and ``.json`` files
the tests read. The JAX side and the one-process references run here
while the workers run. The network is the tiny CIFAR PSLD net at 8x8
(nf 8, ch_mult [1, 2], attention at 8, hash dropout 0.15); the one-image
case takes CelebA-HQ 256's resampling (FIR, ``output_skip`` and
``input_skip`` pyramids) on it, so the FIR halos run, at 4 ranks thin
enough (one row a rank at 4x4) that a level is gathered.

Tolerances: the training states as ``tests/test_spatial.py`` holds the
JAX spatial step to plain data parallelism (losses rtol 1e-4, trees rtol
1e-3 and atol 1e-6); against the port's one process, which differs only
in the order of float sums, ``test_torch_train.py``'s (rtol 1e-5, floored
at 1e-5 of the tree's largest magnitude plus 1e-8); sampled f32 rows
within 1e-5 of their scale of one process's.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
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

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.losses.score import PSLDScoreLoss as JLoss
from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu.parallel.mesh import replicate, shard_batch
from psld_tpu.parallel.spatial import check_divisible as j_check_divisible
from psld_tpu.parallel.spatial import make_spatial_mesh as j_mesh
from psld_tpu.parallel.spatial import spatial_batch_sharding
from psld_tpu.sde.psld import PSLD as JPSLD
from psld_tpu.train.state import init_state as j_init_state
from psld_tpu.train.steps import make_train_step as j_make_train_step
from psld_tpu.train.steps import sample_times as j_sample_times
from psld_tpu_torch.cli import class_cond_sample as cc_cli
from psld_tpu_torch.cli import inpaint as inpaint_cli
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.cli._common import bootstrap
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.interop.from_flax import flax_to_state_dict
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.layers import init_parameters
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.parallel import spatial
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.loop import (build_clf_model, build_score_model,
                                       init_score_params, train_sde)
from psld_tpu_torch.train.state import TrainState, init_state, make_optimizer
from psld_tpu_torch.train.steps import make_train_step
from test_torch_loss import jax_draws
from test_torch_ncsnpp import random_flax_params
from test_torch_parallel import CFG, record_seeds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GLOBAL_B = 4
STEPS = 3
# the tiny CIFAR net with attention at 8 and hash dropout
SP_CFG = json.loads(json.dumps(CFG))
SP_CFG["model"]["score_fn"]["attn_resolutions"] = [8]
# the same with CelebA-HQ 256's resampling
FIR_CFG = json.loads(json.dumps(SP_CFG))
FIR_CFG["model"]["score_fn"].update(fir=True, progressive="output_skip",
                                    progressive_input="input_skip")

TINY = [
    "+dataset=cifar10/cifar10_psld",
    "dataset.diffusion.data.root=/unused",
    "dataset.diffusion.data.name=synthetic",
    "dataset.diffusion.data.image_size=8",
    "dataset.diffusion.data.hflip=false",
    "dataset.diffusion.model.score_fn.nf=8",
    "dataset.diffusion.model.score_fn.ch_mult=[1,2]",
    "dataset.diffusion.model.score_fn.num_res_blocks=1",
    "dataset.diffusion.model.score_fn.attn_resolutions=[8]",
    "dataset.diffusion.model.score_fn.dropout=0.15",
    "+dataset.diffusion.model.score_fn.dropout_impl=hw",
    "+dataset.diffusion.training.device=cpu",
    "+dataset.diffusion.evaluation.device=cpu",
    "dataset.diffusion.evaluation.n_discrete_steps=3",
    "dataset.diffusion.evaluation.sample_from=source",
    "dataset.diffusion.training.log_step=1",
    "+dataset.diffusion.training.prefetch=0",
]
CLF = [
    "dataset.clf.data.root=/unused", "dataset.clf.data.name=synthetic",
    "dataset.clf.data.image_size=8", "dataset.clf.model.clf_fn.n_cls=10",
    "dataset.clf.model.clf_fn.nf=8", "dataset.clf.model.clf_fn.ch_mult=[1,2]",
    "dataset.clf.model.clf_fn.num_res_blocks=1",
    "dataset.clf.model.clf_fn.attn_resolutions=[8]",
]
# the sampling runs: (tag, cli, extra overrides, spatial factor, rows a
# data group); spatial 2 on 4 ranks samples lockstep over 2 data groups
SAMPLES = [
    ("em_pc", "sample", [
        "+dataset.diffusion.evaluation.sampler.corrector=langevin"], 2),
    ("adaptive", "sample", [
        "dataset.diffusion.evaluation.sampler.name=adaptive_ode",
        "+dataset.diffusion.evaluation.sampler.rtol=1e-2",
        "+dataset.diffusion.evaluation.sampler.atol=1e-2"], 2),
    ("guided", "class_cond_sample", [
        "dataset.diffusion.evaluation.sampler.name=cc_em_sde",
        "dataset.clf.evaluation.label_to_sample=3"], 2),
    ("inpaint", "inpaint", [
        "dataset.diffusion.evaluation.sampler.name=ip_em_sde"], 4),
]
ROWS = 2

WORKER = r"""
import json, os, sys
rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                  WORLD_SIZE=str(world), LOCAL_RANK="0", PSLD_MULTIHOST="1")
import numpy as np
import torch
torch.set_num_threads(1)
import psld_tpu_torch
psld_tpu_torch.import_modules_into_registry()
from psld_tpu_torch.cli._common import bootstrap
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.losses.score import PSLDScoreLoss
from psld_tpu_torch.models.ncsnpp import NCSNpp
from psld_tpu_torch.parallel import distributed, spatial
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.train.state import init_state
from psld_tpu_torch.train.steps import make_train_step

setup = json.load(open(os.path.join(work, "setup.json")))
arrays = np.load(os.path.join(work, "setup.npz"))
distributed.maybe_initialize("cpu")
assert distributed.process_info() == (rank, world)
out = {}


def trees(prefix, state):
    t = {"params": state.params, "ema": state.ema_params,
         "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    return {f"{prefix}/{n}/{k}": v.detach().numpy()
            for n, tree in t.items() for k, v in tree.items()}


def steps(tag, cfg, sp, n_steps):
    # injected global draws: this data group's rows, this rank's height
    distributed.configure_spatial(sp)
    s, _, d, n_data = distributed.spatial_info()
    cfg = ConfigDict(cfg)
    sde = PSLD(cfg)
    net = NCSNpp.from_config(cfg)
    net.load_state_dict({k[len(tag) + 3:]: torch.from_numpy(arrays[k])
                         for k in arrays.files
                         if k.startswith(tag + ":p:")})
    step, opt = make_train_step(net, sde, PSLDScoreLoss(cfg, sde), cfg)
    state = init_state(dict(net.named_parameters()), opt)
    metrics = []
    for i in range(n_steps):
        def part(name, image=True):
            v = torch.from_numpy(arrays[f"{tag}:{name}{i}"])
            b = v.shape[0] // n_data
            v = v[d * b:(d + 1) * b]
            return spatial.height_slice(v, 1) if image else v
        state, m = step(state, part("x"), None, t=part("t", False),
                        m0=part("m0"), eps=part("eps"),
                        dropout_seeds=[tuple(w) for w in
                                       setup[tag + "_seeds"][i]])
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out.update(trees(tag, state))
    out[tag + "_metrics"] = np.array(metrics)


# (a) (data 2, spatial 2), 3 steps; (b) one image over 4 ranks
steps("a", setup["sp_cfg"], 2, setup["steps"])
steps("b", setup["fir_cfg"], 4, 1)

# the halo exchange at 4 ranks on 2-row shards of an 8-row map: from the
# neighbours (1 row) and from the whole level (3 rows), against slices of
# the zero-padded map; the gradients against autograd on the whole map
s = distributed.spatial_info()[0]
whole = torch.arange(2 * 3 * 8 * 5, dtype=torch.float64).reshape(2, 3, 8, 5)
halo_ok = []
for k in (1, 3):
    weights = [torch.cos(torch.arange(2 * 3 * (2 + 2 * k) * 5,
                                      dtype=torch.float64) * (r + 1)
                         ).reshape(2, 3, 2 + 2 * k, 5) for r in range(4)]
    x = spatial.height_slice(whole, 2).clone().requires_grad_()
    y = spatial.halo(x, k, k)
    (y * weights[s]).sum().backward()
    ref = whole.clone().requires_grad_()
    padded = torch.nn.functional.pad(ref, (0, 0, k, k))
    sum(((padded[:, :, 2 * r:2 * r + 2 + 2 * k] * weights[r]).sum()
         for r in range(4))).backward()
    halo_ok.append(bool(torch.equal(y.detach(), padded.detach()[
        :, :, 2 * s:2 * s + 2 + 2 * k])))
    halo_ok.append(bool(torch.allclose(x.grad, spatial.height_slice(
        ref.grad, 2))))
out["halo_ok"] = np.array(halo_ok)

# the training loop with training.spatial=2, two steps
from psld_tpu_torch.train.loop import train_sde
cfg = bootstrap(setup["loop_args"] + [
    "+dataset.diffusion.training.spatial=2",
    f"dataset.diffusion.training.results_dir={work}/loop"]).dataset.diffusion
state, stats = train_sde(cfg, max_steps=2)
out.update(trees("loop", state))
out["loop_loss"] = np.array([r["loss"] for r in stats])

# CelebA-HQ 256's scaling stack at 8x8: remat, FSDP, spatial and
# grad_accum together (tests/test_spatial.py's extension-config case)
from psld_tpu_torch.parallel import fsdp
fsdp.DEFAULT_MIN_SIZE = 256
cfg = bootstrap(setup["stack_args"] + [
    f"dataset.diffusion.training.results_dir={work}/stack"]
    ).dataset.diffusion
state, stats = train_sde(cfg, max_steps=2)
out["stack_loss"] = np.array([r["loss"] for r in stats])
out["stack_step"] = np.array(state.step)

# sampling: every row this rank writes
from psld_tpu_torch.cli import class_cond_sample, inpaint, sample
from psld_tpu_torch.eval import writers
written = {}
for cls in (writers.SimpleImageWriter, writers.InpaintingImageWriter):
    def recording(self, samples, rank, batch_idx, real=cls.write_batch,
                  **kw):
        written[f"{tag}/{rank}/{batch_idx}"] = np.asarray(samples)
        return real(self, samples, rank, batch_idx, **kw)
    cls.write_batch = recording
mains = {"sample": sample.main, "class_cond_sample": class_cond_sample.main,
         "inpaint": inpaint.main}
for tag, cli, extra, sp in setup["samples"]:
    batches = mains[cli](setup["sample_args"][tag] + extra + [
        f"+dataset.diffusion.evaluation.spatial={sp}",
        f"dataset.diffusion.evaluation.save_path={work}/{tag}"])
    out[f"{tag}_count"] = np.array([b["samples"] for b in batches])
for k, v in written.items():
    out["rows/" + k] = v

# refusals, with the JAX package's messages
def refused(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("not refused")

out["msg_world"] = refused(lambda: distributed.configure_spatial(3))
out["msg_height"] = refused(lambda: train_sde(bootstrap(
    setup["loop_args"] + ["dataset.diffusion.data.image_size=6",
                          "+dataset.diffusion.training.spatial=4",
                          f"dataset.diffusion.training.results_dir={work}/x"]
    ).dataset.diffusion, max_steps=1))
np.savez(os.path.join(work, f"rank_{rank}.npz"), **out)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "psld_tpu"))
print("IMPORTED", bad, flush=True)
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _start(work):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), port, str(work)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


def _finish(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _draws(tag, cfg_dict, jnet, params, batch, n_steps, rng, arrays):
    """Global t, m0, eps and x of ``n_steps`` steps (the JAX step's own
    draws from ``rng``), the dropout words of each, and the weights,
    into ``arrays``; returns (data, seed words)."""
    data = np.random.default_rng(0).uniform(
        -1, 1, (n_steps, batch, 8, 8, 3)).astype(np.float32)
    keys = []
    for s in range(n_steps):
        k_t, k_loss = jax.random.split(jax.random.fold_in(rng, s))
        m0, eps = jax_draws(k_loss, data[s].shape)
        keys.append(k_loss)
        arrays.update({f"{tag}:x{s}": data[s],
                       f"{tag}:t{s}": np.array(j_sample_times(k_t, batch,
                                                              1e-5)),
                       f"{tag}:m0{s}": m0, f"{tag}:eps{s}": eps})
    seeds = record_seeds(jnet, params, keys,
                         jnp.zeros((batch, 8, 8, 6), jnp.float32),
                         jnp.full((batch,), 0.5, jnp.float32))
    sd = flax_to_state_dict(params, NCSNpp.from_config(ConfigDict(cfg_dict)))
    arrays.update({f"{tag}:p:{k}": v.numpy() for k, v in sd.items()})
    return data, seeds, sd


def _one_process(tag, cfg_dict, sd, arrays, seeds, n_steps):
    """The port's step in one process at the global batch."""
    cfg = ConfigDict(cfg_dict)
    net = NCSNpp.from_config(cfg)
    net.load_state_dict(sd)
    sde = PSLD(cfg)
    step, opt = make_train_step(net, sde, PSLDScoreLoss(cfg, sde), cfg)
    state = init_state(dict(net.named_parameters()), opt)
    metrics = []
    for s in range(n_steps):
        state, m = step(state, torch.from_numpy(arrays[f"{tag}:x{s}"]), None,
                        **{k: torch.from_numpy(arrays[f"{tag}:{k}{s}"])
                           for k in ("t", "m0", "eps")},
                        dropout_seeds=[tuple(w) for w in seeds[s]])
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return state, np.array(metrics)


def _recorded(fn, args):
    """``fn(args)``, with every row the writers write: {batch: rows}."""
    from psld_tpu_torch.eval import writers

    rows, reals = {}, {}
    for cls in (writers.SimpleImageWriter, writers.InpaintingImageWriter):
        reals[cls] = cls.write_batch

        def recording(self, samples, rank, batch_idx, real=reals[cls], **kw):
            rows[batch_idx] = np.asarray(samples)
            return real(self, samples, rank, batch_idx, **kw)

        cls.write_batch = recording
    try:
        fn(args)
    finally:
        for cls, real in reals.items():
            cls.write_batch = real
    return rows


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers, and meanwhile the JAX spatial step and the port's
    one-process references."""
    work = tmp_path_factory.mktemp("spatial")
    arrays = {}
    jcfg = JConfigDict(SP_CFG)
    jnet = JNCSNpp.from_config(jcfg)
    params = random_flax_params(jnet, {"image_size": 8, "in_ch": 6}, seed=1,
                                scale=0.1)
    rng = jax.random.PRNGKey(7)
    data, seeds_a, sd_a = _draws("a", SP_CFG, jnet, params, GLOBAL_B, STEPS,
                                 rng, arrays)
    # (b) is the port against itself: its own weights, numpy draws
    fnet = NCSNpp.from_config(ConfigDict(FIR_CFG))
    init_parameters(fnet, torch.Generator().manual_seed(2))
    sd_b = {k: v.detach().clone() for k, v in fnet.state_dict().items()}
    draw = np.random.default_rng(3)
    arrays.update({"b:x0": draw.uniform(-1, 1, (1, 8, 8, 3)),
                   "b:t0": draw.uniform(0.1, 1.0, (1,)),
                   "b:m00": draw.standard_normal((1, 8, 8, 3)),
                   "b:eps0": draw.standard_normal((1, 8, 8, 6))})
    arrays.update({f"b:p:{k}": v.numpy() for k, v in sd_b.items()})
    arrays = {k: v.astype(np.float32) if v.dtype == np.float64
              and not k.startswith(("a:t", "b:t")) else v
              for k, v in arrays.items()}
    seeds_b = [[[int(w) for w in row] for row in draw.integers(
        0, 2 ** 32, (fnet.dropout_sites, 2))]]
    np.savez(work / "setup.npz", **arrays)

    # a score and a classifier checkpoint to sample from
    base = bootstrap(TINY + CLF)
    ckpt_path = ckpt.save_checkpoint(str(work), "score", init_state(
        init_score_params(build_score_model(base.dataset.diffusion), 0),
        make_optimizer(base.dataset.diffusion.training.optimizer)))
    clf = build_clf_model(base.dataset.clf, 1)
    clf_path = ckpt.save_checkpoint(str(work), "clf", init_state(
        dict(clf.named_parameters()),
        make_optimizer(base.dataset.clf.training.optimizer)))
    sample_args = {}
    for tag, cli, extra, sp in SAMPLES:
        args = TINY + [f"dataset.diffusion.evaluation.chkpt_path={ckpt_path}",
                       f"dataset.diffusion.evaluation.n_samples="
                       f"{ROWS * WORLD // sp}",
                       f"dataset.diffusion.evaluation.batch_size={ROWS}"]
        if cli == "class_cond_sample":
            args = args + CLF + [
                f"dataset.clf.evaluation.chkpt_path={clf_path}"]
        sample_args[tag] = args
    loop_args = TINY + ["dataset.diffusion.training.batch_size=2",
                        "dataset.diffusion.training.epochs=1"]
    stack_args = [a.replace("cifar10/cifar10_psld", "celebahq/celebahq256_psld")
                  for a in TINY if "attn_resolutions" not in a] + [
        "dataset.diffusion.model.score_fn.attn_resolutions=[4]",
        "dataset.diffusion.training.batch_size=2",
        "dataset.diffusion.training.epochs=1",
        "+dataset.diffusion.training.remat=true",
        "+dataset.diffusion.training.fsdp=true",
        "+dataset.diffusion.training.spatial=2",
        "+dataset.diffusion.training.grad_accum=2"]
    with open(work / "setup.json", "w") as f:
        json.dump({"sp_cfg": SP_CFG, "fir_cfg": FIR_CFG, "steps": STEPS,
                   "a_seeds": seeds_a, "b_seeds": seeds_b,
                   "samples": SAMPLES, "sample_args": sample_args,
                   "loop_args": loop_args, "stack_args": stack_args}, f)
    procs = _start(work)
    try:
        # the JAX spatial step (spatial 2 on the 8-device CPU mesh)
        jsde = JPSLD(jcfg)
        j_step, j_opt = j_make_train_step(jnet, jsde, JLoss(jcfg, jsde), jcfg,
                                          donate=False)
        mesh = j_mesh(2)
        jstate = replicate(j_init_state(params, j_opt), mesh)
        j_metrics, compiled = [], None
        for s in range(STEPS):
            b = shard_batch(jnp.asarray(data[s]), mesh,
                            sharding=spatial_batch_sharding(mesh))
            if compiled is None:  # three steps: XLA's lowest level pays
                compiled = j_step.lower(jstate, b, rng).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            jstate, jm = compiled(jstate, b, rng)
            j_metrics.append([float(jm["loss"]), float(jm["grad_norm"])])
        one_a = _one_process("a", SP_CFG, sd_a, arrays, seeds_a, STEPS)
        one_b = _one_process("b", FIR_CFG, sd_b, arrays, seeds_b, 1)
        # the loop in one process at the global batch (2 data groups)
        loop_cfg = bootstrap(loop_args[:-2] + [
            "dataset.diffusion.training.batch_size=4",
            "dataset.diffusion.training.epochs=1",
            f"dataset.diffusion.training.results_dir={work}/one_loop"]
        ).dataset.diffusion
        one_loop = train_sde(loop_cfg, max_steps=2)
        mains = {"sample": sample_cli.main,
                 "class_cond_sample": cc_cli.main,
                 "inpaint": inpaint_cli.main}
        ref_rows = {}
        for tag, cli, extra, sp in SAMPLES:
            ref_rows[tag] = _recorded(mains[cli], sample_args[tag] + extra + [
                "dataset.diffusion.evaluation.batch_size="
                f"{ROWS * WORLD // sp}",
                f"dataset.diffusion.evaluation.save_path={work}/one_{tag}"])
    finally:
        outs = _finish(procs)
    ranks = [dict(np.load(work / f"rank_{r}.npz")) for r in range(WORLD)]
    return {"jstate": jstate, "j_metrics": np.array(j_metrics),
            "one_a": one_a, "one_b": one_b, "one_loop": one_loop,
            "ref_rows": ref_rows, "ranks": ranks, "outs": outs}


def _state(arrays, prefix, cfg_dict, steps) -> TrainState:
    net = NCSNpp.from_config(ConfigDict(cfg_dict))

    def tree(name):
        return {k: torch.from_numpy(arrays[f"{prefix}/{name}/{k}"])
                for k in net.state_dict()}
    return TrainState(step=steps, params=tree("params"),
                      ema_params=tree("ema"),
                      opt_state={"mu": tree("mu"), "nu": tree("nu"),
                                 "count": steps})


def _close_to_one(got: TrainState, want: TrainState, what: str):
    """``test_torch_train.py``'s tolerance: rtol 1e-5, floored at 1e-5 of
    the tree's largest magnitude plus 1e-8."""
    for name in ("params", "ema_params"):
        a, b = getattr(got, name), getattr(want, name)
        floor = 1e-5 * max(float(v.detach().abs().max()) for v in b.values())
        for k, v in b.items():
            np.testing.assert_allclose(a[k].detach().numpy(),
                                       v.detach().numpy(), rtol=1e-5,
                                       atol=floor + 1e-8,
                                       err_msg=f"{what}: {name} {k}")


def test_data2_spatial2_steps_match_jax_spatial_mesh_and_one_process(run):
    """(a) Three steps at (data 2, spatial 2) with t, eps, m0 and the
    dropout words injected: every rank holds the same state, which is
    the JAX step's on ``make_spatial_mesh(2)`` at ``tests/test_spatial.
    py``'s tolerances and the port's one-process step's."""
    ranks = run["ranks"]
    for r in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("a/"):
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = _state(ranks[0], "a", SP_CFG, STEPS)
    np.testing.assert_allclose(ranks[0]["a_metrics"][:, 0],
                               run["j_metrics"][:, 0], rtol=1e-4)
    s = jax.device_get(run["jstate"])
    net = NCSNpp.from_config(ConfigDict(SP_CFG))
    for name, tree in (("params", s.params), ("ema_params", s.ema_params)):
        want = flax_to_state_dict(tree, net)
        for k, w in want.items():
            np.testing.assert_allclose(getattr(got, name)[k].numpy(),
                                       w.numpy(), rtol=1e-3, atol=1e-6,
                                       err_msg=f"{name} {k}")
    one, one_metrics = run["one_a"]
    _close_to_one(got, one, "spatial vs one process")
    np.testing.assert_allclose(ranks[0]["a_metrics"], one_metrics,
                               rtol=1e-5)


def test_one_image_over_four_ranks_matches_one_process(run):
    """(b) Batch 1 at (data 1, spatial 4), CelebA-HQ's FIR pyramids: one
    row a rank at 4x4, where the FIR halos gather the level; the step
    equals one process's."""
    ranks = run["ranks"]
    got = _state(ranks[0], "b", FIR_CFG, 1)
    one, one_metrics = run["one_b"]
    _close_to_one(got, one, "one image over 4 ranks")
    np.testing.assert_allclose(ranks[0]["b_metrics"], one_metrics,
                               rtol=1e-5)
    assert np.all(np.isfinite(ranks[0]["b_metrics"]))


def test_halo_exchange_from_neighbours_and_from_the_level(run):
    """The halo exchange at 4 ranks on 2-row shards: 1 row (the
    neighbours' edge rows) and 3 rows (wider than a shard: the level
    gathered) equal slices of the zero-padded map, and their gradients
    reach the rows' owners as autograd on the whole map sends them."""
    for r in run["ranks"]:
        assert r["halo_ok"].tolist() == [True] * 4


def test_train_loop_spatial_matches_one_process(run):
    """``train_sde`` with ``training.spatial=2`` on 4 ranks (global batch
    2 x 2, hflip off) follows one process at batch 4: the loader's rows
    by data group, each rank's slice of their height, the draws of the
    global batch."""
    ranks = run["ranks"]
    state, stats = run["one_loop"]
    got = _state(ranks[0], "loop", SP_CFG, 2)
    _close_to_one(got, state, "the loop")
    np.testing.assert_allclose(ranks[0]["loop_loss"],
                               [r["loss"] for r in stats], rtol=1e-5)


def test_scaling_stack_trains_under_spatial(run):
    """CelebA-HQ 256's config at 8x8 with remat, FSDP (leaves of 256
    elements and up), ``training.spatial=2`` and ``grad_accum=2``
    together, as ``tests/test_spatial.py`` trains the JAX package's: two
    steps, finite losses, the same on every rank."""
    ranks = run["ranks"]
    for r in ranks:
        assert int(r["stack_step"]) == 2
        assert np.all(np.isfinite(r["stack_loss"]))
        np.testing.assert_array_equal(r["stack_loss"],
                                      ranks[0]["stack_loss"])


@pytest.mark.parametrize("tag", [t for t, *_ in SAMPLES])
def test_spatial_sampling_rows_match_one_process(run, tag):
    """(c) ``evaluation.spatial``: EM with the Langevin corrector,
    ``adaptive_ode`` and a guided EM step at spatial 2 lockstep over two
    data groups, and inpainting over one group of 4: each image is
    written once, by the first rank of its group, and its f32 rows are
    within 1e-5 of their scale of one process's."""
    sp = next(s for t, _, _, s in SAMPLES if t == tag)
    want = run["ref_rows"][tag][0]
    got = {}
    for r, arrays in enumerate(run["ranks"]):
        keys = [k for k in arrays if k.startswith(f"rows/{tag}/")]
        if r % sp:
            assert not keys, (r, keys)
            continue
        assert len(keys) == 1, keys
        got[r // sp] = arrays[keys[0]]
    rows = np.concatenate([got[d] for d in sorted(got)])
    assert rows.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(rows - want).max() <= 1e-5 * scale


def test_refusals_and_imports(run):
    """(d) The JAX package's messages for a spatial factor that does not
    divide the world and an indivisible height; serving refuses spatial;
    the workers imported nothing of JAX."""
    r0 = run["ranks"][0]
    assert str(r0["msg_world"]) == (
        "spatial=3 must divide the device count 4 (training.spatial / "
        "evaluation.spatial)")
    with pytest.raises(ValueError) as e:
        j_check_divisible(6, j_mesh(4))
    assert str(r0["msg_height"]) == str(e.value)
    with pytest.raises(ValueError) as mine:
        spatial.check_divisible(6, 4)
    assert str(mine.value) == str(e.value)
    with pytest.raises(ValueError) as e:
        j_mesh(3)
    assert str(e.value).replace("device count 8", "device count 4") == \
        str(r0["msg_world"])
    for out in run["outs"]:
        assert "IMPORTED []" in out, out[-2000:]

    from psld_tpu_torch.serve.server import SamplerService

    cfg = bootstrap(TINY + [
        "dataset.diffusion.evaluation.chkpt_path=/does/not/exist",
        "+dataset.diffusion.evaluation.spatial=2"]).dataset.diffusion
    with pytest.raises(NotImplementedError, match="spatial"):
        SamplerService(cfg)


# -- in-process: the split GroupNorm and the strided dropout, no ranks ------
@pytest.mark.parametrize("dtype,gn16", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)],
                         ids=["f32", "bf16", "gn_bf16"])
@pytest.mark.parametrize("act", ["swish", "none"])
def test_split_group_norm_of_two_shards_is_the_whole_maps(monkeypatch, dtype,
                                                          gn16, act):
    """Stats and apply of two half-height shards, their sums added, equal
    ``group_norm_act_plain`` on the whole map; partials and dx, their
    (P1, P2) added, equal autograd through it, and dscale and dbias are
    the shards' sums. Tolerance: f32 1e-5 of each output's scale (sums in
    another order); bf16 2**-7 of the scale, two bf16 steps: the whole
    map's autograd rounds the moments' gradient and the direct term to
    bf16 separately before adding them, the split dx rounds once (and,
    under gn_bf16, keeps the group sums P1, P2 in f32 where autograd
    rounds them to bf16)."""
    from psld_tpu_torch import ops
    from psld_tpu_torch.ops import group_norm as gn

    monkeypatch.setenv("PSLD_GN_BF16", "1" if gn16 else "0")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 4, 16)) * 2 + 0.5).to(
        dtype)
    g = torch.from_numpy(rng.standard_normal((2, 8, 4, 16))).to(dtype)
    scale = torch.from_numpy(rng.standard_normal(16) * 0.1 + 1).float()
    bias = torch.from_numpy(rng.standard_normal(16) * 0.1).float()
    groups, n = 4, 8 * 4 * 4
    want = ops.group_norm_act_plain(x, scale, bias, groups, 1e-6, act)
    dx_w, ds_w, db_w = ops.group_norm_act_backward_plain(
        x, scale, bias, g, groups, 1e-6, act)
    halves = [(x[:, :4], g[:, :4]), (x[:, 4:], g[:, 4:])]
    sums = sum(gn.group_norm_split_stats(h, groups) for h, _ in halves)
    y = torch.cat([gn.group_norm_split_apply(h, scale, bias, sums, n, groups,
                                             1e-6, act) for h, _ in halves],
                  1)
    parts = [gn.group_norm_split_partials(h, gh, scale, bias, sums, n,
                                          groups, 1e-6, act)
             for h, gh in halves]
    p = parts[0][0] + parts[1][0]
    dx = torch.cat([gn.group_norm_split_dx(h, gh, scale, bias, sums, p, n,
                                           groups, 1e-6, act)
                    for h, gh in halves], 1)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for got, ref in ((y, want), (dx, dx_w),
                     (parts[0][1] + parts[1][1], ds_w),
                     (parts[0][2] + parts[1][2], db_w)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max())
        assert err <= tol * float(ref.float().abs().max()), err


@pytest.mark.parametrize("shape,spatial_n", [((3, 8, 4, 5), 2),
                                             ((2, 8, 3, 7), 4),
                                             ((4, 6, 6, 128), 3)])
def test_strided_dropout_is_the_whole_images_mask_sliced(shape, spatial_n):
    """The plain dropout of a rank's slice of every image's height, at
    its offset with ``image = (L, Gi)``, is the whole tensor's dropout
    sliced, bit for bit, for each data row and height slice."""
    from psld_tpu_torch import ops

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)
                         .astype(np.float32))
    seed, rate = (123456789, 42), 0.3
    whole = ops.hash_dropout_plain(x, seed, rate)
    b, h = shape[0], shape[1] // spatial_n
    for d in range(2):
        rows = slice(d * b // 2, (d + 1) * b // 2)
        for s in range(spatial_n):
            part = x[rows, s * h:(s + 1) * h].contiguous()
            local = part[0].numel()
            off = rows.start * x[0].numel() + s * local
            got = ops.hash_dropout(part, seed, rate, elem_off=off,
                                   image=(local, x[0].numel()))
            assert torch.equal(got, whole[rows, s * h:(s + 1) * h])
