"""Per-rank sampling fan-out of the port against the JAX package (CPU):
``evaluation.rank`` / ``evaluation.num_processes`` for 1, 2 and 3 ranks.

The JAX package's rank arithmetic is run where it lives: its
``_rank_info``, the label of each batch its ``class_cond_sample`` hands
its writer, and the dataset indices its ``edit`` and ``inpaint`` read
(their set-up around the rank arithmetic is stubbed: no checkpoint is
read and no sampler compiled). The port runs its entry points for real,
at 8 x 8 on the CPU.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import os
import types

import numpy as np
import pytest
import torch

import psld_tpu
from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.config import compose as j_compose
from psld_tpu.data import datasets as jdatasets
from psld_tpu.eval import generate as jgen
from psld_tpu.eval.writers import SimpleImageWriter as JWriter
from psld_tpu_torch.cli import class_cond_sample as guided_cli
from psld_tpu_torch.cli import edit as edit_cli
from psld_tpu_torch.cli import inpaint as inpaint_cli
from psld_tpu_torch.cli import sample as sample_cli
from psld_tpu_torch.cli._common import bootstrap
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.data import datasets
from psld_tpu_torch.eval import generate
from psld_tpu_torch.train import checkpoint as ckpt
from psld_tpu_torch.train.loop import (build_clf_model, build_score_model,
                                       init_score_params)
from psld_tpu_torch.train.state import init_state, make_optimizer

N_SAMPLES, BATCH = 5, 2
RUN = ["+dataset=cifar10/cifar10_psld",
       "dataset.diffusion.data.root=/unused",
       "dataset.diffusion.data.name=synthetic",
       "dataset.diffusion.data.image_size=8",
       "dataset.diffusion.model.score_fn.nf=8",
       "dataset.diffusion.model.score_fn.ch_mult=[1]",
       "dataset.diffusion.model.score_fn.num_res_blocks=1",
       "dataset.diffusion.model.score_fn.attn_resolutions=[]",
       f"dataset.diffusion.evaluation.n_samples={N_SAMPLES}",
       f"dataset.diffusion.evaluation.batch_size={BATCH}",
       "dataset.diffusion.evaluation.n_discrete_steps=2",
       "dataset.diffusion.evaluation.sample_from=source",
       "+dataset.diffusion.evaluation.sampler.edit_t0=0.5",
       "+dataset.diffusion.evaluation.device=cpu"]
CLF = ["dataset.clf.data.root=/unused",
       "dataset.clf.data.image_size=8",
       "dataset.clf.model.clf_fn.n_cls=10",
       "dataset.clf.model.clf_fn.nf=8",
       "dataset.clf.model.clf_fn.ch_mult=[1]",
       "dataset.clf.model.clf_fn.num_res_blocks=1",
       "dataset.clf.model.clf_fn.attn_resolutions=[]",
       "dataset.diffusion.evaluation.sampler.name=cc_em_sde",
       "dataset.clf.evaluation.label_to_sample=1,4,7"]
FANOUTS = [(r, n) for n in (1, 2, 3) for r in range(n)]


@pytest.fixture(autouse=True)
def one_thread():
    """The entry points run at tiny shapes here, where PyTorch's
    intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(rank, nproc):
    return [f"+dataset.diffusion.evaluation.rank={rank}",
            f"+dataset.diffusion.evaluation.num_processes={nproc}"]


def share(nproc):
    """Each rank's samples and batches: the JAX package's
    ``-(-n_samples // num_processes)`` (psld_tpu/eval/generate.py)."""
    per = -(-N_SAMPLES // nproc)
    return per, -(-per // BATCH)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A score and a classifier checkpoint of the tiny networks."""
    d = tmp_path_factory.mktemp("ckpts")
    cfg = bootstrap(RUN + CLF).dataset
    net = build_score_model(cfg.diffusion)
    opt = make_optimizer(cfg.diffusion.training.optimizer)
    score = ckpt.save_checkpoint(str(d), "score", init_state(
        init_score_params(net, 0), opt))
    clf = build_clf_model(cfg.clf, 0)
    clf_path = ckpt.save_checkpoint(str(d), "clf", init_state(
        dict(clf.named_parameters()), opt))
    return score, clf_path


@pytest.mark.parametrize("rank,nproc", [(None, None), (0, None), (0, 1),
                                        (1, 2), (0, 3), (2, 3), (3, 3),
                                        (1, 1)])
def test_rank_info_matches_jax(rank, nproc):
    ecfg = {}
    if rank is not None:
        ecfg["rank"] = rank
    if nproc is not None:
        ecfg["num_processes"] = nproc
    port = ConfigDict({"evaluation": ecfg})
    jax_cfg = JConfigDict({"evaluation": ecfg})
    if rank is not None and rank >= (nproc or 1):
        for fn, cfg in ((generate._rank_info, port),
                        (jgen._rank_info, jax_cfg)):
            with pytest.raises(ValueError):
                fn(cfg)
        return
    rank_, nproc_, lockstep = jgen._rank_info(jax_cfg)
    assert not lockstep
    assert generate._rank_info(port) == (rank_, nproc_)


def test_sample_shares_names_and_streams(tmp_path, ckpts):
    """Rank r of N writes its ceil(n / N) samples under the JAX writer's
    names for rank r; one rank of one equals the run without the keys,
    bit for bit; the ranks of a fan-out draw other images."""
    score, _ = ckpts
    base = RUN + [f"dataset.diffusion.evaluation.chkpt_path={score}",
                  "dataset.diffusion.evaluation.save_mode=np"]
    out = {}
    for rank, nproc in FANOUTS:
        d = tmp_path / f"{rank}of{nproc}"
        rows = sample_cli.main(base + ranks(rank, nproc) + [
            f"dataset.diffusion.evaluation.save_path={d}"])
        per, n_batches = share(nproc)
        takes = [min(BATCH, per - BATCH * k) for k in range(n_batches)]
        assert [r["samples"] for r in rows] == takes
        ref = tmp_path / f"ref{rank}of{nproc}"
        jw = JWriter(str(ref), sample_prefix="tpu", save_mode="np")
        for k, take in enumerate(takes):
            jw.write_batch(np.zeros((take, 8, 8, 6), np.float32), rank, k)
        assert sorted(os.listdir(d / "images")) == sorted(
            os.listdir(ref / "images"))
        out[rank, nproc] = np.load(d / "images" / f"output_tpu_{rank}_0_0.npy")
    plain = tmp_path / "plain"
    sample_cli.main(base + [f"dataset.diffusion.evaluation.save_path={plain}"])
    assert np.array_equal(out[0, 1], np.load(
        plain / "images" / "output_tpu_0_0_0.npy"))
    firsts = [out[r, 3] for r in range(3)] + [out[0, 1]]
    for i in range(len(firsts)):
        for j in range(i):
            assert not np.array_equal(firsts[i], firsts[j])


def _stub(monkeypatch, recorded):
    """The JAX package's set-up around its rank arithmetic, stubbed: no
    checkpoint, no network, no compiled sampler; ``_run_sampler`` records
    its arguments."""
    psld_tpu.import_modules_into_registry()
    monkeypatch.setattr(jgen, "load_eval_state", lambda *a, **k: (None, None))
    monkeypatch.setattr(jgen, "build_clf_model",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(jgen, "init_state", lambda *a, **k: None)
    monkeypatch.setattr(jgen.ckpt, "restore_checkpoint",
                        lambda *a, **k: types.SimpleNamespace(params=None))
    monkeypatch.setattr(jgen, "_run_sampler",
                        lambda *a, **k: recorded.update(args=a, kw=k))


@pytest.mark.parametrize("rank,nproc", FANOUTS)
def test_guided_labels_cycle_as_jax(tmp_path, monkeypatch, ckpts, rank,
                                    nproc):
    """Batch k of rank r samples label ``labels[(k * N + r) % 3]``: the
    port's batches and file prefixes against the labels the JAX package's
    ``class_cond_sample`` gives the same batches."""
    score, clf = ckpts
    args = RUN + CLF + ranks(rank, nproc) + [
        f"dataset.diffusion.evaluation.chkpt_path={score}",
        f"dataset.clf.evaluation.chkpt_path={clf}",
        f"dataset.diffusion.evaluation.save_path={tmp_path}"]
    rows = guided_cli.main(args)
    per, n_batches = share(nproc)
    got = [r["label"] for r in rows]
    assert len(got) == n_batches
    recorded = {}
    _stub(monkeypatch, recorded)
    jgen.class_cond_sample(j_compose(args).dataset)
    prefix = recorded["kw"]["prefix_source"]
    want = [int(prefix(k).split("y")[-1]) for k in range(n_batches)]
    assert got == want
    names = {f.split("_")[1] for f in os.listdir(tmp_path / "images")}
    assert names == {f"tpuy{y}" for y in want}


class _Record:
    """Records the indices a dataset class's ``batch`` is asked for."""

    def __init__(self, monkeypatch, cls):
        self.idxs = []
        real = cls.batch

        def batch(ds, idxs):
            self.idxs.append([int(i) for i in idxs])
            return real(ds, idxs)

        monkeypatch.setattr(cls, "batch", batch)


@pytest.mark.parametrize("mode", ["edit", "inpaint"])
@pytest.mark.parametrize("rank,nproc", FANOUTS)
def test_dataset_shards_match_jax(tmp_path, monkeypatch, ckpts, mode, rank,
                                  nproc):
    """Batch k of rank r reads images ``((k * B + i) * N + r) % len``: the
    port's reads against those of the JAX package's batch source."""
    score, _ = ckpts
    args = RUN + ranks(rank, nproc) + [
        f"dataset.diffusion.evaluation.chkpt_path={score}",
        f"dataset.diffusion.evaluation.save_path={tmp_path}"]
    port = _Record(monkeypatch, datasets.SyntheticDataset)
    rows = (edit_cli if mode == "edit" else inpaint_cli).main(args)
    per, n_batches = share(nproc)
    assert [r["samples"] for r in rows] == [
        min(BATCH, per - BATCH * k) for k in range(n_batches)]
    recorded = {}
    _stub(monkeypatch, recorded)
    jax_reads = _Record(monkeypatch, jdatasets.SyntheticDataset)
    getattr(jgen, mode)(j_compose(args).dataset.diffusion)
    source = recorded["args"][5]
    for k in range(n_batches):
        source(None, BATCH, k, rank, nproc)
    assert port.idxs == jax_reads.idxs and len(port.idxs) == n_batches


def test_spatial_stays_refused():
    """Spatial parallelism needs a spatial group of ranks
    (``test_torch_spatial.py``): one process asked for
    ``evaluation.spatial=2`` is refused with the JAX package's message;
    fan-out alone is not."""
    def cfg(**ecfg):
        return ConfigDict({"evaluation": ecfg, "data": {"image_size": 8}})

    with pytest.raises(ValueError, match="must divide the device count 1"):
        generate._spatial_setup(cfg(spatial=2))
    generate._spatial_setup(cfg(num_processes=4))


def test_batch_generator_seeds_a_rank_apart():
    """N > 1: (seed, k) with the spawn key r seeds batch k of rank r,
    rank 0 included; N = 1: (seed, k)."""
    one = datasets.batch_generator(3, 1, "cpu")
    assert torch.equal(torch.rand(4, generator=one), torch.rand(
        4, generator=datasets.batch_generator(3, 1, "cpu")))
    draws = [torch.rand(4, generator=datasets.batch_generator(3, 1, "cpu", r))
             for r in range(3)]
    base = torch.rand(4, generator=datasets.batch_generator(3, 1, "cpu"))
    for i, d in enumerate(draws):
        assert not torch.equal(d, base)
        for j in range(i):
            assert not torch.equal(d, draws[j])
