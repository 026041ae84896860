"""The float32 reference against the port's plain path on the CPU, at tiny
widths: the same network, SDE, sampler step, loss and training step.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import program
from benchmark.kinds import train as train_kind
from benchmark.reference.ncsnpp import NCSNpp
from benchmark.reference.psld import PSLD, em_step, hsm_loss
from benchmark.weights import make_weights

import tiny

CONFIGS = [c["name"] for c in tiny.spec()["configs"]]


def _tiny_config(name: str, bf16: bool = False) -> dict:
    path = os.path.join(tiny.ROOT, "benchmark", "configs", name + ".json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["image_size"] = 16
    cfg["model"].update(tiny.TINY_MODEL)
    cfg["compute"]["bf16"] = bf16
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_network_matches_port(name):
    cfg = _tiny_config(name)
    ref = NCSNpp(cfg["model"], cfg["image_size"])
    w = make_weights(ref.shapes, 3, "cpu")
    net = program.score_net(program.port_config(cfg, "cpu"), w, "cpu")
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} \
        == ref.shapes
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 16, 6, generator=g)
    t = torch.rand(3, generator=g) * 0.9 + 0.05
    with torch.no_grad():
        a, b = net.eval()(x, t), ref(w, x, t)
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_sde_step_and_loss_match_port(name):
    from psld_tpu_torch.eval.generate import build_sde
    from psld_tpu_torch.registry import get_module
    from psld_tpu_torch.samplers.sde_samplers import _em_update

    cfg = _tiny_config(name)
    pcfg = program.port_config(cfg, "cpu")
    sde, ref = build_sde(pcfg), PSLD(cfg["sde"])
    for tv in (1e-5, 1e-3, 0.3, 0.999):
        t = torch.full((2,), tv, dtype=torch.float64)
        port = [v[0].item() for v in sde._cov(0.0, sde.mm_0, t)]
        mine = ref.cov(t, 0.0, ref.mm_0)[0]
        assert port == pytest.approx([mine[0, 0].item(), mine[0, 1].item(),
                                      mine[1, 1].item()], rel=1e-7)
        mean = [c[0].item() for c in sde.kernel_mean_coeff(t)]
        assert mean == pytest.approx(ref.mean_map(t)[0].flatten().tolist(),
                                     rel=1e-12, abs=1e-15)

    def net(z, tt):
        return torch.sin(3 * z) * 0.1 + tt[:, None, None, None] * 0.01

    g = torch.Generator().manual_seed(1)
    z = torch.randn(4, 8, 8, 6, generator=g) * 2
    noise = torch.randn(4, 8, 8, 6, generator=g)
    for t, dt, n in ((0.0, 1e-3, noise), (0.5, 1e-3, noise),
                     (0.999, 1e-3, None)):
        a, _ = _em_update(sde, net, z, t, dt, n, 1.0)
        b, moved = em_step(ref, net, z, t, dt, n)
        assert (a - b).abs().max() <= 1e-3 * moved.abs().max()
    crit = get_module("losses", "psld_score_loss")(pcfg, sde)
    x0 = torch.rand(4, 8, 8, 3, generator=g) * 2 - 1
    t = torch.rand(4, generator=g, dtype=torch.float64) * 0.9 + 1e-5
    e = torch.randn(4, 8, 8, 6, generator=g)
    assert float(crit(x0, t, net, eps=e)) == pytest.approx(
        float(hsm_loss(ref, net, x0, t, e)), rel=1e-6)


def test_training_steps_match_port_in_float32():
    """Three float32 steps of the port's training step against the
    reference's, from the same weights and EMA: the check's numbers read
    at round-off."""
    cfg = _tiny_config("celebahq256-psld")
    shapes = NCSNpp(cfg["model"], 16).shapes
    step, state, _ = program.train_step(program.port_config(cfg, "cpu"),
                                        make_weights(shapes, 5, "cpu"), "cpu")
    ema0 = train_kind.ema_start(shapes, 5, "cpu")
    with torch.no_grad():
        for k, v in state.ema_params.items():
            v.copy_(ema0[k])
    losses, first = [], None
    for i in range(1, 4):
        x, t, n = train_kind.batch_of(5, i, cfg, 4, "cpu")
        state, m = step(state, x, None, t=t, eps=n)
        losses.append(float(m["loss"]))
        if i == 1:
            first = {k: v.clone() / 0.1
                     for k, v in state.opt_state["mu"].items()}
    after = {k: v.detach().clone() for k, v in state.params.items()}
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    ref = train_kind.reference_steps(cfg, 5, 3, 4, 2, "cpu")
    assert set(ema) == set(ref[3])
    nums = train_kind.compare((losses, first, after, ema), ref,
                              make_weights(shapes, 5, "cpu"), ema0,
                              lambda m: None)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-3
    assert nums["ema_gap"] < 1e-4
