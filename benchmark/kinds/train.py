"""Traffic kind ``train``: the configured training step at a fixed batch,
step after step, for the window.

Set-up builds one training step with its network and optimizer state as
``cli.train_sde`` does (``program.train_step``) and drives it from the
seed through its first ``check_steps`` steps, which are also the
warm-up; the window takes that same object on. Every step gets a batch of
its own, made on the card from the seed: images uniform in [-1, 1], times
``t`` uniform in [train_eps, 1] (float64) and the noise ``eps``, handed to
the step (``t=``, ``eps=``); HSM draws no momentum.

- ``train_img_per_s``: batch x steps / window seconds, the window ending
  at a device sync after the first step the host clock finds late.

Check: the float32 reference follows the first ``check_steps`` steps on
the same weights and batches (in blocks of ``reference_rows`` rows, the
gradients summed), and four numbers compare:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient as the optimizer took it (after
  the clip), read from Adam's first moment after step 1 (mu / (1 -
  beta_1)); per leaf, the gap between the program's norm and the
  reference's, over the larger of the reference's norm of that leaf and
  of the median leaf; the worst leaf;
- ``change_gap``: the same of each leaf's change from the initial weights
  after the check steps, kept before the next step overwrites them;
  leaves whose reference gradient is under a thousandth of the median
  leaf's move by round-off alone under Adam and are left out;
- ``ema_gap``: the same of each leaf's EMA change after the check steps.
  Both sides start the EMA from a seeded draw of its own
  (:func:`ema_start`), not from the weights: the EMA then moves by (1 -
  tau) (params - ema) a step, far above float32's resolution, where from
  the weights it would move by (1 - tau) times the first steps' tiny
  updates.
"""

from __future__ import annotations

import time

import torch

from benchmark import counts, program
from benchmark.reference.ncsnpp import NCSNpp
from benchmark.reference.ops import exact_float32
from benchmark.reference.optim import Adam
from benchmark.reference.psld import PSLD, hsm_loss
from benchmark.tracing import Traced
from benchmark.weights import generator, make_weights


def batch_of(seed: int, i: int, cfg: dict, B: int, dev):
    """Step ``i``'s images, times and noise."""
    g = generator(seed, "batch", i, device=dev)
    s, c = int(cfg["image_size"]), int(cfg["num_channels"])
    x = torch.rand(B, s, s, c, generator=g, device=dev) * 2 - 1
    eps = float(cfg["training"]["train_eps"])
    t = torch.rand(B, generator=g, device=dev, dtype=torch.float64) \
        * (1.0 - eps) + eps
    noise = torch.randn(B, s, s, 2 * c, generator=g, device=dev)
    return x, t, noise


def ema_start(shapes: dict, seed: int, dev) -> dict:
    """The EMA both sides start from: N(0, 1) * 0.02, a stream of its own."""
    return make_weights(shapes, seed, dev, tag="ema")


def _fixed(name: str) -> bool:
    """The Fourier features' ``W`` is fixed: it never trains."""
    return name.startswith("GaussianFourierProjection")


class Reference:
    """The reference's training step of configuration ``cfg``: its
    network, SDE and optimizer, the gradients in blocks of ``rows`` rows,
    the arithmetic of ``ops`` (float32 by default)."""

    def __init__(self, cfg: dict, rows: int, ops=None):
        self.net = NCSNpp(cfg["model"], cfg["image_size"])
        self.sde = PSLD(cfg["sde"])
        self.opt = Adam(cfg["training"]["optimizer"],
                        cfg["training"]["ema_decay"])
        self.rows, self.ops = int(rows), ops

    def grads(self, p: dict, x, t, noise) -> tuple[float, dict]:
        """The batch's loss and the gradients of the leaves that train."""
        n = x.shape[0]
        grads = {k: torch.zeros_like(v) for k, v in p.items()
                 if not _fixed(k)}
        loss = 0.0
        for a in range(0, n, self.rows):
            b = min(n, a + self.rows)
            leaves = {k: v.detach().requires_grad_(not _fixed(k))
                      for k, v in p.items()}
            part = hsm_loss(self.sde,
                            lambda z, tt: self.net(leaves, z, tt, self.ops),
                            x[a:b], t[a:b], noise[a:b]) * ((b - a) / n)
            got = torch.autograd.grad(part, [leaves[k] for k in grads])
            for k, gk in zip(grads, got):
                grads[k] += gk
            loss += float(part.detach())
        return loss, grads


def reference_steps(cfg: dict, seed: int, steps: int, B: int, rows: int,
                    dev, ops=None):
    """The reference's ``steps`` steps from the seeded weights and EMA:
    ``(losses, first clipped gradient, weights after, EMA after, first raw
    gradient)``."""
    ref = Reference(cfg, rows, ops)
    p = make_weights(ref.net.shapes, seed, dev)
    state = ref.opt.init(p)
    state["ema"] = ema_start(ref.net.shapes, seed, dev)
    losses, first, raw = [], None, None
    for i in range(1, steps + 1):
        x, t, noise = batch_of(seed, i, cfg, B, dev)
        loss, grads = ref.grads(p, x, t, noise)
        losses.append(loss)
        if i == 1:
            first, raw = ref.opt.clipped(grads), grads
        ref.opt.update(p, grads, state)
    return losses, first, p, state["ema"], raw


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _leaf_gap(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """Worst leaf of |norm(prog) - norm(ref)| / max(norm(ref), median)."""
    keys = list(keys)
    med = float(torch.tensor([ref[k] for k in keys]).median())
    worst, at = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def compare(prog, ref, p0: dict, ema0: dict, log) -> dict:
    """The four numbers of the check, from the program's ``(losses, first
    gradient, weights after, EMA after)`` and the reference's."""
    l_p, g_p, p_p, e_p = prog
    l_r, g_r, p_r, e_r, raw = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_p, l_r))
    gn_p, gn_r = _norms(g_p), _norms(g_r)
    grad_gap, g_at = _leaf_gap(gn_p, gn_r, g_r)
    raw_n = _norms(raw)
    med = float(torch.tensor(list(raw_n.values())).median())
    moving = [k for k in raw_n if raw_n[k] >= 1e-3 * med]
    d_p = _norms({k: p_p[k].to(p0[k].device) - p0[k] for k in moving})
    d_r = _norms({k: p_r[k] - p0[k] for k in moving})
    change_gap, c_at = _leaf_gap(d_p, d_r, moving)
    both = [k for k in e_r if k in e_p]
    m_p = _norms({k: e_p[k].to(ema0[k].device) - ema0[k] for k in both})
    m_r = _norms({k: e_r[k] - ema0[k] for k in both})
    ema_gap, e_at = _leaf_gap(m_p, m_r, both)
    log(f"losses program {l_p} reference {l_r}")
    log(f"grad_gap worst leaf {g_at}; change_gap worst leaf {c_at}; "
        f"{len(raw_n) - len(moving)} leaves of {len(raw_n)} left out of the "
        f"change (reference gradient under 1e-3 of the median leaf's); "
        f"ema_gap worst leaf {e_at} of {len(both)}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "ema_gap": ema_gap}


def run(rc) -> dict:
    cell, tr = rc.cell, rc.cell.traffic
    cfg, dev = cell.config, rc.device
    B, n_check = int(tr["batch"]), int(tr["check_steps"])
    shapes = NCSNpp(cfg["model"], cfg["image_size"]).shapes
    b1 = float(cfg["training"]["optimizer"]["beta_1"])

    rc.stage("imports")
    pcfg = program.port_config(cfg, dev.type)
    w = make_weights(shapes, rc.seed, dev)
    rc.stage("weights")
    step, state, _ = program.train_step(pcfg, w, dev)
    del w
    with torch.no_grad():
        e0 = ema_start(shapes, rc.seed, dev)
        for k, v in state.ema_params.items():
            v.copy_(e0[k])
        del e0
    rc.stage("step built")
    step = rc.plant(step, state) or step

    losses, first_grad = [], None
    i = 0

    def one():
        nonlocal state, i
        i += 1
        x, t, noise = batch_of(rc.seed, i, cfg, B, dev)
        state, m = step(state, x, None, t=t, eps=noise)
        return m

    for _ in range(n_check):
        m = one()
        losses.append(m["loss"])
        if i == 1:
            first_grad = {k: v.to("cpu", copy=True) / (1.0 - b1)
                          for k, v in state.opt_state["mu"].items()}
    after = {k: v.detach().to("cpu", copy=True)
             for k, v in state.params.items()}
    ema_after = {k: v.to("cpu", copy=True)
                 for k, v in state.ema_params.items()}
    losses = [float(v) for v in losses]
    rc.sync()
    rc.stage(f"{n_check} steps")
    summary = None
    if rc.trace:
        t = tr["trace"]
        with Traced(dev) as traced:
            for _ in range(int(t["absorb"])):
                one()
            traced.open()
            for _ in range(int(t["units"])):
                one()
            traced.close()
        summary = traced.summary
        summary["units"] = int(t["units"])
    setup_s = rc.setup_done()

    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() < t0 + rc.seconds:
        one()
        done += 1
    rc.sync()
    window = time.perf_counter() - t0
    out = {"setup_s": setup_s, "window_s": window, "attempted": done,
           "train_img_per_s": B * done / window,
           "memory_peak_bytes": rc.memory_peak(), "trace": summary}
    if summary is not None:
        out["units"] = summary["units"]
        out["flops_per_unit"] = counts.flops(cfg, B, True)
        out["gn_bytes_per_unit"] = counts.gn_bytes(cfg, B, True)
        out["conv_costs_per_unit"] = counts.conv_costs(cfg, B, True)

    del step, state
    rc.free()
    exact_float32()
    rows = int(tr["reference_rows"])
    with torch.no_grad():
        p0 = make_weights(shapes, rc.seed, dev)
        ema0 = ema_start(shapes, rc.seed, dev)
    ref = reference_steps(cfg, rc.seed, n_check, B, rows, dev)
    nums = compare((losses, first_grad, after, ema_after), ref, p0, ema0,
                   rc.log)
    out["checks"] = {k: (v, float(cell.limits[k])) for k, v in nums.items()}
    out["failed"] = sum(1 for v, lim in out["checks"].values()
                        if not v <= lim)
    return out
