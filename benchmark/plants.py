"""What can be put in the program's place to show that the check fails: the
control (the reference in the precision below the configuration's) and
one planted fault for each way a cell's timed path can go wrong. Each is a
function ``plant(rc, *objects)`` that a traffic kind's ``rc.plant`` calls
with what the kind built (``em_sample``: the sampler and its score
wrapper, changed in place; ``train``: the step and its state, and a step
to use instead is returned). The benchmark's own runs plant nothing;
``control.py`` plants them on the card, the CPU tests at tiny sizes."""

from __future__ import annotations

import torch

from benchmark.kinds import train as train_kind
from benchmark.reference.ncsnpp import NCSNpp
from benchmark.reference.ops import Float8, exact_float32
from benchmark.weights import make_weights


def sample_control(rc, sampler, score):
    """The reference network in float8 (:class:`Float8`) as the score."""
    cfg = rc.cell.config
    net = NCSNpp(cfg["model"], cfg["image_size"])
    w = make_weights(net.shapes, rc.seed, rc.device)
    exact_float32()
    score.fn = lambda z, t: net(w, z, t, Float8())


def sample_unchanged(rc, sampler, score):
    """Each step hands back the state it was given."""
    step = sampler._step
    sampler._step = lambda x, *a: (step(x, *a), x)[1]


def sample_half_batch(rc, sampler, score):
    """The network sees the first half of the batch; the rest gets 0."""
    fn = score.fn

    def half(z, t):
        h = z.shape[0] // 2
        out = fn(z[:h], t[:h])
        return torch.cat([out, torch.zeros_like(out)[:z.shape[0] - h]])
    score.fn = half


def sample_altered(rc, sampler, score):
    """Each step's answer is moved by 1e-3 where it is produced."""
    step = sampler._step
    sampler._step = lambda x, *a: step(x, *a) + 1e-3


def train_control(rc, step, state):
    """The reference's step in float8 on the program's state: the loss
    and gradients of :class:`Float8`'s network, then the reference's clip,
    Adam and EMA on the program's weights, moments and EMA."""
    cfg, tr = rc.cell.config, rc.cell.traffic
    ref = train_kind.Reference(cfg, int(tr["reference_rows"]), Float8())
    exact_float32()

    def low(st, x, rng=None, *, t, eps, **kw):
        view = {"mu": st.opt_state["mu"], "nu": st.opt_state["nu"],
                "count": st.opt_state["count"], "ema": st.ema_params}
        loss, grads = ref.grads(st.params, x, t, eps)
        ref.opt.update(st.params, grads, view)
        st.opt_state["count"] = view["count"]
        st.step += 1
        return st, {"loss": torch.tensor(loss)}
    return low


def _copy_back(dicts, kept):
    with torch.no_grad():
        for d, old in zip(dicts, kept):
            for k, v in old.items():
                d[k].copy_(v)


def train_unchanged(rc, step, state):
    """The step runs, and hands back its state as it came."""
    def same(st, *a, **k):
        parts = (st.params, st.ema_params, st.opt_state["mu"],
                 st.opt_state["nu"])
        kept = [{k_: v.detach().clone() for k_, v in d.items()}
                for d in parts]
        count = st.opt_state["count"]
        st, m = step(st, *a, **k)
        _copy_back(parts, kept)
        st.opt_state["count"] = count
        return st, m
    return same


def train_ema_unchanged(rc, step, state):
    """The step runs, and leaves the EMA as it came."""
    def no_ema(st, *a, **k):
        kept = {k_: v.clone() for k_, v in st.ema_params.items()}
        st, m = step(st, *a, **k)
        _copy_back([st.ema_params], [kept])
        return st, m
    return no_ema


def train_half_batch(rc, step, state):
    """The step sees the first half of each batch, its mean over those."""
    def half(st, x, rng, *, t, eps, **k):
        h = x.shape[0] // 2
        return step(st, x[:h], rng, t=t[:h], eps=eps[:h], **k)
    return half


def train_altered(rc, step, state):
    """Each step's loss is moved by 1% where it is produced."""
    def altered(st, *a, **k):
        st, m = step(st, *a, **k)
        return st, dict(m, loss=m["loss"] * 1.01)
    return altered


# the plants of each traffic kind, by name
PLANTS = {
    "em_sample": {"control": sample_control, "unchanged": sample_unchanged,
                  "half_batch": sample_half_batch,
                  "altered": sample_altered},
    "train": {"control": train_control, "unchanged": train_unchanged,
              "ema_unchanged": train_ema_unchanged,
              "half_batch": train_half_batch, "altered": train_altered},
}
