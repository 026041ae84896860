"""Traffic kind ``em_sample``: Euler--Maruyama trajectories of the
configured sampler at a fixed batch, back to back, for the window.

Set-up builds the sampler as ``cli.sample`` does (``program.em_sampler``)
and runs a ``warmup_nfe`` trajectory (two noisy rows and the mean-only
denoise row). The window then joins the last ``R`` rows of one trajectory
(``R`` drawn from the seed in ``tail_nfe``; it starts from a prior draw,
and an NFE's work does not depend on the state) to whole trajectories
from fresh prior draws, so that it always holds a denoise row and a first
row. The host clock closes it: the first score call after ``--seconds``
stops the loop, and the window ends at the device sync after it.

- ``sample_img_per_s``: batch x NFEs completed / (nfe x window seconds).
- ``nfe_ms_p95``: the 95th percentile of the gaps between CUDA events
  recorded after each score call (the first from the window's start).

Check: at a few NFEs of the window (its first, the tail's denoise row,
the next trajectory's first row, and ``random`` more drawn from the seed
below ``within``), ``rows`` rows drawn from the seed keep the state the
step started from, its noise draw and the state it produced. After the
window the float32 reference takes the same step from the same state with
the same noise; ``step_gap`` is the largest, over those rows, of the norm
of the two steps' difference over the norm of what the network moves in
the reference's step (``g^2 score dt``). The reference follows the
program step by step from the program's own states: the first NFE starts
from the benchmark's prior draw.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, program
from benchmark.reference.ncsnpp import NCSNpp
from benchmark.reference.ops import exact_float32
from benchmark.reference.psld import PSLD, em_step
from benchmark.tracing import Traced
from benchmark.weights import generator, make_weights, mix


class _Closed(Exception):
    """The window's time is up."""


class _Score:
    """The sampler's score function with the benchmark's hooks around it:
    the window's deadline, a CUDA event after each call, the captures of
    the checked steps."""

    def __init__(self, fn):
        self.fn = fn
        self.n = 0
        self.deadline = None
        self.events = None
        self.before = None
        self.plan: dict = {}   # NFE -> row indices (device)
        self.last_of_segment: set = set()
        self.z_in, self.z_out, self.noise = {}, {}, {}

    def __call__(self, z, t):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise _Closed
        n = self.n
        if self.before is not None:
            self.before(n)
        if n in self.plan:
            self.z_in[n] = z.index_select(0, self.plan[n])
        prev = n - 1
        if prev in self.plan and prev not in self.last_of_segment \
                and prev in self.z_in:
            self.z_out[prev] = z.index_select(0, self.plan[prev])
        out = self.fn(z, t)
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.n += 1
        return out

    def draw(self, gen):
        """The sampler's ``noise(k, like)``: a standard normal draw from
        the benchmark's generator, kept where the step is checked."""
        def noise(k, like):
            d = torch.randn(like.shape, generator=gen, device=like.device,
                            dtype=like.dtype)
            if self.n in self.plan:
                self.noise[self.n] = d.index_select(0, self.plan[self.n])
            return d
        return noise


def _grid(nfe: int, eps: float) -> torch.Tensor:
    """The sampler's float64 time grid of ``nfe - 1`` noisy rows."""
    return torch.from_numpy(np.linspace(0.0, 1.0 - eps, nfe))


def _row(ts, nfe: int, eps: float, g: int):
    """(t, dt, noisy) of row ``g`` of a trajectory."""
    if g < nfe - 1:
        return float(ts[g]), float(ts[g + 1]) - float(ts[g]), True
    return 1.0 - eps, eps, False


def run(rc) -> dict:
    cell, tr = rc.cell, rc.cell.traffic
    cfg, dev = cell.config, rc.device
    B, nfe, eps = int(tr["batch"]), int(tr["nfe"]), float(tr["eval_eps"])
    size, ch = int(cfg["image_size"]), int(cfg["num_channels"])
    ts = _grid(nfe, eps)
    ref_sde = PSLD(cfg["sde"])
    shapes = NCSNpp(cfg["model"], size).shapes

    rc.stage("imports")
    pcfg = program.port_config(cfg, dev.type)
    w = make_weights(shapes, rc.seed, dev)
    rc.stage("weights")
    _, sampler = program.em_sampler(pcfg, w, dev)
    del w
    rc.stage("sampler built")
    score = _Score(sampler.score_fn)
    sampler.score_fn = score
    rc.plant(sampler, score)

    def prior(tag):
        return ref_sde.prior((B, size, size, ch), generator(
            rc.seed, "prior", tag, device=dev), dev)

    def segment(z, first_row, noise, denoise=True, rows=None):
        seg = ts[first_row:] if rows is None else ts[first_row:first_row
                                                     + rows + 1]
        return sampler.sample(None, z, seg, len(seg) - 1, denoise=denoise,
                              eps=eps, noise=noise)

    with torch.inference_mode():
        segment(prior("warmup"), 0,
                score.draw(generator(rc.seed, "warmup", device=dev)),
                rows=int(tr["warmup_nfe"]) - 1)
        rc.sync()
        rc.stage("warm-up")
        summary = None
        if rc.trace:
            t = tr["trace"]
            absorb, units = int(t["absorb"]), int(t["units"])
            with Traced(dev) as traced:
                score.n = 0
                score.before = lambda n: traced.open() if n == absorb \
                    else None
                segment(prior("trace"), 0, score.draw(generator(
                    rc.seed, "trace", device=dev)), denoise=False,
                    rows=absorb + units)
                traced.close()
            score.before = None
            summary = traced.summary
            summary["units"] = units
        setup_s = rc.setup_done()

        # the window's plan: the tail's length and the checked NFEs
        host = np.random.default_rng(mix(rc.seed, "plan"))
        lo, hi = (int(v) for v in tr["tail_nfe"])
        R = int(host.integers(lo, hi + 1))
        chk = tr["check"]
        fixed = {0, R - 1, R}
        pool = [n for n in range(int(chk["within"])) if n not in fixed]
        picks = fixed | set(host.choice(pool, int(chk["random"]),
                                        replace=False).tolist())
        score.plan = {n: torch.from_numpy(np.sort(host.choice(
            B, int(chk["rows"]), replace=False))).to(dev)
            for n in sorted(picks)}
        score.n = 0
        score.events = [] if dev.type == "cuda" else None
        score.z_in, score.z_out, score.noise = {}, {}, {}
        gen = generator(rc.seed, "noise", device=dev)
        segs, first, start_n = 0, nfe - R, 0
        start_ev = None
        if score.events is not None:
            start_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
        t0 = time.perf_counter()
        score.deadline = t0 + rc.seconds
        try:
            while True:
                length = nfe - first
                score.last_of_segment.add(start_n + length - 1)
                z_end = segment(prior(segs), first, score.draw(gen))
                last = start_n + length - 1
                if last in score.plan and last in score.z_in:
                    score.z_out[last] = z_end.index_select(0,
                                                           score.plan[last])
                segs, first, start_n = segs + 1, 0, start_n + length
        except _Closed:
            pass
        rc.sync()
        window = time.perf_counter() - t0
    done = score.n
    out = {"setup_s": setup_s, "window_s": window, "attempted": done}
    if score.events is not None and done:
        stamps = [start_ev] + score.events
        gaps = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
        out["sample_img_per_s"] = B * done / (nfe * window)
        out["nfe_ms_p95"] = float(np.percentile(gaps, 95))
        out["nfe_ms_median"] = float(np.median(gaps))
    out["memory_peak_bytes"] = rc.memory_peak()
    out["trace"] = summary
    if summary is not None:
        out["units"] = summary["units"]
        out["flops_per_unit"] = counts.flops(cfg, B, False)
        out["gn_bytes_per_unit"] = counts.gn_bytes(cfg, B, False)
        out["conv_costs_per_unit"] = counts.conv_costs(cfg, B, False)

    # the check, on what the window produced, after the program is freed
    due = [n for n in score.plan if n in score.z_in and n in score.z_out
           and n < done]
    saved = {n: (score.z_in[n], score.noise.get(n), score.z_out[n])
             for n in due}
    del sampler, score
    rc.free()
    exact_float32()
    net = NCSNpp(cfg["model"], size)
    w = make_weights(net.shapes, rc.seed, dev)
    limit = float(cell.limits["step_gap"])
    gaps, failed = [], 0
    with torch.no_grad():
        for n in due:
            z_in, noise, z_out = saved[n]
            g = nfe - R + n if n < R else (n - R) % nfe
            t, dt, noisy = _row(ts, nfe, eps, g)
            ref, moved = em_step(ref_sde, lambda z, tt: net(w, z, tt), z_in,
                                 t, dt, noise if noisy else None)
            scale = moved.flatten(1).norm(dim=1)
            gap = float(((z_out - ref).flatten(1).norm(dim=1) / scale).max())
            gaps.append(gap)
            failed += gap > limit
            rc.log(f"check nfe {n} row {g} (t {t:.6f}, "
                   f"{'noisy' if noisy else 'denoise'}): step_gap {gap:.6g}")
    out["checks"] = {"step_gap": (max(gaps) if gaps else float("inf"),
                                  limit)}
    out["failed"] = failed if gaps else 1
    out["checked"] = len(gaps)
    return out
