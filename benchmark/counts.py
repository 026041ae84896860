"""Operations and bytes of the work a cell runs, counted from the plain
reference's calls at the cell's shapes (its forward traced on the
``meta`` device), so that the counts do not change when the program does.

Conventions (those of the port's former bench, ``eval/bench.py``
``count_flops``): FLOPs are those of convolutions and matrix products, 2 a
multiply-add. A FIR filter is a depthwise convolution and counts the
multiply-adds its nonzero inputs need (after a zero-stuffing upsample, a
quarter of its taps); a transposed convolution counts its input pixels. A
training step's backward counts the input gradient of each call (not of
the first convolution, whose input is the data) and the weight gradient
(not of the FIR filters, whose weights are fixed): about two forwards.
Bytes read each input once and write each output once, in the dtype the
configuration computes in (``compute.bf16``: 2 bytes a value).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ncsnpp import NCSNpp
from benchmark.reference.ops import Recorder


def calls(cfg: dict, batch: int) -> list:
    """The reference network's calls of one forward at ``batch``."""
    net = NCSNpp(cfg["model"], cfg["image_size"])
    rec = Recorder()
    with torch.device("meta"):
        p = {k: torch.empty(s) for k, s in net.shapes.items()}
        x = torch.empty(batch, cfg["image_size"], cfg["image_size"],
                        net.in_ch)
        net(p, x, torch.empty(batch), rec)
    return rec.calls


def _n(shape) -> int:
    return math.prod(shape)


def _size(cfg) -> int:
    return 2 if cfg["compute"]["bf16"] else 4


def conv_costs(cfg: dict, batch: int, train: bool, listed=None) -> list:
    """``(flops, bytes)`` of each convolution of one forward (the FIR
    filters too), and with ``train`` of each one's backward."""
    size, out = _size(cfg), []
    for call in listed or calls(cfg, batch):
        kind = call[0]
        if kind in ("conv", "conv_t"):
            x, w, y = call[1], call[2], call[3]
            first = kind == "conv" and call[4]
            pixels = _n(y) // y[1] if kind == "conv" else _n(x) // x[1]
            f = 2 * pixels * _n(w)
            out.append((f, (_n(x) + _n(w) + _n(y) + w[0]) * size))
            if train:
                # reads x, dy and w; writes dw, db and (but for the data) dx
                b = _n(x) + _n(y) + 2 * _n(w) + w[0] + (0 if first else _n(x))
                out.append((f * (1 if first else 2), b * size))
        elif kind == "depthwise":
            x, taps, y, up = call[1], call[2], call[3], call[4]
            f = 2 * _n(y) * taps // (up * up)
            b = (_n(x) // (up * up) + _n(y)) * size
            out.append((f, b))
            if train:
                out.append((f, b))
    return out


def flops(cfg: dict, batch: int, train: bool) -> float:
    """Convolution and matrix-product FLOPs of one forward at ``batch``,
    or with ``train`` of one training step (forward and backward)."""
    listed = calls(cfg, batch)
    total = sum(f for f, _ in conv_costs(cfg, batch, train, listed))
    for call in listed:
        if call[0] == "linear":
            f = 2 * (_n(call[1]) // call[1][-1]) * _n(call[2])
        elif call[0] == "bmm":
            a, b = call[1], call[2]
            f = 2 * a[0] * a[1] * a[2] * b[2]
        else:
            continue
        total += f * (3 if train else 1)
    return float(total)


def gn_bytes(cfg: dict, batch: int, train: bool) -> float:
    """Bytes of the GroupNorm calls of one forward (``train``: and of their
    backward): the forward reads x, scale and bias and writes y; the
    backward reads x, dy, scale and bias and writes dx, dscale and
    dbias."""
    size, total = _size(cfg), 0
    for call in calls(cfg, batch):
        if call[0] == "gn":
            n, c = _n(call[1]), call[1][1]
            total += (2 * n + 2 * c) * size
            if train:
                total += (3 * n + 4 * c) * size
    return float(total)
