"""Seeded inputs that the benchmark hands to the program and to the
reference alike."""

from __future__ import annotations

import hashlib

import torch


def mix(seed: int, *tags) -> int:
    """A 63-bit generator seed from ``seed`` and ``tags``: every stream of
    a run has its own, so a draw does not depend on the order of others."""
    text = ":".join(str(v) for v in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, *tags, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def make_weights(shapes: dict, seed: int, device, std: float = 0.02,
                 tag: str = "weights") -> dict:
    """Every parameter N(0, 1) * ``std``, float32, drawn on ``device`` in one
    call from the stream ``tag`` and cut in the sorted order of the
    names."""
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[k]).numel()) for k in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, tag,
                                                       device=device),
                       device=device, dtype=torch.float32)
    flat.mul_(std)
    return {k: v.view(shapes[k])
            for k, v in zip(names, torch.split(flat, sizes))}
