"""The arithmetic of the per-layer metrics, shared by the small readers
in ``metrics/``. Each takes a :class:`benchmark.harness.Reading` and
returns a percentage, or None where the run has nothing to read (no
trace, no card, another kind of traffic, no kernel of the layer)."""

from __future__ import annotations

import re

# the port's GroupNorm kernels (csrc/group_norm_fwd.cu, group_norm_bwd.cu,
# group_norm_split_bwd.cu): gn_fwd_kernel, gn_bwd_kernel, gn_split_...
GN_KERNEL = re.compile(r"\bgn_\w*kernel")


def _ready(ctx, kind: str) -> bool:
    return ctx.trace is not None and ctx.peaks is not None \
        and ctx.cell.kind == kind and bool(ctx.trace["kernels"])


def mfu(ctx, kind: str):
    """Model FLOPs of the traced units over the traced window's wall and
    the card's bf16 peak, in %."""
    if not _ready(ctx, kind):
        return None
    seconds = ctx.trace["window_us"] / 1e6
    return 100.0 * ctx.out["flops_per_unit"] * ctx.units / seconds \
        / ctx.peaks["bf16_flops"]


def idle_share(ctx, kind: str):
    """The traced window's share, in %, that no device span covers."""
    if not _ready(ctx, kind):
        return None
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])


def gn_roofline(ctx, kind: str):
    """The GroupNorm calls' least time (their bytes over the card's
    bandwidth) over the device time of the GroupNorm kernels, in %."""
    if not _ready(ctx, kind):
        return None
    took = sum(b - a for name, a, b in ctx.trace["kernels"]
               if GN_KERNEL.search(name)) / 1e6
    if took <= 0:
        return None
    least = ctx.out["gn_bytes_per_unit"] * ctx.units / ctx.peaks["hbm_bytes"]
    return 100.0 * least / took


def conv_roofline(ctx, kind: str):
    """The convolution calls' least time (each call's FLOPs over the bf16
    peak or its bytes over the bandwidth, the larger) over the device time
    of the kernels that ``aten::convolution`` and
    ``aten::convolution_backward`` launch, less their bias passes (which
    the least time does not count either), in %."""
    if not _ready(ctx, kind):
        return None
    took = ctx.trace["conv_us"] / 1e6
    if took <= 0:
        return None
    p = ctx.peaks
    least = sum(max(f / p["bf16_flops"], b / p["hbm_bytes"])
                for f, b in ctx.out["conv_costs_per_unit"]) * ctx.units
    return 100.0 * least / took
