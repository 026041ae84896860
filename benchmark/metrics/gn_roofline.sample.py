"""``gn_roofline.sample``: :func:`benchmark.readers.gn_roofline`
of the ``em_sample`` cells."""

from benchmark.readers import gn_roofline


def read(ctx):
    return gn_roofline(ctx, "em_sample")
