"""``gn_roofline.train``: :func:`benchmark.readers.gn_roofline`
of the ``train`` cells."""

from benchmark.readers import gn_roofline


def read(ctx):
    return gn_roofline(ctx, "train")
