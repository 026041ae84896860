"""``conv_roofline.train``: :func:`benchmark.readers.conv_roofline`
of the ``train`` cells."""

from benchmark.readers import conv_roofline


def read(ctx):
    return conv_roofline(ctx, "train")
