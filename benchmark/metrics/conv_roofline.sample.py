"""``conv_roofline.sample``: :func:`benchmark.readers.conv_roofline`
of the ``em_sample`` cells."""

from benchmark.readers import conv_roofline


def read(ctx):
    return conv_roofline(ctx, "em_sample")
