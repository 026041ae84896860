"""``mfu.sample``: :func:`benchmark.readers.mfu`
of the ``em_sample`` cells."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "em_sample")
