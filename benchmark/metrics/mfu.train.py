"""``mfu.train``: :func:`benchmark.readers.mfu`
of the ``train`` cells."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
