"""``idle_share.train``: :func:`benchmark.readers.idle_share`
of the ``train`` cells."""

from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train")
