"""``idle_share.sample``: :func:`benchmark.readers.idle_share`
of the ``em_sample`` cells."""

from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx, "em_sample")
