"""K1's share of its roofline over a step, in percent (bytes alone)."""

from benchmark import roofline


def read(ctx):
    return roofline.share('k1', ctx)
