"""K5's share of its roofline over a step, in percent."""

from benchmark import roofline


def read(ctx):
    return roofline.share('k5', ctx)
