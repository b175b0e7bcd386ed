"""K4's share of its roofline over a step, in percent (bytes alone: a
lower bound)."""

from benchmark import roofline


def read(ctx):
    return roofline.share('k4', ctx)
