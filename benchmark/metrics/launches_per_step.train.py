"""Kernel launches a training step, from the trace."""

def read(ctx):
    return ctx['summary']['kernels'] / ctx['units'] if ctx['summary']['kernels'] else None
