"""Kernel launches a 65,536-path wavefront of the render, from the trace."""

def read(ctx):
    return ctx['summary']['kernels'] / ctx['units'] if ctx['summary']['kernels'] else None
