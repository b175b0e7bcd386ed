"""1 - device busy / wall of a step: busy from the traced steps, wall from the window's steps."""

def _idle(ctx):
    busy = ctx["summary"]["busy_ms"] / ctx["units"]
    return 1.0 - busy / ctx["unit_wall_ms"] if busy > 0 else None


def read(ctx):
    return _idle(ctx)
