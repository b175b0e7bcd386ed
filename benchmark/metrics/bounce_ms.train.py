"""Device ms a step in the bounce range (``trace._bounce``: K1, or K5 in bounce mode)."""

def _layer_ms(ctx, *names):
    layers = ctx["summary"]["layers"]
    ms = sum(layers[n]["device_ms"] for n in names)
    return ms / ctx["units"] if ms > 0 else None


def read(ctx):
    return _layer_ms(ctx, 'bounce')
