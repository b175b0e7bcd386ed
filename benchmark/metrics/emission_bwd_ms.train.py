"""Device ms a step in the emission backward: the sky image's histogram (K3) and the transposes of the emission gathers."""

def _layer_ms(ctx, *names):
    layers = ctx["summary"]["layers"]
    ms = sum(layers[n]["device_ms"] for n in names)
    return ms / ctx["units"] if ms > 0 else None


def read(ctx):
    return _layer_ms(ctx, 'emission_bwd', 'sky_hist')
