"""Device ms a step in the replay backward: the bounces' backward (K2 or K6), the packing of their scene vector and its VJP."""

def _layer_ms(ctx, *names):
    layers = ctx["summary"]["layers"]
    ms = sum(layers[n]["device_ms"] for n in names)
    return ms / ctx["units"] if ms > 0 else None


def read(ctx):
    return _layer_ms(ctx, 'bounce_bwd', 'replay_pack', 'replay_pack_bwd')
