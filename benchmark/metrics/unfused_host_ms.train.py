"""Host ms a step in the unfused bounce's route: the port's spans
``unfused_bounce`` (the plain-PyTorch bounce on K4's hit) and
``replay_vjp`` (its backward, the surface textures' transposes within),
each whole (``ptx_torch.utils.profiling``'s recorder).  None where the
segment took no bounce on that route (counter ``unfused_bounces``)."""


def _snapshot():
    """What the port's recorder holds of the traced segment, or None where it
    holds nothing of a card: a program without the recorder, a capture
    without CUDA."""
    from ptx_torch.utils import profiling

    snap = getattr(profiling, "snapshot", None)
    s = snap() if snap is not None else None
    return s if s and s["cuda"] and s["units"] else None


def read(ctx):
    s = _snapshot()
    if s is None or not s["counters"].get("unfused_bounces"):
        return None
    return sum(s["spans"].get(n, {}).get("host_ms", 0.0)
               for n in ("unfused_bounce", "replay_vjp")) / ctx["units"]
