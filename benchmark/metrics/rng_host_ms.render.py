"""Host ms a wavefront in the random draws' span (``trace._phase_uniforms``,
``rng_draws``), less its child spans: the launches of the draws and the
waits of their synchronises (``ptx_torch.utils.profiling``'s recorder)."""


def _snapshot():
    """What the port's recorder holds of the traced segment, or None where it
    holds nothing of a card: a program without the recorder, a capture
    without CUDA (the CPU counts no synchronise)."""
    from ptx_torch.utils import profiling

    snap = getattr(profiling, "snapshot", None)
    s = snap() if snap is not None else None
    return s if s and s["cuda"] and s["units"] else None


def read(ctx):
    s = _snapshot()
    if s is None or "rng_draws" not in s["spans"]:
        return None
    return s["spans"]["rng_draws"]["self_ms"] / ctx["units"]
