"""Host-device synchronises a 65,536-path wavefront of the render makes
inside the port's spans (``ptx_torch.utils.profiling``'s recorder; those
outside every span, the benchmark's own reads, are left out)."""


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
    return sum(v["syncs"] for v in s["spans"].values()) / ctx["units"] if s else None
