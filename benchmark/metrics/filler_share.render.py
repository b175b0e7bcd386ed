"""The share of the render's lane-bounces traced on compaction's filler rows:
the rows past the kept lanes of each compacted wavefront, times the
bounces of its phase, over the lane-bounces of every phase, the first
included (``ptx_torch.utils.profiling``'s counters)."""


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
    if s is None or not s["counters"].get("lane_bounces"):
        return None
    return s["counters"]["filler_lane_bounces"] / s["counters"]["lane_bounces"]
