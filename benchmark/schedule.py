"""The wavefront widths a traced call bounces at: the port's compaction
schedule at commit 4da45c6 (``_COMPACT_SCHEDULE`` and
``_COMPACT_MIN_BATCH`` in ``ptx_torch/integrate/trace.py``), frozen here
for the kernels' byte and operation counts."""

COMPACT_SCHEDULE = ((2, 3), (6, 16))
COMPACT_MIN_BATCH = 16384


def widths(lanes: int, depth: int) -> list:
    """The lanes of each of the ``depth + 1`` bounces of a ``lanes``-ray
    call: all of them before the first compaction, ``lanes // 3`` from
    bounce 2 and ``lanes // 16`` from bounce 6 (on calls of 16,384 rays or
    more at depth 8 or more)."""
    phases = [(0, 1)]
    if lanes >= COMPACT_MIN_BATCH and depth >= 8:
        phases += [(s, dv) for s, dv in COMPACT_SCHEDULE if s <= depth]
    out = []
    for i, (start, div) in enumerate(phases):
        end = phases[i + 1][0] if i + 1 < len(phases) else depth + 1
        out += [lanes // div] * (end - start)
    return out
