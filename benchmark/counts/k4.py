"""K4 (``first_hit_kernel``, the hit-only kernel under the unfused bounce
of a scene of at most 24 leaves): bytes a call moves.

Frozen from ``chip_smoke.bound_k4`` at commit 79562cc: a lane reads o and
d (24 B) and writes t, normal, mat_id (int64), evt, hit and entering (30
B): 54 bytes.  Its operation count is left out, as K1's and K5's are: the
walk in time order visits a number of events a lane that only the
program's own hit can count, and ``bound_k4``'s 4·L² fold term counts
work the kernel has not done since its walk replaced the fold.  K4's
share rests on bytes alone.
"""

BYTES_PER_LANE = 54


def bytes_moved(lanes: int) -> int:
    return BYTES_PER_LANE * lanes


def operations(lanes: int, n_leaves: int):
    return None
