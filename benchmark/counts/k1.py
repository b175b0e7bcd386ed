"""K1 (``bounce_forward_kernel``, the fused bounce of a scene of at most
24 leaves): bytes a call moves.

Frozen from ``chip_smoke.bound_k1`` at commit 4da45c6: a lane reads o, d,
thr, strength, alive, u_coin, u3 (57 B) and writes t, o2, d2, thr2,
strength2, u_sel, evt (56 B), five decision bytes and mat_id (int64):
126 bytes.  Its operation count is left out: the walk visits a number of
events a lane that only the program's own hit can count
(``chip_smoke.walk_visits``), and the old count of the 4·L² fold measured
work K1 no longer does.  K1's share rests on bytes alone.
"""

BYTES_PER_LANE = 126


def bytes_moved(lanes: int) -> int:
    return BYTES_PER_LANE * lanes


def operations(lanes: int, n_leaves: int):
    return None
