"""K5 (``megasweep_kernel`` in bounce mode, the fused bounce of a union of
more than 24 leaves): bytes a call moves.

Frozen from ``chip_smoke.bound_k5`` at commit 4da45c6: a lane moves the
126 bytes of K1's lane (its inputs, its carry, its decisions).  Its
operation count is left out: the kernel culls 64-row clusters a warp, so
the rows a lane evaluates are what the cull leaves, which only the
program's own cull lists can count; ``bound_k5``'s 25 operations for
every row and lane count the most the kernel could do.  K5's share rests
on bytes alone.
"""

BYTES_PER_LANE = 126


def bytes_moved(lanes: int) -> int:
    return BYTES_PER_LANE * lanes


def operations(lanes: int, n_leaves: int):
    return None
