"""The sweep-select kernel K9: the select of the union sweep's ``kernel``
mode.

Port of ``ptx/ops/sweep_kernel.py`` ``build_sweep_select`` (:164), a Pallas
TPU kernel, as the hand-written CUDA kernel ``ptx_torch/csrc/sweep_kernel.cu``.
From the S pooled coverage intervals ``(s, e)`` of a union (valid-masked:
``s = PAD_T``, ``e = NEG`` where invalid) and the L raw leaf intervals
``(t0, t1)``, each (rows, B) float32, it computes per ray the exclusive
prefix max ``P`` of ``e`` over the rows sorted by ``s``, the breaks (``s <
2e20`` and ``s > P``), the entry and exit candidate minima, and the
payload: the least leaf whose raw ``t0`` (``m_start``), and the least whose
raw ``t1`` (``m_end``), equals ``t_star`` bit for bit, ``L`` where none
does.  With ``sort=True`` it sorts ``(s, e)`` by ``s`` itself (a bitonic
network in registers, one warp a lane); with ``sort=False`` they come
sorted.

- :func:`sweep_select_reference` is K9's plain PyTorch version (a stable
  sort, ``cummax``, the same masks), on any device and dtype; the union
  sweep's ``sort`` mode is this function (``ptx/geom/fasthit.py:953-999``).
- :func:`sweep_select` is K9's wrapper: CUDA tensors launch the kernel or
  raise; CPU tensors, and only those, run the plain version.  ``LAUNCHES``
  and ``REFERENCE_CALLS`` count the two.
- :func:`sort_inside` is the kernel mode's route: ``sort=True`` on the
  unsorted intervals up to ``SORT_INSIDE_ROWS`` padded rows, else a stable
  ``torch.sort`` and ``sort=False``.

The outputs are ``(t_star, entering, m_start, m_end, found)``, each (B,):
float32, bool, int32, int32, bool.
"""

from __future__ import annotations

import torch

from ptx_torch.ops import _build
from ptx_torch.ops._build import _check_inputs, _ptr, _raise_on, _stream

PAD_T = 3e20                 # start padding and "no candidate"
NEG = -3e20                  # end padding: never extends a chain
FOUND = 2e20                 # t_star below this is a boundary
SORT_TILE_BYTES = 73728      # a sort=True block's (s, e) columns at most (csrc/sweep_kernel.cu)
MAX_SORT_ROWS = 1024         # a lane's column sorted in registers: 32 entries a thread
# Kernel mode sorts inside K9 up to this many padded rows (the most its
# register sort holds), else runs torch.sort and sort=False.  On an H100
# (chip_smoke.py E5, PERF.md section 6) sorting inside beat the torch.sort
# route 10-18x at Sp 256 and 512 at every width of a train step and a
# chunk: no crossover below the kernel's limit.
SORT_INSIDE_ROWS = MAX_SORT_ROWS

LAUNCHES = 0
REFERENCE_CALLS = 0


def padded_rows(S: int) -> int:
    """The sort=True kernel's row count: a power of 2 of at least 8 and S
    (the TPU kernel's ``Sp``; the kernel sorts columns of at least 32)."""
    return max(8, 1 << (S - 1).bit_length())


def tile_width(Sp: int) -> int | None:
    """The widest tile (lanes a block, a power of 2 up to 16: on an H100 16
    beat 32 at Sp 256, PERF.md) of the sort=True kernel whose (s, e) columns
    of ``max(32, Sp) + 1`` rows fit ``SORT_TILE_BYTES``, or None past
    ``MAX_SORT_ROWS`` rows."""
    rows = max(32, Sp)
    if rows > MAX_SORT_ROWS:
        return None
    return next(bw for bw in (16, 8, 4, 2, 1) if 8 * bw * (rows + 1) <= SORT_TILE_BYTES)


def lane_tile(B: int) -> int:
    """The sort=False kernel's lanes a block (32, 16 or 8; 256 / that many
    segments a lane): the widest that still gives some 4 blocks on each of
    the card's 132 SMs at B lanes."""
    return next((bw for bw in (32, 16) if B >= bw * 4 * 132), 8)


def sort_inside(S: int) -> bool:
    """Whether kernel mode calls K9 with ``sort=True`` on S unsorted rows."""
    return padded_rows(S) <= SORT_INSIDE_ROWS


def sweep_select_reference(s, e, t0, t1, L: int, eps: float, sort: bool):
    """K9's plain version, in PyTorch.  ``s``, ``e`` (S, B); ``t0``,
    ``t1`` (L, B); with ``sort`` the rows are stable-sorted by ``s`` here,
    else they must come sorted.  Returns ``(t_star, entering, m_start,
    m_end, found)``."""
    if sort:
        s, idx = torch.sort(s, dim=0, stable=True)
        e = e.gather(0, idx)
    inc = torch.cummax(e, dim=0).values
    p = torch.cat([torch.full_like(e[:1], NEG), inc[:-1]])
    is_break = (s < FOUND) & (s > p)
    te = torch.where(is_break & (s >= eps), s, PAD_T).amin(0)
    tx = torch.where(is_break & (p >= eps), p, PAD_T).amin(0)
    tx = torch.minimum(tx, torch.where(inc[-1] >= eps, inc[-1], PAD_T))
    t_star = torch.minimum(te, tx)
    return (t_star, te <= tx, *payload_match(t0, t1, t_star, L), t_star < FOUND)


def payload_match(t0, t1, t_star, L: int):
    """``(m_start, m_end)``, int32: the least leaf whose raw ``t0``, and the
    least whose raw ``t1``, equals ``t_star`` bit for bit; ``L`` where none
    does (``ptx/geom/fasthit.py:984-998``)."""
    lf = torch.arange(L, dtype=torch.int32, device=t0.device)[:, None]
    sentinel = torch.tensor(L, dtype=torch.int32, device=t0.device)
    return (torch.where(t0 == t_star[None], lf, sentinel).amin(0),
            torch.where(t1 == t_star[None], lf, sentinel).amin(0))


def sweep_select(s, e, t0, t1, L: int, eps: float, sort: bool = False):
    """K9 as the sweep calls it: the kernel on CUDA tensors (or a raise),
    the plain version on CPU tensors."""
    global REFERENCE_CALLS
    if s.device.type == "cpu":
        REFERENCE_CALLS += 1
        return sweep_select_reference(s, e, t0, t1, L, eps, sort)
    if s.device.type != "cuda":
        raise ValueError(f"sweep-select kernel: no kernel for {s.device}")
    return launch(s, e, t0, t1, L, eps, sort)


def launch(s, e, t0, t1, L: int, eps: float, sort: bool = False, out=None, tile=None):
    """One kernel launch on the current stream, no synchronisation.  ``out``
    optionally gives the five outputs (as returned), ``tile`` the lanes a
    block (default :func:`lane_tile` / :func:`tile_width`)."""
    global LAUNCHES
    S, B = s.shape
    device = s.device
    _check_inputs("sweep-select kernel", device, {
        "s": (s, (S, B), torch.float32), "e": (e, (S, B), torch.float32),
        "t0": (t0, (L, B), torch.float32), "t1": (t1, (L, B), torch.float32)})
    if S == 0 or L == 0 or B == 0:
        raise ValueError(f"sweep-select kernel: empty input (S={S}, L={L}, B={B})")
    Sp = padded_rows(S) if sort else S
    bw = tile or (tile_width(Sp) if sort else lane_tile(B))
    if bw is None:
        raise NotImplementedError(
            f"sweep-select kernel: {Sp} sorted rows exceed the in-kernel sort's "
            f"{MAX_SORT_ROWS} (a lane's column in registers and in shared memory)")
    lib = _build.library()
    dtypes = (torch.float32, torch.bool, torch.int32, torch.int32, torch.bool)
    if out is None:
        out = tuple(torch.empty(B, dtype=dt, device=device) for dt in dtypes)
    _check_inputs("sweep-select kernel", device, {
        f"out[{i}]": (x, (B,), dt) for i, (x, dt) in enumerate(zip(out, dtypes, strict=True))})
    err = lib.ptx_sweep_select(_ptr(s), _ptr(e), S, _ptr(t0), _ptr(t1), L, B, float(eps),
                               int(bool(sort)), Sp, bw, *(_ptr(x) for x in out),
                               _stream(device))
    _raise_on(err, lib, "sweep-select kernel")
    LAUNCHES += 1
    return out
