"""The numbers that decide ``correct``, each held to its limit.

Training cells (the first three steps of the chain the window continues,
run through the window's own step, against the reference's three steps
from the same inputs):

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the three steps;
- ``grad_gap``: the first gradient as the optimizer applied it,
  ``(p0 − p1) / learning_rate`` per leaf (a parameter table or an
  image), on each side from its own float32 state; the largest gap between
  the two sides' norms over the leaves, against the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the gap of the change after three steps, ``p3 − p0``,
  taken as ``grad_gap``'s per leaf, of the median leaf: the median over
  the leaves.  Not the worst leaf: a leaf whose change over three steps is
  a few float32 steps of its values (a sphere's radius moves ~1e-7 a step
  at a learning rate of 1e-4) reads 6e-4 when one value rounds to its
  neighbour on one side, while a step that is skipped or doubled moves
  every leaf.

Training cells also hold one step of the window, taken by the reference
from the program's parameters before it:

- ``window_loss_gap``: the relative gap of that step's loss;
- ``window_grad_gap``: the gap of its applied gradient, ``(before −
  after) / learning_rate``, per leaf as ``grad_gap``'s, of the median
  leaf as ``change_gap``'s: an update is ~100 float32 steps of a value
  near 1, and where one value of the program's rounds to its neighbour
  the worst leaf reads up to 1e-3 while a step half the batch reads
  ~1e-2.

Leaves whose reference gradient is under a thousandth of the median
leaf's (the rule, not a list of names) are left out of the gradients' and
the change's gaps: those move by round-off alone.

Render cells: ``band_gap``, the largest ``Σ|program − reference| /
Σ|reference|`` over the bands checked.

A number that is not finite reads as infinite.
"""

from __future__ import annotations

import math
import statistics

import torch

ZERO_GRAD_SHARE = 1e-3


def _f(x) -> float:
    x = float(x)
    return x if math.isfinite(x) else math.inf


def _norms(a: dict, b: dict, scale: float = 1.0) -> dict:
    return {k: _f(torch.linalg.vector_norm((a[k].double() - b[k].double()))) / scale
            for k in a}


def _leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Per leaf of ``keep``, the gap of the two norms against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; all infinite where a norm of the program's is not finite."""
    if not all(math.isfinite(prog[k]) for k in keep):
        return [math.inf] * max(1, len(keep))
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) else 0.0
            for k in keep] or [0.0]


def _gap(prog: dict, ref: dict, keep) -> float:
    return max(_leaf_gaps(prog, ref, keep))


def _loss_gap(prog, ref) -> float:
    return abs(_f(prog) - _f(ref)) / abs(_f(ref)) if _f(ref) else math.inf


def _moved(grad_norms: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= ZERO_GRAD_SHARE * med]


def train_numbers(prog: dict, ref: dict, learning_rate: float) -> dict:
    """``prog`` and ``ref``: ``losses`` (3 floats) and ``p0``, ``p1``,
    ``p3`` (leaf name → CPU tensor, empty leaves left out); ``ref`` also
    ``grad_norms`` (leaf → the reference's autograd gradient norm of step
    one)."""
    if set(prog["p0"]) != set(ref["p0"]):
        raise ValueError(f"the program's leaves {sorted(prog['p0'])} are not the "
                         f"reference's {sorted(ref['p0'])}")
    loss_gap = max(_loss_gap(a, b) for a, b in zip(prog["losses"], ref["losses"]))
    keep = _moved(ref["grad_norms"])
    g_p = _norms(prog["p0"], prog["p1"], learning_rate)
    g_r = _norms(ref["p0"], ref["p1"], learning_rate)
    c_p = _norms(prog["p3"], prog["p0"])
    c_r = _norms(ref["p3"], ref["p0"])
    return {"loss_gap": _f(loss_gap), "grad_gap": _gap(g_p, g_r, keep),
            "change_gap": statistics.median(_leaf_gaps(c_p, c_r, keep))}


def window_numbers(prog: dict, ref: dict, learning_rate: float) -> dict:
    """``prog`` and ``ref``: one step's ``loss``, and ``before`` and
    ``after`` (leaf name → CPU tensor); ``ref`` also ``grad_norms``."""
    if set(prog["after"]) != set(ref["after"]):
        raise ValueError(f"the program's leaves {sorted(prog['after'])} are not the "
                         f"reference's {sorted(ref['after'])}")
    g_p = _norms(prog["before"], prog["after"], learning_rate)
    g_r = _norms(ref["before"], ref["after"], learning_rate)
    return {"window_loss_gap": _f(_loss_gap(prog["loss"], ref["loss"])),
            "window_grad_gap": statistics.median(_leaf_gaps(g_p, g_r,
                                                            _moved(ref["grad_norms"])))}


def band_gap(prog, ref) -> float:
    p, r = prog.double(), ref.double()
    return _f((p - r).abs().sum() / r.abs().sum())


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit;
    ``checks`` maps each name to its value and limit."""
    missing = set(limits) ^ set(numbers)
    if missing:
        raise ValueError(f"numbers and limits disagree on {sorted(missing)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}
    return all(v["value"] <= v["limit"] for v in checks.values()), checks
