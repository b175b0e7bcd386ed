"""Material parameter table (port of ``ptx/shade/materials.py``).

A material is 5 texture slots plus an index of refraction
(the reference's ``include/material.h:10-37``): ``reflect`` tint,
``scatter`` (0 mirror → 1 diffuse), ``emissive`` radiance, ``transmit``
tint, ``transmit_reflect`` (0 reflect → 1 transmit) and ``ior``.

Constant slots resolve through one packed per-material row, gathered by
material id; the JAX package's one-hot MXU lookups
(``ptx/ops/tableops.py``) become a plain gather here.  Position-dependent
slots evaluate per lane and override their material's lanes.

:meth:`MaterialTable.rows` builds every per-material row the port packs,
from one gather of the const table: the plain shading's (``SHADE_ROW``),
the fused bounce kernels' (K1, K5: ``BOUNCE_ROW``) and the replay
backward's (K2, K6: ``REPLAY_ROW``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ptx_torch.geom import tape
from ptx_torch.shade import textures as tx

SLOTS = ("reflect", "scatter", "emissive", "transmit", "transmit_reflect")

# Per-material row layouts (MaterialTable.rows): a slot's name is its 3
# channels, ``<slot>_f`` its channel mean (mean3), ``ior`` the ior.
SHADE_ROW = SLOTS + ("ior",)                                     # (M, 16)
# the scalars the fused bounce kernels K1 and K5 shade with — must match
# ptx_torch/csrc/shade_lane.cuh
BOUNCE_ROW = ("reflect", "scatter_f", "transmit", "transmit_reflect_f", "ior")   # (M, 9)
# the material scalars the replay backward K2 / K6 differentiates — must
# match ptx_torch/csrc/replay_lane.cuh
REPLAY_ROW = ("reflect", "scatter_f", "transmit", "ior")                         # (M, 8)


def _as_tex(v):
    if isinstance(v, (int, float)):
        return tx.Constant(float(v))
    if isinstance(v, (tuple, list, np.ndarray)):
        return tx.Constant(np.asarray(v, np.float32))
    return v


@dataclasses.dataclass(frozen=True, eq=False)
class Material:
    """Slot defaults mirror the reference constructor (material.h:18-21)."""
    reflect: Any = 1.0
    scatter: Any = 1.0
    emissive: Any = 0.0
    transmit: Any = 0.0
    ior: float = 1.0
    transmit_reflect: Any = 0.0

    def __post_init__(self):
        for f in SLOTS:
            object.__setattr__(self, f, _as_tex(getattr(self, f)))


def transform_material(A, mat: Material) -> Material:
    """``transform(Matrix, Material*)``: every slot's lookup coordinates
    move; ior is unchanged (material.h:39-42)."""
    return Material(
        reflect=tx.transform_texture(A, mat.reflect),
        scatter=tx.transform_texture(A, mat.scatter),
        emissive=tx.transform_texture(A, mat.emissive),
        transmit=tx.transform_texture(A, mat.transmit),
        ior=mat.ior,
        transmit_reflect=tx.transform_texture(A, mat.transmit_reflect),
    )


def mean3(v):
    """Channel mean ``(v0 + v1 + v2) / 3`` — the scalar lookup of a colour
    slot (texture.h:14-18), in one fixed summation order."""
    return (v[..., 0] + v[..., 1] + v[..., 2]) / 3.0


def _const_zero(texn) -> bool:
    return (isinstance(texn, tx.Constant)
            and not np.any(np.asarray(texn.color, np.float32)))


class MaterialTable:
    """The compiled material table: ``table(params, pos, mat_id)``
    evaluates every slot at positions ``pos`` (..., 3) for material ids
    ``mat_id`` (...,) and returns the slot colours (..., 3) plus
    ``scatter_f``, ``transmit_reflect_f`` and ``ior`` (...,).

    Attributes the integrator and the bounce kernel read:

    - ``const_idx[slot]``: (M,) row of ``params["const"]`` per material
      (the zero placeholder row for a dynamic slot); :meth:`const_rows`
      is the same on a device, copied there once;
    - ``dynamic_slots[slot]``: material ids whose slot is per-position;
    - ``terminal_dynamic_emissive``: ``(mi, fn)`` for dynamic emissive
      chains of *terminal* materials (reflect ≡ transmit ≡ 0), which
      ``trace_rays`` evaluates on one selected lane per path;
    - ``emissive_dynamic_specs``: ``(mi, spec)`` of every dynamic emissive
      chain (the texture closures' ``.spec``), which the fused emission
      kernel's eligibility reads.
    """

    def __init__(self, materials, compiler: tx.TextureCompiler):
        M = len(materials)
        self.n_materials = M
        self.const_idx = {s: np.zeros(M, np.int64) for s in SLOTS}
        self._dynamic = {s: [] for s in SLOTS}       # (material, fn)
        zero_idx = None
        for mi, m in enumerate(materials):
            for s in SLOTS:
                texn = getattr(m, s)
                if isinstance(texn, tx.Constant):
                    self.const_idx[s][mi] = len(compiler.params["const"])
                    compiler.compile(texn)
                else:
                    if zero_idx is None:
                        zero_idx = len(compiler.params["const"])
                        compiler.compile(tx.Constant(0.0))
                    self.const_idx[s][mi] = zero_idx
                    self._dynamic[s].append((mi, compiler.compile(texn)))
        self.dynamic_slots = {s: [mi for mi, _ in self._dynamic[s]]
                              for s in SLOTS}
        terminal = {mi for mi, m in enumerate(materials)
                    if _const_zero(m.reflect) and _const_zero(m.transmit)}
        self.terminal_dynamic_emissive = [
            (mi, fn) for mi, fn in self._dynamic["emissive"] if mi in terminal]
        self.emissive_dynamic_specs = [(mi, fn.spec)
                                       for mi, fn in self._dynamic["emissive"]]
        self._dev: dict = {}

    def const_rows(self, slot, device) -> torch.Tensor:
        """``const_idx[slot]`` as an int64 tensor on ``device``, built once
        per device: a copy from the host at every call would synchronise
        the device with it."""
        key = (slot, torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.const_idx[slot], device=device)
        return self._dev[key]

    def rows(self, params, layout=SHADE_ROW) -> torch.Tensor:
        """The (M, width) per-material rows of ``layout`` (``SHADE_ROW``,
        ``BOUNCE_ROW``, ``REPLAY_ROW``) from ``params``, with their autograd
        history: one gather of every slot's const row, then the columns in
        ``layout``'s order."""
        const = params["const"]
        key = ("slots", const.device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(
                np.stack([self.const_idx[s] for s in SLOTS], axis=1).reshape(-1),
                device=const.device)
        slot = const[self._dev[key]].reshape(self.n_materials, len(SLOTS), 3)
        cols = []
        for name in layout:
            if name == "ior":
                cols.append(params["ior"][:, None])
            elif name.endswith("_f"):
                cols.append(mean3(slot[:, SLOTS.index(name[:-2])])[:, None])
            else:
                cols.append(slot[:, SLOTS.index(name)])
        return torch.cat(cols, dim=1)

    def __call__(self, params, pos, mat_id):
        # (..., 16); index_select for its index_add_ transpose (hitreplay)
        row = self.rows(params).index_select(0, mat_id.reshape(-1)).reshape(
            *mat_id.shape, 16)
        out = {}
        for i, s in enumerate(SLOTS):
            val = row[..., 3 * i:3 * i + 3]
            for mi, fn in self._dynamic[s]:
                val = torch.where((mat_id == mi)[..., None], fn(params, pos), val)
            out[s] = val
        out["scatter_f"] = mean3(out["scatter"])
        out["transmit_reflect_f"] = mean3(out["transmit_reflect"])
        out["ior"] = row[..., 15]
        return out

    def _emissive(self, params, pos, mat_id, skip=()):
        const = params["const"]
        idx = self.const_rows("emissive", const.device)
        # index_select, not [mat_id]: its transpose is index_add_, where that
        # of [mat_id] sorts every record to sum a few rows (2.9 s of a large
        # scene's train step on the card, all-constant emission)
        val = const[idx].index_select(0, mat_id.reshape(-1)).reshape(mat_id.shape + (3,))
        for mi, fn in self._dynamic["emissive"]:
            if mi not in skip:
                val = torch.where((mat_id == mi)[..., None], fn(params, pos), val)
        return val

    def eval_emissive(self, params, pos, mat_id):
        """The emissive slot alone (the rest are bounce-kernel inputs)."""
        return self._emissive(params, pos, mat_id)

    def eval_emissive_base(self, params, pos, mat_id):
        """Emission without the terminal dynamic chains: their lanes are
        exact zero; ``trace_rays`` adds those chains back on the lanes the
        sky-select picks."""
        term = {mi for mi, _ in self.terminal_dynamic_emissive}
        val = self._emissive(params, pos, mat_id, skip=term)
        for mi in term:
            val = torch.where((mat_id == mi)[..., None], 0.0, val)
        return val


def compile_material_table(materials_in_id_order,
                           compiler: tx.TextureCompiler, device):
    """Compile materials → ``(params_contrib, table)``; ``params_contrib``
    holds ``ior`` (M,) on ``device``."""
    iors = torch.tensor([m.ior for m in materials_in_id_order],
                        dtype=torch.float32, device=device)
    return {"ior": iors}, MaterialTable(materials_in_id_order, compiler)


def assign_material_ids(root) -> tuple:
    """Distinct materials of a geometry tree in first-seen order.
    Returns ``(ordered materials, {id(mat): index})``."""
    ordered, ids = [], {}

    def walk(node):
        if isinstance(node, (tape.Sphere, tape.Plane)):
            if id(node.material) not in ids:
                ids[id(node.material)] = len(ordered)
                ordered.append(node.material)
        elif isinstance(node, tape.Transformed):
            walk(node.obj)
        elif isinstance(node, (tape.Union, tape.Intersection)):
            for c in node.objects:
                walk(c)
        elif isinstance(node, tape.Difference):
            walk(node.a)
            walk(node.b)
        else:
            raise TypeError(f"unknown scene node {type(node)!r}")

    walk(root)
    return ordered, ids
