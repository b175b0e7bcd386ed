"""Material parameter table (port of ``ptx/shade/materials.py``).

A material is 5 texture slots plus an index of refraction
(the reference's ``include/material.h:10-37``): ``reflect`` tint,
``scatter`` (0 mirror → 1 diffuse), ``emissive`` radiance, ``transmit``
tint, ``transmit_reflect`` (0 reflect → 1 transmit) and ``ior``.

Constant slots resolve through one packed per-material row, gathered by
material id; the JAX package's one-hot MXU lookups
(``ptx/ops/tableops.py``) become a plain gather here.  Position-dependent
slots evaluate per lane and override their material's lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ptx_torch.shade import textures as tx

SLOTS = ("reflect", "scatter", "emissive", "transmit", "transmit_reflect")


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
      (the zero placeholder row for a dynamic slot);
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

    def packed(self, params) -> torch.Tensor:
        """(M, 16) per-material row: the 5 constant slots then ior."""
        const = params["const"]
        idx = {s: torch.as_tensor(v, device=const.device)
               for s, v in self.const_idx.items()}
        return torch.cat([const[idx[s]] for s in SLOTS]
                         + [params["ior"][:, None]], dim=1)

    def __call__(self, params, pos, mat_id):
        # (..., 16); index_select for its index_add_ transpose (hitreplay)
        row = self.packed(params).index_select(0, mat_id.reshape(-1)).reshape(
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
        idx = torch.as_tensor(self.const_idx["emissive"], device=const.device)
        val = const[idx][mat_id]
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
    from ptx_torch.geom import tape

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
