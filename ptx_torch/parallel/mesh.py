"""The (tiles × samples) device mesh over ``torch.distributed`` (port of
``ptx/parallel/mesh.py``).

One rank per device.  The ``tiles`` axis shards the image rows: each rank
renders its row band, with no communication until the frame is gathered.
The ``samples`` axis shards the samples per pixel: each rank renders its
band at ``spp / samples`` and an all-reduce over the sample group averages
the estimates; training steps average the gradients over both axes.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` of shape
``(tiles, samples)`` with those dimension names over the initialised
world (:func:`ptx_torch.parallel.dist.initialize`).  A process without a
process group gets a :class:`LocalMesh`, the 1×1 mesh on its own device
that runs no collective: what a single-process JAX run on one chip gets
from ``jax.devices()``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def rank_device(device=None) -> torch.device:
    """``device``, else ``cuda:<LOCAL_RANK>`` (``LOCAL_RANK`` as torchrun
    sets it, 0 when unset).  A CPU device must be asked for."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The 1×1 mesh of a process without a process group: tile 0, sample
    0, on ``device``; it has no groups, so the renders run no collective."""
    device: torch.device
    mesh_dim_names = (TILE_AXIS, SAMPLE_AXIS)
    shape = (1, 1)

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, mesh_dim):
        return None


def make_mesh(tiles: int | None = None, samples: int = 1, device=None):
    """A ``(tiles, samples)`` mesh over every rank of the world, each rank
    on :func:`rank_device` ``(device)`` (a CUDA device unless a CPU one is
    asked for; a CPU mesh needs a gloo world).  Default: every rank on
    the tile axis.  Without a process group, a :class:`LocalMesh`."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if tiles is None:
        tiles = n // samples
    if tiles * samples != n:
        raise ValueError(f"{tiles}×{samples} mesh != {n} devices")
    device = rank_device(device)
    if not dist.is_initialized():
        return LocalMesh(device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, (tiles, samples),
                            mesh_dim_names=(TILE_AXIS, SAMPLE_AXIS))


def mesh_shape(mesh) -> tuple[int, int]:
    """``(tiles, samples)``."""
    tiles, samples = mesh.shape
    return tiles, samples


def coordinate(mesh) -> tuple[int, int]:
    """This rank's ``(tile_idx, samp_idx)``."""
    tile_idx, samp_idx = mesh.get_coordinate()
    return tile_idx, samp_idx


def image_rows(mesh, height: int) -> tuple[int, int]:
    """This rank's row band ``(y0, rows)`` of a ``height``-row image, rows
    sharded over tiles and replicated over samples (the counterpart of
    ``image_sharding``)."""
    tiles, _ = mesh_shape(mesh)
    rows = height // tiles
    return coordinate(mesh)[0] * rows, rows


def mesh_device(mesh) -> torch.device:
    """The device this rank renders on: a :class:`LocalMesh`'s own, else
    the mesh's device type at the current CUDA device (the one
    :func:`ptx_torch.parallel.dist.initialize` set)."""
    if isinstance(mesh, LocalMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_params(params: dict, mesh) -> dict:
    """The params on this rank's device (:func:`mesh_device`), the same
    values on every rank: each tensor (list entries one by one) is
    broadcast from rank 0 of the world when a process group is
    initialised.  Scene params are small (geometry and material tables,
    textures): they are replicated."""
    device = mesh_device(mesh)

    def place(x):
        x = x.detach().to(device, copy=True).contiguous()
        if dist.is_initialized():
            dist.broadcast(x, src=0)
        return x
    return {k: ([place(x) for x in v] if isinstance(v, list) else place(v))
            for k, v in params.items()}
