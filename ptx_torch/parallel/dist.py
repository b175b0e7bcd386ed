"""Multi-process initialisation (port of ``ptx/parallel/dist.py``).

The reference's multi-node story is a hand-rolled TCP tile farm (the
port's is :mod:`ptx_torch.runtime`).  Under ``torch.distributed`` one
process drives one device: :func:`initialize` joins the process group,
:func:`global_mesh` lays the world out as a (tiles × samples) mesh, and
the renders of :mod:`ptx_torch.parallel.render` exchange bands and
gradients by all-reduce.  A failed process ends the job; progress
survives in the tile checkpoints (:mod:`ptx_torch.parallel.checkpoint`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ptx_torch.parallel.mesh import make_mesh, rank_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group; a no-op for a single process.

    Each of the three comes from its argument or, when that is not given,
    from torchrun's environment: ``MASTER_ADDR`` and ``MASTER_PORT``
    (``host:port``), ``WORLD_SIZE``, ``RANK``.  None of them set is a
    single-process run and a world of 1 needs no group: both do nothing.
    Some but not all of them set is a ``ValueError``.

    The rank's device is :func:`~ptx_torch.parallel.mesh.rank_device`
    ``(device)``, ``cuda:<LOCAL_RANK>`` unless a CPU device is asked for.
    On a CUDA device it becomes the current device before the group is
    made, because the kernels' wrappers launch on the current device
    (``ops/bounce_kernel.py:_stream``): a rank whose tensors live on
    ``cuda:k`` while the current device is 0 would launch on the wrong
    card.  The backend is ``nccl`` on a CUDA device and ``gloo`` on a CPU
    device; neither stands in for the other."""
    env = os.environ.get
    if coordinator_address is None and env("MASTER_ADDR") and env("MASTER_PORT"):
        coordinator_address = f"{env('MASTER_ADDR')}:{env('MASTER_PORT')}"
    if num_processes is None and env("WORLD_SIZE"):
        num_processes = int(env("WORLD_SIZE"))
    if process_id is None and env("RANK"):
        process_id = int(env("RANK"))
    given = (coordinator_address is not None, num_processes is not None,
             process_id is not None)
    if not any(given):
        return                      # single-process run
    if num_processes == 1:
        return
    if not all(given):
        raise ValueError(
            "multi-process init needs all of coordinator_address, num_processes, "
            "process_id (arguments or MASTER_ADDR + MASTER_PORT / WORLD_SIZE / RANK); "
            f"got {given}")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_mesh(tiles: int | None = None, samples: int = 1, device=None):
    """The (tiles × samples) mesh over every rank of the job
    (:func:`~ptx_torch.parallel.mesh.make_mesh`)."""
    return make_mesh(tiles=tiles, samples=samples, device=device)
