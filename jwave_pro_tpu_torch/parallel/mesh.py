"""Device meshes over ``torch.distributed``.

Counterpart of ``jwave_pro_tpu/parallel/mesh.py``; same names.  A mesh is a
``DeviceMesh`` whose named dims map the library's parallelism dimensions:

  * ``data``   — batch axis (embarrassingly parallel)
  * ``signal`` — the time axis of long signals (halo exchanges ride the
                 ring as point-to-point hops)
  * ``scale``  — CWT scale axis / WPT packet axis

Each rank is one process on one device.  NCCL carries the collectives on
the card and gloo on the CPU; :func:`init_distributed` starts the process
group, and :func:`make_mesh` starts a one-rank group by itself when the
mesh has one rank, as the JAX package's meshes need no set-up on one
device.
"""
from __future__ import annotations

import datetime
import math
import os
import typing

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (
    DTensor, Placement, Replicate, Shard, distribute_tensor,
)

__all__ = ["make_mesh", "P", "NamedSharding", "shard_batch", "shard_signal",
           "init_distributed"]


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL backend for 'cuda' "
                               "meshes")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unknown device type {device_type!r} (cuda or cpu)")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device_type: str = "cuda",
                     timeout: float | None = None) -> None:
    """Start this process's rank of the process group.

    ``coordinator_address``: ``host:port`` of rank 0 (or a full init URL,
    ``tcp://…`` or ``file://…``); with ``None`` the address, world size and
    rank come from the environment torchrun sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``device_type='cuda'``
    uses NCCL and first selects the card ``LOCAL_RANK`` names (else the
    rank modulo the cards); ``'cpu'`` uses gloo.  There is no fallback:
    without NCCL a 'cuda' group raises.  ``timeout``: seconds a collective
    may wait (torch's default when None).  Call once per process, before
    :func:`make_mesh`.
    """
    backend = _backend(device_type)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = rank if rank >= 0 else os.environ.get("RANK", 0)
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)


def make_mesh(shape: dict[str, int] | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """Build a mesh over every rank; default: all ranks on one ``data`` axis.

    ``shape`` maps axis name → size, e.g. ``{"data": 2, "signal": 4}``;
    the sizes multiply to the world size.  Without a process group a mesh
    of one rank starts a one-rank group in memory; a larger one needs
    :func:`init_distributed` first.
    """
    if not dist.is_initialized():
        size = 1 if shape is None else math.prod(shape.values())
        if size != 1:
            raise RuntimeError(
                f"mesh {shape} needs {size} ranks and no process group is "
                "running: call init_distributed in every process first")
        dist.init_process_group(_backend(device_type),
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world}
    sizes = tuple(int(s) for s in shape.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(sizes)} devices, "
                         f"have {world}")
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=tuple(shape.keys()))


class P(tuple):
    """Partition spec: for each dim of a tensor, the name of the mesh dim it
    is sharded over, or None (the JAX ``PartitionSpec``)."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def placements(mesh: DeviceMesh, spec) -> tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the mesh
    dim a tensor dim ``d`` names, ``Replicate()`` on the others."""
    names = tuple(mesh.mesh_dim_names or ())
    unknown = [n for n in spec if n is not None and n not in names]
    if unknown:
        raise ValueError(f"spec {spec} names {unknown}, not axes of the "
                         f"mesh {names}")
    out = []
    for name in names:
        dims = [d for d, n in enumerate(spec) if n == name]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} shards dims {dims} over one "
                             f"mesh axis {name!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


class NamedSharding(typing.NamedTuple):
    """A mesh and a :class:`P` spec; ``.placements`` are DTensor's."""

    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple[Placement, ...]:
        return placements(self.mesh, self.spec)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _place(x, mesh: DeviceMesh, spec) -> DTensor:
    """``x`` (the global value, the same on every rank) as a DTensor:
    each rank keeps its own shard, nothing is sent."""
    x = torch.as_tensor(x, device=mesh_device(mesh))
    return distribute_tensor(x, mesh, placements(mesh, spec),
                             src_data_rank=None)


def shard_batch(x, mesh: DeviceMesh, axis: str = "data") -> DTensor:
    """Place ``x`` with its leading axis sharded over ``axis``."""
    x = torch.as_tensor(x)
    return _place(x, mesh, P(axis, *([None] * (x.ndim - 1))))


def shard_signal(x, mesh: DeviceMesh, axis: str = "signal") -> DTensor:
    """Place ``x`` with its last axis sharded over ``axis``."""
    x = torch.as_tensor(x)
    return _place(x, mesh, P(*([None] * (x.ndim - 1)), axis))
