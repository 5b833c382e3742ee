"""Meshes over the ``torch.distributed`` world (PyTorch port of
``repro.launch.mesh``).

The reference builds its production meshes, (16, 16) ("data", "model")
on one 256-chip TPU v5e pod and (2, 16, 16) ("pod", "data", "model") on
512 chips, and forces the host's placeholder device count through
``XLA_FLAGS`` before JAX starts.  The port's :func:`make_mesh` lays a mesh
over the ranks of the initialised process group with
``torch.distributed.device_mesh.init_device_mesh``: one group per axis,
each axis's size and this rank's coordinate.  The XLA flag functions have
no counterpart.  The ``"data"`` axis carries data and expert parallelism,
the ``"model"`` axis tensor parallelism (``distributed.sharding.
shard_params``).

:func:`init_distributed` starts the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

#: The reference's production meshes as axis-name -> size mappings, in axis
#: order: one 256-chip pod and two pods of 256 chips.
PRODUCTION_MESHES = {"pod": {"data": 16, "model": 16},
                     "multipod": {"pod": 2, "data": 16, "model": 16}}


class Mesh(tuple):
    """A mesh: the tuple of its axis names, with

    * ``sizes`` — axis name -> size, in axis order (the mapping
      ``distributed.sharding``'s spec functions read);
    * ``groups`` — axis name -> process group of the ranks that differ
      only along that axis (None for every axis of a one-rank mesh built
      without a process group);
    * ``coords`` — axis name -> this rank's coordinate."""

    def __new__(cls, axes, sizes, groups, coords):
        self = super().__new__(cls, tuple(axes))
        self.sizes = dict(sizes)
        self.groups = dict(groups)
        self.coords = dict(coords)
        return self


def _check(shape, axes) -> None:
    if len(shape) != len(axes):
        raise ValueError(f"mesh {tuple(shape)} against axes {tuple(axes)}")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the process group's ranks.

    A shape of one device needs no process group: without one, the mesh
    has no groups.  Otherwise the process group must be initialised with
    exactly ``prod(shape)`` ranks, laid out row-major (rank ``d * m +
    j`` of a ``(d, m)`` mesh is data coordinate ``d``, model coordinate
    ``j``); the groups live on the group's device type (``"cuda"`` under
    NCCL, ``"cpu"`` under gloo)."""
    shape = tuple(int(n) for n in shape)
    _check(shape, axes)
    n = math.prod(shape)
    if n == 1 and not dist.is_initialized():
        return Mesh(axes, zip(axes, shape), {a: None for a in axes},
                    {a: 0 for a in axes})
    if not dist.is_initialized():
        raise ValueError(f"mesh {shape} needs {n} ranks; initialise the "
                         "process group first (torchrun, or "
                         "init_distributed)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {shape} needs {n} ranks; the process group "
                         f"has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(kind, shape, mesh_dim_names=tuple(axes))
    return Mesh(axes, zip(axes, shape),
                {a: dm.get_group(a) for a in axes},
                {a: dm.get_local_rank(a) for a in axes})


def mesh_of(mesh, axes=("data", "model")) -> Optional[Mesh]:
    """``mesh`` as a :class:`Mesh`: None stays None, a shape is laid out
    by :func:`make_mesh` over ``axes``."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return make_mesh(tuple(mesh), axes)


def init_distributed(device: str = "cuda") -> None:
    """Initialise the default process group from torchrun's environment
    when ``WORLD_SIZE`` is above 1 and none is: NCCL on ``"cuda"`` (each
    rank on card ``LOCAL_RANK``), gloo on ``"cpu"``.  A group that fails
    to initialise raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    rank = int(os.environ["RANK"])
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, which one card cannot hold."""
    shape = tuple(PRODUCTION_MESHES["multipod" if multi_pod
                                    else "pod"].values())
    n = math.prod(shape)
    raise RuntimeError(f"the production mesh {shape} needs {n} chips; the "
                       "port runs on one card (launch.dryrun counts each "
                       "cell on it)")
