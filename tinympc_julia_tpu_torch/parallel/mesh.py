"""The device mesh of the port (counterpart of
tinympc_julia_tpu/parallel/mesh.py).

A mesh is the default ``torch.distributed`` process group, one rank per
device, or a world of one where no group is initialised.  A batch of
instances is split into contiguous rank blocks on the leading axis: rank r
holds rows ``r*B/world : (r+1)*B/world`` on its own device.  Where one JAX
process drives several local devices, the port runs one rank per device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..types import map_tensors

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this rank's place in the group and its device.
    ``group`` is None in a world of one without a process group."""
    world: int
    rank: int
    device: torch.device
    group: Any = None
    axis_name: str = BATCH_AXIS

    @property
    def shape(self) -> dict:
        """The JAX mesh's ``shape``: axis name -> number of ranks."""
        return {self.axis_name: self.world}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tree's leading axis lies on the mesh: split into rank blocks
    (``axis_name`` set) or whole on every rank (``axis_name`` None)."""
    mesh: Mesh
    axis_name: Optional[str]

    def local(self, tree):
        """This rank's part of a global tree (a Problem, Cache, State or
        tensor), on the mesh's device.  A split needs a leading axis that
        the mesh size divides."""
        mesh = self.mesh
        if self.axis_name is None:
            return _map(lambda a: a.to(mesh.device), tree)
        B = leading_size(tree)
        check_divisible(B, mesh.world)
        b = B // mesh.world
        lo = mesh.rank * b
        return _map(lambda a: a[lo:lo + b].to(mesh.device).contiguous(),
                    tree)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return map_tensors(fn, tree)


def leading_size(tree) -> int:
    """The leading (instance) axis of a tensor or a tree's first field."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    first = getattr(tree, dataclasses.fields(tree)[0].name)
    return first.shape[0]


def check_divisible(B: int, world: int) -> None:
    """The JAX package's refusal of a batch the mesh does not divide."""
    if B % world != 0:
        raise ValueError(f"batch {B} not divisible by mesh size {world}")


def make_mesh(n_devices: Optional[int] = None, *, device=None,
              axis_name: str = BATCH_AXIS) -> Mesh:
    """The mesh of the default process group (a world of one without one).

    ``n_devices``, where given, must equal the world size.  A rank's device
    is ``device`` where it names one; for ``None`` or ``"cuda"`` it is the
    card ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` from the
    environment, else the rank), and without CUDA this raises: there is no
    CPU fallback."""
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, but the "
                         f"process group has {world} ranks (one a device)")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "device= to run the mesh elsewhere")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(world=world, rank=rank, device=device, group=group,
                axis_name=axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = BATCH_AXIS) -> Sharding:
    """Split the leading (instance) axis into rank blocks."""
    return Sharding(mesh, axis_name)


def replicated(mesh: Mesh) -> Sharding:
    """Whole on every rank."""
    return Sharding(mesh, None)


def shard_state(state, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """This rank's block of a global batched workspace (every rank builds
    the same one, from the same seed), on the mesh's device."""
    return batch_sharding(mesh, axis_name).local(state)
