"""Device meshes of the LM plane on ``torch.distributed``.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` whose
dims carry the reference's axis names: ``("data", "model")`` on one pod,
``("pod", "data", "model")`` across pods.  The sharding rules
(:mod:`.sharding`) read only a mesh's axis names and sizes, so they also
take an :class:`AbstractMesh` (the reference's
``jax.sharding.AbstractMesh``): the production shapes resolve without
256 processes.

Nothing here runs at import.  The reference's ``HARDWARE`` table (TPU
figures, read by its dry-run and roofline tools) comes with those tools,
and there holds the H100's own figures.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

__all__ = ["AbstractMesh", "axis_sizes", "make_production_mesh",
           "make_smoke_mesh"]

#: the reference's production meshes: ``multi_pod`` → (shape, axis names)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes alone, with no devices or process
    groups: the argument order of ``jax.sharding.AbstractMesh``."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if (len(self.axis_sizes) != len(self.axis_names)
                or len(set(self.axis_names)) != len(self.axis_names)):
            raise ValueError(f"axis sizes {self.axis_sizes} and unique names "
                             f"{self.axis_names} must pair up")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}`` in the mesh's order."""
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_sizes(mesh: DeviceMesh | AbstractMesh) -> dict[str, int]:
    """``{axis name: size}`` of a named ``DeviceMesh`` or an
    :class:`AbstractMesh`, in the mesh's dim order."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the mesh's dims need names")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """The reference's ``(16, 16)`` ``("data", "model")`` mesh, or with
    ``multi_pod`` the ``(2, 16, 16)`` ``("pod", "data", "model")`` mesh,
    over the running process group's ranks.

    :raises ValueError: unless the group has exactly as many ranks as the
        mesh has places (the reference raises without as many devices).
    """
    shape, names = PRODUCTION[multi_pod]
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_smoke_mesh(*, device: str = "cuda") -> DeviceMesh:
    """The one-rank ``(1, 1)`` mesh with the production axis names.  With
    no process group running, it starts a one-rank gloo group on an
    in-memory store (no network).

    :raises ValueError: if the running group has more than one rank.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_world_size() != 1:
        raise ValueError("the smoke mesh is one rank; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
