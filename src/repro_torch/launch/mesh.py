"""Meshes of the launch tools (counterpart of ``repro.launch.mesh``).

The production meshes are H100 clusters:

* single: ``(data=32, model=8)``, 256 cards;
* multi: ``(pod=2, data=32, model=8)``, 512 cards, the ``pod`` axis a
  second level of data parallelism.

Tensor parallelism (``model``) stays inside one 8-card NVLink domain,
an HGX/DGX H100 node; ``data`` and ``pod`` cross nodes over
InfiniBand.  The card counts are the reference's 256 and 512, so the
dry-run's matrix has the same size.

A :class:`Mesh` is what the sharding rules read: ``shape`` (axis name
-> size) and ``axis_names``, as ``jax.sharding.Mesh`` has them.  A
production mesh also holds a ``torch.distributed`` ``DeviceMesh`` over
a *fake* process group of 256 or 512 ranks (this process is rank 0):
DTensors over it shard fake tensors exactly as they would across the
cluster, and their collectives are recorded but move nothing.  The fake
group comes from ``torch.testing._internal.distributed.fake_pg``, a
private torch module; :func:`fake_world` is the one place that imports
it.  A process group stays initialised until it is destroyed, so the
group lives only inside :func:`fake_world` (or :func:`production_mesh`)
and is destroyed on exit.

:func:`make_test_mesh` gives the devices present, as the sharded index
backend's ``mesh=`` lists do: one card each, or the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

PRODUCTION = {
    False: ((32, 8), ("data", "model")),
    True: ((2, 32, 8), ("pod", "data", "model")),
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name, with the ``DeviceMesh`` that shards DTensors
    over them (None for a mesh of rules only) and, for a test mesh, the
    devices themselves."""

    shape: dict
    axis_names: tuple
    device_mesh: Optional[object] = None
    devices: tuple = ()

    @property
    def name(self) -> str:
        return "x".join(str(self.shape[a]) for a in self.axis_names)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit.  Refuses to replace a group already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh over the initialised (fake) process group, whose size must
    be the product of ``shape``."""
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                    mesh_dim_names=tuple(axes))
    return Mesh(dict(zip(axes, shape)), tuple(axes), dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The single (256-card) or multi-pod (512-card) H100 mesh, over a
    fake process group of that size already initialised."""
    return make_mesh(*PRODUCTION[multi_pod])


@contextlib.contextmanager
def mesh_context(shape: tuple, axes: tuple):
    """:func:`make_mesh` inside its own :func:`fake_world`."""
    with fake_world(math.prod(shape)):
        yield make_mesh(shape, axes)


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False):
    """:func:`make_production_mesh` inside its own :func:`fake_world`."""
    with fake_world(math.prod(PRODUCTION[multi_pod][0])):
        yield make_production_mesh(multi_pod=multi_pod)


def make_test_mesh(shape: tuple = None,
                   axes: tuple = ("data", "model")) -> Mesh:
    """Degenerate mesh over the devices present: every visible card, or
    the CPU; by default all of them on the first axis."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = ([torch.device("cuda", i) for i in range(n)]
               or [torch.device("cpu")])
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    return Mesh(dict(zip(axes, shape)), tuple(axes),
                devices=tuple(devices[:math.prod(shape)]))


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: every axis except the tensor-parallel one."""
    return tuple(a for a in mesh.axis_names if a != "model")


def mesh_size(mesh) -> int:
    return int(math.prod(mesh.shape.values()))
