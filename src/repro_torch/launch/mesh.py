"""Production meshes (the counterpart of ``src/repro/launch/mesh.py``).

A ``Mesh`` carries what the sharding rules read — ``axis_names``,
``shape[axis]``, ``devices.shape`` — and, for more than one device, a
``torch.distributed`` ``DeviceMesh`` for DTensor placements, built on
first use (``Mesh.device_mesh``), never at import.  A mesh of more
devices than the process has runs on torch's ``fake`` process-group
backend, with this process playing rank 0: collectives are recorded and
move no data, which is what a dry run needs.  A one-device mesh needs no
process group at all.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np


class Mesh:
    """Named mesh axes over ``prod(shape)`` devices (ranks 0..n-1,
    row-major, as ``jax.make_mesh`` lays out a host's devices)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = np.arange(math.prod(self.shape.values())).reshape(tuple(shape))
        self.size = int(self.devices.size)
        self._device_mesh = None

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes})"

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over this mesh's ranks (None for one device)."""
        if self.size == 1:
            return None
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            _ensure_process_group(self.size)
            # the dry run's shards are fake tensors on the CPU
            self._device_mesh = init_device_mesh(
                "cpu", tuple(self.devices.shape), mesh_dim_names=self.axis_names)
        return self._device_mesh


def _ensure_process_group(world_size: int) -> None:
    """A default process group of ``world_size`` ranks: the one already
    initialised if its size matches, else the ``fake`` backend with this
    process as rank 0 (re-initialised when an earlier fake group had
    another size)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise ValueError(
                f"a mesh of {world_size} devices cannot run in a process group of "
                f"{dist.get_world_size()} ranks")
        dist.destroy_process_group()
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:   # torch's internal namespace: not promised to exist
        raise RuntimeError(
            "this torch has no fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg); a mesh of "
            f"{world_size} devices needs it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh_compat(shape, axes) -> Mesh:
    """A ``Mesh`` of ``shape`` named ``axes`` (the reference's
    ``jax.make_mesh`` wrapper)."""
    return Mesh(tuple(shape), tuple(axes))


@contextlib.contextmanager
def use_mesh_compat(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` current: on more than one device, tensors a model
    makes itself (positions, RoPE tables, masks) join DTensor operations
    as replicated (``implicit_replication``)."""
    if mesh.size == 1:
        yield mesh
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_fedleo_mesh(*, num_orbits: int = 4, multi_pod: bool = False) -> Mesh:
    """Mesh for the FedLEO hierarchical training step: the leading
    ``orbit`` axis carries the per-orbit model replicas; gradient sync
    during local steps stays inside ("data", "model"); the scheduled
    sink->GS aggregation is the only collective crossing ``orbit``.  On
    the multi-pod mesh the orbit axis is the pod axis (2 orbits of 256
    devices); single-pod it splits the data axis (num_orbits x
    (16/num_orbits) x 16)."""
    if multi_pod:
        return make_mesh_compat((2, 16, 16), ("orbit", "data", "model"))
    if 16 % num_orbits != 0:
        raise ValueError("orbit count must divide the data axis")
    return make_mesh_compat((num_orbits, 16 // num_orbits, 16), ("orbit", "data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the global batch (and the FSDP param dim)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
