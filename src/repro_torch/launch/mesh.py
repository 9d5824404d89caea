"""Device meshes: the counterpart of ``repro.launch.mesh``.

Each function returns a ``torch.distributed.device_mesh.DeviceMesh`` over
named axes.  A mesh needs a process group of its size:

  * on the card, a one-device mesh makes its own (NCCL at world size 1);
    a bigger one needs a group that the caller has started, one process
    per card;
  * the dry-run traces on the fake backend (``fake_process_group``), the
    counterpart of the reference's ``--xla_force_host_platform_device_count``:
    every rank's collectives return at once, so it only ever carries fake
    tensors;
  * the CPU tests start a gloo group of their own.

A process group is global to the process, so the fake one belongs in a
process of its own (the dry-run's command, or a subprocess).

``mesh_context(mesh)`` sets the mesh that ``models.common.shard_hint``
reads, and lets the model's plain tensors (positions, masks, zeros) mix
with DTensors as replicated values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import MeshConfig
from repro_torch.device import resolve
from repro_torch.models.common import use_mesh


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names without devices or a process group (the
    counterpart of ``jax.sharding.AbstractMesh``), read as a
    ``DeviceMesh`` is (``mesh_dim_names``, ``shape``) by the spec rules of
    ``launch/sharding.py`` and by ``spec_placements``."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fake_process_group(world_size: int) -> None:
    """Start the fake backend at ``world_size`` in this process (for
    tracing on fake tensors only: its collectives move no data)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: this process already has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _ensure_group(size: int, device_type: str) -> None:
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise ValueError(f"a mesh of {size} devices needs a process group of that "
                             f"size; this one has {dist.get_world_size()}")
        return
    if device_type == "cuda" and size == 1:
        dev = resolve("cuda")
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()
                                                       if dev.index is None else dev.index))
        return
    raise ValueError(
        f"no process group for a {device_type} mesh of {size} devices: start one "
        "(one process per card over NCCL, gloo for CPU tests, or "
        "fake_process_group for a dry-run)")


def _make_mesh(shape, axes, device_type: str) -> DeviceMesh:
    shape, axes = tuple(shape), tuple(axes)
    _ensure_group(math.prod(shape), device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model")."""
    cfg = MeshConfig(multi_pod)
    return _make_mesh(cfg.shape, cfg.axis_names, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device_type: str = "cuda") -> DeviceMesh:
    """A small mesh: (1, 1) on one card, (2, 2) over a CPU test's gloo
    group."""
    return _make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Make ``mesh`` the one that ``shard_hint`` reads, with the model's
    plain tensors taken as replicated over it."""
    with use_mesh(mesh), implicit_replication():
        yield mesh


def mesh_config_of(mesh) -> MeshConfig:
    return MeshConfig(multi_pod="pod" in axis_sizes(mesh))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that shard the batch (pure DP across pods + FSDP data axis)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
