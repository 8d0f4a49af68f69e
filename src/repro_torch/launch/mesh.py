"""Device meshes over the ranks of the default process group.

The counterpart of the JAX package's ``launch/mesh.py``.  The port is SPMD
with one process a device: the caller starts the processes (``torchrun``,
or a test's own launcher) and initializes the default process group, and
every rank calls the same API with the same arguments.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names; its world is the default group's, not a list of local devices.

Single pod:  (data=16, model=16)            — 256 ranks
Multi-pod:   (pod=2, data=16, model=16)     — 512 ranks

Nothing here touches a process group or a device while the module is
imported.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..device import resolve_device


def world_size() -> int:
    """Ranks of the initialized default group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def _exact(shape, names, device):
    """A mesh of exactly the world's ranks; raises ``ValueError`` for any
    other world, as ``jax.make_mesh`` does for another device count."""
    n, total = math.prod(shape), world_size()
    if n != total or not dist.is_initialized():
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} {tuple(names)} needs an "
            f"initialized process group of {n} ranks, have {total}"
            + ("" if dist.is_initialized() else " (no process group)"))
    return _mesh(shape, names, device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _exact(shape, axes, device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *, device="cuda"):
    """Tiny ``("data", "model")`` mesh for integration tests (the world
    must have ``n_data * n_model`` ranks)."""
    return _exact((n_data, n_model), ("data", "model"), device)


def make_sweep_mesh(n_devices: int | None = None, *, device="cuda"):
    """1-D ``("scenario",)`` mesh over the first ``n_devices`` ranks (all by
    default) for embarrassingly parallel scenario sweeps: every scenario is
    an independent experiment, so the only sharded axis is the grid.

    Returns ``None`` without a process group or on a world of 1 — the
    sweeps (``FusedRoundEngine.scan_v_grid``) take that as "run on the
    engine's one device".  A rank outside the first ``n_devices`` is in no
    sweep."""
    total = world_size()
    n = total if n_devices is None else min(n_devices, total)
    if n <= 1:
        return None
    return _mesh((n,), ("scenario",), device)


def make_population_mesh(n_scenario: int | None = None,
                         n_clients: int | None = None, *, device="cuda"):
    """2-D ``("scenario", "clients")`` mesh for population-scale sweeps: the
    scenario axis fans out independent experiments (as ``make_sweep_mesh``)
    while the clients axis partitions the client store and the per-client
    randomness, so the O(K·N·d) population data scales over the ranks
    (``FusedRoundEngine.scan_v_grid`` and ``from_store(mesh=)``).

    Factor the world explicitly (``n_scenario × n_clients``) or leave one
    side None to infer it; with both None every rank goes to the clients
    axis (scenario=1).  Returns ``None`` without a process group or on a
    world of 1, like ``make_sweep_mesh``."""
    total = world_size()
    if total <= 1:
        return None
    if n_scenario is None and n_clients is None:
        n_scenario, n_clients = 1, total
    elif n_clients is None:
        n_clients = total // n_scenario
    elif n_scenario is None:
        n_scenario = total // n_clients
    n = n_scenario * n_clients
    if n_scenario < 1 or n_clients < 1 or n > total:
        raise ValueError(
            f"mesh {n_scenario}x{n_clients} needs {n} devices, "
            f"have {total}")
    return _mesh((n_scenario, n_clients), ("scenario", "clients"), device)


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of a stand-in object."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a ``DeviceMesh``'s names against its shape, or a
    stand-in's ``shape`` dict (``{"data": 16, "model": 16}``)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


def data_axes(mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def fsdp_axes(mesh) -> tuple:
    """Axes FSDP-style parameter sharding uses (ZeRO over all data
    replicas; on the multi-pod mesh this includes the pod axis)."""
    return data_axes(mesh)


def n_data_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in data_axes(mesh)))
