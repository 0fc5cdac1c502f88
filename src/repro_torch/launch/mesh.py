"""Mesh construction — the port of ``repro.launch.mesh``.

Functions, not module constants: importing this module creates no process
group and touches no device. Both build a ``DeviceMesh`` over the default
process group, which the caller has started (``torch.distributed.
init_process_group``: gloo ranks on the CPU, NCCL on the card, the
``fake`` backend for the dry run's 256 or 512 ranks in one process).
"""
from __future__ import annotations

import math

import torch.distributed as dist


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the reference's production meshes."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Single pod: (16, 16) = ('data', 'model'), 256 ranks. Multi-pod:
    (2, 16, 16) = ('pod', 'data', 'model'), 512 ranks. The shapes are the
    reference's, so every spec can be held against its own; the process
    group needs at least that many ranks (the dry run's fake one)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    import torch
    shape, names = production_shape(multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size()
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    if world < n:
        raise ValueError(f"the production mesh needs {n} ranks, the process "
                         f"group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_host_mesh(axis_names=("data", "model"), device_type="cuda"):
    """A mesh over every rank of the process group: one axis of all of
    them, or two of (a, world // a) with a the largest divisor of the world
    not above its square root (8 ranks: (2, 4); 1 rank: (1, 1))."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if len(axis_names) == 1:
        shape = (n,)
    else:
        a = int(math.isqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))
