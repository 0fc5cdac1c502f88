"""Cluster management: carve the device fleet into disjoint partitions —
the port of ``repro.core.clusters``.

The paper pins work to specific GPU clusters (SMs) for spatial isolation.
A cluster here is a slice of the device list; ``recarve`` rebuilds the
clusters from the healthy devices after failures (elastic scaling). On one
card, k clusters are carved by repeating the device, ``devices=[cuda] * k``,
as the reference does on one TPU core: each cluster then gets its own
persistent worker (``MegaRuntime``, one CTA, its own stream).

Cluster meshes: a manager made with ``meshed=True`` (``LkSystem`` asks for
it when it has a ``state_shardings_factory``) gives each cluster a
``DeviceMesh`` over ITS ranks (``Cluster.mesh``, the reference's submesh of
the pod), shaped by the reference's ``_best_2d`` rule, so DTensors and
collectives placed on it touch only that cluster's ranks. A device maps to
a global rank as one process a card does: ``cuda:i`` is rank i; an int is
taken as a rank id as it is (the CPU tests' gloo ranks). Making a
``DeviceMesh`` over a subset of ranks is a collective of the default group
(unlike the reference's ``Mesh``, it is not free), so a meshed manager is
made on every rank, and every rank builds every cluster's mesh, in the
same order, in ``_carve`` (and so in ``recarve``); a manager that is not
meshed (the default) builds none and needs no process group. A recarve
keeps the mesh of a cluster whose ranks it keeps (a survivor's state stays
on it) and retires the rest; ``release_retired`` destroys their groups
once nothing runs on them (``LkSystem`` calls it when its lame ducks are
reaped). New meshes need every rank of the default group alive: a heal
after a rank has died needs the job restarted on the survivors. Without a
process group ``make_cluster_mesh`` raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclass
class Cluster:
    cid: int
    devices: np.ndarray          # flat device array
    healthy: bool = True
    mesh: Any = None             # DeviceMesh over the cluster's ranks

    @property
    def n_devices(self) -> int:
        return int(self.devices.size)


def _best_2d(n: int) -> tuple[int, int]:
    """Most-square (a, b) with a*b == n, a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def _rank_of(device) -> int:
    """The global rank that drives ``device``: one process a card, so
    ``cuda:i`` is rank i; an int is a rank id."""
    if isinstance(device, (int, np.integer)):
        return int(device)
    if isinstance(device, torch.device) and device.type == "cuda":
        return device.index or 0
    raise ValueError(f"{device!r} maps to no rank: cluster meshes take "
                     f"cuda devices (one process a card) or rank ids")


def _require_group() -> None:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a cluster mesh is a DeviceMesh over ranks of a process group, "
            "and none is running: start one (torch.distributed."
            "init_process_group) before carving clusters with meshes")


def make_cluster_mesh(devices: Sequence, axis_names=("data", "model"),
                      shape: Optional[tuple] = None):
    """A ``DeviceMesh`` over the ranks of ``devices`` (see ``_rank_of``),
    shaped ``shape`` or, for one or two axes, (n,) / ``_best_2d(n)``. A
    collective of the default process group: every rank makes it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    _require_group()
    ranks = [_rank_of(d) for d in np.asarray(devices, dtype=object).ravel()]
    n = len(ranks)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            shape = _best_2d(n)
        else:
            raise ValueError("provide explicit shape for >2 axes")
    assert math.prod(shape) == n, (shape, n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


class ClusterManager:
    def __init__(self, devices: Optional[Sequence] = None,
                 n_clusters: int = 1,
                 axis_names=("data", "model"),
                 cluster_shape: Optional[tuple] = None,
                 meshed: bool = False):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no devices were given and CUDA is not available; pass "
                    "devices=[...] explicitly to carve a fleet without a GPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.all_devices = list(devices)
        self.axis_names = axis_names
        self.cluster_shape = cluster_shape
        self.meshed = meshed
        self._meshes: dict = {}          # rank tuple -> DeviceMesh, this carve
        self.retired_meshes: list = []   # meshes an earlier carve dropped
        self.clusters: list[Cluster] = []
        self.generation = 0
        self._carve(self.all_devices, n_clusters)

    # ------------------------------------------------------------------
    def _carve(self, devices: Sequence, n_clusters: int) -> None:
        n = len(devices)
        assert n_clusters >= 1
        per = n // n_clusters
        assert per >= 1, f"{n} devices cannot host {n_clusters} clusters"
        used = per * n_clusters
        self.clusters = []
        old, self._meshes = self._meshes, {}
        for cid in range(n_clusters):
            devs = np.asarray(devices[cid * per:(cid + 1) * per], dtype=object)
            mesh = self._mesh_for(devs, old) if self.meshed else None
            self.clusters.append(Cluster(cid=cid, devices=devs, mesh=mesh))
        self.retired_meshes += [m for k, m in old.items()
                                if k not in self._meshes]
        self.spare_devices = list(devices[used:])
        self.generation += 1

    def _mesh_for(self, devs: np.ndarray, old: dict):
        """The mesh over ``devs``' ranks: this carve's or the last one's
        where it has one over the same ranks, else a new one (the same
        choice on every rank, which all carve alike)."""
        _require_group()
        key = tuple(_rank_of(d) for d in devs)
        mesh = self._meshes.get(key, old.get(key))
        if mesh is None:
            mesh = make_cluster_mesh(devs, self.axis_names, self.cluster_shape)
        self._meshes[key] = mesh
        return mesh

    def release_retired(self) -> int:
        """Destroy the process groups of the meshes earlier carves retired
        (call it once nothing runs on them; it is local to this rank).
        Returns the number of groups destroyed."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _get_default_group
        n = 0
        for mesh in self.retired_meshes:
            if mesh.get_coordinate() is None:
                continue                       # this rank is in no group
            for d in range(mesh.ndim):
                pg = mesh.get_group(d)
                if pg is not _get_default_group():
                    dist.destroy_process_group(pg)
                    n += 1
        self.retired_meshes = []
        return n

    # ------------------------------------------------------------------
    def healthy_clusters(self) -> list[Cluster]:
        return [c for c in self.clusters if c.healthy]

    def mark_failed(self, cid: int) -> None:
        self.clusters[cid].healthy = False

    def recarve(self, n_clusters: Optional[int] = None) -> list[Cluster]:
        """Elastic rebuild from devices of still-healthy clusters (plus
        spares). Called by the dispatcher after failures."""
        devices = [d for c in self.healthy_clusters() for d in c.devices]
        devices += self.spare_devices
        if not devices:
            raise RuntimeError("no healthy devices left")
        if n_clusters is None:
            n_clusters = max(1, len(self.healthy_clusters()))
        self._carve(devices, n_clusters)
        return self.clusters

    # ------------------------------------------------------------------
    def check_disjoint(self) -> bool:
        seen = set()
        for c in self.clusters:
            for d in c.devices:
                if id(d) in seen:
                    return False
                seen.add(id(d))
        return True

    def coverage(self) -> float:
        used = sum(c.n_devices for c in self.clusters)
        return used / max(len(self.all_devices), 1)

    def pin_map(self, classes: Sequence[str]) -> dict[str, int]:
        """Pin request classes to clusters round-robin (paper: allocate work
        on a specific subset of cores)."""
        cl = self.healthy_clusters()
        return {cls: cl[i % len(cl)].cid for i, cls in enumerate(classes)}
