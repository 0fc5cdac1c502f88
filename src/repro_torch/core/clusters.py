"""Cluster management: carve the device fleet into disjoint partitions —
the port of ``repro.core.clusters``.

The paper pins work to specific GPU clusters (SMs) for spatial isolation.
A cluster here is a slice of the device list; ``recarve`` rebuilds the
clusters from the healthy devices after failures (elastic scaling). On one
card, k clusters are carved by repeating the device, ``devices=[cuda] * k``,
as the reference does on one TPU core: each cluster then gets its own
persistent worker (``MegaRuntime``, one CTA, its own stream).

What waits for training on a mesh (slice 13): a cluster holds no device
mesh, and ``make_cluster_mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass
class Cluster:
    cid: int
    devices: np.ndarray          # flat device array
    healthy: bool = True

    @property
    def n_devices(self) -> int:
        return int(self.devices.size)


def make_cluster_mesh(devices: Sequence, axis_names=("data", "model"),
                      shape: Optional[tuple] = None):
    raise NotImplementedError(
        "cluster device meshes are not ported yet: they come with "
        "training on a mesh (slice 13); serving meshes are "
        "launch/mesh.py's")


class ClusterManager:
    def __init__(self, devices: Optional[Sequence] = None,
                 n_clusters: int = 1,
                 axis_names=("data", "model"),
                 cluster_shape: Optional[tuple] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no devices were given and CUDA is not available; pass "
                    "devices=[...] explicitly to carve a fleet without a GPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.all_devices = list(devices)
        # kept for the cluster meshes of slice 13
        self.axis_names = axis_names
        self.cluster_shape = cluster_shape
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
        for cid in range(n_clusters):
            devs = np.asarray(devices[cid * per:(cid + 1) * per], dtype=object)
            self.clusters.append(Cluster(cid=cid, devices=devs))
        self.spare_devices = list(devices[used:])
        self.generation += 1

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
