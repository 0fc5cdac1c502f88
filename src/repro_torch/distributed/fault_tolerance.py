"""Fault tolerance & straggler mitigation for 1000+-node fleets — the port
of ``repro.distributed.fault_tolerance`` (host logic only, no device code).

Pure-logic components (testable without hardware):

* ``HeartbeatMonitor`` — per-cluster liveness from step-completion stamps;
  a cluster is dead when silent for ``timeout_factor`` × its EWMA step time.
* ``StragglerDetector`` — EWMA + k·σ outlier flagging of step times; the
  dispatcher uses it to re-pin request classes off slow clusters without a
  global barrier (the paper's pinning, used elastically).
* ``ElasticPlanner`` — failure → concrete recovery plan: recarve clusters,
  restore step, which request classes to re-pin where. The executor
  (launch/train.py, serving engine) applies the plan. It works against
  the port's ``core.clusters.ClusterManager`` and
  ``checkpoint.CheckpointManager``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional


class StragglerDetector:
    def __init__(self, alpha: float = 0.2, k_sigma: float = 3.0,
                 min_samples: int = 8):
        self.alpha = alpha
        self.k = k_sigma
        self.min_samples = min_samples
        self.mean: dict[int, float] = {}
        self.var: dict[int, float] = {}
        self.count: dict[int, int] = {}

    def observe(self, cluster: int, dt: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        n = self.count.get(cluster, 0)
        m = self.mean.get(cluster, dt)
        v = self.var.get(cluster, 0.0)
        is_straggler = (n >= self.min_samples
                        and dt > m + self.k * math.sqrt(v) + 1e-12
                        and dt > 1.5 * m)
        d = dt - m
        m2 = m + self.alpha * d
        v2 = (1 - self.alpha) * (v + self.alpha * d * d)
        self.mean[cluster], self.var[cluster] = m2, v2
        self.count[cluster] = n + 1
        return is_straggler

    def slowest(self) -> Optional[int]:
        if not self.mean:
            return None
        return max(self.mean, key=self.mean.get)


class HeartbeatMonitor:
    def __init__(self, timeout_factor: float = 10.0,
                 min_timeout_s: float = 5.0, clock=time.monotonic):
        self.timeout_factor = timeout_factor
        self.min_timeout_s = min_timeout_s
        self.clock = clock
        self.last_beat: dict[int, float] = {}
        self.ewma_dt: dict[int, float] = {}

    def beat(self, cluster: int) -> None:
        now = self.clock()
        if cluster in self.last_beat:
            dt = now - self.last_beat[cluster]
            prev = self.ewma_dt.get(cluster, dt)
            self.ewma_dt[cluster] = 0.8 * prev + 0.2 * dt
        self.last_beat[cluster] = now

    def dead_clusters(self) -> list[int]:
        now = self.clock()
        dead = []
        for c, last in self.last_beat.items():
            budget = max(self.min_timeout_s,
                         self.timeout_factor * self.ewma_dt.get(c, 1.0))
            if now - last > budget:
                dead.append(c)
        return dead


@dataclass
class RecoveryPlan:
    failed_clusters: list[int]
    surviving_devices: int
    new_n_clusters: int
    restore_step: Optional[int]
    repin: dict[str, int] = field(default_factory=dict)


class ElasticPlanner:
    """Turns failures into recovery plans against a ClusterManager."""

    def __init__(self, cluster_manager, checkpoint_manager=None):
        self.cm = cluster_manager
        self.ckpt = checkpoint_manager

    def plan(self, failed: list[int],
             request_classes: tuple[str, ...] = ()) -> RecoveryPlan:
        for cid in failed:
            self.cm.mark_failed(cid)
        healthy = self.cm.healthy_clusters()
        if not healthy:
            raise RuntimeError("no healthy clusters survive")
        surviving = sum(c.n_devices for c in healthy) \
            + len(self.cm.spare_devices)
        restore = self.ckpt.latest_step() if self.ckpt else None
        plan = RecoveryPlan(
            failed_clusters=list(failed),
            surviving_devices=surviving,
            new_n_clusters=len(healthy),
            restore_step=restore,
        )
        return plan

    def execute(self, plan: RecoveryPlan,
                request_classes: tuple[str, ...] = ()):
        clusters = self.cm.recarve(plan.new_n_clusters)
        if request_classes:
            plan.repin = self.cm.pin_map(request_classes)
        return clusters
