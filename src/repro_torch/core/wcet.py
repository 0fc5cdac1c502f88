"""Worst-case execution time accounting (paper Tables II/III).

Phases mirror the paper: LK Init / Trigger / Wait / Dispose (and the
traditional-path Alloc / Spawn / Wait / Dispose). We record wall-clock ns per
phase and report average, worst, variance — the paper's predictability metric
is exactly the avg↔worst gap.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

PHASES = ("init", "trigger", "wait", "dispose")

# Dimensionless companion series: in-flight pipeline depth sampled at each
# trigger. avg > 1 means host/device overlap actually happened; worst is the
# deepest the pipeline ever got. Not a time phase — report it separately.
QUEUE_DEPTH = "queue_depth"


@dataclass
class PhaseStats:
    count: int = 0
    total_ns: float = 0.0
    total_sq: float = 0.0
    worst_ns: float = 0.0
    best_ns: float = math.inf

    def record(self, ns: float) -> None:
        self.count += 1
        self.total_ns += ns
        self.total_sq += ns * ns
        self.worst_ns = max(self.worst_ns, ns)
        self.best_ns = min(self.best_ns, ns)

    @property
    def avg_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0

    @property
    def var_ns2(self) -> float:
        if self.count < 2:
            return 0.0
        m = self.avg_ns
        return max(self.total_sq / self.count - m * m, 0.0)

    @property
    def std_ns(self) -> float:
        return math.sqrt(self.var_ns2)

    def as_dict(self) -> dict:
        return {"count": self.count, "avg_ns": self.avg_ns,
                "worst_ns": self.worst_ns,
                "best_ns": self.best_ns if self.count else 0.0,
                "std_ns": self.std_ns}


class WcetTracker:
    """Per-phase timing aggregator with a context-manager interface."""

    def __init__(self, name: str = ""):
        self.name = name
        self.stats: dict[str, PhaseStats] = defaultdict(PhaseStats)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.stats[name].record(time.perf_counter_ns() - t0)

    def record(self, name: str, ns: float) -> None:
        self.stats[name].record(ns)

    def record_depth(self, depth: int) -> None:
        """Sample the in-flight queue depth (see ``QUEUE_DEPTH``)."""
        self.stats[QUEUE_DEPTH].record(float(depth))

    def time_phases(self) -> dict[str, PhaseStats]:
        """Stats minus dimensionless series — safe to print as ns."""
        return {k: v for k, v in self.stats.items() if k != QUEUE_DEPTH}

    def avg(self, name: str) -> float:
        return self.stats[name].avg_ns

    def worst(self, name: str) -> float:
        return self.stats[name].worst_ns

    def report(self) -> dict:
        return {k: v.as_dict() for k, v in self.stats.items()}
