"""Log-spaced latency histograms with percentile summaries.

The paper's predictability story is a DISTRIBUTION claim — the avg↔worst
gap — yet aggregate moments (count/avg/worst/σ, ``WcetTracker``) cannot
answer "what does the p99 look like" or "how heavy is the tail". A
:class:`LogHistogram` records each observation into geometrically-spaced
buckets (constant RELATIVE resolution: a 5% bucket at 100µs and at 100ms
alike), so memory stays O(log dynamic-range) no matter how many latencies
stream through, and any quantile is a single cumulative walk.

Guarantees (property-tested in ``tests/test_telemetry.py``):

* ``merge`` preserves counts, sums, best and worst exactly;
* ``quantile(q)`` is monotone non-decreasing in ``q``;
* every quantile is bracketed by the exact observed best and worst
  (``quantile(0) == best``, ``quantile(1) == worst`` — the bucket
  midpoint is clamped to the true extremes, so the tail never reads
  better OR worse than reality).
"""
from __future__ import annotations

import math

__all__ = ["LogHistogram"]

# default bucket growth: 2^(1/8) ≈ 9% relative resolution — fine enough
# that a reported p99 is within one bucket (~9%) of the exact statistic,
# coarse enough that µs→minutes spans a few hundred buckets
DEFAULT_GROWTH = 2.0 ** 0.125

# observations at or below this are folded into one "zero" bucket (index
# None is avoided by clamping): latencies are µs floats, a true 0 means
# "below clock resolution", not "log of zero"
_FLOOR = 1e-3


class LogHistogram:
    """Bounded-memory latency histogram over log-spaced buckets."""

    __slots__ = ("growth", "_lg", "counts", "n", "total", "best", "worst")

    def __init__(self, growth: float = DEFAULT_GROWTH):
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.growth = float(growth)
        self._lg = math.log(self.growth)
        self.counts: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.best = math.inf
        self.worst = 0.0

    # ------------------------------------------------------------------
    def _bucket(self, us: float) -> int:
        return int(math.floor(math.log(max(us, _FLOOR)) / self._lg))

    def record(self, us: float) -> None:
        us = float(us)
        if not math.isfinite(us) or us < 0.0:
            raise ValueError(f"latency must be finite and >= 0, got {us}")
        b = self._bucket(us)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.n += 1
        self.total += us
        self.best = min(self.best, us)
        self.worst = max(self.worst, us)

    def merge(self, other: "LogHistogram") -> None:
        """Fold ``other`` into self. Exact for counts/sum/best/worst —
        merged quantiles are as good as if every observation had been
        recorded here directly (same buckets, same growth)."""
        if not math.isclose(other.growth, self.growth, rel_tol=1e-12):
            raise ValueError(
                f"cannot merge histograms with different growth "
                f"({self.growth} vs {other.growth})")
        for b, c in other.counts.items():
            self.counts[b] = self.counts.get(b, 0) + c
        self.n += other.n
        self.total += other.total
        self.best = min(self.best, other.best)
        self.worst = max(self.worst, other.worst)

    # ------------------------------------------------------------------
    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        """The q-quantile (0 ≤ q ≤ 1) as the geometric midpoint of the
        bucket holding the ⌈q·n⌉-th observation, clamped to the exact
        [best, worst] envelope. Empty histograms answer 0."""
        if self.n == 0:
            return 0.0
        if q <= 0.0:
            return self.best
        if q >= 1.0:
            return self.worst
        rank = max(1, math.ceil(q * self.n))
        cum = 0
        bucket = max(self.counts)
        for b in sorted(self.counts):
            cum += self.counts[b]
            if cum >= rank:
                bucket = b
                break
        # geometric midpoint of [growth^b, growth^(b+1))
        mid = self.growth ** (bucket + 0.5)
        return float(min(max(mid, self.best), self.worst))

    def summary(self) -> dict:
        """The standard reporting row: count, avg, p50/p95/p99, extremes."""
        return {
            "count": self.n,
            "avg_us": self.avg,
            "p50_us": self.quantile(0.50),
            "p95_us": self.quantile(0.95),
            "p99_us": self.quantile(0.99),
            "best_us": self.best if self.n else 0.0,
            "worst_us": self.worst,
        }
