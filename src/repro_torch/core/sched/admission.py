"""Analytic admission tests for the scheduling policies.

Replaces the dispatcher's ad-hoc "sum the earlier deadlines" loop with the
standard real-time feasibility machinery (cf. RTGPU, arXiv:2101.10463, and
server-based GPU management, arXiv:1709.06613):

* processor-demand test for EDF — work demanded before a deadline must fit
  in the time until that deadline;
* Liu–Layland utilization bound and iterative response-time analysis for
  fixed-priority (rate-monotonic) scheduling;
* supply-bound function of a replenishing bandwidth server for the
  budgeted-server policy.

WCET inputs come from observation: :func:`inflated_wcet` turns a window of
observed service times into ``worst + k·σ`` — the observed worst case
inflated by the measured jitter, so admission hardens as variance grows
instead of trusting a lucky fastest run.

Every rejection is an :class:`AdmissionError` carrying the FAILING TERM
(``test``, ``term``, ``bound``) so callers and operators can see *which*
analysis failed and by how much, not just "deadline unattainable".
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = [
    "AdmissionError", "inflated_wcet", "quantile_wcet",
    "backlog_demand_us", "remaining_us", "chunk_blocking_us",
    "edf_demand_test", "liu_layland_bound", "utilization_test",
    "response_time", "server_supply_us",
]


class AdmissionError(RuntimeError):
    """Deadline-feasibility rejection, carrying the failing analysis term.

    test — which analysis failed: "demand", "utilization",
           "response_time", or "supply".
    term — the computed value that violated the bound (µs or ratio).
    bound — the bound it violated.
    """

    def __init__(self, msg: str, *, test: str = "demand",
                 term: float = 0.0, bound: float = 0.0):
        super().__init__(msg)
        self.test = test
        self.term = term
        self.bound = bound


def inflated_wcet(observed: Sequence[float], sigma_factor: float) -> float:
    """Worst observed service time inflated by ``sigma_factor`` standard
    deviations of the observation window — the paper's avg↔worst jitter
    gap folded into the estimate."""
    worst = max(observed)
    if sigma_factor <= 0.0 or len(observed) < 2:
        return float(worst)
    n = len(observed)
    mean = sum(observed) / n
    var = max(sum(v * v for v in observed) / n - mean * mean, 0.0)
    return float(worst + sigma_factor * math.sqrt(var))


def quantile_wcet(observed: Sequence[float], q: float) -> float:
    """Percentile WCET estimator: the empirical q-quantile of the
    observation window (``Dispatcher(wcet_quantile=q)``). The soft
    real-time alternative to :func:`inflated_wcet` — instead of charging
    worst + k·σ (which one straggler inflates forever, over-rejecting),
    admission charges the stated percentile and the telemetry monitor's
    bound-violation ledger reports how often reality exceeded it.
    ``q=1`` recovers the plain observed worst; quantiles use the ceiling
    rank, so the estimate is always an actually-observed value."""
    if not observed:
        raise ValueError("quantile_wcet needs at least one observation")
    q = min(max(q, 0.0), 1.0)
    xs = sorted(observed)
    rank = max(1, math.ceil(q * len(xs)))
    return float(xs[rank - 1])


def remaining_us(desc, estimate, chunk_estimate=None) -> float:
    """Worst-case work LEFT in a descriptor: for chunked work, the lower
    of the whole-item estimate and ``remaining_chunks`` chunk lengths —
    both are upper bounds, and whichever is tighter applies (a requeued
    remainder demands only what it has not yet run; a fresh item whose
    class has no chunk estimate yet must not charge n_chunks × its full
    WCET). Atomic work demands its full estimate."""
    chunked = getattr(desc, "chunked", False)
    full = estimate(desc.opcode)
    if not chunked:
        return full
    per_chunk = (chunk_estimate or estimate)(desc.opcode)
    return min(full, per_chunk * desc.remaining_chunks)


def chunk_blocking_us(spec, estimate_us: float, preemptive: bool) -> float:
    """The blocking a class can inflict on more urgent work: its full
    WCET when its items are non-preemptible, but only ONE chunk once the
    class declares ``chunk_us`` under a preemptive policy — the worst
    term in every response-time bound collapses from "longest WCET in
    the system" to "one chunk"."""
    if preemptive and spec is not None and spec.chunk_us is not None:
        return min(float(spec.chunk_us), estimate_us)
    return estimate_us


def backlog_demand_us(desc, estimate, inflight, items, ignore,
                      item_counts, inflight_counts=None,
                      inflight_us=None, item_us=None,
                      self_us=None) -> float:
    """Worst-case work that runs before (or around) ``desc``: its own
    estimate, in-flight carry-in, and every live queued item the policy's
    ``item_counts`` predicate selects. ``ignore`` items are treated as
    cancelled (the dispatcher's shed dry-run). The one demand summation
    every policy shares — the predicates are the policy.

    The ``*_us`` callables override the per-entry contribution (default:
    the opcode's full ``estimate``); chunk-aware policies pass
    ``remaining_us``-style contributions so requeued remainders and
    preemptible in-flight steps are charged for chunks, not whole WCETs.
    """
    demand = self_us(desc) if self_us is not None else estimate(desc.opcode)
    for d in inflight:
        if inflight_counts is None or inflight_counts(d):
            demand += inflight_us(d) if inflight_us is not None \
                else estimate(d.opcode)
    skip = set(map(id, ignore))
    for it in items:
        if id(it) in skip:
            continue
        if item_counts(it):
            demand += item_us(it) if item_us is not None \
                else estimate(it.desc.opcode)
    return demand


def edf_demand_test(now_us: int, deadline_us: int,
                    demand_us: float) -> None:
    """Processor-demand criterion for one EDF deadline: all work that must
    finish by ``deadline_us`` (earlier-or-equal deadlines plus in-flight
    carry-in) has to fit between now and the deadline."""
    if now_us + demand_us > deadline_us:
        raise AdmissionError(
            f"deadline {deadline_us} unattainable "
            f"(worst-case load {demand_us:.0f}µs)",
            test="demand", term=demand_us,
            bound=float(max(deadline_us - now_us, 0)))


def liu_layland_bound(n_classes: int) -> float:
    """Sufficient utilization bound for rate-monotonic fixed priorities:
    n(2^{1/n} − 1); → ln 2 as n grows."""
    if n_classes <= 0:
        return 1.0
    return n_classes * (2.0 ** (1.0 / n_classes) - 1.0)


def utilization_test(utilizations: Sequence[float],
                     bound: Optional[float] = None) -> bool:
    """True when total utilization is within ``bound`` (default: the
    Liu–Layland bound for this many classes). A False return is NOT a
    rejection by itself — it only means the quick sufficient test is
    inconclusive and exact response-time analysis must decide."""
    if bound is None:
        bound = liu_layland_bound(len(utilizations))
    return sum(utilizations) <= bound


def response_time(c_us: float,
                  higher: Sequence[tuple[float, float]],
                  blocking_us: float = 0.0,
                  limit_us: float = float("inf"),
                  max_iter: int = 64) -> float:
    """Iterative response-time analysis for a fixed-priority class:

        R = C + B + Σ_{j ∈ hp} ceil(R / T_j) · C_j

    ``higher`` is the (C_j, T_j) table of strictly-higher-priority
    classes; ``blocking_us`` is the priority-ceiling-style blocking bound
    (longest lower-priority critical section — here: the longest
    non-preemptible in-flight step). Returns the fixpoint, or +inf when
    the iteration diverges past ``limit_us``.
    """
    r = c_us + blocking_us
    for _ in range(max_iter):
        interference = sum(math.ceil(r / t_j) * c_j
                           for c_j, t_j in higher if t_j > 0)
        nxt = c_us + blocking_us + interference
        if nxt > limit_us:
            return float("inf")
        if nxt <= r:
            return r
        r = nxt
    return float("inf")


def server_supply_us(remaining_us: float, budget_us: float,
                     period_us: float, next_replenish_us: Optional[int],
                     now_us: int, deadline_us: int) -> float:
    """Execution supply a replenishing bandwidth server can deliver in
    [now, deadline]: what is left of the current budget plus one budget
    per replenishment boundary inside the window — every credit capped
    by the WALL CLOCK left when it becomes available (budget the server
    has no time to spend is not supply). A deferrable server's lower
    supply-bound; linear in the window length."""
    window = deadline_us - now_us
    if window <= 0:
        return 0.0
    supply = min(max(remaining_us, 0.0), float(window))
    t0 = next_replenish_us if next_replenish_us is not None \
        else now_us + period_us
    if t0 <= deadline_us:
        # all boundaries except the last precede the deadline by at least
        # one period >= budget (utilization <= 1), so only the last
        # replenishment can be wall-clock-truncated
        n_bound = 1 + int((deadline_us - t0) // period_us)
        t_last = t0 + (n_bound - 1) * period_us
        supply += budget_us * (n_bound - 1)
        supply += min(budget_us, float(deadline_us - t_last))
    return float(min(supply, window))
