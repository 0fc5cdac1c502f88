"""Contention-aware elastic partitioning: the ElasticController — the port
of ``repro.core.elastic`` (host logic only, the reference's code with the
port's imports).

The carve is no longer fixed at boot. This controller closes the loop
the real-time partitioning literature (Zahaf et al.'s contention-aware
GPU partitioning, RTGPU's fine-grain utilization) says matters most:
partition sizes chosen from OBSERVED load dominate static carves. It
watches the same per-opcode backlog the dispatcher's admission analyses
charge — worst-case remaining work per class, straight from the policy
queues and in-flight records, priced by the dispatcher's own WCET
estimators — and when the demand split disagrees with the cluster split
for long enough, it recarves.

The control loop, per ``tick()``:

1. **Measure** — per-class backlog demand (µs of worst-case remaining
   work: queued items + in-flight carry-in, chunk-aware via
   :func:`~repro_torch.core.sched.admission.remaining_us`).
2. **Propose** — a largest-remainder proportional split of the active
   clusters (every class keeps at least one), i.e. capacity ∝ demand.
3. **Hysteresis** — the same proposal must recur ``sustain`` consecutive
   ticks, and at least ``cooldown_us`` must have passed since the last
   recarve (applied OR rejected), before anything changes. Oscillating
   load therefore never flaps the carve.
4. **Safety gate** — the proposal is re-run through the admission
   analysis: for every class holding admitted (deadline-bearing) work,
   its backlog charged against its PROPOSED share must still pass the
   EDF processor-demand test. A carve that would break any admitted
   class's response-time bound is REJECTED (counted on the dispatcher's
   ``recarve_rejected``, emitted as an ``EV_RECARVE`` event with
   ``rejected=True``) — a resize must never un-admit work the analyses
   already promised.
5. **Apply** — ``LkSystem.apply_shares()`` drives the heal-loop rebuild
   (adopt unchanged partitions, boot fresh runtimes — warm-pool/compiled-
   executable-cache backed, so milliseconds not hundreds —, lame-duck
   displaced survivors) and rewrites the class → cluster-set pins. In
   ADVISORY mode (``bind_dispatcher``) only the pin sets move; nothing
   reboots — the mode a single-cluster serving engine threads through
   ``launch/serve.py --elastic``.

Zero ticket loss is inherited, not re-implemented: displaced clusters
become lame ducks that drain their queued/in-flight backlog before
``reap()`` retires them, exactly as in the failure-heal path.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.mailbox import NO_DEADLINE
from repro_torch.core.sched.admission import (
    AdmissionError, edf_demand_test, remaining_us,
)
from repro_torch.core.telemetry import EV_RECARVE
from repro_torch.core.telemetry.events import now_us

__all__ = ["ElasticController", "allocate_clusters"]


def allocate_clusters(dids: list, shares: dict) -> dict:
    """Split an ordered cluster-id list into per-class pin sets sized by
    ``shares`` (largest-remainder rounding, floor of one cluster per
    class while clusters last). Returns ``{name: (did, ...)}``; with
    more classes than clusters the tail classes get empty tuples
    (→ unpinned: they fall back to global least-loaded placement)."""
    names = list(shares)
    n = len(dids)
    if not names or n == 0:
        return {m: () for m in names}
    want = {m: max(int(shares[m]), 0) for m in names}
    total = sum(want.values()) or len(names)
    quota = {m: (want[m] or 1) * n / total for m in names}
    size = {m: max(1, int(quota[m])) for m in names}
    while sum(size.values()) > n:
        cand = [m for m in names if size[m] > 1]
        if not cand:
            break                  # more classes than clusters
        size[max(cand, key=lambda m: size[m] - quota[m])] -= 1
    rem = n - sum(size.values())
    order = sorted(names, key=lambda m: quota[m] - int(quota[m]),
                   reverse=True)
    i = 0
    while rem > 0 and order:
        size[order[i % len(order)]] += 1
        i += 1
        rem -= 1
    out, i = {}, 0
    for m in names:
        out[m] = tuple(dids[i:i + size[m]])
        i += size[m]
    return out


class ElasticController:
    """Backlog-driven recarve controller (module docstring has the loop).

    interval_us — minimum spacing between ``maybe_tick`` evaluations
                  (``tick()`` ignores it).
    sustain     — consecutive agreeing ticks a proposal needs before it
                  may apply (hysteresis).
    cooldown_us — minimum time between recarve attempts; an attempt,
                  applied or admission-rejected, starts the window.
    clock       — injectable µs clock (tests/benchmarks).

    Bind with :meth:`bind` (full mode: drives ``LkSystem.apply_shares``)
    or :meth:`bind_dispatcher` (advisory: rewrites pin sets only).
    ``share_history`` records ``(generation, {class: share})`` per
    applied carve — the per-generation table ``serve.py --elastic``
    prints at exit.
    """

    def __init__(self, *, interval_us: int = 20_000, sustain: int = 3,
                 cooldown_us: int = 200_000,
                 clock: Optional[Callable[[], int]] = None):
        if sustain < 1:
            raise ValueError("sustain must be >= 1")
        self.interval_us = int(interval_us)
        self.sustain = int(sustain)
        self.cooldown_us = int(cooldown_us)
        self._clock = clock if clock is not None else now_us
        self._system = None
        self._dispatcher = None
        self._opcodes: dict[str, int] = {}
        self._advisory = False
        self._pending: Optional[dict] = None   # proposal being sustained
        self._agree = 0
        self._last_attempt_us: Optional[int] = None
        self._last_tick_us: Optional[int] = None
        self._metrics = None                   # bind_metrics registry
        self.last_utilization: dict[str, float] = {}
        self.ticks = 0
        self.proposals = 0                     # survived hysteresis
        self.applied = 0
        self.rejected = 0                      # admission-gate vetoes
        self.share_history: list[tuple[int, dict]] = []

    # -- binding ---------------------------------------------------------
    def bind(self, system) -> "ElasticController":
        """Full mode: observe ``system.dispatcher``, apply through
        ``system.apply_shares`` (recarve + warm reboot + pin rewrite)."""
        if system.dispatcher is None:
            raise RuntimeError("bind() after the system boots")
        self._system = system
        self._dispatcher = system.dispatcher
        self._opcodes = dict(system._opcodes)
        self._advisory = False
        self._register_telemetry()
        return self

    def bind_dispatcher(self, dispatcher,
                        opcodes: dict[str, int]) -> "ElasticController":
        """Advisory mode: observe a bare dispatcher and apply carves as
        pin-set rewrites over its EXISTING clusters — no reboot machinery
        (the serving-engine path, where the engine owns its runtime)."""
        self._system = None
        self._dispatcher = dispatcher
        self._opcodes = dict(opcodes)
        self._advisory = True
        self._register_telemetry()
        return self

    def bind_metrics(self, registry) -> "ElasticController":
        """Advisory utilization feed: consume the metrics registry's
        per-cluster utilization gauges (sampled from the flight
        recorder's device-stamped chunk spans) ALONGSIDE backlog demand.
        Each tick scales class k's demand by ``1 + util_k`` where
        ``util_k`` is the mean device utilization of the clusters
        currently pinned to k — a class whose clusters are measurably
        saturated argues for capacity beyond what its queue length alone
        shows, and an idle class cannot hold clusters on backlog noise.
        Purely a bias on the proposal signal: the admission veto still
        gates every carve."""
        self._metrics = registry
        return self

    def _utilization_bias(self, demand: dict) -> dict:
        """Scale per-class demand by measured cluster utilization (see
        ``bind_metrics``); records ``last_utilization`` per class."""
        util = self._metrics.utilization()
        if not util:
            return demand
        pins = self._dispatcher.pins()
        live = set(self._active_clusters())
        out = dict(demand)
        for name in out:
            members = [c for c in pins.get(name, ()) if c in live]
            vals = [util[c] for c in members if c in util]
            u = sum(vals) / len(vals) if vals else 0.0
            self.last_utilization[name] = u
            out[name] *= 1.0 + u
        return out

    def _register_telemetry(self) -> None:
        t = self._dispatcher.telemetry
        if t is not None:
            t.register_source("elastic", self.counters)

    def counters(self) -> dict:
        return {"ticks": self.ticks, "proposals": self.proposals,
                "applied": self.applied, "rejected": self.rejected}

    # -- observation -----------------------------------------------------
    def _active_clusters(self) -> list[int]:
        if self._system is not None:
            return sorted(self._system.cluster_ids())
        d = self._dispatcher
        return sorted(c for c in d.runtimes if c not in d._draining)

    def demand_us(self) -> dict[str, float]:
        """Per-class backlog demand: worst-case µs of remaining work
        (queued + in-flight carry-in), priced by the dispatcher's own
        WCET estimators — the exact quantity the admission analyses
        charge, so supply/demand comparisons share one currency."""
        d = self._dispatcher
        by_op = {op: name for name, op in self._opcodes.items()}
        demand = {name: 0.0 for name in self._opcodes}
        for c in list(d.runtimes):
            for it in d.policy.live_items(c):
                name = by_op.get(it.desc.opcode)
                if name is not None:
                    demand[name] += remaining_us(
                        it.desc, d._estimate_us, d._chunk_estimate_us)
            for it, _t, _b in d._inflight.get(c, ()):
                name = by_op.get(it.desc.opcode)
                if name is not None:
                    demand[name] += remaining_us(
                        it.desc, d._estimate_us, d._chunk_estimate_us)
        return demand

    def current_shares(self) -> dict[str, int]:
        """Clusters currently pinned per class (live members only)."""
        live = set(self._active_clusters())
        pins = self._dispatcher.pins()
        return {name: sum(1 for c in pins.get(name, ()) if c in live)
                for name in self._opcodes}

    def _propose(self, demand: dict[str, float]) -> Optional[dict]:
        n = len(self._active_clusters())
        if n < 2 or not self._opcodes:
            return None                  # nothing to redistribute
        total = sum(demand.values())
        if total <= 0.0:
            return None                  # idle: leave the carve alone
        names = sorted(self._opcodes)
        quota = {m: demand[m] * n / total for m in names}
        share = {m: max(1, int(quota[m])) for m in names}
        while sum(share.values()) > n:
            cand = [m for m in names if share[m] > 1]
            if not cand:
                return None              # more classes than clusters
            share[max(cand, key=lambda m: share[m] - quota[m])] -= 1
        rem = n - sum(share.values())
        order = sorted(names, key=lambda m: quota[m] - int(quota[m]),
                       reverse=True)
        i = 0
        while rem > 0 and order:
            share[order[i % len(order)]] += 1
            i += 1
            rem -= 1
        return share

    # -- safety gate -----------------------------------------------------
    def _admission_veto(self, proposal: dict, demand: dict,
                        now: int) -> Optional[str]:
        """Re-run the EDF processor-demand criterion for every class
        holding admitted (deadline-bearing) work, charging its backlog
        against its PROPOSED share. Returns the first failing class name,
        or None when the carve is provably safe."""
        d = self._dispatcher
        by_op = {op: name for name, op in self._opcodes.items()}
        earliest: dict[str, int] = {}
        for c in list(d.runtimes):
            for it in d.policy.live_items(c):
                if it.deadline_us == NO_DEADLINE:
                    continue
                name = by_op.get(it.desc.opcode)
                if name is not None:
                    earliest[name] = min(
                        earliest.get(name, it.deadline_us), it.deadline_us)
        for name, deadline in sorted(earliest.items()):
            share = max(proposal.get(name, 1), 1)
            try:
                edf_demand_test(now, deadline,
                                demand.get(name, 0.0) / share)
            except AdmissionError:
                return name
        return None

    # -- the loop --------------------------------------------------------
    def maybe_tick(self) -> Optional[dict]:
        """Rate-limited ``tick()``: evaluates at most once per
        ``interval_us``. The hook hosts call from their pump loops."""
        now = self._clock()
        if self._last_tick_us is not None and \
                now - self._last_tick_us < self.interval_us:
            return None
        return self.tick(now)

    def tick(self, t_us: Optional[int] = None) -> Optional[dict]:
        """One control-loop evaluation. Returns the applied share map, or
        None (no imbalance / still sustaining / cooling down / vetoed)."""
        if self._dispatcher is None:
            raise RuntimeError("bind() or bind_dispatcher() first")
        now = self._clock() if t_us is None else t_us
        self._last_tick_us = now
        self.ticks += 1
        demand = self.demand_us()
        if self._metrics is not None:
            demand = self._utilization_bias(demand)
        proposal = self._propose(demand)
        if proposal is None or proposal == self.current_shares():
            self._pending, self._agree = None, 0
            return None
        if proposal != self._pending:
            self._pending, self._agree = proposal, 1
        else:
            self._agree += 1
        if self._agree < self.sustain:
            return None                  # hysteresis: keep sustaining
        if self._last_attempt_us is not None and \
                now - self._last_attempt_us < self.cooldown_us:
            return None                  # cooldown window still open
        self.proposals += 1
        self._last_attempt_us = now      # attempts start the window,
        self._pending, self._agree = None, 0   # applied or not
        veto = self._admission_veto(proposal, demand, now)
        if veto is not None:
            self.rejected += 1
            d = self._dispatcher
            d.recarve_rejected += 1
            if d.telemetry is not None:
                d.telemetry.emit(EV_RECARVE, t_us=now, rejected=True,
                                 veto_class=veto, shares=dict(proposal))
            return None
        self._apply(proposal, now)
        self.applied += 1
        return dict(proposal)

    def _apply(self, proposal: dict, now: int) -> None:
        if self._system is not None:
            self._system.apply_shares(proposal)
            gen = self._system.cm.generation
        else:
            d = self._dispatcher
            alloc = allocate_clusters(self._active_clusters(), proposal)
            for name, members in alloc.items():
                d.pin(name, members)
            d.recarves += 1
            gen = self.applied + 1
            if d.telemetry is not None:
                d.telemetry.emit(EV_RECARVE, t_us=now, advisory=True,
                                 shares=dict(proposal),
                                 clusters=len(self._active_clusters()))
        self.share_history.append((gen, dict(proposal)))
