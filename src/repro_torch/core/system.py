"""LkSystem — the one-stop facade over the persistent-dispatch stack, ported
to PyTorch (counterpart of ``repro.core.system``).

Wires ``ClusterManager`` (spatial carving), ``PersistentRuntime`` (one per
cluster, booted from a declarative work table), and the ticket-based
``Dispatcher`` into a single context-managed object with a SELF-HEALING
cluster lifecycle: when a cluster dies mid-flight, the dispatcher's
``on_failure`` hook drives ``mark_failed`` → ``recarve`` → reboot →
``register`` before the failed cluster's work is replayed, so the replay
lands on the rebuilt capacity and no request is lost — all without user
code.

Usage::

    from repro_torch.system import LkSystem, WorkClass

    sys_ = LkSystem(state_factory=make_state,
                    result_template=torch.zeros((1,)),
                    n_clusters=2)
    sys_.register(WorkClass("interactive", fn=decode_fn, wcet_us=800.0,
                            pin=0))
    sys_.register(WorkClass("batch", fn=train_fn))
    with sys_:                              # boot: one runtime per cluster
        t = sys_.submit("interactive", deadline_us=now_us() + 10_000)
        print(t.result())                   # ticket future, resolved at
                                            # retirement

Healing policy: the system restores the ORIGINAL cluster count (clamped to
the surviving device fleet — spares fill in first, elastic shrink
otherwise). After a recarve, a surviving runtime whose device partition is
unchanged is adopted as-is (its device-resident state keeps serving); a
runtime whose partition was rearranged becomes a *lame duck* — it finishes
its queued/in-flight backlog, then is unregistered and disposed by
``reap()``.

What changed from the reference: a runtime is placed on its cluster's
first device when that is a ``torch.device``, else on ``"cuda"``, which
raises where CUDA is absent; the scan runtime compiles
nothing, so only ``runtime="mega"`` boots go through the shared
``ExecutableCache``; there is no ``donate`` knob (state is updated in
place); ``state_shardings_factory`` waits for the distribution slice and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

from repro_torch.core import mailbox as mb
import torch

from repro_torch.core.clusters import Cluster, ClusterManager
from repro_torch.core.dispatcher import Dispatcher, Ticket
from repro_torch.core.elastic import ElasticController, allocate_clusters
from repro_torch.core.persistent import (
    ExecutableCache, PersistentRuntime, RuntimeProtocol, reap_deferred,
)
from repro_torch.core.sched import CRIT_LOW, ClassSpec, SchedPolicy
from repro_torch.core.telemetry import EV_HEAL, EV_RECARVE, TraceCollector
from repro_torch.core.telemetry.events import now_us


@dataclass(frozen=True)
class WorkClass:
    """Declarative registration of one kind of work.

    name        — request-class name; also the opcode's row name in every
                  runtime's work table.
    fn          — chunk-aware ``fn(state, carry, desc) -> (state, carry,
                  result, done)`` or legacy ``fn(state, desc) -> (state,
                  result)``; one entry of every cluster's work table (every
                  cluster can run every class — that is what makes failure
                  replay universal).
    wcet_us     — seed worst-case execution time for deadline admission;
                  refined online from observed worsts.
    pin         — manager-cluster index for spatial pinning (paper §II-A),
                  or None for least-loaded placement.
    priority    — static priority for the fixed-priority policy (smaller =
                  more urgent; None derives rate-monotonic from period_us).
    budget_us   — per-period execution budget for the budgeted-server
                  policy (requires period_us); None = best effort.
    period_us   — budget replenishment / rate-monotonic period.
    criticality — overload-shedding level (``"low"``/``"high"``): on
                  admission failure a HIGH submission may cancel queued
                  LOW work to make room.
    chunk_us    — declared worst-case length of ONE resumable chunk when
                  this class submits chunked work (``submit(...,
                  n_chunks=k)``): collapses the class's blocking term in
                  every admission analysis from its WCET to one chunk.
    carry       — per-opcode resumable-carry template (device-resident
                  scratch threaded through every step); scalar zero when
                  omitted.
    """

    name: str
    fn: Callable[..., tuple]
    wcet_us: Optional[float] = None
    pin: Optional[int] = None
    priority: Optional[int] = None
    budget_us: Optional[float] = None
    period_us: Optional[float] = None
    criticality: str = CRIT_LOW
    chunk_us: Optional[float] = None
    carry: Any = None

    def spec(self, opcode: int) -> ClassSpec:
        """The scheduling-policy view of this class (validates knobs)."""
        return ClassSpec(opcode=opcode, name=self.name,
                         priority=self.priority, budget_us=self.budget_us,
                         period_us=self.period_us,
                         criticality=self.criticality,
                         chunk_us=self.chunk_us)


class LkSystem:
    """Context-managed boot/dispose of one PersistentRuntime per
    ClusterManager cluster, with ticket submission and a wired
    self-healing failure loop."""

    def __init__(self, *, state_factory: Callable[[Cluster], Any],
                 result_template: Any,
                 cluster_manager: Optional[ClusterManager] = None,
                 devices: Optional[Sequence] = None,
                 n_clusters: int = 1,
                 axis_names: tuple = ("data",),
                 cluster_shape: Optional[tuple] = None,
                 work_classes: Sequence[WorkClass] = (),
                 max_inflight: int = 2,
                 max_steps: int = 8,
                 completion_window: int = 1024,
                 straggler_factor: float = 4.0,
                 state_shardings_factory: Optional[
                     Callable[[Cluster], Any]] = None,
                 runtime_factory: Optional[
                     Callable[[Cluster], RuntimeProtocol]] = None,
                 heal: bool = True,
                 policy: Union[str, SchedPolicy] = "edf",
                 default_wcet_us: float = 1000.0,
                 preemptive: Optional[bool] = None,
                 telemetry: Optional[TraceCollector] = None,
                 wcet_quantile: Optional[float] = None,
                 elastic: Optional[ElasticController] = None,
                 warm_pool: int = 0,
                 exec_cache: Optional[ExecutableCache] = None,
                 runtime: str = "scan",
                 staged_cap: int = 4,
                 profile: Optional[bool] = None):
        if runtime not in ("scan", "mega"):
            raise ValueError(
                f"runtime must be 'scan' or 'mega', got {runtime!r}")
        if state_shardings_factory is not None:
            raise NotImplementedError(
                "state_shardings_factory needs cluster meshes, which come "
                "with the distribution slice (slice 5)")
        self.cm = cluster_manager if cluster_manager is not None else \
            ClusterManager(devices=devices, n_clusters=n_clusters,
                           axis_names=axis_names,
                           cluster_shape=cluster_shape)
        self._target_clusters = len(self.cm.clusters)
        self._state_factory = state_factory
        self._result_template = result_template
        self._max_inflight = int(max_inflight)
        self._max_steps = int(max_steps)
        self._completion_window = int(completion_window)
        self._straggler_factor = straggler_factor
        self._runtime_factory = runtime_factory
        # runtime selection: "scan" = PersistentRuntime (host-refilled
        # descriptor ring, the default); "mega" = MegaRuntime (device-
        # resident queue drained by ONE drain-kernel launch per cluster —
        # classes must follow the drain kernel's tile-op table, validated
        # at boot). Per-item dispatch falls back through trigger() on
        # both, so dispatcher semantics (preemption, replay) are shared.
        self._runtime = runtime
        self._staged_cap = int(staged_cap)
        # flight recorder: None = per-runtime auto (on exactly when a
        # telemetry collector is attached); True/False force it
        self._profile = profile
        self._heal = heal
        self._policy = policy
        self._preemptive = preemptive
        self._default_wcet_us = float(default_wcet_us)
        # one collector serves the whole system: dispatcher decisions,
        # per-runtime step instants, and the heal loop's fail→heal pairs
        # all land on the same timeline (see repro_torch.core.telemetry)
        self.telemetry = telemetry
        self._wcet_quantile = wcet_quantile
        self._classes: dict[str, WorkClass] = {}
        self._opcodes: dict[str, int] = {}
        self.dispatcher: Optional[Dispatcher] = None
        self._runtimes: dict[int, RuntimeProtocol] = {}
        self._cluster_of: dict[int, Cluster] = {}
        self._lame_ducks: set[int] = set()
        self._next_dispatch_id = itertools.count()
        self._req_ids = itertools.count(1)
        self.heals = 0
        # elastic partitioning: controller + warm reboot machinery. One
        # ExecutableCache is shared by every runtime this system boots —
        # post-first mega boots reuse the prepared drain launch; the warm
        # pool goes one
        # further and keeps `warm_pool` spare runtimes ALREADY BOOTED, so
        # a grow-recarve registers capacity in milliseconds.
        self.elastic = elastic
        self.exec_cache = exec_cache if exec_cache is not None \
            else ExecutableCache()
        self._warm_pool_size = int(warm_pool)
        self._warm: list[RuntimeProtocol] = []
        self.warm_boots = 0        # clusters served from the warm pool
        self.recarves = 0          # elastic repartitions applied
        self.recarve_stall_us = 0  # duration of the last apply_shares
        for wc in work_classes:
            self.register(wc)

    # -- declarative registration (pre-boot) ---------------------------
    def register(self, work_class: WorkClass) -> int:
        """Register a work class; returns its opcode. The combined work
        table is built into every runtime at boot, so registration
        closes when the system boots."""
        if self.dispatcher is not None:
            raise RuntimeError("register() before boot(): the work table "
                               "is built into every cluster's runtime")
        if work_class.name in self._classes:
            raise KeyError(f"work class {work_class.name!r} already "
                           "registered")
        opcode = len(self._classes)
        work_class.spec(opcode)     # validate sched knobs at declare time
        self._classes[work_class.name] = work_class
        self._opcodes[work_class.name] = opcode
        return opcode

    @property
    def booted(self) -> bool:
        return self.dispatcher is not None

    @property
    def runtimes(self) -> dict[int, RuntimeProtocol]:
        """Live runtimes by dispatcher cluster id (read-only view)."""
        return dict(self._runtimes)

    @property
    def lame_ducks(self) -> set[int]:
        return set(self._lame_ducks)

    def cluster_ids(self) -> list[int]:
        """Dispatcher cluster ids currently accepting new work."""
        return [d for d in self._runtimes if d not in self._lame_ducks]

    # -- lifecycle ------------------------------------------------------
    def boot(self) -> "LkSystem":
        """Init phase for the whole system: one runtime per healthy
        cluster, all registered with a fresh ticket dispatcher."""
        if self.dispatcher is not None:
            raise RuntimeError("already booted")
        if not self._classes:
            raise RuntimeError("register at least one WorkClass before "
                               "boot()")
        cids = {c.cid for c in self.cm.healthy_clusters()}
        for name, wc in self._classes.items():
            # the modulo fallback in _repin exists only for post-heal cid
            # renumbering — at boot an unmatched pin is a config error, not
            # something to silently remap (it would break spatial isolation)
            if wc.pin is not None and wc.pin not in cids:
                raise ValueError(
                    f"WorkClass {name!r} pins to cluster {wc.pin}, but "
                    f"only clusters {sorted(cids)} exist")
        wcet = {self._opcodes[n]: wc.wcet_us
                for n, wc in self._classes.items() if wc.wcet_us}
        specs = tuple(wc.spec(self._opcodes[n])
                      for n, wc in self._classes.items())
        self.dispatcher = Dispatcher(
            {}, wcet_us=wcet, straggler_factor=self._straggler_factor,
            completion_window=self._completion_window,
            policy=self._policy, classes=specs,
            default_wcet_us=self._default_wcet_us,
            preemptive=self._preemptive,
            telemetry=self.telemetry,
            wcet_quantile=self._wcet_quantile,
            on_failure=self._on_cluster_failure if self._heal else None)
        for cl in self.cm.healthy_clusters():
            self._add_cluster(cl)
        self._repin()
        if self.telemetry is not None:
            self.telemetry.register_source("exec_cache",
                                           self.exec_cache.counters)
        self._prestage()
        if self.elastic is not None:
            self.elastic.bind(self)
        return self

    def __enter__(self) -> "LkSystem":
        return self.boot() if self.dispatcher is None else self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.dispose()

    def dispose(self) -> None:
        """Drain outstanding work, then unregister and dispose every
        runtime (paper Dispose phase, system-wide)."""
        if self.dispatcher is None:
            return
        try:
            self.dispatcher.drain()
        except Exception:
            pass                  # partial drain: dispose what remains
        for did in list(self._runtimes):
            rt = self._runtimes.pop(did)
            self._cluster_of.pop(did, None)
            self._lame_ducks.discard(did)
            if did in self.dispatcher.runtimes:
                try:
                    self.dispatcher.unregister(did)
                except Exception:
                    pass
            try:
                rt.dispose()
            except Exception:
                pass
        for rt in self._warm:
            try:
                rt.dispose()
            except Exception:
                pass
        self._warm.clear()
        self.dispatcher = None
        reap_deferred()    # finalize the teardown dispose() deferred

    # -- submission -----------------------------------------------------
    def submit(self, work_class: str, *, arg0: int = 0, arg1: int = 0,
               seq_len: int = 0, deadline_us: int = 0,
               request_id: Optional[int] = None,
               admission: Optional[bool] = None,
               n_chunks: int = 1) -> Ticket:
        """Submit one item of ``work_class``; returns its Ticket.
        Admission control defaults to on exactly when a deadline is set.
        ``n_chunks > 1`` submits the item as a sequence of resumable
        chunks — more urgent work can preempt it at every chunk
        boundary (the class's fn must honour the chunk contract)."""
        self._require_booted()
        if work_class not in self._classes:
            raise KeyError(work_class)
        if n_chunks < 1:
            raise ValueError("n_chunks must be >= 1")
        self.reap()     # retire any lame duck whose backlog has drained —
        #                 result()-only callers never pass through drain()
        if self.elastic is not None:
            self.elastic.maybe_tick()
        desc = mb.WorkDescriptor(
            opcode=self._opcodes[work_class], arg0=arg0, arg1=arg1,
            seq_len=seq_len,
            request_id=request_id if request_id is not None
            else next(self._req_ids),
            deadline_us=deadline_us, n_chunks=n_chunks)
        return self.dispatcher.submit(
            desc, request_class=work_class,
            admission=bool(deadline_us) if admission is None else admission)

    def drain(self) -> list:
        """Run every queue and pipeline to empty; reap retired lame
        ducks; returns the completions."""
        self._require_booted()
        out = self.dispatcher.drain()
        self.reap()
        return out

    def poll(self) -> list:
        self._require_booted()
        out = self.dispatcher.poll()
        self.reap()
        if self.elastic is not None:
            self.elastic.maybe_tick()
        return out

    def _require_booted(self) -> None:
        if self.dispatcher is None:
            raise RuntimeError("boot() first")

    # -- self-healing failure loop --------------------------------------
    def _on_cluster_failure(self, did: int) -> None:
        """Dispatcher ``on_failure`` hook. Runs BEFORE the failed
        cluster's work is replayed, so capacity registered here is a
        replay target: mark_failed → recarve → reboot → register."""
        cl = self._cluster_of.pop(did, None)
        rt = self._runtimes.pop(did, None)
        self._lame_ducks.discard(did)
        if rt is not None:
            try:
                rt.dispose()
            except Exception:
                pass              # the runtime is already dead
        if cl is None or not any(c is cl for c in self.cm.clusters):
            # a lame duck died: its Cluster object is from a previous
            # generation and its devices already belong to the current
            # carve (which has live runtimes) — nothing to mark failed or
            # rebuild, the dispatcher replays onto the live clusters
            return
        self.heals += 1
        self.cm.mark_failed(cl.cid)
        n_dev = sum(c.n_devices for c in self.cm.healthy_clusters()) \
            + len(self.cm.spare_devices)
        if n_dev == 0:
            return                # nothing left; dispatcher raises
        clusters = self.cm.recarve(
            max(1, min(self._target_clusters, n_dev)))
        self._rebuild_from_carve(clusters)
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_HEAL, cluster=did, generation=self.cm.generation,
                clusters=len(self.cluster_ids()),
                lame_ducks=len(self._lame_ducks), heals=self.heals)

    def _rebuild_from_carve(self, clusters: Sequence[Cluster]) -> None:
        """Reconcile live runtimes against a fresh carve — the machinery
        both the failure-heal loop and an elastic recarve drive: adopt
        survivors whose device partition is unchanged (their device-
        resident state keeps serving), boot fresh runtimes for new
        partitions (warm-pool / executable-cache backed), and lame-duck
        displaced survivors (they finish their backlog, then ``reap()``
        retires them — zero ticket loss). Partitions are matched as
        device-id multisets, so identical partitions pair up one-for-one
        even when the fleet repeats a physical device."""
        live_by_devs: dict[tuple, list[int]] = {}
        for d, c in self._cluster_of.items():
            if d in self._lame_ducks:
                continue
            key = tuple(sorted(id(dev) for dev in c.devices))
            live_by_devs.setdefault(key, []).append(d)
        for cl_new in clusters:
            key = tuple(sorted(id(dev) for dev in cl_new.devices))
            cand = live_by_devs.get(key)
            if cand:
                self._cluster_of[cand.pop(0)] = cl_new
            else:
                self._add_cluster(cl_new)
        for ducks in live_by_devs.values():
            for duck in ducks:
                self._lame_ducks.add(duck)
                self.dispatcher.quiesce(duck)     # drain, don't feed
        self._repin()

    def apply_shares(self, shares: dict) -> dict:
        """Elastic repartition: make each named work class own
        ``shares[name]`` of the active clusters. When the requested total
        differs from the live cluster count, the device fleet is recarved
        and rebuilt through the heal-loop machinery (adopt / warm-boot /
        lame-duck — no ticket is lost); then the class → cluster-set pins
        are rewritten so placement follows the new carve. Returns the
        applied pin map ``{name: (cluster_id, ...)}``.

        This is the MECHANISM half: callers wanting the sustained-
        imbalance policy and the admission safety gate go through
        :class:`~repro_torch.core.elastic.ElasticController`, which calls this
        only for carves the analyses re-admitted."""
        self._require_booted()
        for name in shares:
            if name not in self._classes:
                raise KeyError(name)
        t0 = now_us()
        total = sum(max(int(k), 0) for k in shares.values())
        if total < 1:
            raise ValueError("shares must sum to >= 1")
        n_dev = sum(c.n_devices for c in self.cm.healthy_clusters()) \
            + len(self.cm.spare_devices)
        total = max(1, min(total, n_dev))
        if total != len(self.cluster_ids()):
            self._rebuild_from_carve(self.cm.recarve(total))
            self._target_clusters = total
        alloc = allocate_clusters(sorted(self.cluster_ids()), shares)
        for name, members in alloc.items():
            self.dispatcher.pin(name, members)
        self.recarves += 1
        self.dispatcher.recarves += 1
        # the stall: how long the system went without its full carve —
        # bounded by the warm-pool reboot, not a cold lk_init
        self.recarve_stall_us = now_us() - t0
        if self.telemetry is not None:
            self.telemetry.emit(
                EV_RECARVE, generation=self.cm.generation,
                clusters=len(self.cluster_ids()),
                lame_ducks=len(self._lame_ducks),
                stall_us=self.recarve_stall_us,
                shares={n: len(m) for n, m in alloc.items()})
        return alloc

    def reap(self) -> list[int]:
        """Unregister + dispose lame-duck clusters whose backlog drained;
        returns the dispatcher ids reaped."""
        if self.dispatcher is None:
            return []
        reaped = []
        for did in list(self._lame_ducks):
            if did not in self.dispatcher.runtimes:
                self._lame_ducks.discard(did)
                continue
            if self.dispatcher.queue_depth(did) or \
                    self.dispatcher.inflight_depth(did):
                continue
            self.dispatcher.unregister(did)
            rt = self._runtimes.pop(did, None)
            self._cluster_of.pop(did, None)
            self._lame_ducks.discard(did)
            if rt is not None:
                try:
                    rt.dispose()
                except Exception:
                    pass
            reaped.append(did)
        # dispose() defers its blocking teardown; this is the off-latency-
        # path place it finalizes. Replenish the warm pool afterwards so
        # the NEXT recarve finds pre-booted spares again.
        reap_deferred()
        self._prestage()
        return reaped

    # -- internals ------------------------------------------------------
    def _prestage(self) -> int:
        """Fill the warm pool up to ``warm_pool`` pre-BOOTED spare
        runtimes (served by the shared executable cache), so a
        grow-recarve registers capacity in milliseconds. Disabled when a
        custom runtime factory makes runtimes cluster-specific
        (a spare booted for one partition would be wrong for another)."""
        if self._warm_pool_size <= 0 or self.dispatcher is None \
                or self._runtime_factory is not None:
            return 0
        ref = next(iter(self.cm.healthy_clusters()), None)
        if ref is None:
            return 0
        n = 0
        while len(self._warm) < self._warm_pool_size:
            self._warm.append(self._make_runtime(ref))
            n += 1
        return n

    def _add_cluster(self, cl: Cluster) -> int:
        did = next(self._next_dispatch_id)
        if self._warm:
            rt = self._warm.pop()
            self.warm_boots += 1
        else:
            rt = self._make_runtime(cl)
        self.dispatcher.register(did, rt)
        if self.telemetry is not None and hasattr(rt, "telemetry_cluster"):
            # runtime-level events carry the dispatcher cluster id so the
            # rt_* instants line up with the dispatcher's spans
            rt.telemetry_cluster = did
        self._runtimes[did] = rt
        self._cluster_of[did] = cl
        return did

    def _runtime_device(self, cl: Cluster):
        """Where ``cl``'s runtime lives: the cluster's first device when it
        is a torch device, else CUDA."""
        first = cl.devices[0] if cl.n_devices else None
        return first if isinstance(first, torch.device) else "cuda"

    def _make_runtime(self, cl: Cluster) -> RuntimeProtocol:
        if self._runtime_factory is not None:
            return self._runtime_factory(cl)
        device = self._runtime_device(cl)
        if self._runtime == "mega":
            from repro_torch.core.mega import MegaRuntime, TILE_OP_NAMES
            names = tuple(self._classes)
            if names != TILE_OP_NAMES[:len(names)]:
                raise ValueError(
                    "runtime='mega' runs the drain megakernel's fixed "
                    "opcode table: registered class names must be a "
                    f"prefix of {TILE_OP_NAMES} in order, got {names} "
                    "(use repro_torch.core.mega.mega_work_classes())")
            rt = MegaRuntime(
                max_inflight=self._max_inflight,
                max_steps=self._max_steps,
                telemetry=self.telemetry,
                exec_cache=self.exec_cache,
                profile=self._profile,
                device=device)
            rt.boot(self._state_factory(cl))
            return rt
        rt = PersistentRuntime(
            [(name, wc.fn) if wc.carry is None else (name, wc.fn, wc.carry)
             for name, wc in self._classes.items()],
            result_template=self._result_template,
            max_inflight=self._max_inflight,
            max_steps=self._max_steps,
            telemetry=self.telemetry,
            staged_cap=self._staged_cap,
            profile=self._profile,
            device=device)
        rt.boot(self._state_factory(cl))
        return rt

    def _repin(self) -> None:
        """Map explicit WorkClass pins (manager-cluster indices) onto the
        dispatcher ids currently accepting work."""
        active = {d: c for d, c in self._cluster_of.items()
                  if d not in self._lame_ducks
                  and d in self.dispatcher.runtimes}
        if not active:
            return
        dids = sorted(active)
        for name, wc in self._classes.items():
            if wc.pin is None:
                continue
            target = next((d for d in dids if active[d].cid == wc.pin),
                          dids[wc.pin % len(dids)])
            self.dispatcher.pin(name, target)

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        """Dispatcher deadline stats plus system lifecycle counters."""
        s = dict(self.dispatcher.deadline_stats()) \
            if self.dispatcher is not None else {"n": 0}
        s.update({
            "heals": self.heals,
            "clusters": len(self.cluster_ids()) if self.dispatcher else 0,
            "lame_ducks": len(self._lame_ducks),
            "generation": self.cm.generation,
            "warm_pool": len(self._warm),
            "warm_boots": self.warm_boots,
            "exec_cache_hits": self.exec_cache.hits,
            "exec_cache_misses": self.exec_cache.misses,
        })
        return s
