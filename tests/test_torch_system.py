"""The port's cluster carving, ``LkSystem`` lifecycle (self-healing loop,
lame ducks, warm pool, ``apply_shares``) and ``ElasticController``
decisions against the reference's, on the same scripted scenarios: fleets
of fake devices (of CPU devices where the port boots real runtimes), fake
runtimes that can be rigged to die, one injected clock. Trigger/wait logs,
ticket placements, heal/recarve counters, ``stats()`` and controller
verdicts must agree."""
import types
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.clusters as j_clusters
import repro.core.dispatcher as j_disp
import repro.core.elastic as j_elastic
import repro.core.mailbox as j_mb
import repro.core.mega as j_mega
import repro.core.telemetry as j_tel
import repro.kernels.persistent as J
import repro.system as j_system
import repro_torch.core.clusters as t_clusters
import repro_torch.core.dispatcher as t_disp
import repro_torch.core.elastic as t_elastic
import repro_torch.core.mega as t_mega
import repro_torch.core.telemetry as t_tel
import repro_torch.kernels.persistent as P
import repro_torch.system as t_system
from repro_torch.core import mailbox as mb
from tests_util_devs import devs


def cpus(n):
    """A fleet of n CPU devices: the port places each runtime on its
    cluster's first device."""
    return [torch.device("cpu") for _ in range(n)]


class FakeRuntime:
    """RuntimeProtocol double (framework-free) whose wait can be rigged to
    die — at once (fail_wait) or after N retirements (fail_after)."""

    def __init__(self, cid, log, max_inflight=2, fail_wait=False,
                 fail_after=None):
        self.cid = cid
        self.log = log
        self.max_inflight = max_inflight
        self.fail_wait = fail_wait
        self.fail_after = fail_after
        self.waits = 0
        self._q = deque()

    def _dead(self):
        return self.fail_wait or (self.fail_after is not None
                                  and self.waits >= self.fail_after)

    def trigger(self, desc):
        if len(self._q) >= self.max_inflight:
            raise RuntimeError("full")
        self.log.append(("trigger", self.cid, desc.request_id))
        self._q.append(desc)

    def ready(self):
        return bool(self._q) and not self._dead()

    def wait(self):
        desc = self._q.popleft()
        if self._dead():
            raise RuntimeError(f"cluster {self.cid} wait died")
        self.waits += 1
        self.log.append(("wait", self.cid, desc.request_id))
        fg = np.zeros((mb.DESC_WIDTH,), np.int32)
        fg[mb.W_STATUS] = mb.THREAD_FINISHED
        fg[mb.W_REQID] = desc.request_id
        return np.float32([desc.request_id]), fg

    def dispose(self):
        self._q.clear()


class Clock:
    """Injected µs clock: moves 1 µs per reading, or when told."""

    def __init__(self, t=1_000_000):
        self.t = t

    def __call__(self):
        self.t += 1
        return self.t

    def advance(self, us):
        self.t += us


def _j_add(state, desc):
    x = state["x"] + 1.0
    return {"x": x}, x.sum()[None]


def _t_add(state, desc):
    state["x"].add_(1.0)
    return state, state["x"].sum()[None]


REF = types.SimpleNamespace(
    LkSystem=j_system.LkSystem, WorkClass=j_system.WorkClass,
    CRIT_HIGH=j_system.CRIT_HIGH, ClusterManager=j_clusters.ClusterManager,
    Controller=j_elastic.ElasticController, Dispatcher=j_disp.Dispatcher,
    TraceCollector=j_tel.TraceCollector, now_us=j_disp.now_us,
    allocate=j_elastic.allocate_clusters, add=_j_add, K=J,
    mega_work_classes=j_mega.mega_work_classes,
    state=lambda cl: {"x": jnp.zeros((4,), jnp.float32)},
    result_template=jnp.zeros((1,), jnp.float32), fleet=devs, mb=j_mb)
PORT = types.SimpleNamespace(
    LkSystem=t_system.LkSystem, WorkClass=t_system.WorkClass,
    CRIT_HIGH=t_system.CRIT_HIGH, ClusterManager=t_clusters.ClusterManager,
    Controller=t_elastic.ElasticController, Dispatcher=t_disp.Dispatcher,
    TraceCollector=t_tel.TraceCollector, now_us=t_disp.now_us,
    allocate=t_elastic.allocate_clusters, add=_t_add, K=P,
    mega_work_classes=t_mega.mega_work_classes,
    state=lambda cl: {"x": torch.zeros(4)},
    result_template=torch.zeros(1), fleet=cpus, mb=mb)


def make_system(S, **kw):
    kw.setdefault("state_factory", S.state)
    kw.setdefault("result_template", S.result_template)
    return S.LkSystem(**kw)


def _stable(stats):
    """stats() less timings and the executable-cache counters (the port's
    scan runtime prepares nothing, the reference's compiles)."""
    return {k: v for k, v in stats.items()
            if not k.endswith("_us") and k != "stragglers"
            and not k.startswith("exec_cache")}


# ---------------------------------------------------------------------------
# cluster carving
# ---------------------------------------------------------------------------

def carve_script(S):
    snap = []

    def take(cm):
        snap.append(([(c.cid, [d.id for d in c.devices], c.healthy)
                      for c in cm.clusters],
                     [d.id for d in cm.spare_devices], cm.generation,
                     cm.check_disjoint(), cm.coverage(),
                     cm.pin_map(["a", "b", "c"])))

    cm = S.ClusterManager(devices=devs(9), n_clusters=2)
    take(cm)
    cm.mark_failed(0)
    cm.recarve()
    take(cm)
    cm.recarve(3)
    take(cm)
    one = devs(1)[0]
    take(S.ClusterManager(devices=[one] * 3, n_clusters=3))
    for c in cm.clusters:
        cm.mark_failed(c.cid)
    cm.spare_devices = []
    with pytest.raises(RuntimeError, match="no healthy"):
        cm.recarve()
    return snap


def test_cluster_manager_matches_reference():
    got = carve_script(PORT)
    assert got == carve_script(REF)
    assert got[0][3] and got[0][4] == pytest.approx(8 / 9)
    assert not got[3][3]                      # one device carved three ways
    # cluster meshes are DeviceMeshes over a process group's ranks; with
    # no group running (here) a cluster holds none, and asking for one
    # raises (8 gloo ranks: tests/test_torch_mesh_train.py)
    assert all(c.mesh is None for c in
               t_clusters.ClusterManager(devices=devs(4), n_clusters=2)
               .clusters)
    with pytest.raises(RuntimeError, match="process group"):
        t_clusters.make_cluster_mesh(devs(2))
    with pytest.raises(RuntimeError, match="process group"):
        make_system(PORT, devices=devs(2),
                    state_shardings_factory=lambda cl: None)


def test_plain_system_boots_under_a_process_group(tmp_path):
    """Cluster meshes are built only for meshed state: under a running
    (one-rank gloo) group a plain LkSystem on CPU devices carves, boots
    and serves as without one, and makes no process group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _world
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        groups = len(_world.pg_map)
        sys_ = make_system(PORT, devices=cpus(4), n_clusters=2,
                           work_classes=[PORT.WorkClass("add", fn=PORT.add,
                                                        pin=1)])
        with sys_:
            got = [float(sys_.submit("add").result()[0]) for _ in range(2)]
            placed = {sys_._cluster_of[d].cid
                      for d in sys_.dispatcher.pins()["add"]}
        assert got == [4.0, 8.0] and placed == {1}
        assert all(c.mesh is None for c in sys_.cm.clusters)
        assert not sys_.cm.meshed and len(_world.pg_map) == groups
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", [0, 1])
def test_allocate_clusters_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        dids = sorted(rng.choice(50, size=int(rng.integers(0, 9)),
                                 replace=False).tolist())
        shares = {f"c{i}": int(rng.integers(0, 6))
                  for i in range(int(rng.integers(1, 5)))}
        assert PORT.allocate(dids, shares) == REF.allocate(dids, shares)


# ---------------------------------------------------------------------------
# the self-healing loop, lame ducks, heal disabled
# ---------------------------------------------------------------------------

def heal_scenario(S, name):
    log = []
    arm = [True]

    def factory(cl):
        if name == "duck_death" and arm[0] and cl.cid == 1:
            return FakeRuntime(cl.cid, log, max_inflight=1, fail_after=1)
        fail = (arm[0] or name == "heal_disabled") and cl.cid == 0
        return FakeRuntime(cl.cid, log,
                           max_inflight=2 if name in ("self_heal",
                                                      "heal_disabled") else 1,
                           fail_wait=fail)

    n_dev = {"self_heal": 9, "lame_duck": 5, "duck_death": 5,
             "heal_disabled": 4}[name]
    classes = [S.WorkClass("a", fn=S.add, pin=0),
               S.WorkClass("b", fn=S.add, pin=1)]
    sys_ = make_system(S, devices=S.fleet(n_dev), n_clusters=2,
                       runtime_factory=factory, work_classes=classes,
                       heal=name != "heal_disabled")
    with sys_:
        arm[0] = False
        tickets = [sys_.submit("b") for _ in range(3)] + \
            [sys_.submit("a") for _ in range(4)]
        sys_.drain()
        assert all(t.done() for t in tickets)       # zero lost
        tickets.append(sys_.submit("a"))
        tickets[-1].result()
        out = dict(log=log, placed=[t.completion.cluster for t in tickets],
                   stats=_stable(sys_.stats()),
                   ids=sorted(sys_.cluster_ids()),
                   runtimes=sorted(sys_.dispatcher.runtimes),
                   pins=sys_.dispatcher.pins(),
                   healthy=[c.healthy for c in sys_.cm.clusters])
    return out


@pytest.mark.parametrize("name", ["self_heal", "lame_duck", "duck_death",
                                  "heal_disabled"])
def test_heal_loop_matches_reference(name):
    got = heal_scenario(PORT, name)
    assert got == heal_scenario(REF, name)
    s = got["stats"]
    assert s["n"] == 8 and s["lame_ducks"] == 0
    assert s["heals"] == (0 if name == "heal_disabled" else 1)
    assert 0 not in got["placed"]


def real_heal(S, runtime):
    kw = dict(work_classes=[S.WorkClass("w", fn=S.add, pin=0)])
    if runtime == "mega":
        kw = dict(work_classes=S.mega_work_classes(), runtime="mega",
                  state_factory=lambda cl: S.K.tile_state(4, seed=3))
    sys_ = make_system(S, devices=S.fleet(9), n_clusters=2, **kw)
    name = "w" if runtime == "scan" else "copy"
    with sys_:
        tickets = [sys_.submit(name, arg0=S.K.pack_args(1, 0)[0])
                   for _ in range(4)]
        sys_.runtimes[0].dispose()       # the fault: cluster 0's runtime dies
        done = sys_.drain()
        assert len(done) == 4 and all(t.done() for t in tickets)
        tickets.append(sys_.submit(name, arg0=S.K.pack_args(1, 0)[0]))
        res = [float(np.asarray(t.result())[0]) for t in tickets]
        return res, [t.completion.cluster for t in tickets], \
            _stable(sys_.stats())


@pytest.mark.parametrize("runtime", ["scan", "mega"])
def test_real_runtime_heal_matches_reference(runtime):
    """Kill a real runtime mid-service: fresh capacity boots from
    state_factory and the replayed work completes, as in the reference."""
    got_res, got_placed, got_stats = real_heal(PORT, runtime)
    want_res, want_placed, want_stats = real_heal(REF, runtime)
    np.testing.assert_allclose(got_res, want_res, rtol=1e-4, atol=1e-4)
    assert got_placed == want_placed and 0 not in got_placed
    assert got_stats == want_stats and got_stats["heals"] == 1


# ---------------------------------------------------------------------------
# elastic: apply_shares, warm pool, the controller
# ---------------------------------------------------------------------------

def recarve_stream(S, seed):
    rng = np.random.default_rng(seed)
    log = []
    collector = S.TraceCollector()
    sys_ = make_system(
        S, devices=S.fleet(8), n_clusters=4, telemetry=collector,
        runtime_factory=lambda cl: FakeRuntime(cl.cid, log),
        work_classes=[S.WorkClass("hi", fn=S.add, wcet_us=100.0,
                                  criticality=S.CRIT_HIGH),
                      S.WorkClass("lo", fn=S.add, wcet_us=100.0)])
    with sys_:
        sys_.apply_shares({"hi": 1, "lo": 3})
        tickets = []
        for i in range(30):
            name = "hi" if rng.random() < 0.8 else "lo"
            tickets.append(sys_.submit(name,
                                       deadline_us=S.now_us() + 60_000_000))
            if i == 15:                   # grow mid-stream: 4 -> 6 clusters
                sys_.apply_shares({"hi": 4, "lo": 2})
        sys_.drain()
        assert all(t.done() for t in tickets)
        return dict(log=log, placed=[t.completion.cluster for t in tickets],
                    stats=_stable(sys_.stats()), pins=sys_.dispatcher.pins(),
                    violations=collector.monitor.counts()["bound_violations"])


def test_recarve_mid_stream_matches_reference():
    got = recarve_stream(PORT, 0)
    assert got == recarve_stream(REF, 0)
    assert got["violations"] == 0 and got["stats"]["recarves"] == 2
    assert got["stats"]["lame_ducks"] == 0 and len(got["pins"]["hi"]) == 4


def warm_pool_run(S):
    sys_ = make_system(
        S, devices=S.fleet(4), n_clusters=2, warm_pool=2, runtime="mega",
        work_classes=S.mega_work_classes()[:2],
        state_factory=lambda cl: S.K.tile_state(4, seed=5))
    with sys_:
        before = sys_.stats()["warm_pool"]
        sys_.apply_shares({"nop": 3, "matmul": 1})      # grow 2 -> 4
        s = sys_.stats()
        r = sys_.submit("matmul", arg0=S.K.pack_args(2, 0, 1)[0], arg1=1)
        res = float(np.asarray(r.result())[0])
        sys_.drain()
        stats = sys_.stats()
        after = dict(_stable(stats), **{k: v for k, v in stats.items()
                                        if k.startswith("exec_cache")})
        return before, _stable(s), after, res


def test_warm_pool_and_exec_cache_match_reference():
    """Mega boots go through the shared cache in both packages, so its
    counters agree too."""
    got = warm_pool_run(PORT)
    want = warm_pool_run(REF)
    assert got[:3] == want[:3]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)
    before, grown, after, _ = got
    assert before == 2 and grown["warm_boots"] == 2
    assert after["warm_pool"] == 2                   # reap() replenished
    assert after["exec_cache_misses"] == 1 and after["exec_cache_hits"] >= 5


def _backlog(S, d, opcode, n, cluster=0, deadline_us=0):
    return [d.submit(S.mb.WorkDescriptor(opcode=opcode, request_id=100 + i,
                                         deadline_us=deadline_us),
                     cluster=cluster, admission=False)
            for i in range(n)]


def controller_script(S, name):
    """One scripted advisory-mode scenario; returns every tick's verdict
    with the controller and dispatcher counters and pins after it."""
    clock = Clock()
    d = S.Dispatcher({c: FakeRuntime(c, []) for c in range(4)},
                     wcet_us={0: 100.0, 1: 100.0}, clock=clock,
                     telemetry=S.TraceCollector(clock=clock))
    kw = dict(hysteresis=dict(sustain=2, cooldown_us=100_000),
              sustained=dict(sustain=2, cooldown_us=100_000),
              veto=dict(sustain=1, cooldown_us=0))[name]
    ctrl = S.Controller(clock=clock, interval_us=0, **kw).bind_dispatcher(
        d, {"hi": 0, "lo": 1})
    d.pin("hi", (0, 1))
    d.pin("lo", (2, 3))
    trace = []

    def tick():
        res = ctrl.tick()
        trace.append((res, ctrl.counters(), d.recarves, d.recarve_rejected,
                       d.pins(), ctrl.current_shares()))

    if name == "hysteresis":
        for _ in range(4):
            hi = _backlog(S, d, 0, 6)
            tick()
            for t in hi:
                t.cancel()
            lo = _backlog(S, d, 1, 6, cluster=2)
            tick()
            for t in lo:
                t.cancel()
            clock.advance(10_000)
    elif name == "sustained":
        _backlog(S, d, 0, 8)
        tick()
        tick()
        for it in d.policy.live_items(0) + d.policy.live_items(1):
            if it.ticket is not None:
                it.ticket.cancel()
        _backlog(S, d, 1, 8, cluster=3)
        tick()
        tick()
        clock.advance(200_000)
        tick()
    else:
        _backlog(S, d, 1, 2, cluster=2, deadline_us=clock.t + 300)
        _backlog(S, d, 1, 2, cluster=3, deadline_us=clock.t + 300)
        _backlog(S, d, 0, 40)
        tick()
    return trace, ctrl.share_history, ctrl.demand_us()


@pytest.mark.parametrize("name", ["hysteresis", "sustained", "veto"])
def test_controller_decisions_match_reference(name):
    got = controller_script(PORT, name)
    assert got == controller_script(REF, name)
    trace = got[0]
    applied = [t[0] for t in trace if t[0] is not None]
    if name == "hysteresis":
        assert applied == []
    elif name == "sustained":
        assert applied[0]["hi"] == 3 and trace[-1][2] == 2
    else:
        assert applied == [] and trace[-1][1]["rejected"] == 1


def full_mode(S):
    clock = Clock()
    ctrl = S.Controller(clock=clock, interval_us=0, sustain=1,
                        cooldown_us=0)
    sys_ = make_system(S, devices=S.fleet(8), n_clusters=4, elastic=ctrl,
                       runtime_factory=lambda cl: FakeRuntime(cl.cid, []),
                       work_classes=[S.WorkClass("hi", fn=S.add,
                                                 wcet_us=100.0),
                                     S.WorkClass("lo", fn=S.add,
                                                 wcet_us=100.0)])
    with sys_:
        sys_.apply_shares({"hi": 1, "lo": 3})
        tickets = [sys_.submit("hi") for _ in range(20)]
        tickets += [sys_.submit("lo") for _ in range(3)]
        sys_.drain()
        assert all(t.done() for t in tickets)
        return (ctrl.share_history, ctrl.counters(), sys_.recarves,
                sys_.dispatcher.pins(), _stable(sys_.stats()))


def test_controller_full_mode_matches_reference():
    got = full_mode(PORT)
    assert got == full_mode(REF)
    assert got[2] >= 2 and got[0][-1][1]["hi"] == 3
