"""The port's megakernel dispatch path against the reference's, on the CPU:
``MegaRuntime`` (drain kernel through its plain version) against the
reference's (Pallas in interpret mode) on the same descriptors and the same
numpy-drawn workspace — byte-identical acks, results within 1e-4, equal
``work_drained`` — plus the port's own mega-vs-scan token identity, batch
splitting, the one-row fallback, the errors, the executable cache, and
``LkSystem(runtime="mega")`` ticket results against the reference's."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.mailbox as j_mb
import repro.core.mega as j_mega
import repro.core.persistent as j_pers
import repro.core.telemetry as j_tel
import repro.kernels.persistent as J
import repro.system as j_system
import repro_torch.core.mailbox as t_mb
import repro_torch.core.mega as t_mega
import repro_torch.core.persistent as t_pers
import repro_torch.core.telemetry as t_tel
import repro_torch.kernels.persistent as P
import repro_torch.system as t_system
from tests_util_devs import devs


def cpus(n):
    """A fleet of n CPU devices: the port places each runtime on its
    cluster's first device."""
    return [torch.device("cpu") for _ in range(n)]

NBUF, SEED, QCAP = 4, 1, 8
TOL = dict(rtol=1e-4, atol=1e-4)
_JCACHE = j_pers.ExecutableCache()     # one interpret compile for the file


def mixed_descs(mb):
    """Every opcode once, with a chunked reduce mid-queue whose first chunk
    stamps THREAD_PREEMPTED between FINISHED neighbours."""
    WD = mb.WorkDescriptor
    return [
        WD(opcode=J.OP_MATMUL, request_id=10, arg0=J.pack_args(3, 0, 1)[0],
           arg1=1),
        WD(opcode=J.OP_REDUCE, request_id=11, arg0=J.pack_args(0, 2)[0],
           n_chunks=3),
        WD(opcode=J.OP_ADD, request_id=12, arg0=J.pack_args(2, 0, 1)[0],
           arg1=1),
        WD(opcode=J.OP_SCALE, request_id=13, arg0=J.pack_scale(1, 1, 0.5)[0],
           arg1=J.pack_scale(1, 1, 0.5)[1]),
        WD(opcode=J.OP_RELU, request_id=14, arg0=J.pack_args(0, 3)[0]),
        WD(opcode=J.OP_COPY, request_id=15, arg0=J.pack_args(1, 2)[0]),
        WD(opcode=J.OP_NOP, request_id=16),
    ]


def boot_ref(telemetry=None, **kw):
    rt = j_mega.MegaRuntime(exec_cache=_JCACHE, telemetry=telemetry, **kw)
    rt.boot(J.tile_state(NBUF, seed=SEED))
    return rt


def boot_port(telemetry=None, max_inflight=64, max_steps=QCAP, **kw):
    rt = t_mega.MegaRuntime(max_inflight=max_inflight, max_steps=max_steps,
                            telemetry=telemetry, device="cpu", **kw)
    rt.boot(P.tile_state(NBUF, seed=SEED))
    return rt


def boot_port_scan():
    rt = t_pers.PersistentRuntime(
        P.tile_work_table(), result_template=P.TILE_RESULT_TEMPLATE,
        max_inflight=64, max_steps=QCAP, device="cpu")
    rt.boot(P.tile_state(NBUF, seed=SEED))
    return rt


def retire_all(rt, descs, batched=True):
    if batched:
        rt.trigger_many(descs)
    else:
        for d in descs:
            rt.trigger(d)
    out = [(np.asarray(res).astype(np.float32),
            np.asarray(fg).astype(np.int32).tobytes())
           for res, fg in rt.wait_all()]
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for (gres, gfg), (wres, wfg) in zip(got, want):
        assert gfg == wfg                                  # byte-identical
        np.testing.assert_allclose(gres, wres, **TOL)


@pytest.mark.parametrize("batched,profile", [(True, False), (False, False),
                                             (True, True)])
def test_mega_matches_reference_and_scan(batched, profile):
    ref = boot_ref(max_inflight=64, max_steps=QCAP,
                   telemetry=j_tel.TraceCollector() if profile else None)
    port = boot_port(telemetry=t_tel.TraceCollector() if profile else None)
    want = retire_all(ref, mixed_descs(j_mb), batched)
    got = retire_all(port, mixed_descs(t_mb), batched)
    assert_same(got, want)
    assert_same(got, retire_all(boot_port_scan(), mixed_descs(t_mb), batched))
    assert (port.work_drained, port.doorbells, port.device_spans) == \
        (ref.work_drained, ref.doorbells, ref.device_spans)
    assert port.work_drained == 7
    assert port.device_spans == (7 if profile else 0)
    statuses = [np.frombuffer(fg, np.int32)[t_mb.W_STATUS] for _, fg in got]
    assert statuses[1] == t_mb.THREAD_PREEMPTED
    for rt in (ref, port):
        rt.dispose()
    j_pers.reap_deferred()
    t_pers.reap_deferred()


def test_mega_chunked_carry_resumes_across_launches():
    """A 3-chunk reduce re-triggered chunk by chunk (three launches)
    threads the device-resident carry: the reference's trajectory, acks
    and PREEMPTED/FINISHED stamps."""
    chain = {}
    for mb in (j_mb, t_mb):
        d0 = mb.WorkDescriptor(opcode=J.OP_REDUCE, request_id=40,
                               arg0=J.pack_args(0, 2)[0], n_chunks=3)
        chain[mb] = [d0, d0.advance(), d0.advance().advance()]
    ref = boot_ref(max_inflight=64, max_steps=QCAP)
    port = boot_port()
    got = retire_all(port, chain[t_mb], batched=False)
    assert_same(got, retire_all(ref, chain[j_mb], batched=False))
    s = float(P.tile_state(NBUF, seed=SEED)["ws"][2].sum())
    np.testing.assert_allclose([r[0] for r, _ in got], [s, 2 * s, 3 * s],
                               rtol=1e-4)
    assert [np.frombuffer(fg, np.int32)[t_mb.W_STATUS] for _, fg in got] == \
        [t_mb.THREAD_PREEMPTED, t_mb.THREAD_PREEMPTED, t_mb.THREAD_FINISHED]


def test_mega_batch_splits_and_work_drained():
    """N > max_steps splits into ceil(N/Q) launches; QC_DRAINED totals N
    after full retirement (NOP padding never counts)."""
    rt = boot_port(max_steps=4)
    descs = [t_mb.WorkDescriptor(opcode=J.OP_RELU, request_id=i,
                                 arg0=J.pack_args(1, 0)[0])
             for i in range(10)]
    assert rt.trigger_many(descs) == 10
    assert rt.doorbells == 3 and rt.batched_steps == 10
    assert rt.work_drained == 0                 # nothing read back yet
    out = rt.wait_all()
    assert [int(fg[t_mb.W_REQID]) for _, fg in out] == list(range(10))
    assert rt.work_drained == 10
    rt.dispose()


def test_mega_trigger_single_item_fallback():
    rt = boot_port()
    rt.trigger(t_mb.WorkDescriptor(opcode=J.OP_COPY, request_id=7,
                                   arg0=J.pack_args(1, 0)[0]))
    res, fg = rt.wait()
    assert int(fg[t_mb.W_STATUS]) == t_mb.THREAD_FINISHED
    assert int(fg[t_mb.W_REQID]) == 7
    s = float(P.tile_state(NBUF, seed=SEED)["ws"][0].sum())
    np.testing.assert_allclose(float(res[0]), s, rtol=1e-4)
    assert rt.work_drained == 1 and rt.doorbells == 1
    rt.dispose()


def test_mega_errors_capacity_cache_and_dispose():
    rt = t_mega.MegaRuntime(device="cpu")
    with pytest.raises(RuntimeError, match="boot"):
        rt.trigger_many([t_mb.WorkDescriptor(opcode=J.OP_NOP)])
    with pytest.raises(ValueError, match="ws"):
        rt.boot({"ws": torch.zeros((2, 8, 8))})
    with pytest.raises(ValueError, match="max_steps"):
        t_mega.MegaRuntime(max_steps=0, device="cpu")
    rt = boot_port(max_inflight=2)
    assert rt.trigger_many([]) == 0
    with pytest.raises(RuntimeError, match="capacity"):
        rt.trigger_many([t_mb.WorkDescriptor(opcode=J.OP_NOP, request_id=i)
                         for i in range(3)])
    # the shared cache prepares a launch once per key (bare / profiled)
    cache = t_pers.ExecutableCache()
    for profile in (False, False, True):
        boot_port(exec_cache=cache, profile=profile).dispose()
    assert cache.counters() == {"hits": 1, "misses": 2, "entries": 2}
    # dispose detaches at once; the blocking half runs in reap_deferred
    t_pers.reap_deferred()
    rt.trigger(t_mb.WorkDescriptor(opcode=J.OP_RELU, request_id=1))
    rt.dispose()
    assert rt.state is None and rt.status == t_mb.THREAD_EXIT
    assert t_pers.reap_deferred() == 1
    assert t_pers.reap_deferred() == 0


def test_mega_work_classes_helper():
    classes = t_mega.mega_work_classes(matmul={"wcet_us": 123.0})
    assert [c.name for c in classes] == list(P.TILE_OP_NAMES)
    assert classes[1].wcet_us == 123.0
    assert classes[J.OP_REDUCE].carry is not None
    assert all(c.carry is None for i, c in enumerate(classes)
               if i != J.OP_REDUCE)
    with pytest.raises(KeyError, match="zap"):
        t_mega.mega_work_classes(zap={"wcet_us": 1.0})


# ---------------------------------------------------------------------------
# LkSystem runtime="mega" end to end
# ---------------------------------------------------------------------------

def _stable(stats):
    return {k: v for k, v in stats.items()
            if not k.endswith("_us") and not k.startswith("exec_cache")
            and k != "stragglers"}


def run_system(S, K, runtime, **kw):
    """One matmul, a 3-chunk reduce resolved through the dispatcher's
    chunk-boundary path, and every other tile op, through ``S.LkSystem``."""
    sys_ = S.LkSystem(devices=S.fleet(2), n_clusters=1,
                      state_factory=lambda cl: K.tile_state(NBUF, seed=2),
                      result_template=K.TILE_RESULT_TEMPLATE,
                      work_classes=S.mega_work_classes(), runtime=runtime,
                      max_inflight=8, **kw).boot()
    tickets = [
        sys_.submit("matmul", arg0=J.pack_args(3, 0, 1)[0], arg1=1),
        sys_.submit("reduce", arg0=J.pack_args(2, 2)[0], n_chunks=3),
        sys_.submit("add", arg0=J.pack_args(1, 3, 0)[0], arg1=0),
        sys_.submit("scale", arg0=J.pack_scale(0, 1, 2.0)[0],
                    arg1=J.pack_scale(0, 1, 2.0)[1]),
        sys_.submit("relu", arg0=J.pack_args(1, 0)[0]),
        sys_.submit("copy", arg0=J.pack_args(3, 2)[0]),
        sys_.submit("nop"),
    ]
    sys_.drain()
    assert all(t.done() for t in tickets)
    results = [float(np.asarray(t.result())[0]) for t in tickets]
    rt = list(sys_.runtimes.values())[0]
    drained = getattr(rt, "work_drained", None)
    stats = _stable(sys_.stats())
    sys_.dispose()
    return results, drained, stats


def test_system_mega_matches_reference_and_scan():
    j_ns = type("J", (), dict(LkSystem=j_system.LkSystem, fleet=devs,
                              mega_work_classes=j_mega.mega_work_classes))
    t_ns = type("T", (), dict(LkSystem=t_system.LkSystem, fleet=cpus,
                              mega_work_classes=t_mega.mega_work_classes))
    want, j_drained, j_stats = run_system(j_ns, J, "mega",
                                          exec_cache=_JCACHE)
    got, t_drained, t_stats = run_system(t_ns, P, "mega")
    scan, _, _ = run_system(t_ns, P, "scan")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(scan, want, **TOL)
    assert t_drained == j_drained == 9         # 6 single rows + 3 chunks
    assert t_stats == j_stats
    ws = P.tile_state(NBUF, seed=2)["ws"].numpy()
    np.testing.assert_allclose(got[1], 3 * float(ws[2].sum()), rtol=1e-4)


def test_system_mega_rejects_non_prefix_classes():
    def make(classes):
        return t_system.LkSystem(
            devices=cpus(2), state_factory=lambda cl: P.tile_state(NBUF),
            result_template=P.TILE_RESULT_TEMPLATE, work_classes=classes,
            runtime="mega")
    zzz = t_system.WorkClass("zzz", fn=lambda s, d: (s, torch.zeros(1)))
    with pytest.raises(ValueError, match="prefix"):
        make([zzz]).boot()
    wrong_order = [t_mega.mega_work_classes()[1],
                   t_mega.mega_work_classes()[0]]
    with pytest.raises(ValueError, match="prefix"):
        make(wrong_order).boot()
    with pytest.raises(ValueError, match="runtime"):
        t_system.LkSystem(devices=devs(1), state_factory=dict,
                          result_template=None, runtime="zap")


# ---------------------------------------------------------------------------
# TraditionalRuntime: the per-call launch baseline
# ---------------------------------------------------------------------------

def test_traditional_runtime_matches_reference():
    def j_add(state, desc):
        x = state["x"] + desc[j_mb.W_ARG0].astype(jnp.float32)
        return {"x": x}, x.sum()[None]

    def t_add(state, desc):
        x = state["x"] + float(desc[t_mb.W_ARG0])
        return {"x": x}, x.sum()[None]

    x0 = np.arange(4, dtype=np.float32)
    ref = j_pers.TraditionalRuntime([("add", j_add)],
                                    jnp.zeros((1,), jnp.float32))
    ref.boot({"x": jnp.asarray(x0)})
    port = t_pers.TraditionalRuntime([("add", t_add)], torch.zeros(1),
                                     device="cpu")
    state = {"x": torch.from_numpy(x0.copy())}
    port.boot(state)
    for arg in (1, 5, -2):
        want = ref.launch("add", j_mb.WorkDescriptor(arg0=arg))
        got = port.launch("add", t_mb.WorkDescriptor(arg0=arg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want))
    assert state["x"].tolist() == x0.tolist()      # the caller's copy stays
    for phase in ("init", "trigger", "wait"):
        assert port.tracker.report()[phase]["count"] == \
            ref.tracker.report()[phase]["count"]
    port.dispose()
