"""The port's persistent runtime + Dispatcher against the reference's: one
descriptor workload, under one injected clock, through both stacks —
mid-batch THREAD_PREEMPTED rows in trigger_many rings, chunked carries,
an EDF preemption at a chunk boundary, and failure replay from a dead
cluster. Ticket results, ack rows, the EV_* event sequence and the
deadline_stats() counters must agree."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dispatcher as j_disp
import repro.core.mailbox as j_mb
import repro.core.persistent as j_pers
import repro.core.sched as j_sched
import repro.core.telemetry as j_tel
import repro_torch.core.dispatcher as t_disp
import repro_torch.core.mailbox as t_mb
import repro_torch.core.persistent as t_pers
import repro_torch.core.sched as t_sched
import repro_torch.core.telemetry as t_tel


# --- the same two work functions, once per framework -----------------------

def j_add(state, desc):
    state = dict(state)
    state["x"] = state["x"] + desc[j_mb.W_ARG0].astype(jnp.float32)
    return state, state["x"].sum()[None]


def j_chunk(state, carry, desc):
    carry = carry + desc[j_mb.W_ARG0]
    done = desc[j_mb.W_CHUNK] + 1 >= desc[j_mb.W_NCHUNKS]
    return state, carry, carry.astype(jnp.float32)[None], done


def t_add(state, desc):
    state["x"].add_(float(desc[t_mb.W_ARG0]))
    return state, state["x"].sum()[None]


def t_chunk(state, carry, desc):
    carry = carry + int(desc[t_mb.W_ARG0])
    done = desc[t_mb.W_CHUNK] + 1 >= desc[t_mb.W_NCHUNKS]
    return state, carry, carry.float()[None], done


JAX = types.SimpleNamespace(
    mb=j_mb, Dispatcher=j_disp.Dispatcher, sched=j_sched,
    TraceCollector=j_tel.TraceCollector,
    make_rt=lambda **kw: _boot(j_pers.PersistentRuntime(
        [("add", j_add), ("chunk", j_chunk, jnp.zeros((), jnp.int32))],
        result_template=jnp.zeros((1,), jnp.float32), **kw),
        {"x": jnp.zeros((4,), jnp.float32)}))

TORCH = types.SimpleNamespace(
    mb=t_mb, Dispatcher=t_disp.Dispatcher, sched=t_sched,
    TraceCollector=t_tel.TraceCollector,
    make_rt=lambda **kw: _boot(t_pers.PersistentRuntime(
        [("add", t_add), ("chunk", t_chunk, torch.zeros((), dtype=torch.int32))],
        result_template=torch.zeros((1,), dtype=torch.float32), device="cpu",
        **kw), {"x": torch.zeros((4,), dtype=torch.float32)}))


def _boot(rt, state):
    rt.boot(state)
    return rt


class Clock:
    """Deterministic injected clock: every reading advances 7 µs."""

    def __init__(self):
        self.t = 1_000_000

    def __call__(self):
        self.t += 7
        return self.t


def _record_acks(rt, cid, log):
    inner = rt.wait

    def wait():
        res, fg = inner()
        log.append((cid, np.asarray(fg).astype(np.int32).tobytes()))
        return res, fg

    rt.wait = wait
    return rt


def run_workload(S, policy: str):
    clock = Clock()
    tc = S.TraceCollector(clock=clock)
    acks = []
    # cluster 0 batches (4 in flight, 4-row rings); cluster 1 runs one step
    # at a time, so a queued arrival meets its chunk boundaries
    rts = {0: _record_acks(S.make_rt(max_inflight=4, max_steps=4), 0, acks),
           1: _record_acks(S.make_rt(max_inflight=1), 1, acks)}
    dead = S.make_rt(max_inflight=4, max_steps=4)
    dead.dispose()                               # triggering it fails
    rts[2] = dead
    disp = S.Dispatcher(rts, policy=S.sched.make_policy(policy,
                                                        preemptive=True),
                        clock=clock, telemetry=tc)
    WD = S.mb.WorkDescriptor
    tickets = {}

    def sub(rid, cluster, **kw):
        tickets[rid] = disp.submit(WD(request_id=rid, **kw), cluster=cluster,
                                   admission=False)

    # one coalesced doorbell whose second row is a non-final chunk
    sub(0, 0, opcode=0, arg0=1)
    sub(1, 0, opcode=1, arg0=5, n_chunks=3)
    sub(2, 0, opcode=0, arg0=2)
    sub(3, 0, opcode=0, arg0=3)
    assert disp.kick(0) == 4
    # a chunked carry in flight on cluster 1; a deadline-carrying arrival
    # cuts in at its chunk boundary (EDF)
    sub(4, 1, opcode=1, arg0=4, n_chunks=4)
    assert disp.kick(1) == 1
    sub(5, 1, opcode=0, arg0=7, deadline_us=clock.t + 10**9)
    disp.drain()
    # failure replay: the dead cluster's work lands on the survivors
    sub(6, 2, opcode=1, arg0=2, n_chunks=2)
    sub(7, 2, opcode=0, arg0=1)
    with pytest.raises(Exception):
        disp.pump(2)
    disp.drain()

    results = {rid: np.asarray(t.result()).tolist()
               for rid, t in sorted(tickets.items())}
    events = [(e.kind, e.cluster, e.request_id, e.opcode, e.chunk)
              for e in tc.events]
    stats = {k: v for k, v in disp.deadline_stats().items()
             if not k.endswith("_us")}
    rts[0].dispose()
    rts[1].dispose()
    return results, acks, events, stats


@pytest.mark.parametrize("policy", ["edf", "fp", "server"])
def test_port_dispatch_matches_reference(policy):
    j_res, j_acks, j_ev, j_stats = run_workload(JAX, policy)
    t_res, t_acks, t_ev, t_stats = run_workload(TORCH, policy)
    assert t_res == j_res
    assert t_acks == j_acks
    assert t_ev == j_ev
    assert t_stats == j_stats
    # the workload exercised what it claims to
    kinds = [e[0] for e in j_ev]
    assert "fail" in kinds and "requeue" in kinds
    assert "chunk_retire" in kinds
    assert j_stats["chunks"] >= 5 and j_stats["n"] == 8
    assert any(status == j_mb.THREAD_PREEMPTED for status in
               (np.frombuffer(a, np.int32)[j_mb.W_STATUS] for _, a in j_acks))
    if policy == "edf":
        assert j_stats["preemptions"] >= 1 and "preempt" in kinds


def test_port_runtime_ring_equals_sequential_triggers():
    """The port's trigger_many ring retires exactly the (result, ack)
    sequence of sequential triggers, NOP padding included."""
    d0 = t_mb.WorkDescriptor(opcode=1, arg0=7, request_id=9, n_chunks=3)
    chain = [t_mb.WorkDescriptor(opcode=0, arg0=1, request_id=8), d0,
             d0.advance(), d0.advance().advance()]
    rt_b = TORCH.make_rt(max_inflight=8, max_steps=3)
    rt_b.trigger_many(chain)
    batched = [(res.tolist(), fg.tobytes()) for res, fg in rt_b.wait_all()]
    rt_s = TORCH.make_rt(max_inflight=8, max_steps=3)
    seq = []
    for d in chain:
        res, fg = rt_s.run_sync(d)
        seq.append((res.tolist(), fg.tobytes()))
    assert batched == seq
    assert rt_b.doorbells == 2 and rt_b.batched_steps == 4
    assert [r[0] for r in batched] == [[4.0], [7.0], [14.0], [21.0]]


def test_port_mailbox_constants_and_device_view():
    mbox = t_mb.Mailbox(2)
    mbox.post(1, t_mb.WorkDescriptor(opcode=3, request_id=5).encode())
    view = mbox.device_view(1, device="cpu")
    assert view.dtype == torch.int32
    assert view.tolist() == mbox.to_gpu[1].tolist()
