"""The port's stream frontend against the reference: reduced llama3-8b with
the reference's parameters converted. Mixed HIGH/LOW streams give the JAX
engine's ``generate`` tokens exactly, every lifecycle phase is traced in
order, no HIGH stream violates its admitted bound, overload sheds only LOW
streams and re-admits them, ``add_request`` does not block, host prefill
emits its ``engine`` event, and ``serve --streams`` fills its report."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.core.sched import CRIT_HIGH, CRIT_LOW
from repro_torch.core.telemetry import EV_ENGINE, EV_STREAM, TraceCollector
from repro_torch.core.telemetry.monitor import BOUND_VIOLATION
from repro_torch.models import build, params_from_jax
from repro_torch.serving import (OP_STREAM_HIGH, OP_STREAM_LOW, ServingEngine,
                                 StreamFrontend)
from repro_torch.serving.streams import ST_CLOSED

MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    j_cfg = j_get_config("llama3-8b").reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    j_params = j_model.init(jax.random.key(0))
    cfg = get_config("llama3-8b").reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    return j_model, j_params, model, params


def reference_tokens(models, prompts, max_new):
    j_model, j_params, _, _ = models
    eng = JServingEngine(j_model, j_params, max_batch=2, max_seq=MAX_SEQ)
    out = eng.generate(prompts, max_new_tokens=max_new)
    eng.dispose()
    return out


def make_engine(models, **kw):
    _, _, model, params = models
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    return ServingEngine(model, params, device="cpu", **kw)


def phases_of(collector, stream_id=None):
    return [e.extra.get("phase")
            for e in collector.events_of(EV_STREAM, stream_id)]


def test_add_request_returns_before_prefill_completes(models):
    eng = make_engine(models, chunked_prefill=True, prefill_chunk_tokens=2)
    slot = eng.add_request(1, np.arange(1, 9), max_new_tokens=4)
    assert slot is not None
    ticket = eng.prefill_tickets.get(slot)
    assert ticket is not None
    assert ticket.completion is None          # nothing ran yet: no block
    assert eng.slots.slots[slot].phase == "prefill"
    ticket.result()
    while eng.slots.any_active:
        eng.step()
    eng.dispose()


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked_prefill", "host_prefill"])
def test_stream_frontend_matches_reference(models, chunked):
    kw = dict(chunked_prefill=True, prefill_chunk_tokens=2) if chunked \
        else {}
    eng = make_engine(models, max_batch=3, **kw)
    fe = StreamFrontend(eng, slack_us=10_000_000.0)
    fe.open_stream(np.arange(1, 6), max_new_tokens=3)      # warm-up
    fe.serve(max_polls=3000)
    prompts = [np.array([i + 1, i + 2, i + 3, i + 4, i + 5])
               for i in range(6)]
    sids = [fe.open_stream(p, max_new_tokens=4,
                           criticality=CRIT_HIGH if i % 2 == 0
                           else CRIT_LOW)
            for i, p in enumerate(prompts)]
    fe.serve(max_polls=6000)
    got = [fe.result(s) for s in sids]
    assert got == reference_tokens(models, prompts, 4)
    assert got == eng.generate(prompts, max_new_tokens=4)
    needed = ("open", "slot_bind", "first_token", "decode", "close")
    if chunked:
        needed += ("prefill_chunk",)
    for sid in sids:
        ph = phases_of(fe.collector, sid)
        for p in needed:
            assert p in ph, f"stream {sid} missing {p}: {ph}"
        assert ph.index("open") < ph.index("slot_bind") \
            < ph.index("first_token") < ph.index("close")
    high_viol = [v for v in fe.monitor.ledger
                 if v.kind == BOUND_VIOLATION and v.opcode == OP_STREAM_HIGH]
    assert high_viol == []
    assert fe.closed == 7 and fe.done
    eng.dispose()


def test_overload_sheds_low_never_high(models):
    eng = make_engine(models, max_batch=2, chunked_prefill=True,
                      prefill_chunk_tokens=2)
    fe = StreamFrontend(eng)
    fe.open_stream(np.arange(1, 5), max_new_tokens=3)      # warm-up
    fe.serve(max_polls=3000)
    low_prompts = [np.array([1, 2, 3, 4, 5]), np.array([6, 7, 8, 9])]
    lows = [fe.open_stream(p, max_new_tokens=6, criticality=CRIT_LOW)
            for p in low_prompts]
    for _ in range(50):                       # let both LOWs bind slots
        fe.poll()
        if eng.slots.free_count == 0:
            break
    assert eng.slots.free_count == 0
    high_prompt = np.array([11, 12, 13])
    high = fe.open_stream(high_prompt, max_new_tokens=4,
                          criticality=CRIT_HIGH)
    fe.serve(max_polls=6000)
    assert fe.shed_count >= 1
    assert fe.readmitted >= 1
    assert eng.slots.evictions >= 1
    sheds = [e for e in fe.collector.events_of(EV_STREAM)
             if e.extra.get("phase") == "shed"]
    assert sheds and all(e.opcode == OP_STREAM_LOW for e in sheds)
    assert all(fe.streams[s].state == ST_CLOSED for s in lows + [high])
    want = reference_tokens(models, low_prompts + [high_prompt], 6)
    assert fe.result(lows[0]) == want[0]
    assert fe.result(lows[1]) == want[1]
    assert fe.result(high) == want[2][:4]
    eng.dispose()


def test_host_prefill_emits_engine_event(models):
    tc = TraceCollector()
    eng = make_engine(models, telemetry=tc)
    slot = eng.add_request(42, np.array([1, 2, 3, 4]), max_new_tokens=3)
    evs = [e for e in tc.events_of(EV_ENGINE, 42)
           if e.extra.get("phase") == "host_prefill"]
    assert len(evs) == 1
    assert evs[0].extra["path"] == "host"
    assert evs[0].extra["slot"] == slot
    assert evs[0].extra["prompt_tokens"] == 4
    while eng.slots.any_active:
        eng.step()
    eng.dispose()


@pytest.mark.parametrize("extra", [[], ["--chunked-prefill"]],
                         ids=["host_prefill", "chunked_prefill"])
def test_serve_streams_cli_fills_report(tmp_path, extra):
    from repro_torch.launch import serve, top
    metrics = tmp_path / "m.jsonl"
    report = serve.main(["--smoke", "--device", "cpu", "--streams",
                         "--requests", "4", "--high-every", "2",
                         "--elastic", "--metrics-file", str(metrics),
                         "--max-seq", "64", "--prefill-chunk", "8",
                         "--trace", str(tmp_path / "t.json")] + extra)
    assert [len(o) for o in report.outputs] == [4] * 4
    st = report.streams
    assert st["opened"] == st["closed"] == 5          # + the warm-up
    assert st["evictions"] == st["shed"] >= 0
    # the verdicts depend on this host's timing; the HIGH bound is held
    # under a fixed slack in test_stream_frontend_matches_reference
    assert report.monitor["checked"] > 0 and "bound_violations" in \
        report.monitor
    assert set(report.stream_ttft_us) == {"stream_high", "stream_low"}
    assert report.stream_ttft_us["stream_high"]["count"] == 2
    assert report.stream_response_us["stream_low"]["count"] == 3
    assert report.metrics["device_chunks"] > 0
    assert report.metrics["samples"] >= 1
    assert set(report.metrics["utilization"]) == {0}
    # samples taken before the first chunk span record no utilization
    assert 0 < report.metrics["utilization_pct"][0]["count"] <= \
        report.metrics["samples"]
    assert report.elastic["ticks"] > 0
    assert "share_history" in report.elastic
    assert metrics.stat().st_size > 0
    assert (tmp_path / "m.jsonl.prom").stat().st_size > 0
    assert top.main(["--once", "--file", str(metrics)]) == 0


def test_serve_bare_streams_reports_monitor():
    """--streams without --trace/--elastic/--metrics-*: the frontend's own
    collector still feeds the report's monitor counts."""
    from repro_torch.launch import serve
    report = serve.main(["--smoke", "--device", "cpu", "--streams",
                         "--requests", "2", "--max-seq", "64"])
    assert [len(o) for o in report.outputs] == [4, 4]
    assert report.streams["closed"] == 3
    assert report.monitor["checked"] > 0
    assert report.metrics is None and report.elastic is None
    assert report.stream_response_us["stream_high"]["count"] == 1
