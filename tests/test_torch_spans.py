"""The port's spans on the serving path (``repro_torch.core.telemetry.span``):
under a CPU ``torch.profiler`` session a reduced dense model behind
``ServingEngine`` + ``StreamFrontend`` opens every span of the serving path,
each nested in its parent and holding the aten ops issued in it on the
profiler's clock; with no profiler recording the program opens no profiler
range at all and serves the same tokens."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.telemetry import span
from repro_torch.models import build
from repro_torch.serving import ServingEngine, StreamFrontend

SPANS = ("repro_torch.streams.poll", "repro_torch.engine.step",
         "repro_torch.engine.prefill", "repro_torch.rt.trigger.decode",
         "repro_torch.rt.wait.decode", "repro_torch.model.layer")


@pytest.fixture(scope="module")
def dense():
    cfg = get_config("mistral-nemo-12b").reduced()
    model = build(cfg, device="cpu")
    return cfg, model, model.init(0)


def serve(dense):
    """Two short streams to the end; their tokens."""
    _, model, params = dense
    eng = ServingEngine(model, params, max_batch=2, max_seq=64,
                        device="cpu")
    fe = StreamFrontend(eng, slack_us=10_000_000.0)
    sids = [fe.open_stream(np.arange(1, 9), max_new_tokens=4),
            fe.open_stream(np.arange(3, 15), max_new_tokens=5)]
    fe.serve(max_polls=1000)
    eng.dispose()
    return [fe.result(s) for s in sids]


def cpu_events(prof) -> list:
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CPU")]


def inside(a, b) -> bool:
    return b[0] <= a[0] and a[1] <= b[1]


def is_decode_trigger(name: str) -> bool:
    head = "repro_torch.rt.trigger."
    return name.startswith(head) and "decode" in name[len(head):].split("+")


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_spans_nest_on_the_serving_path(dense):
    cfg = dense[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(dense)
    evs = cpu_events(prof)
    spans = [e for e in evs if e[2].startswith("repro_torch.")]
    names = {e[2] for e in spans}
    assert set(SPANS) <= names, set(SPANS) - names
    of = {n: [e for e in spans if e[2] == n] for n in names}
    polls = of["repro_torch.streams.poll"]
    steps = of["repro_torch.engine.step"]
    layers = of["repro_torch.model.layer"]
    triggers = [e for e in spans if is_decode_trigger(e[2])]
    for s in steps:
        assert any(inside(s, p) for p in polls)
    for t in triggers:
        assert any(inside(t, s) for s in steps)
        # a decode ring issues the whole stack, one layer span a layer
        assert sum(inside(x, t) for x in layers) == cfg.num_layers
    for w in of["repro_torch.rt.wait.decode"]:
        assert any(inside(w, s) for s in steps)
    for p in of["repro_torch.engine.prefill"]:
        assert any(inside(p, q) for q in polls)
        assert sum(inside(x, p) for x in layers) == cfg.num_layers
    # every layer span holds the layer's projections (aten::mm and
    # friends, on the same clock) and none reaches past its span
    ops = [e for e in evs if e[2].startswith("aten::")]
    for x in layers:
        held = [o for o in ops if x[0] <= o[0] < x[1]]
        assert any(o[2] in ("aten::mm", "aten::matmul", "aten::linear")
                   for o in held)
        assert all(o[1] <= x[1] for o in held)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_no_profiler_no_range_and_the_same_tokens(dense, monkeypatch):
    opened = []
    fast = torch._C._profiler._RecordFunctionFast
    slow = torch.autograd.profiler.record_function

    def counting(inner):
        def make(*a, **k):
            opened.append(a[0] if a else k.get("name"))
            return inner(*a, **k)
        return make

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(fast))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting(slow))
    monkeypatch.setattr(torch.profiler, "record_function", counting(slow))
    plain = serve(dense)
    assert opened == []
    assert span("repro_torch.streams.poll") is span("repro_torch.model.layer")
    # a span's name is made only while a profiler records
    assert span(lambda: pytest.fail("named with no profiler")) is \
        span("repro_torch.model.layer")
    with profile(activities=[ProfilerActivity.CPU]):
        traced = serve(dense)
    # the counting hook is the one the spans go through
    assert "repro_torch.model.layer" in opened
    assert traced == plain
