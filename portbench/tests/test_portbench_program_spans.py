"""The program-span reduction (``portbench.program_spans``) on a synthetic
kineto-like trace: the program's ``repro_torch.*`` spans leave the harness's
reduction as it was but for the kernels launched through ctypes, which they
give a launching range (out of ``unlinked``, into the harness span that
holds it); each program-span reader gives its hand-computed value, and an
idle gap goes to the innermost span however many spans it holds."""
import math

import pytest

from portbench import program_spans, spec, trace
from portbench.serve import Run
from portbench.tests import tiny


class Ev:
    """One kineto event; times in microseconds, read back in ns."""
    ids = iter(range(1, 10 ** 6))

    def __init__(self, name, s, e, dev="CPU", linked=0, tid=1):
        self._name, self.s, self.e, self.dev = name, s, e, dev
        self.linked, self.tid = linked, tid
        self.corr = next(Ev.ids) if dev == "CPU" else 0

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def start_ns(self):
        return self.s * 1000

    def duration_ns(self):
        return (self.e - self.s) * 1000

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.tid


def timeline(program: bool) -> list:
    """A 10 ms window: a poll that prefills two layers and runs a decode
    step (trigger over two layers, one holding an ``.item()``; the wait),
    and a poll whose step's ring is decode+insert. Without ``program``,
    the ``repro_torch.*`` spans are left out, and a kernel launched from
    a layer span through ctypes links to no CPU event: the harness's
    ``record_function`` ranges are user annotations, which kineto does not
    link a launch to."""
    cpu = []

    def c(name, s, e, tid=1):
        ev = Ev(name, s, e, tid=tid)
        if program or not name.startswith("repro_torch."):
            cpu.append(ev)
        return ev

    c("portbench.window", 0, 10000)
    c("portbench.poll", 90, 3110)
    c("repro_torch.streams.poll", 100, 3100)
    c("portbench.add_request", 150, 1250)
    c("repro_torch.engine.prefill", 200, 1200)
    c("portbench.prefill", 250, 1150)
    c("repro_torch.model.layer", 300, 700)
    mm0 = c("aten::mm", 350, 650)
    c("repro_torch.model.layer", 700, 1100)
    mm1 = c("aten::mm", 750, 1050)
    c("portbench.step", 1250, 3050)
    c("repro_torch.engine.step", 1300, 3000)
    c("repro_torch.rt.trigger.decode", 1400, 2400)
    c("portbench.decode_step", 1450, 2350)
    l2 = c("repro_torch.model.layer", 1500, 1900)
    c("aten::mm", 1550, 1850)
    c("repro_torch.model.layer", 1900, 2300)
    item = c("aten::_local_scalar_dense", 1950, 2050)
    c("cudaStreamSynchronize", 1960, 2040)
    amax = c("aten::argmax", 2360, 2390)
    c("repro_torch.rt.wait.decode", 2500, 2900)
    c("cudaEventSynchronize", 2510, 2890)
    c("portbench.poll", 3190, 6210)
    c("repro_torch.streams.poll", 3200, 6200)
    c("portbench.step", 3250, 6150)
    c("repro_torch.engine.step", 3300, 6100)
    c("repro_torch.rt.trigger.decode+insert", 3400, 5400)
    c("portbench.decode_step", 3450, 5350)
    l4 = c("repro_torch.model.layer", 3500, 4500)
    c("aten::mm", 3600, 4400)
    c("repro_torch.model.layer", 4500, 5300)
    c("repro_torch.rt.wait.decode", 5500, 6000)
    # another host thread's long op holds none of the serving thread's
    c("aten::copy_", 1400, 5000, tid=2)

    def linked(span):
        return span.corr if program else 0

    dev = [Ev("gemm", 360, 640, "CUDA", mm0.corr),
           Ev("gemm", 760, 1040, "CUDA", mm1.corr),
           Ev("decode_mma_kernel<128>", 1560, 1840, "CUDA", linked(l2)),
           Ev("Memcpy DtoH", 1950, 2000, "CUDA", item.corr),
           Ev("argmax_kernel", 2000, 2700, "CUDA", amax.corr),
           Ev("decode_mma_kernel<128>", 3610, 4390, "CUDA", linked(l4)),
           # kineto's copy of a harness span on the device timeline
           Ev("portbench.decode_step", 1560, 2000, "CUDA")]
    return cpu + dev


def run_of(events) -> Run:
    run = Run(tiny.cell(), 1, 10.0)
    run.trace = trace.reduce_events(events)
    run.trace["program"] = program_spans.reduce_events(events)
    return run


def test_program_spans_move_only_the_ctypes_launches():
    bare = trace.reduce_events(timeline(program=False))
    spanned = trace.reduce_events(timeline(program=True))
    moved = program_spans.reduce_events(timeline(program=True))[
        "device_s_via_program_spans"]
    k4 = (280 + 780) / 1e6
    assert moved == {"portbench.decode_step": pytest.approx(k4)}
    for key in ("window_s", "busy_s", "kernel_s", "breakdown"):
        assert spanned[key] == bare[key], key
    b, s = bare["device_s_by_span"], spanned["device_s_by_span"]
    assert b["unlinked"] == pytest.approx(k4) and "unlinked" not in s
    assert s["portbench.decode_step"] == pytest.approx(
        b["portbench.decode_step"] + k4)
    assert {k: v for k, v in s.items() if k != "portbench.decode_step"} \
        == {k: v for k, v in b.items()
            if k not in ("portbench.decode_step", "unlinked")}
    assert spanned["linked_share"] == pytest.approx(1.0)
    assert bare["linked_share"] == pytest.approx(
        1.0 - k4 / bare["busy_s"])


@pytest.mark.parametrize("name, want", [
    ("decode_issue_ms.code", (1000 + 2000) / 2 / 1e3),
    ("decode_wait_ms.code", (400 + 500) / 2 / 1e3),
    ("layer_issue_us.code", (400 + 400 + 1000 + 800) / 4),
    # the .item() in the first step (its stream sync inside it counted
    # once); the wait's event sync lies outside every trigger
    ("decode_syncs.code", 1 / 2),
    # gaps begun in a decode trigger's layers: 1840-1950, 4390-10000
    ("idle_issue_pct.code", 100 * (110 + 5610) / 10000),
    # each poll less its engine spans: 3000 - 1000 - 1700, 3000 - 2800
    ("frontend_ms.code", (300 + 200) / 2 / 1e3),
])
def test_each_reader_gives_its_hand_computed_value(name, want):
    run = run_of(timeline(program=True))
    assert math.isclose(spec.metric_reader(name)(run), want, rel_tol=1e-9)
    assert name in program_spans.METRICS
    # a run without a trace, or without the program's reduction in it
    # (a harness that does not store it), reads nothing
    assert spec.metric_reader(name)(Run(tiny.cell(), 1, 10.0)) is None
    bare = Run(tiny.cell(), 1, 10.0)
    bare.trace = trace.reduce_events(timeline(program=True))
    assert spec.metric_reader(name)(bare) is None


def test_idle_table_and_decode_host_ops():
    prog = run_of(timeline(program=True)).trace["program"]
    want = {"repro_torch.model.layer": 120 + 520 + 110 + 5610,
            "repro_torch.rt.wait.decode": 910,
            program_spans.OUTSIDE: 360}
    assert prog["idle_s"].keys() == want.keys()
    for k, v in want.items():
        assert math.isclose(prog["idle_s"][k], v / 1e6, rel_tol=1e-9)
    assert prog["decode_steps"] == 2
    assert prog["device_span_events"] == 0
    assert prog["sync_calls"] == {
        "repro_torch.model.layer > aten::_local_scalar_dense": 1}
    # K4 launched from the layer spans, under the harness's decode_step
    assert prog["device_s_via_program_spans"] == {
        "portbench.decode_step": pytest.approx((280 + 780) / 1e6)}
    ops = dict(prog["top_host_ops"])
    # self time: the trigger less its child, the harness span less its
    # layers, a layer less its ops
    assert math.isclose(ops["repro_torch.rt.trigger.decode"],
                        (1000 - 900 - 30) / 1e6)
    assert math.isclose(ops["aten::_local_scalar_dense"], 20 / 1e6)
    assert "aten::copy_" not in ops and "aten::mm" in ops
    assert any("idle" in line for line in program_spans.describe(prog))


def test_a_gap_inside_a_span_of_many_children_goes_to_that_span():
    evs = [Ev("portbench.window", 0, 2000),
           Ev("repro_torch.rt.trigger.decode", 10, 1990)]
    for i in range(100):
        evs.append(Ev("repro_torch.model.layer", 20 + 5 * i, 23 + 5 * i))
    evs += [Ev("k", 0, 600, "CUDA"), Ev("k", 1900, 2000, "CUDA")]
    prog = program_spans.reduce_events(evs)
    assert prog["idle_s"] == {
        "repro_torch.rt.trigger.decode": pytest.approx(1300 / 1e6)}
    assert prog["idle_issue_s"] == pytest.approx(1300 / 1e6)
    assert prog["layer_issue_us"] == pytest.approx(3.0)
