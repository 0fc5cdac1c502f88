"""The port's continuous metrics surface against the reference's: one
synthetic event sequence under one fake clock gives equal ``snapshot()``
dicts and Prometheus texts; the pump writes its JSON-lines and ``.prom``
files and serves ``/metrics`` on 127.0.0.1; ``bind_metrics`` biases the
elastic controller as the reference's does; ``top.render`` draws the
reference's lines; and the trace CLI passes its two checks on the CPU."""
import json
import time
import urllib.request
from collections import deque

import numpy as np
import pytest

import repro.core.mailbox as j_mb
import repro.core.telemetry as j_tel
import repro_torch.core.mailbox as t_mb
import repro_torch.core.telemetry as t_tel
from repro.core.dispatcher import Dispatcher as JDispatcher
from repro.core.elastic import ElasticController as JElasticController
from repro.launch import top as j_top
from repro_torch.core.dispatcher import Dispatcher
from repro_torch.core.elastic import ElasticController
from repro_torch.launch import top


class FakeClock:
    def __init__(self, t: int = 1_000_000):
        self.t = t

    def __call__(self) -> int:
        return self.t

    def advance(self, us: int) -> None:
        self.t += us


def _feed(tc, cluster, n, dur=100.0, qdepth=2):
    for i in range(n):
        tc.emit("chunk_retire", cluster=cluster, request_id=i, opcode=1,
                chunk=0, source="device", start_us=i * dur, dur_us=dur,
                tick=i, row=i, qdepth=qdepth)


def _drive(tel):
    """One event sequence (device spans on two clusters, a host span, other
    kinds, labelled instruments) and three samples under a fake clock."""
    clk = FakeClock()
    tc = tel.TraceCollector(clock=clk)
    reg = tel.MetricsRegistry(tc, clock=clk)
    reg.counter("reqs").inc(3)
    reg.gauge("depth", cluster=1).set(7)
    reg.histogram("lat_us", op="relu").record(50.0)
    _feed(tc, 0, 5, dur=100.0, qdepth=3)
    _feed(tc, 1, 2, dur=37.5, qdepth=1)
    tc.emit("chunk_retire", cluster=0, request_id=9, opcode=1,
            start_us=0.0, dur_us=999.0)
    tc.emit("submit", cluster=0, request_id=9)
    tc.observe("response_us", 1, 123.0)
    snaps = []
    for n in (0, 50, 3):
        _feed(tc, 0, n, dur=100.0)
        clk.advance(1_000)
        snaps.append(reg.sample())
    return reg, snaps


def test_snapshot_and_prometheus_equal_reference():
    j_reg, j_snaps = _drive(j_tel)
    reg, snaps = _drive(t_tel)
    assert snaps == j_snaps
    assert reg.snapshot() == j_reg.snapshot()
    assert reg.to_prometheus() == j_reg.to_prometheus()
    assert reg.to_json_line() == j_reg.to_json_line()
    assert reg.utilization() == j_reg.utilization()
    assert snaps[1]["cluster_utilization{cluster=0}"] == 1.0


def test_pump_files_http_and_top(tmp_path):
    tc = t_tel.TraceCollector()
    reg = t_tel.MetricsRegistry(tc)
    _feed(tc, 0, 3)
    path = str(tmp_path / "m.jsonl")
    pump = t_tel.MetricsPump(reg, path=path, port=0, interval_s=0.02).start()
    try:
        deadline = time.monotonic() + 30.0     # one looped write, at least
        while pump.writes < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        base = f"http://127.0.0.1:{pump.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=10)\
            .read().decode()
        assert 'lk_cluster_chunks{cluster="0"} 3' in body
        doc = json.loads(urllib.request.urlopen(
            base + "/metrics.json", timeout=10).read())
        assert doc["cluster_chunks{cluster=0}"] == 3.0
    finally:
        pump.stop()
    assert pump._httpd is None and pump._thread is None
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) >= 2                     # looped + final flush
    assert lines[-1]["cluster_chunks{cluster=0}"] == 3.0
    assert 'lk_cluster_utilization{cluster="0"}' in \
        open(path + ".prom").read()
    assert top.main(["--once", "--file", path]) == 0
    assert top.main(["--once", "--file", str(tmp_path / "none")]) == 1


class _FakeRuntime:
    max_inflight = 1

    def __init__(self, mb):
        self._mb = mb
        self._q = deque()

    def trigger(self, desc):
        self._q.append(desc)

    def ready(self):
        return bool(self._q)

    def wait(self):
        d = self._q.popleft()
        fg = np.zeros((self._mb.DESC_WIDTH,), np.int32)
        fg[self._mb.W_STATUS] = self._mb.THREAD_FINISHED
        fg[self._mb.W_REQID] = d.request_id
        return d.request_id, fg

    def dispose(self):
        pass


def _bias(tel, mb, dispatcher_cls, controller_cls):
    clk = FakeClock()
    tc = tel.TraceCollector(clock=clk)
    reg = tel.MetricsRegistry(tc, clock=clk)
    disp = dispatcher_cls({c: _FakeRuntime(mb) for c in range(4)}, clock=clk)
    disp.pin("a", [0, 1])
    disp.pin("b", [2, 3])
    ctl = controller_cls(clock=clk).bind_dispatcher(
        disp, {"a": 0, "b": 1}).bind_metrics(reg)
    _feed(tc, 0, 10, dur=100.0)               # class a: one saturated,
    _feed(tc, 1, 3, dur=100.0)                # one 30% busy; b idle
    clk.advance(1_000)
    reg.sample()
    biased = ctl._utilization_bias({"a": 100.0, "b": 40.0})
    return biased, dict(ctl.last_utilization), ctl._propose(biased)


def test_bind_metrics_matches_reference():
    want = _bias(j_tel, j_mb, JDispatcher, JElasticController)
    got = _bias(t_tel, t_mb, Dispatcher, ElasticController)
    assert got == want
    biased, util, proposal = got
    assert biased["a"] == pytest.approx(165.0)     # x (1 + mean(1.0, 0.3))
    assert util["b"] == 0.0
    assert proposal == {"a": 3, "b": 1}


def test_top_render_matches_reference():
    _, snaps = _drive(t_tel)
    _, j_snaps = _drive(j_tel)
    for snap, j_snap in zip(snaps, j_snaps):
        assert top.render(snap) == j_top.render(j_snap)
    lines = top.render(snaps[-1])
    rows = [ln for ln in lines if ln.strip().startswith(("0 ", "1 "))]
    assert len(rows) == 2
    assert top.main(["--demo", "--once"]) == 0


def test_trace_cli_passes_both_checks_on_cpu(tmp_path, capsys):
    from repro_torch.launch import trace
    out = tmp_path / "trace.json"
    csv = tmp_path / "trace.csv"
    assert trace.main(["--smoke", "--device", "cpu", "--out", str(out),
                       "--csv", str(csv)]) == 0
    text = capsys.readouterr().out
    assert "HIGH trigger between LOW chunk retirements: True" in text
    assert " 0 bound violations" in text
    events = json.loads(out.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert any(e.get("args", {}).get("source") == "device" for e in events)
    assert csv.stat().st_size > 0


def test_serve_stops_its_pump_when_serving_fails(tmp_path, monkeypatch):
    import threading

    from repro_torch.launch import serve

    def boom(*a, **k):
        raise RuntimeError("serving failed")

    monkeypatch.setattr(serve, "_drive", boom)
    with pytest.raises(RuntimeError, match="serving failed"):
        serve.main(["--smoke", "--device", "cpu", "--metrics-port", "0",
                    "--metrics-file", str(tmp_path / "m.jsonl")])
    left = [t for t in threading.enumerate()
            if t.name in ("metrics-pump", "metrics-http")]
    for t in left:                 # serve_forever returns just after stop
        t.join(timeout=10)
    assert not [t for t in left if t.is_alive()]
    assert (tmp_path / "m.jsonl").stat().st_size > 0   # final sample
