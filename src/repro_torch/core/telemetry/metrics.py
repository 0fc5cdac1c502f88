"""Continuous metrics registry + exposition on top of the flight recorder —
the port's copy of ``repro.core.telemetry.metrics`` (pure Python: only the
imports differ).

The TraceCollector is an EVENT surface: a bounded ring you export after
the fact. Operating a serving system needs the complementary CONTINUOUS
surface — named counters/gauges/histograms with O(1) hot-path updates
that a scraper or a live view can sample while the system runs. The
:class:`MetricsRegistry` is that surface, and its device feed is the
flight recorder: attaching a collector subscribes the registry to the
event stream, and every device-stamped ``chunk_retire`` span
(``source=device``, re-emitted by the runtimes from in-kernel profile
rows — see ``core.mailbox``) updates the per-cluster instruments:

* ``cluster_busy_us``        — counter: device-observed execution time
* ``cluster_queue_depth``    — gauge: queue occupancy at the last pop
* ``cluster_chunks``         — counter: device-stamped chunks retired
* ``device_chunk_us``        — histogram: calibrated chunk durations
* ``cluster_utilization``    — gauge: Δbusy/Δwall between samples
  (computed by ``sample()``, so it means "fraction of the last sample
  window the cluster spent executing"). On ``PersistentRuntime`` the
  device spans are logical ticks mapped into each block's host window
  ``[trigger, materialize]``, so there it is the share of wall time from
  a step's trigger to its readback, not the card's busy share
* ``cluster_utilization_pct``— histogram of those samples ×100 — the
  per-cluster utilization distribution the ElasticController's
  ``bind_metrics`` hook consumes alongside backlog demand.

``snapshot()`` is unified with ``TraceCollector.counters()``: one flat
dict carries both the registry's instruments and every counter the
collector aggregates (dispatcher/elastic/exec-cache/monitor/...).

Exposition is pull AND push:

* :meth:`MetricsRegistry.to_prometheus` — Prometheus text format
  (``lk_`` namespace, labels preserved, histogram quantile summaries);
* :meth:`MetricsRegistry.to_json_line` — one JSON object per sample
  (JSON-lines when appended);
* :class:`MetricsPump` — background thread that samples every
  ``interval_s``, appends JSONL to ``path``, rewrites a ``.prom``
  sibling atomically, and optionally serves ``/metrics`` +
  ``/metrics.json`` over HTTP (stdlib ``http.server``; used by
  ``launch/serve.py --metrics-port / --metrics-file`` and read by
  ``launch/top.py``).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Optional

from repro_torch.core.telemetry.events import (EV_CHUNK_RETIRE, Event,
                                         TraceCollector, now_us)
from repro_torch.core.telemetry.histogram import LogHistogram

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsPump"]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_name(namespace: str, name: str) -> str:
    out = [c if (c.isalnum() or c in "_:") else "_"
           for c in f"{namespace}_{name}"]
    return "".join(out)


def _prom_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotone counter; ``inc`` is the O(1) hot-path update."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-value instrument; ``set`` is the O(1) hot-path update."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Distribution instrument — a :class:`LogHistogram` under a metric
    name; ``record`` is the O(1) hot-path update, exposition reads the
    p50/p95/p99 summary."""

    __slots__ = ("hist",)

    def __init__(self):
        self.hist = LogHistogram()

    def record(self, v: float) -> None:
        self.hist.record(v)

    @property
    def value(self):            # summary view, used by snapshot()
        return self.hist.summary()


class MetricsRegistry:
    """Named counters/gauges/histograms with label support, fed live
    from a TraceCollector's device-stamped spans (``attach``), sampled
    into utilization gauges (``sample``), and exposed as one flat
    ``snapshot()`` dict, Prometheus text, or a JSON line.

    Instruments are created on first use: ``registry.counter("x",
    cluster=0).inc()``. Not thread-safe for instrument CREATION under
    concurrent writers; the serving stack creates everything from one
    dispatch loop and the pump only reads.
    """

    def __init__(self, collector: Optional[TraceCollector] = None,
                 namespace: str = "lk",
                 clock: Optional[Callable[[], int]] = None):
        self.namespace = namespace
        self._clock = clock if clock is not None else now_us
        self._counters: dict[tuple[str, tuple], Counter] = {}
        self._gauges: dict[tuple[str, tuple], Gauge] = {}
        self._hists: dict[tuple[str, tuple], Histogram] = {}
        self.collector: Optional[TraceCollector] = None
        self._busy_us: dict[int, float] = {}
        self._util_state: dict[int, tuple[int, float]] = {}
        self._t0 = self._clock()
        self.samples = 0
        if collector is not None:
            self.attach(collector)

    # -- instruments ----------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        return h

    # -- the flight-recorder feed ----------------------------------------
    def attach(self, collector: TraceCollector) -> None:
        """Subscribe to the collector: every device-stamped
        ``chunk_retire`` span updates the per-cluster instruments (no
        runtime plumbing beyond the spans the runtimes already emit)."""
        self.collector = collector
        collector.subscribe(self._on_event)

    def _on_event(self, ev: Event) -> None:
        if ev.kind != EV_CHUNK_RETIRE or \
                ev.extra.get("source") != "device":
            return
        c = ev.cluster
        dur = float(ev.extra.get("dur_us", 0.0))
        self._busy_us[c] = self._busy_us.get(c, 0.0) + dur
        self.counter("cluster_busy_us", cluster=c).inc(dur)
        self.counter("cluster_chunks", cluster=c).inc()
        self.gauge("cluster_queue_depth", cluster=c).set(
            float(ev.extra.get("qdepth", 0)))
        self.histogram("device_chunk_us", cluster=c).record(max(dur, 0.0))

    def utilization(self) -> dict[int, float]:
        """Per-cluster utilization gauges as sampled last (``{}`` before
        the first ``sample()``) — the ElasticController's advisory feed."""
        out = {}
        for (name, labels), g in self._gauges.items():
            if name == "cluster_utilization":
                out[int(dict(labels)["cluster"])] = g.value
        return out

    def sample(self) -> dict:
        """One sampling pass: fold Δbusy/Δwall since the previous sample
        into each cluster's utilization gauge + distribution histogram,
        then return ``snapshot()``. Called by the pump (and usable
        inline)."""
        now = self._clock()
        for c, busy in self._busy_us.items():
            last_t, last_b = self._util_state.get(c, (self._t0, 0.0))
            dt = max(now - last_t, 1)
            util = max(0.0, min(1.0, (busy - last_b) / dt))
            self.gauge("cluster_utilization", cluster=c).set(util)
            self.histogram("cluster_utilization_pct",
                           cluster=c).record(util * 100.0)
            self._util_state[c] = (now, busy)
        self.samples += 1
        return self.snapshot()

    # -- exposition ------------------------------------------------------
    def snapshot(self) -> dict:
        """One flat dict: every instrument (labels flattened into the
        key) plus the attached collector's unified ``counters()``."""
        out: dict = {"ts_us": self._clock(), "samples": self.samples}

        def flat(name, labels):
            if not labels:
                return name
            return name + "{" + ",".join(
                f"{k}={v}" for k, v in labels) + "}"

        for (name, labels), c in sorted(self._counters.items()):
            out[flat(name, labels)] = c.value
        for (name, labels), g in sorted(self._gauges.items()):
            out[flat(name, labels)] = g.value
        for (name, labels), h in sorted(self._hists.items()):
            s = h.hist.summary()
            base = flat(name, labels)
            out[f"{base}.count"] = s["count"]
            out[f"{base}.p50"] = s["p50_us"]
            out[f"{base}.p99"] = s["p99_us"]
            out[f"{base}.worst"] = s["worst_us"]
        if self.collector is not None:
            for k, v in self.collector.counters().items():
                out[k] = v
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): counters and gauges with
        labels, histograms as quantile summaries, collector counters as
        untyped ``lk_collector_*`` gauges."""
        lines: list[str] = []
        seen_type: set[str] = set()

        def header(pname, ptype):
            if pname not in seen_type:
                seen_type.add(pname)
                lines.append(f"# TYPE {pname} {ptype}")

        for (name, labels), c in sorted(self._counters.items()):
            pname = _prom_name(self.namespace, name)
            header(pname, "counter")
            lines.append(f"{pname}{_prom_labels(labels)} {c.value:g}")
        for (name, labels), g in sorted(self._gauges.items()):
            pname = _prom_name(self.namespace, name)
            header(pname, "gauge")
            lines.append(f"{pname}{_prom_labels(labels)} {g.value:g}")
        for (name, labels), h in sorted(self._hists.items()):
            pname = _prom_name(self.namespace, name)
            header(pname, "summary")
            s = h.hist.summary()
            for q, key in ((0.5, "p50_us"), (0.95, "p95_us"),
                           (0.99, "p99_us")):
                qlab = labels + (("quantile", f"{q:g}"),)
                lines.append(f"{pname}{_prom_labels(qlab)} {s[key]:g}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{s['count']:g}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} "
                         f"{h.hist.total:g}")
        if self.collector is not None:
            for k, v in sorted(self.collector.counters().items()):
                if not isinstance(v, (int, float)):
                    continue
                pname = _prom_name(self.namespace, f"collector_{k}")
                header(pname, "gauge")
                lines.append(f"{pname} {float(v):g}")
        return "\n".join(lines) + "\n"

    def to_json_line(self) -> str:
        return json.dumps(self.snapshot(), default=float)


class MetricsPump:
    """Background sampler: every ``interval_s`` it calls
    ``registry.sample()``, appends one JSON line to ``path`` (when
    given), atomically rewrites the ``<path>.prom`` sibling with the
    Prometheus text, and (with ``port``) serves ``/metrics`` and
    ``/metrics.json`` from a daemon HTTP server. ``stop()`` performs one
    final sample/write so short runs always leave an artifact."""

    def __init__(self, registry: MetricsRegistry,
                 path: Optional[str] = None,
                 port: Optional[int] = None,
                 interval_s: float = 0.5):
        self.registry = registry
        self.path = path
        self.port = port
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd = None
        self.writes = 0

    # -- one sampling pass ----------------------------------------------
    def pump_once(self) -> dict:
        snap = self.registry.sample()
        if self.path:
            with open(self.path, "a") as f:
                f.write(self.registry.to_json_line() + "\n")
            prom_path = self.path + ".prom"
            tmp = prom_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(self.registry.to_prometheus())
            os.replace(tmp, prom_path)
            self.writes += 1
        return snap

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.pump_once()

    def start(self) -> "MetricsPump":
        if self.port is not None:
            self._serve_http()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-pump")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        self.pump_once()          # final sample: short runs still export

    def __enter__(self) -> "MetricsPump":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- optional HTTP exposition -----------------------------------------
    def _serve_http(self) -> None:
        import http.server

        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.startswith("/metrics.json"):
                    body = registry.to_json_line().encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    registry.sample()
                    body = registry.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # quiet: the CLI owns stdout
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="metrics-http").start()
