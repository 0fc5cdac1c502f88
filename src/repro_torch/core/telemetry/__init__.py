"""Telemetry & runtime-verification subsystem (the port's copy of
``repro.core.telemetry``).

The paper's predictability metric is a distribution claim (avg↔worst),
and the admission analyses are promises about response times — this
package is what makes both OBSERVABLE and CHECKED at runtime:

* :class:`TraceCollector` — bounded ring of structured events
  (submit/admit/shed/trigger/chunk-retire/preempt/requeue/resolve/
  cancel/fail/heal) stamped with monotonic time and ticket/opcode/
  cluster/chunk ids, plus per-opcode log-spaced latency histograms
  (p50/p95/p99/worst) and the unified ``counters()`` surface;
* :class:`BoundMonitor` — online runtime verification: every completion
  is replayed against the admission analysis' response-time bound, with
  a bounded violation ledger and alert callbacks;
* :class:`LogHistogram` — the bounded-memory quantile estimator behind
  the histograms (and the ``wcet_quantile=`` admission estimator);
* exporters — Chrome/Perfetto trace JSON and CSV
  (``TraceCollector.export_chrome`` / ``export_csv``), with device-
  stamped spans (``source=device``) on parallel per-cluster tracks;
* :class:`MetricsRegistry` / :class:`MetricsPump` — the continuous
  surface: named counters/gauges/histograms fed live from the flight
  recorder's device spans, per-cluster utilization/occupancy gauges,
  Prometheus-text + JSON-lines exposition, background sampling pump
  (``launch/serve.py --metrics-port / --metrics-file``; viewed live by
  ``launch/top.py``). The pump reads host dicts only: it never touches a
  CUDA tensor and never synchronizes.

Wire-up: pass one collector as ``telemetry=`` to ``Dispatcher``,
``LkSystem``, or ``ServingEngine`` (see ARCHITECTURE.md "Telemetry &
runtime verification"); ``launch/trace.py`` is the CLI that runs a
traced workload end to end.
"""
from repro_torch.core.telemetry.events import (
    EV_ADMIT, EV_CANCEL, EV_CHUNK_RETIRE, EV_ENGINE, EV_FAIL, EV_HEAL,
    EV_PREEMPT, EV_RECARVE, EV_REJECT, EV_REQUEUE, EV_RESOLVE,
    EV_RT_RETIRE, EV_RT_TRIGGER, EV_SHED, EV_STREAM, EV_SUBMIT, EV_TRIGGER,
    EVENT_KINDS, Event, TraceCollector,
)
from repro_torch.core.telemetry.export import (
    DEVICE_PID_BASE, chrome_trace, write_chrome, write_csv,
)
from repro_torch.core.telemetry.histogram import LogHistogram
from repro_torch.core.telemetry.metrics import (
    Counter, Gauge, Histogram, MetricsPump, MetricsRegistry,
)
from repro_torch.core.telemetry.monitor import (
    BOUND_VIOLATION, DEADLINE_MISS, WCET_OVERRUN, BoundMonitor, Violation,
)

__all__ = [
    "BOUND_VIOLATION", "BoundMonitor", "Counter", "DEADLINE_MISS",
    "DEVICE_PID_BASE", "EVENT_KINDS",
    "EV_ADMIT", "EV_CANCEL", "EV_CHUNK_RETIRE", "EV_ENGINE", "EV_FAIL",
    "EV_HEAL", "EV_PREEMPT", "EV_RECARVE", "EV_REJECT", "EV_REQUEUE",
    "EV_RESOLVE",
    "EV_RT_RETIRE", "EV_RT_TRIGGER", "EV_SHED", "EV_STREAM", "EV_SUBMIT",
    "EV_TRIGGER",
    "Event", "Gauge", "Histogram", "LogHistogram", "MetricsPump",
    "MetricsRegistry", "TraceCollector", "Violation", "WCET_OVERRUN",
    "chrome_trace", "write_chrome", "write_csv",
]
