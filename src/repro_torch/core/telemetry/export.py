"""Trace exporters: Chrome/Perfetto trace-event JSON and CSV.

The Chrome exporter emits the Trace Event Format that both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

* execution spans — every ``chunk_retire``/``resolve`` event carries its
  step's ``start_us``/``dur_us``, exported as complete (``ph: "X"``)
  events with ``pid`` = cluster and ``tid`` = request id, so one row per
  ticket reconstructs the item's chunk-by-chunk timeline (a preemption
  is visibly a HIGH span cutting between two LOW chunk spans on the same
  cluster's process track);
* instants — submit/trigger/preempt/cancel/shed/requeue are thread-scope
  instant events (``ph: "i"``); fail/heal are process-scope;
* device tracks — a span carrying ``source=device`` (the flight
  recorder's re-emitted in-kernel timestamps) lands on a PARALLEL
  process track (``pid = DEVICE_PID_BASE + cluster``, named
  "cluster N (device)"), so the device's view of each launch sits
  directly under the host's spans for the same tickets;
* metadata — cluster and request tracks are named for the UI.

The CSV exporter is the flat analyst view: one row per event, stable
column order, kind-specific payload flattened as ``k=v`` pairs.
"""
from __future__ import annotations

import csv
import json
from typing import Callable, Iterable, Optional

from repro_torch.core.telemetry.events import (
    EV_CHUNK_RETIRE, EV_FAIL, EV_HEAL, EV_RESOLVE, Event,
)

__all__ = ["chrome_trace", "write_chrome", "write_csv", "DEVICE_PID_BASE"]

_SPAN_KINDS = (EV_CHUNK_RETIRE, EV_RESOLVE)
_PROCESS_SCOPE = (EV_FAIL, EV_HEAL)

# device-stamped spans render on their own per-cluster process track:
# pid = DEVICE_PID_BASE + cluster (host clusters are small ints, so the
# namespaces cannot collide in practice)
DEVICE_PID_BASE = 10_000


def _span_name(ev: Event, name_of: Callable[[int], str]) -> str:
    base = name_of(ev.opcode)
    if ev.chunk >= 0 and ev.kind == EV_CHUNK_RETIRE:
        return f"{base} chunk {ev.chunk}"
    return base


def chrome_trace(events: Iterable[Event],
                 name_of: Optional[Callable[[int], str]] = None) -> dict:
    """Build the Trace Event Format document (``{"traceEvents": [...]}``)
    from a collector's event snapshot."""
    if name_of is None:
        name_of = lambda op: f"op{op}"                      # noqa: E731
    out: list[dict] = []
    pids: set[int] = set()
    device_pids: set[int] = set()
    tids: set[tuple[int, int]] = set()
    for ev in events:
        pid = ev.cluster if ev.cluster >= 0 else 0
        if ev.extra.get("source") == "device":
            pid = DEVICE_PID_BASE + pid
            device_pids.add(pid)
        else:
            pids.add(pid)
        tid = ev.request_id if ev.request_id >= 0 else 0
        tids.add((pid, tid))
        args = {"request_id": ev.request_id, "opcode": ev.opcode}
        if ev.chunk >= 0:
            args["chunk"] = ev.chunk
        args.update(ev.extra)
        if ev.kind in _SPAN_KINDS and "start_us" in ev.extra:
            out.append({
                "name": _span_name(ev, name_of), "cat": ev.kind,
                "ph": "X", "ts": ev.extra["start_us"],
                "dur": max(ev.extra.get("dur_us", 0.0), 1.0),
                "pid": pid, "tid": tid, "args": args,
            })
        else:
            out.append({
                "name": f"{ev.kind}:{name_of(ev.opcode)}"
                if ev.opcode >= 0 else ev.kind,
                "cat": ev.kind, "ph": "i", "ts": ev.t_us,
                "s": "p" if ev.kind in _PROCESS_SCOPE else "t",
                "pid": pid, "tid": tid, "args": args,
            })
    for pid in sorted(pids):
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": f"cluster {pid}"}})
    for pid in sorted(device_pids):
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name":
                             f"cluster {pid - DEVICE_PID_BASE} (device)"}})
    for pid, tid in sorted(tids):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"ticket {tid}"}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome(events: Iterable[Event], path: str,
                 name_of: Optional[Callable[[int], str]] = None) -> int:
    """Write the Chrome trace JSON; returns the trace-event count."""
    doc = chrome_trace(events, name_of)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return len(doc["traceEvents"])


_CSV_COLUMNS = ("kind", "t_us", "cluster", "request_id", "opcode", "chunk",
                "name", "extra")


def write_csv(events: Iterable[Event], path: str,
              name_of: Optional[Callable[[int], str]] = None) -> int:
    """Write one row per event; returns the row count."""
    if name_of is None:
        name_of = lambda op: f"op{op}"                      # noqa: E731
    n = 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(_CSV_COLUMNS)
        for ev in events:
            extra = ";".join(f"{k}={v}" for k, v in sorted(ev.extra.items()))
            w.writerow([ev.kind, ev.t_us, ev.cluster, ev.request_id,
                        ev.opcode, ev.chunk,
                        name_of(ev.opcode) if ev.opcode >= 0 else "",
                        extra])
            n += 1
    return n
