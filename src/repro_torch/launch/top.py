"""lktop: live ops view over the flight-recorder metrics stream — the
port's copy of ``repro.launch.top`` (pure Python).

Reads the JSON-lines samples a :class:`MetricsPump` appends (``serve.py
--metrics-file``) and renders an in-place refreshing panel:

* per-cluster DEVICE utilization bars (from the in-kernel chunk
  timestamps), queue depth at last pop, and chunk-latency p50/p99;
* the admission ledger: completed/met, the slack between checked
  completions and runtime-verification violations, rejected/shed;
* the BoundMonitor row: checked, bound violations, deadline misses,
  WCET overruns;
* controller counters: preemptions, recarves (applied/rejected), heals,
  and the collector's own health (dropped events, subscriber errors).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --streams --metrics-file /tmp/lk.jsonl &
    PYTHONPATH=src python -m repro_torch.launch.top --file /tmp/lk.jsonl

``--once`` renders the latest sample and exits (CI / scripting);
``--demo`` renders from a synthetic event stream (no model, no device) so
the panel can be exercised anywhere.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

_CLUSTER_KEY = re.compile(r"^(?P<name>[a-z_]+)\{cluster=(?P<c>-?\d+)\}"
                          r"(?:\.(?P<field>\w+))?$")

_BAR_W = 24


def _bar(frac: float, width: int = _BAR_W) -> str:
    frac = max(0.0, min(1.0, frac))
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _per_cluster(snap: dict) -> dict[int, dict]:
    """Regroup the flat snapshot into ``{cluster: {metric[.field]: v}}``."""
    out: dict[int, dict] = {}
    for k, v in snap.items():
        m = _CLUSTER_KEY.match(k)
        if not m:
            continue
        c = int(m.group("c"))
        name = m.group("name")
        if m.group("field"):
            name = f"{name}.{m.group('field')}"
        out.setdefault(c, {})[name] = v
    return out


def render(snap: dict) -> list[str]:
    """One panel from one metrics snapshot (pure: testable)."""
    g = snap.get
    lines = [f"lktop — sample {snap.get('samples', '?')} "
             f"@ t={snap.get('ts_us', 0) / 1e6:.3f}s"]
    lines.append("")
    lines.append(f"  {'cluster':<8} {'device util':<{_BAR_W + 7}} "
                 f"{'qdepth':>6} {'chunks':>7} {'p50us':>8} {'p99us':>8}")
    clusters = _per_cluster(snap)
    for c in sorted(clusters):
        m = clusters[c]
        u = float(m.get("cluster_utilization", 0.0))
        lines.append(
            f"  {c:<8} [{_bar(u)}] {u:5.1%} "
            f"{m.get('cluster_queue_depth', 0):>6.0f} "
            f"{m.get('cluster_chunks', 0):>7.0f} "
            f"{m.get('device_chunk_us.p50', 0):>8.1f} "
            f"{m.get('device_chunk_us.p99', 0):>8.1f}")
    if not clusters:
        lines.append("  (no device-stamped samples yet)")
    lines.append("")
    completed = g("dispatcher.completed", 0)
    met = g("dispatcher.met", 0)
    checked = g("monitor.checked", 0)
    viol = g("monitor.bound_violations", 0)
    slack = 1.0 - (viol / checked) if checked else 1.0
    lines.append(
        f"  admission: completed={completed:.0f} met={met:.0f} "
        f"slack={slack:6.1%} rejected={g('dispatcher.rejected', 0):.0f} "
        f"shed={g('dispatcher.shed', 0):.0f}")
    lines.append(
        f"  monitor:   checked={checked:.0f} bound_violations={viol:.0f} "
        f"deadline_misses={g('monitor.deadline_misses', 0):.0f} "
        f"wcet_overruns={g('monitor.wcet_overruns', 0):.0f} "
        f"ledger={g('monitor.ledger', 0):.0f}")
    lines.append(
        f"  control:   preemptions={g('dispatcher.preemptions', 0):.0f} "
        f"recarves={g('dispatcher.recarves', 0):.0f} "
        f"(rejected={g('dispatcher.recarve_rejected', 0):.0f}) "
        f"heals={g('events.heal', 0):.0f} "
        f"shed_events={g('events.shed', 0):.0f}")
    lines.append(
        f"  collector: dropped_events={g('dropped_events', 0):.0f} "
        f"subscriber_errors={g('subscriber_error_count', 0):.0f}")
    return lines


def _draw(lines: list[str], prev_height: int, stream=sys.stdout) -> int:
    """In-place refresh: move the cursor up over the previous frame and
    repaint (each line cleared to EOL)."""
    if prev_height:
        stream.write(f"\x1b[{prev_height}F")
    for ln in lines:
        stream.write(f"\x1b[2K{ln}\n")
    stream.flush()
    return len(lines)


def _read_last(path: str) -> dict | None:
    last = None
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    last = ln
    except OSError:
        return None
    return json.loads(last) if last else None


def _demo_snapshots(frames: int):
    """Synthetic sample stream: a collector + registry fed device spans
    directly — the panel without a model or a device."""
    from repro_torch.core.telemetry import (EV_CHUNK_RETIRE, MetricsRegistry,
                                            TraceCollector)
    tc = TraceCollector()
    reg = MetricsRegistry(tc)
    t = 1_000.0
    for i in range(frames):
        for c in (0, 1, 2):
            dur = 40.0 + 25.0 * ((i + c) % 3)
            if (i + c) % 4 != 3:     # cluster idles every 4th frame
                tc.emit(EV_CHUNK_RETIRE, cluster=c, request_id=i,
                        opcode=c, chunk=0, source="device",
                        start_us=t, dur_us=dur, tick=i, row=i,
                        qdepth=(i + c) % 5)
            t += dur
        yield reg.sample()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lktop")
    ap.add_argument("--file", default=None, metavar="PATH",
                    help="JSON-lines metrics stream to follow (the "
                         "serve --metrics-file output)")
    ap.add_argument("--demo", action="store_true",
                    help="render from a synthetic event stream")
    ap.add_argument("--once", action="store_true",
                    help="render the latest sample once and exit")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="refresh interval in seconds (default 0.5)")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N refreshes (0 = until ^C)")
    args = ap.parse_args(argv)
    if (args.file is None) == (not args.demo):
        ap.error("exactly one of --file or --demo is required")

    height = 0
    if args.demo:
        frames = args.frames or (1 if args.once else 20)
        for snap in _demo_snapshots(frames):
            height = _draw(render(snap), height)
            if args.once:
                break
            time.sleep(0.0 if args.frames else args.interval)
        return 0

    n = 0
    while True:
        snap = _read_last(args.file)
        if snap is None:
            if args.once:
                print(f"lktop: no samples in {args.file}", file=sys.stderr)
                return 1
            time.sleep(args.interval)
            continue
        height = _draw(render(snap), height)
        n += 1
        if args.once or (args.frames and n >= args.frames):
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main() or 0)
