"""Reduce a traced run's profiler trace to what the metric readers read.

The trace is ``torch.profiler`` over the whole measured window (CPU and
CUDA activities). Read straight from the profiler's event list:

* the window: the ``portbench.window`` span;
* device intervals: every event on the device (kernels, copies, sets);
  busy time is the length of their union inside the window;
* attribution: a device event's linked correlation id names the CPU
  event (an operator, or the innermost ``record_function`` span) that
  launched it; that event's start lies inside the harness's spans, and
  the innermost ``portbench.*`` span there owns the device time;
* idle gaps: each gap between busy intervals goes to the innermost
  ``portbench.*`` span the host was in when the gap began.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "portbench."
K4_NAMES = ("decode_mma_kernel", "decode_ffma_kernel")
K5_NAMES = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")


def _kind(name: str) -> str:
    if any(k in name for k in K4_NAMES):
        return "k4"
    if any(k in name for k in K5_NAMES):
        return "k5"
    return ""


class Spans:
    """The harness's spans, for 'the innermost span at time t'."""

    def __init__(self, spans: list):
        # (start, end, name), sorted by start; nesting is proper
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: int) -> str:
        """The innermost span holding ``t``: of the spans that started
        by ``t``, the latest-starting one that has not ended (a poll holds
        at most a few dozen spans, so the search looks that far back)."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            s, e, name = self.spans[j]
            if s <= t < e:
                return name
        return "outside_harness_spans"


def union_busy(intervals: list, lo: int, hi: int):
    """(busy ns inside [lo, hi), the merged intervals)."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def reduce_events(events) -> dict:
    """``events``: the profiler's kineto events (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``correlation_id()``, ``linked_correlation_id()``)."""
    cpu_start = {}
    spans = []
    dev = []
    window = None
    for e in events:
        name = e.name()
        s = e.start_ns()
        d = e.duration_ns()
        if str(e.device_type()).endswith("CPU"):
            cpu_start[e.correlation_id()] = s
            if name.startswith(SPAN_PREFIX):
                spans.append((s, s + d, name))
                if name == "portbench.window":
                    window = (s, s + d)
        elif not name.startswith(SPAN_PREFIX):
            # (a span's range on the device timeline is no operation)
            dev.append((s, s + d, name, e.linked_correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi = window
    sp = Spans([x for x in spans if x[2] != "portbench.window"])
    busy, merged = union_busy([(s, e) for s, e, _, _ in dev], lo, hi)
    by_name = defaultdict(float)
    by_span = defaultdict(float)
    kern = defaultdict(float)
    linked = 0
    for s, e, name, corr in dev:
        if e <= lo or s >= hi:
            continue
        dur = (min(e, hi) - max(s, lo)) / 1e9
        by_name[name] += dur
        k = _kind(name)
        if k:
            kern[k] += dur
        t = cpu_start.get(corr)
        if t is not None:
            linked += dur
            by_span[sp.at(t)] += dur
        else:
            by_span["unlinked"] += dur
    gaps = defaultdict(float)
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps[sp.at(prev)] += (s - prev) / 1e9
        prev = max(prev, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "device_s_by_span": dict(by_span),
        "kernel_s": dict(kern),
        "linked_share": linked / max(busy / 1e9, 1e-12),
        "breakdown": {"device_ops": [[n, v] for n, v in top],
                      "idle_gaps": [[n, v] for n, v in top_gaps]},
    }


def reduce_profile(prof) -> dict:
    return reduce_events(prof.profiler.kineto_results.events())
