"""The program's own spans (``repro_torch.*``) in a traced run, reduced
beside the harness's (``portbench.trace``) from the same kineto events.

* nesting: each host thread's CPU events (spans, aten ops, CUDA runtime
  calls), sorted by start, nest by time; an event's parent is the
  innermost event holding its start (one stack sweep, exact at any depth:
  a decode trigger holds 40 and more layer spans);
* idle gaps: the gaps between the window's device-busy intervals, found
  as ``portbench.trace`` finds them; each goes to the innermost program
  span the host was in when it began (the program's spans come from one
  host thread, the serving loop's);
* decode triggers: ``repro_torch.rt.trigger.<work>`` spans whose works
  (``+``-joined when a ring mixes them) include ``decode``: one decode
  step each. What the readers report is read from the spans that start in
  the window;
* device time whose launch links to a program span: a kernel launched
  through ctypes (K4, K5) has no operator around it and links to the
  innermost profiler range of an operator's kind, which the program's
  spans are (the harness's ``record_function`` spans are not), so it now
  counts under the harness span that holds that program span.

    python3 portbench/program_spans.py --workload nemo-code --seed 7 \\
        --seconds 50

runs ``portbench/run.py`` traced, with this reduction stored as
``run.trace["program"]``; it prints the window's idle seconds by program
span and the decode trigger's top host ops to standard error, and adds the
program-span metrics (``METRICS``) to the result line.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "repro_torch."
TRIGGER = "repro_torch.rt.trigger."
WAIT_DECODE = "repro_torch.rt.wait.decode"
LAYER = "repro_torch.model.layer"
POLL = "repro_torch.streams.poll"
ENGINE = "repro_torch.engine."
SYNCS = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize",
                   "cudaEventSynchronize", "aten::_local_scalar_dense"})
OUTSIDE = "outside_program_spans"
# the readers in metrics/ and their units
METRICS = {"decode_issue_ms.code": "ms", "decode_wait_ms.code": "ms",
           "layer_issue_us.code": "us", "decode_syncs.code": "count",
           "idle_issue_pct.code": "%", "frontend_ms.code": "ms"}


def is_decode_trigger(name: str) -> bool:
    return name.startswith(TRIGGER) and \
        "decode" in name[len(TRIGGER):].split("+")


def _mean(xs: list, unit_ns: float):
    return sum(xs) / len(xs) / unit_ns if xs else None


def _nest(evs: list) -> list:
    """Sort ``evs`` ((start, end, name, ...), proper nesting) in place;
    each one's parent: the index of the innermost event holding its start,
    or -1."""
    evs.sort(key=lambda x: (x[0], -x[1]))
    parent, stack = [], []
    for s, e, *_ in evs:
        while stack and evs[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def _decode_ops(evs: list, lo: int, hi: int, host_ops: dict,
                layers: list, syncs: dict) -> None:
    """One host thread's CPU events: the self time of each event that a
    decode trigger starting in [lo, hi) holds (the trigger included) into
    ``host_ops`` by name, the durations of the layer spans it holds into
    ``layers``, the sync calls it holds into ``syncs`` (one nested in
    another counted once), keyed ``"<caller> > <call>"``: the caller the
    outermost aten op holding the call, else the range that holds it."""
    parent = _nest(evs)
    self_ns = [e - s for s, e, _ in evs]
    for i, p in enumerate(parent):
        if p >= 0:
            self_ns[p] -= evs[i][1] - evs[i][0]
    dec = [-1] * len(evs)        # the decode trigger holding each event
    op = [-1] * len(evs)         # the outermost aten op holding it
    in_sync = [False] * len(evs)
    for i, (s, e, name) in enumerate(evs):
        p = parent[i]
        if p >= 0:
            dec[i] = dec[p]
            op[i] = op[p]
            in_sync[i] = in_sync[p] or evs[p][2] in SYNCS
        if op[i] < 0 and name.startswith("aten::"):
            op[i] = i
        if is_decode_trigger(name):
            dec[i] = i
        if dec[i] < 0 or not lo <= evs[dec[i]][0] < hi:
            continue
        host_ops[name] += max(self_ns[i], 0) / 1e9
        if name in SYNCS and not in_sync[i]:
            caller = op[i] if op[i] not in (-1, i) else p
            syncs[f"{evs[caller][2] if caller >= 0 else '-'} > {name}"] += 1
        if name == LAYER:
            layers.append(e - s)


def reduce_events(events) -> dict:
    """``events``: the profiler's kineto events (``portbench.trace``'s
    interface, and ``start_thread_id()``)."""
    from portbench.trace import SPAN_PREFIX, Spans, union_busy
    window = None
    by_thread = defaultdict(list)
    harness = []
    prog_start = {}     # correlation id of a program span -> its start
    dev = []
    dev_spans = 0       # program spans copied onto the device timeline
    for e in events:
        name = e.name()
        s = e.start_ns()
        d = e.duration_ns()
        if str(e.device_type()).endswith("CPU"):
            if name == "portbench.window":
                window = (s, s + d)
            elif name.startswith(SPAN_PREFIX):
                harness.append((s, s + d, name))
            elif name.startswith(PREFIX):
                prog_start[e.correlation_id()] = s
            by_thread[e.start_thread_id()].append((s, s + d, name))
        elif not name.startswith(SPAN_PREFIX):
            dev.append((s, s + d, e.linked_correlation_id()))
            dev_spans += name.startswith(PREFIX)
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi = window
    # device time launched with no operator around it (K4 and K5 through
    # ctypes), whose launch links to a program span, by harness span
    sp = Spans(harness)
    via_spans = defaultdict(float)
    for s, e, corr in dev:
        if corr in prog_start and e > lo and s < hi:
            via_spans[sp.at(prog_start[corr])] += \
                (min(e, hi) - max(s, lo)) / 1e9

    host_ops = defaultdict(float)
    layers = []
    syncs = defaultdict(int)
    for evs in by_thread.values():
        _decode_ops(evs, lo, hi, host_ops, layers, syncs)

    # the program's spans alone, nested
    prog = [x for evs in by_thread.values() for x in evs
            if x[2].startswith(PREFIX)]
    up = _nest(prog)
    issue, waits, polls = [], [], {}
    cover = defaultdict(int)      # poll -> ns its engine spans cover
    for i, (s, e, name) in enumerate(prog):
        if name.startswith(ENGINE):
            a = up[i]
            while a >= 0 and prog[a][2] != POLL and \
                    not prog[a][2].startswith(ENGINE):
                a = up[a]
            if a >= 0 and prog[a][2] == POLL:
                cover[a] += e - s
        if not lo <= s < hi:
            continue
        if is_decode_trigger(name):
            issue.append(e - s)
        elif name == WAIT_DECODE:
            waits.append(e - s)
        elif name == POLL:
            polls[i] = e - s
    fronts = [d - cover[i] for i, d in polls.items()]

    # idle gaps, by the innermost program span holding each gap's start:
    # of the spans started by then, the latest-starting one or the
    # innermost of its ancestors that has not ended
    starts = [x[0] for x in prog]
    _, merged = union_busy([(s, e) for s, e, _ in dev], lo, hi)
    idle = defaultdict(float)
    idle_issue = 0.0
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gap = (s - prev) / 1e9
            j = bisect.bisect_right(starts, prev) - 1
            while j >= 0 and prog[j][1] <= prev:
                j = up[j]
            idle[prog[j][2] if j >= 0 else OUTSIDE] += gap
            while j >= 0 and not is_decode_trigger(prog[j][2]):
                j = up[j]
            if j >= 0:
                idle_issue += gap
        prev = max(prev, e)
    n = len(issue)
    top = sorted(host_ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_issue_s": idle_issue,
        "decode_steps": n,
        "decode_issue_ms": _mean(issue, 1e6),
        "decode_wait_ms": _mean(waits, 1e6),
        "layer_issue_us": _mean(layers, 1e3),
        "decode_syncs": sum(syncs.values()) / n if n else None,
        "sync_calls": dict(syncs),
        "frontend_ms": _mean(fronts, 1e6),
        "top_host_ops": [[k, v] for k, v in top],
        "device_span_events": dev_spans,
        "device_s_via_program_spans": dict(via_spans),
    }


def reduce_profile(prof) -> dict:
    return reduce_events(prof.profiler.kineto_results.events())


def describe(prog: dict) -> list:
    """The lines a traced run prints: the window's idle seconds by
    innermost program span, the decode trigger's top host ops."""
    out = [f"portbench: card idle by innermost program span "
           f"(s of the {prog['window_s']:.2f} s window):"]
    out += [f"  {v:10.4f}  {k}" for k, v in prog["idle_s"].items()]
    out.append(f"portbench: host self time inside decode triggers "
               f"({prog['decode_steps']} steps in the window), top ops (s):")
    out += [f"  {v:10.4f}  {k}" for k, v in prog["top_host_ops"]]
    out.append(f"portbench: sync calls inside decode triggers: "
               f"{prog['sync_calls']}; device s launched from program "
               f"spans, by harness span: "
               f"{prog['device_s_via_program_spans']}; program spans on "
               f"the device timeline: {prog['device_span_events']}")
    return out


def main(argv=None) -> int:
    """``portbench/run.py``'s traced run with the program's spans."""
    from portbench import run, spec, trace
    reduce0, run_cell0 = trace.reduce_profile, run.run_cell

    def reduce_both(prof):
        out = reduce0(prof)
        out["program"] = reduce_profile(prof)
        return out

    def run_cell(*a, **k):
        out = run_cell0(*a, **k)
        r = out["_run"]
        if r.trace and "program" in r.trace:
            print("\n".join(describe(r.trace["program"])), file=sys.stderr)
            for name, unit in METRICS.items():
                v = spec.metric_reader(name, ROOT)(r)
                if v is not None:
                    out["metrics"][name] = {"value": float(v), "unit": unit}
        return out

    trace.reduce_profile, run.run_cell = reduce_both, run_cell
    return run.main(argv)


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
