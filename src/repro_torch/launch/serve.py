"""Serving entrypoint of the PyTorch port: persistent engine, batched
requests, WCET report (paper phases Init/Trigger/Wait/Dispose).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 4 --max-new 8            # full width, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --streams --elastic --metrics-file /tmp/lk.jsonl

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --requests 4 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --reduced --device cpu

Weights are random, drawn on the device from ``--seed``. The flags are the
reference's (``repro.launch.serve``) plus ``--device`` (default ``cuda``;
no silent CPU fallback). An encdec arch (whisper-tiny) gives each request
its 1500 stub frames (``encoder_frames`` x ``d_model``), drawn from the
same numpy generator as the prompts and in the reference's order, and
takes the host prefill for them; a vlm arch (internvl2-76b) likewise gives
each request its stub patch embeddings (``vision_tokens`` x ``d_model``).
``main`` returns a :class:`ServeReport`, so callers read the results
without parsing stdout; ``main(argv, cfg=...)`` serves a config a caller
made (a cut depth) in place of ``--arch``'s.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import wcet
from repro_torch.core.elastic import ElasticController
from repro_torch.core.sched import CRIT_HIGH, CRIT_LOW
from repro_torch.core.telemetry import (MetricsPump, MetricsRegistry,
                                        TraceCollector)
from repro_torch.core.wcet import WcetTracker
from repro_torch.distributed import ShardCtx
from repro_torch.models import build
from repro_torch.serving import ServingEngine, StreamFrontend
from repro_torch.serving.engine import OP_DECODE, OP_INSERT, OP_PREFILL
from repro_torch.serving.streams import OP_STREAM_HIGH, OP_STREAM_LOW


@dataclass
class ServeReport:
    """What one ``main`` run served: per-request token lists, the
    dispatcher's ``deadline_stats()`` and the WCET tracker; with a
    collector attached, ``monitor`` (``BoundMonitor.counts()``); with
    ``--streams``, the frontend's counters (``streams``: opened, admitted,
    shed, readmitted, closed, admission_failures, evictions) and the
    collector's per-class quantile summaries of ``stream_ttft_us`` and
    ``stream_response_us`` (``{"stream_high"|"stream_low": summary}``, the
    warm-up stream among the LOW ones); with ``--metrics-*``, ``metrics``
    (samples, device_chunks, utilization by cluster at the last sample and
    ``utilization_pct``, the summary of every sample ×100: on this runtime
    the share of wall time from a step's trigger to its readback, not the
    card's busy share); with ``--elastic``, the controller's counters
    plus the dispatcher's recarves and the share history."""
    outputs: list
    deadline_stats: dict
    tracker: WcetTracker
    monitor: Optional[dict] = None
    streams: Optional[dict] = None
    stream_ttft_us: dict = field(default_factory=dict)
    stream_response_us: dict = field(default_factory=dict)
    metrics: Optional[dict] = None
    elastic: Optional[dict] = None


def _requests(cfg, n: int, seed: int):
    """``n`` prompts of 4-23 tokens and, for an encdec arch, each one's
    stub frames, for a vlm arch each one's stub patch embeddings: the
    reference's draws, in its order."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
               for _ in range(n)]
    extras = None
    if cfg.family == "encdec":
        extras = [{"frames": rng.normal(
            size=(cfg.encoder_frames, cfg.d_model)).astype(np.float32)}
            for _ in range(n)]
    if cfg.family == "vlm":
        extras = [{"vision_embeds": rng.normal(
            size=(cfg.vision_tokens, cfg.d_model)).astype(np.float32)}
            for _ in range(n)]
    return prompts, extras


def _drive(args, engine, collector, prompts, extras):
    """Serve ``prompts``: through the stream frontend (``--streams``: a
    2-token warm-up stream first, then every ``--high-every``-th stream
    HIGH, each arrival followed by one poll) or ``engine.generate``.
    Returns (token lists, the frontend or None)."""
    if not args.streams:
        return engine.generate(prompts, max_new_tokens=args.max_new,
                               extras=extras), None
    fe = StreamFrontend(engine, collector=collector)
    fe.open_stream(prompts[0], max_new_tokens=2)      # warm WCETs
    fe.serve()
    sids = []
    for i, p in enumerate(prompts):
        crit = CRIT_HIGH if args.high_every and \
            i % args.high_every == 0 else CRIT_LOW
        sids.append(fe.open_stream(p, max_new_tokens=args.max_new,
                                   criticality=crit))
        fe.poll()             # arrivals land on a loaded engine
    fe.serve()
    print(f"[serve] streams: opened={fe.opened} shed={fe.shed_count} "
          f"readmitted={fe.readmitted} closed={fe.closed} "
          f"evictions={engine.slots.evictions}")
    for line in fe.collector.format_table("stream_ttft_us"):
        print(f"[serve] {line}")
    for line in fe.collector.format_table("stream_response_us"):
        print(f"[serve] {line}")
    return [fe.result(s) for s in sids], fe


def main(argv=None, *, cfg=None) -> ServeReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (cuda raises when CUDA is "
                         "absent; nothing falls back to the CPU)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--completion-window", type=int, default=1024,
                    help="rolling completion/straggler window kept by the "
                         "dispatcher (stats stay exact beyond it)")
    ap.add_argument("--policy", choices=("edf", "fp", "server"),
                    default="edf",
                    help="scheduling policy: earliest-deadline-first, "
                         "fixed-priority, or per-class budgeted servers "
                         "(decode gets a HIGH-criticality 80%% server)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="run prefill device-side as resumable chunks "
                         "through the dispatcher (queued work can cut in at "
                         "every chunk boundary; admission charges one "
                         "chunk, not one prompt)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per prefill chunk "
                         "(default: the prefill bucket size)")
    ap.add_argument("--max-steps", type=int, default=8,
                    help="descriptor-ring capacity of one batched doorbell "
                         "(trigger_many rows per ring)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable chunk-boundary preemption (chunks of "
                         "one item run back to back)")
    ap.add_argument("--streams", action="store_true",
                    help="serve through the continuous-batching stream "
                         "frontend: each request is an admission-governed "
                         "stream (HIGH/LOW criticality), LOW streams shed "
                         "and re-admitted under overload, per-stream "
                         "TTFT/response quantiles reported")
    ap.add_argument("--high-every", type=int, default=4,
                    help="with --streams: every Nth stream is "
                         "HIGH-criticality (default 4)")
    ap.add_argument("--elastic", action="store_true",
                    help="attach the elastic partitioning controller in "
                         "ADVISORY mode: it observes the dispatcher's "
                         "per-class backlog off the telemetry stream, "
                         "admission-gates every proposed carve, and "
                         "rewrites class pin sets when an imbalance "
                         "sustains; the per-generation cluster-shares "
                         "table prints at exit")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="attach the telemetry collector and export a "
                         "Chrome/Perfetto trace JSON of the run to PATH "
                         "(also prints the per-opcode latency quantiles "
                         "and the runtime-verification ledger)")
    ap.add_argument("--metrics-file", default=None, metavar="PATH",
                    help="attach the continuous metrics registry and pump "
                         "one JSON-lines sample per interval to PATH (a "
                         "Prometheus-text sibling PATH.prom is rewritten "
                         "atomically each sample; tail either with "
                         "launch/top.py)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics (Prometheus text) and "
                         "/metrics.json from a background HTTP thread on "
                         "127.0.0.1:PORT (0 picks a free port)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI preset: forces --reduced and clamps request "
                         "counts so the serve loop (and its metrics "
                         "exposition) finishes in seconds; --device is "
                         "left as given")
    args = ap.parse_args(argv)
    if args.smoke:
        args.reduced = True
        args.requests = min(args.requests, 6)
        args.max_new = min(args.max_new, 4)

    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    prompts, extras = _requests(cfg, args.requests, args.seed)
    if args.streams and extras is not None:
        raise SystemExit("--streams does not support encdec/vlm archs "
                         "(prompt extras need the host prefill path with "
                         "per-request tensors)")
    model = build(cfg, ShardCtx.single(kind="decode"), device=args.device)
    params = model.init(args.seed)

    tracker = WcetTracker("serve")
    # the elastic controller and the metrics registry both observe load
    # through the telemetry stream, so --elastic / --metrics-* attach a
    # collector even without --trace (which also turns the runtime's
    # flight recorder on — its chunk spans feed the per-cluster gauges)
    want_metrics = args.metrics_file is not None or \
        args.metrics_port is not None
    collector = TraceCollector() \
        if (args.trace or args.elastic or want_metrics) else None
    engine = ServingEngine(model, params, max_batch=args.max_batch,
                           max_seq=args.max_seq, tracker=tracker,
                           completion_window=args.completion_window,
                           policy=args.policy,
                           max_steps=args.max_steps,
                           chunked_prefill=args.chunked_prefill,
                           prefill_chunk_tokens=args.prefill_chunk,
                           telemetry=collector, device=args.device)
    if args.no_preempt:
        engine.dispatcher.policy.preemptive = False
    metrics = pump = None
    if want_metrics:
        metrics = MetricsRegistry(collector)
        pump = MetricsPump(metrics, path=args.metrics_file,
                           port=args.metrics_port, interval_s=0.25).start()
        if args.metrics_port is not None:
            print(f"[serve] metrics: http://127.0.0.1:{pump.port}/metrics")
    elastic = None
    if args.elastic:
        classes = {"decode": OP_DECODE, "insert": OP_INSERT}
        if args.chunked_prefill:
            classes["prefill"] = OP_PREFILL
        if args.streams:
            classes["stream_high"] = OP_STREAM_HIGH
            classes["stream_low"] = OP_STREAM_LOW
        elastic = ElasticController().bind_dispatcher(
            engine.dispatcher, classes)
        if metrics is not None:
            # advisory: blend per-cluster measured utilization into the
            # backlog-demand signal driving recarve proposals
            elastic.bind_metrics(metrics)
        # advisory threading: every emitted event gives the controller a
        # (rate-limited) chance to evaluate, so the serve loop needs no
        # explicit tick plumbing
        collector.subscribe(lambda ev: elastic.maybe_tick())
    try:
        outs, fe = _drive(args, engine, collector, prompts, extras)
    except BaseException:
        if pump is not None:
            pump.stop()           # no pump thread outlives a failed run
        raise
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    for i, o in enumerate(outs[: min(4, len(outs))]):
        print(f"[serve] req{i}: {o}")
    print(f"[serve] completed {len(outs)} requests, "
          f"{sum(len(o) for o in outs)} tokens")
    for phase, s in tracker.time_phases().items():
        print(f"[serve] {phase:8s} avg={s.avg_ns/1e3:9.1f}us "
              f"worst={s.worst_ns/1e3:9.1f}us jitter={(s.worst_ns-s.avg_ns)/1e3:9.1f}us "
              f"n={s.count}")
    qd = tracker.stats.get(wcet.QUEUE_DEPTH)
    if qd is not None:
        print(f"[serve] queue_depth avg={qd.avg_ns:5.2f} "
              f"worst={qd.worst_ns:3.0f} n={qd.count}")
    ds = engine.dispatcher.deadline_stats()
    print(f"[serve] policy={ds.get('policy', '?')} shed={ds.get('shed', 0)} "
          f"chunks={ds.get('chunks', 0)} "
          f"preemptions={ds.get('preemptions', 0)}")
    print(f"[serve] dispatcher n={ds['n']} met={ds.get('met', 0)} "
          f"rejected={ds.get('rejected', 0)} "
          f"stragglers={ds.get('stragglers', 0)} "
          f"window={ds.get('window', 0)}/{engine.dispatcher.completion_window}")
    report = ServeReport(outputs=outs, deadline_stats=ds, tracker=tracker)
    if elastic is not None:
        ec = elastic.counters()
        print(f"[serve] elastic: ticks={ec['ticks']} "
              f"applied={ec['applied']} rejected={ec['rejected']} "
              f"recarves={ds.get('recarves', 0)} "
              f"recarve_rejected={ds.get('recarve_rejected', 0)}")
        print("[serve] elastic shares by generation:")
        if elastic.share_history:
            for gen, shares in elastic.share_history:
                cells = " ".join(f"{k}={v}" for k, v in sorted(
                    shares.items()))
                print(f"[serve]   gen {gen:3d}: {cells}")
        else:
            print("[serve]   gen   1: static carve held "
                  "(no sustained imbalance)")
        report.elastic = dict(
            ec, recarves=ds.get("recarves", 0),
            recarve_rejected=ds.get("recarve_rejected", 0),
            share_history=list(elastic.share_history))
    # --streams alone attaches the frontend's own collector
    tel = fe.collector if fe is not None else collector
    if tel is not None:
        report.monitor = tel.monitor.counts()
    if collector is not None and args.trace:
        for line in collector.format_table("response_us"):
            print(f"[serve] {line}")
        mc = report.monitor
        print(f"[serve] runtime verification: checked={mc['checked']} "
              f"bound_violations={mc['bound_violations']} "
              f"deadline_misses={mc['deadline_misses']} "
              f"wcet_overruns={mc['wcet_overruns']}")
        n_ev = collector.export_chrome(args.trace)
        print(f"[serve] wrote {n_ev} trace events to {args.trace}")
    if fe is not None:
        report.streams = dict(
            opened=fe.opened, admitted=fe.admitted, shed=fe.shed_count,
            readmitted=fe.readmitted, closed=fe.closed,
            admission_failures=fe.admission_failures,
            evictions=engine.slots.evictions)
        report.stream_ttft_us = fe.collector.quantiles("stream_ttft_us")
        report.stream_response_us = fe.collector.quantiles(
            "stream_response_us")
    if pump is not None:
        pump.stop()               # final sample: short runs still export
        snap = metrics.snapshot()
        util = metrics.utilization()
        cells = " ".join(f"cluster{c}={u:.3f}"
                         for c, u in sorted(util.items()))
        chunks = sum(v for k, v in snap.items()
                     if k.startswith("cluster_chunks{"))
        # the runtime's chunk spans are logical ticks mapped into each
        # block's host window, so this is a host-window share
        print(f"[serve] metrics: samples={metrics.samples} "
              f"device_chunks={chunks:.0f} utilization (host-window share, "
              f"trigger to readback) "
              f"{cells if cells else '(no device spans)'}")
        if args.metrics_file:
            print(f"[serve] metrics written to {args.metrics_file} "
                  f"(+ .prom sibling)")
        # the last sample covers only the run's tail: the distribution of
        # every sample is what describes the run
        report.metrics = dict(
            samples=metrics.samples, device_chunks=chunks, utilization=util,
            utilization_pct={c: metrics.histogram(
                "cluster_utilization_pct", cluster=c).hist.summary()
                for c in util})
    engine.dispose()
    return report


if __name__ == "__main__":
    main()
