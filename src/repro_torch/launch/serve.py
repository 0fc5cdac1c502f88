"""Serving entrypoint of the PyTorch port: persistent engine, batched
requests, WCET report (paper phases Init/Trigger/Wait/Dispose).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 4 --max-new 8            # full width, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Weights are random, drawn on the device from ``--seed``. The flags are the
reference's (``repro.launch.serve``) minus those whose modules are not
ported yet (--streams, --elastic, --metrics-*, --smoke), plus
``--device`` (default ``cuda``; no silent CPU fallback).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import wcet
from repro_torch.core.telemetry import TraceCollector
from repro_torch.core.wcet import WcetTracker
from repro_torch.distributed import ShardCtx
from repro_torch.models import build
from repro_torch.serving import ServingEngine


@dataclass
class ServeReport:
    """What one ``main`` run served: per-request token lists, the
    dispatcher's ``deadline_stats()`` and the WCET tracker."""
    outputs: list
    deadline_stats: dict
    tracker: WcetTracker


def main(argv=None) -> ServeReport:
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="attach the telemetry collector and export a "
                         "Chrome/Perfetto trace JSON of the run to PATH "
                         "(also prints the per-opcode latency quantiles "
                         "and the runtime-verification ledger)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg, ShardCtx.single(kind="decode"), device=args.device)
    params = model.init(args.seed)

    tracker = WcetTracker("serve")
    collector = TraceCollector() if args.trace else None
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
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
               for _ in range(args.requests)]

    outs = engine.generate(prompts, max_new_tokens=args.max_new)
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
    if collector is not None:
        for line in collector.format_table("response_us"):
            print(f"[serve] {line}")
        mc = collector.monitor.counts()
        print(f"[serve] runtime verification: checked={mc['checked']} "
              f"bound_violations={mc['bound_violations']} "
              f"deadline_misses={mc['deadline_misses']} "
              f"wcet_overruns={mc['wcet_overruns']}")
        n_ev = collector.export_chrome(args.trace)
        print(f"[serve] wrote {n_ev} trace events to {args.trace}")
    engine.dispose()
    return ServeReport(outputs=outs, deadline_stats=ds, tracker=tracker)


if __name__ == "__main__":
    main()
