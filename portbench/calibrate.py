"""Readings that set a cell's numbers, taken on the card, in one process.

    python3 portbench/calibrate.py checks --workload nemo-code \
        --seeds 11,12,13 --control 11,12,13 --seconds 20
    python3 portbench/calibrate.py knee --workload nemo-code \
        --rates 1.5,2,2.5 --seconds 30

``checks``: for each seed a run of the cell at its own size and load (a
short window), then the correctness numbers of what the program served
and, for the seeds in ``--control``, of the control (the reference in
float8 in the program's place, judged by the float32 reference at the
same positions). The limits in ``checks/<workload>.json`` are set from
these readings. ``knee``: the cell's traffic at each open-loop rate, with
how far behind the frontend fell over the window. One JSON line a
reading, also appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _emit(rec: dict, out: Path) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def checks_readings(cell, seeds, control, seconds, out, device):
    import torch

    from portbench import checks, serve, traffic
    for seed in seeds:
        t = time.time()
        system = serve.System(cell, seed, device)
        reqs = traffic.generate(cell.traffic, system.cfg.vocab_size, seed,
                                seconds)
        system.warm_up(seed)
        run = serve.Run(cell, seed, float(seconds),
                        model=cell.config["model"])
        serve.serve_window(system, reqs, run)
        serve.finish(system, run)
        del system
        torch.cuda.empty_cache()
        t_ref = time.time()
        due = [r for r in run.streams if run.in_window(r.due)]
        finished = checks.sample_finished(
            due, seed, int(cell.checks.get("served_tokens", 320)),
            int(cell.checks.get("max_requests", 16)))
        got = checks.compare(cell.config, seed, device, finished,
                             control=seed in control)
        _emit({"workload": cell.name, "seed": seed, **got,
               "finished": len(finished),
               "run_s": t_ref - t, "reference_s": time.time() - t_ref},
              out)


def knee_readings(cell, rates, seconds, out, device, seed):
    from portbench import serve, traffic
    from portbench.serve import pctl, ttfts
    system = serve.System(cell, seed, device)
    system.warm_up(seed)
    for rate in rates:
        tr = dict(cell.traffic, rate_per_s=float(rate))
        reqs = traffic.generate(tr, system.cfg.vocab_size, seed, seconds)
        run = serve.Run(cell, seed, float(seconds),
                        model=cell.config["model"])
        serve.serve_window(system, reqs, run)
        waiting = sum(1 for r in run.live.values() if r.first is None)
        serve.drain(system, run)
        half = run.t0 + seconds / 2
        early = [r.first - r.due for r in run.streams
                 if r.first is not None and r.due < half]
        late = [r.first - r.due for r in run.streams
                if r.first is not None and r.due >= half]
        _emit({"workload": cell.name, "rate": rate, "due": len(reqs),
               "waiting_at_end": waiting, "late_open_s": run.late_s,
               "ttft_p50_first_half_ms": pctl(early, 50) * 1e3,
               "ttft_p50_second_half_ms": pctl(late, 50) * 1e3,
               "ttft_p95_ms": pctl(ttfts(run), 95) * 1e3,
               "shed": run.counters1["shed"] - run.counters0["shed"]}, out)
        system.fe.serve()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("checks", "knee"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--control", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "portbench"
                                         / "calibrate.jsonl"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import spec
    from portbench.run import set_cache_dirs
    set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    if args.what == "checks":
        checks_readings(cell, seeds, control, args.seconds, Path(args.out),
                        "cuda:0")
    else:
        knee_readings(cell, [float(r) for r in args.rates.split(",")],
                      args.seconds, Path(args.out), "cuda:0", seeds[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
