"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights drawn on the card from the seed, the engine booted, the
cell's prompt lengths served once) is timed from the process's start;
then the traffic's lead-in (the end of its schedule, due before the
window; not timed) brings the load to its steady state, and ``--seconds``
of the cell's traffic are served and measured; then the requests due in
the window are waited for, the program's state is freed and what it
served of them is checked against the plain reference. With
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the per-layer metrics, the device's busy and window seconds and a
breakdown; with ``--trace 0`` the end-to-end metrics. The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit.

It runs on the card it is started on and refuses to run without one.
Every build and kernel cache goes under ``build/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs(root: Path) -> None:
    """Every cache the program or torch could write, at fixed paths in
    the checkout (the port's own kernels build into ``build/kernels``)."""
    cache = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_proc: float) -> dict:
    """Set up, serve and measure one cell, check it; the result line as a
    dict (and, for tests, ``_run``: the harness's record, ``_numbers``:
    the numbers compared, ``_material``: what they were compared on)."""
    import torch

    from portbench import checks, serve, spec, traffic
    from portbench.trace import reduce_profile
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    system = serve.System(cell, seed, dev)
    reqs = traffic.generate(cell.traffic, system.cfg.vocab_size, seed,
                            seconds)
    system.warm_up(seed)
    setup_s = time.time() - t_proc
    run = serve.Run(cell, seed, float(seconds), model=cell.config["model"],
                    device_kind=torch.cuda.get_device_name(dev)
                    if on_card else "cpu")
    prof = None

    def start_trace():
        nonlocal prof
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        system.tracing = True
    serve.serve_window(system, reqs, run,
                       on_window=start_trace if trace else None)
    if prof is not None:
        prof.stop()
        system.tracing = False
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    serve.finish(system, run)
    del system
    if on_card:
        torch.cuda.empty_cache()
    if prof is not None:
        run.trace = reduce_profile(prof)
        del prof
    due = [r for r in run.streams if run.in_window(r.due)]
    finished = checks.sample_finished(
        due, seed, int(cell.checks.get("served_tokens", 320)),
        int(cell.checks.get("max_requests", 16)))
    numbers = checks.compare(cell.config, seed, dev, finished)["program"]
    correct, shown = checks.verdict(numbers, cell.checks)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["source"] == "device_trace" and not on_card:
            continue            # no device number from a CPU run
        if m["name"] == "setup_s":
            v = setup_s
        else:
            v = spec.metric_reader(m["name"], ROOT)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(1 for r in due if r.failed or (
        r.req.high and r.sid in run.violations))
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": run.device_kind, "count": cell.chips,
                "memory_peak_bytes": int(peak)}
    if on_card:
        dev_info["power_limit"] = power_limit()
    out = {"correct": bool(correct), "attempted": len(due),
           "failed": failed, "metrics": metrics, "device": dev_info}
    if run.trace:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = shown
    out["_run"] = run
    out["_numbers"] = numbers
    out["_material"] = finished
    return out


def main(argv=None) -> int:
    t_proc = time.time() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import spec
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_proc)
    numbers = out.pop("_numbers")
    run = out.pop("_run")
    trace_linked = run.trace["linked_share"] if run.trace else 0.0
    out.pop("_material")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"portbench: numbers {json.dumps(numbers)}", file=sys.stderr)
    if "breakdown" in out:
        print(f"portbench: device time linked to its launch: "
              f"{trace_linked:.3f} of busy", file=sys.stderr)
    for name, c in out["checks"].items():
        lim = c.get("limit", c.get("min"))
        rel = "<=" if "limit" in c else ">="
        print(f"check {name} {c['value']} {rel} {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
