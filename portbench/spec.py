"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's entry names its file, the traffic mix is
``traffic/<traffic>.json``, each metric is read by ``metrics/<name>.py``
and the cell's correctness limits are ``checks/<workload>.json``. Adding a
cell, a configuration, a traffic mix or a metric adds files and entries
and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    config: dict              # the configuration file's content
    traffic: dict             # the traffic file's content
    chips: int
    end_to_end: list          # metric entries this cell reports (trace 0)
    per_layer: list           # metric entries this cell reports (trace 1)
    checks: dict              # correctness limits (checks/<workload>.json)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (or ``bench``)
    with its files read."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    entry = cfgs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)
                 and m["moves"] in reported]
    pkg = root / "portbench"
    checks_path = pkg / "checks" / f"{workload}.json"
    return Cell(
        name=workload,
        config=load_json(root / entry["file"]),
        traffic=load_json(pkg / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
        checks=load_json(checks_path) if checks_path.exists() else {})


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
