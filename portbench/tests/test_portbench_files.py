"""A configuration, a traffic mix and a metric added as new files (and
entries) in a copy of the benchmark are found by name, with no edit to a
file that was there."""
import json
import shutil

from portbench import spec


def test_new_files_are_found(tmp_path):
    root = spec.ROOT
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "mistral-nemo-12b.json").read_text())
    cfg["name"] = "nemo-half"
    (pb / "configs" / "nemo-half.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "code_nemo.json").read_text())
    tr["rate_per_s"] = 1.5
    (pb / "traffic" / "code_slow.json").write_text(json.dumps(tr))
    (pb / "metrics" / "late_open_ms.py").write_text(
        "def read(run):\n    return run.late_s * 1e3\n")
    (pb / "checks" / "nemo-slow.json").write_text(
        json.dumps({"limits": {"gap_max": {"limit": 0.5}}}))
    bench["configs"].append({"name": "nemo-half", "source": "x",
                             "file": "portbench/configs/nemo-half.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "nemo-slow", "config": "nemo-half",
                               "traffic": "code_slow", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "late_open_ms", "unit": "ms",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "serving/streams",
                               "moves": "itl_p95_ms",
                               "workloads": ["nemo-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(tmp_path, "nemo-slow")
    assert cell.config["name"] == "nemo-half"
    assert cell.traffic["rate_per_s"] == 1.5
    assert cell.checks["limits"]["gap_max"]["limit"] == 0.5
    assert "late_open_ms" in [m["name"] for m in cell.per_layer]
    assert {m["name"] for m in cell.end_to_end} == {"itl_p95_ms", "setup_s"}
    assert "late_open_ms" not in [
        m["name"] for m in spec.load_cell(tmp_path, "nemo-code").per_layer]

    class R:
        late_s = 0.003
    assert spec.metric_reader("late_open_ms", tmp_path)(R) == 3.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    root = spec.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(root, w["name"], bench)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert cell.checks["limits"], w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(spec.metric_reader(m["name"], root))
