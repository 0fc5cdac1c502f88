"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: the port's ``repro_torch`` begins with
``repro``), nothing reads ``benchmarks/``, and the reference and the work
counters import nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_loads_jax_or_repro():
    code = (
        "import sys, json, warnings; warnings.simplefilter('ignore');"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}];"
        "import portbench.run, portbench.serve, portbench.checks,"
        " portbench.trace, portbench.calibrate, portbench.reference,"
        " portbench.work, portbench.traffic, portbench.weights;"
        "from portbench import spec; from portbench.tests import tiny;"
        "[spec.metric_reader(p.stem) for p in"
        f" __import__('pathlib').Path({str(PKG / 'metrics')!r}).glob('*.py')];"
        "import time; from portbench.run import run_cell;"
        "run_cell(tiny.cell(), 5, 1.0, True, 'cpu', time.time());"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "portbench" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_forbidden_names_compared_whole():
    assert "repro" in FORBIDDEN and "repro_torch" not in FORBIDDEN
    from portbench.run import forbidden_modules
    sys.modules.setdefault("repro_torch_probe_module", sys)
    try:
        assert "repro_torch_probe_module" not in forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_probe_module", None)


def test_reference_and_work_import_nothing_of_the_port():
    plain = list((PKG / "reference").glob("*.py")) + \
        list((PKG / "work").glob("*.py")) + [PKG / "weights.py"]
    for p in plain:
        bad = _imports(p) & {"repro", "repro_torch", "jax", "jaxlib",
                             "flax"}
        assert not bad, (p, bad)


def test_nothing_reads_benchmarks():
    for p in PKG.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text, p
        assert not _imports(p) & {"benchmarks"}, p
