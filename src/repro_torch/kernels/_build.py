"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes``. Libraries go into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built at import: the first launch builds its own source, and
``build_all()`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_DIR = Path(__file__).resolve().parent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[Path, ctypes.CDLL] = {}


def sources() -> list[Path]:
    """Every kernel source of the package."""
    return sorted(KERNEL_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(srcs=None) -> dict[Path, float]:
    """Build every missing library, one ``nvcc`` per source started
    together; returns {source: seconds} for the sources it compiled.
    Raises with the compiler's output if any build fails. The ptxas
    report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``."""
    srcs = [Path(s) for s in (srcs if srcs is not None else sources())]
    todo = [s for s in srcs if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((src, out, tmp, proc))
    took: dict[Path, float] = {}
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, building it first if needed."""
    src = Path(src)
    lib = _loaded.get(src)
    if lib is None:
        build_all([src])
        lib = ctypes.CDLL(str(library_path(src)))
        _loaded[src] = lib
    return lib
