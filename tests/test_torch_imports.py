"""The port stands alone: every ``repro_torch`` module imports without
pulling in ``jax`` or the reference package, the protocol constants it
copies equal the reference's, and its entry points refuse CUDA where
there is none instead of dropping to the CPU."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core.mailbox as j_mb
import repro.core.sched as j_sched
import repro.core.telemetry as j_tel
import repro.kernels.persistent.kernel as j_pk
import repro.kernels.persistent.ops as j_pops
import repro.serving.engine as j_engine
import repro_torch
import repro_torch.core.mailbox as t_mb
import repro_torch.core.sched as t_sched
import repro_torch.core.telemetry as t_tel
import repro_torch.kernels.persistent.kernel as t_pk
import repro_torch.kernels.persistent.ops as t_pops
import repro_torch.serving.engine as t_engine

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    for m in ("serving.engine", "kernels.flash_attention.kernel",
              "kernels.persistent.kernel", "kernels.persistent.ops",
              "core.mega", "core.clusters", "core.elastic", "core.system",
              "system"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _upper_constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float, str, tuple))}


@pytest.mark.parametrize("ref,port", [
    (j_mb, t_mb), (j_sched, t_sched), (j_tel, t_tel), (j_engine, t_engine),
    (j_pk, t_pk), (j_pops, t_pops),
], ids=["mailbox", "sched", "telemetry", "engine", "persistent_kernel",
        "persistent_ops"])
def test_copied_constants_equal_reference(ref, port):
    want = _upper_constants(ref)
    got = _upper_constants(port)
    assert want, ref.__name__
    assert got == want
    if ref is j_pk:
        assert {"TILE", "OP_REDUCE", "NUM_DRAIN_OPS", "SCALE_SHIFT"} <= set(got)
    if ref is j_pops:
        assert got["TILE_OP_NAMES"] == want["TILE_OP_NAMES"]


def test_protocol_constants_spelled_out():
    for name in ("THREAD_INIT", "THREAD_FINISHED", "THREAD_WORKING",
                 "THREAD_PREEMPTED", "THREAD_NOP", "THREAD_EXIT",
                 "THREAD_WORK", "DESC_WIDTH", "QCTRL_WIDTH", "PROF_WIDTH",
                 "NO_DEADLINE", "W_STATUS", "W_NCHUNKS", "QC_DRAINED",
                 "P_ACTIVE"):
        assert getattr(t_mb, name) == getattr(j_mb, name), name
    assert (t_mb.WorkDescriptor(opcode=2, arg0=3, request_id=9,
                                deadline_us=2**40, n_chunks=4).encode()
            == j_mb.WorkDescriptor(opcode=2, arg0=3, request_id=9,
                                   deadline_us=2**40, n_chunks=4).encode()
            ).all()


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal path is not reachable")
    from repro_torch.configs import get_config
    from repro_torch.core.clusters import ClusterManager
    from repro_torch.core.mega import MegaRuntime, mega_work_classes
    from repro_torch.core.persistent import (PersistentRuntime,
                                             TraditionalRuntime)
    from repro_torch.kernels.persistent import tile_state
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.system import LkSystem
    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)                                   # the default is cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        PersistentRuntime([("nop", lambda s, d: (s, s))],
                          result_template=torch.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        MegaRuntime()
    with pytest.raises(RuntimeError, match="CUDA"):
        TraditionalRuntime([], result_template=torch.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterManager()
    with pytest.raises(RuntimeError, match="CUDA"):
        LkSystem(state_factory=lambda cl: tile_state(2),
                 result_template=torch.zeros(1),
                 work_classes=mega_work_classes(), runtime="mega")
    # a fleet given without a device still places its runtimes on CUDA
    sys_ = LkSystem(devices=["d0", "d1"], state_factory=lambda cl: tile_state(2),
                    result_template=torch.zeros(1),
                    work_classes=mega_work_classes(), runtime="mega")
    with pytest.raises(RuntimeError, match="CUDA"):
        sys_.boot()
