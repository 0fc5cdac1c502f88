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
import repro.serving.streams as j_streams
import repro_torch
import repro_torch.core.mailbox as t_mb
import repro_torch.core.sched as t_sched
import repro_torch.core.telemetry as t_tel
import repro_torch.kernels.persistent.kernel as t_pk
import repro_torch.kernels.persistent.ops as t_pops
import repro_torch.serving.engine as t_engine
import repro_torch.serving.streams as t_streams

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    for m in ("serving.engine", "serving.streams", "launch.trace",
              "launch.top", "core.telemetry.metrics",
              "configs.gemma2_2b", "configs.mistral_nemo_12b",
              "configs.qwen2_72b", "kernels.flash_attention.kernel",
              "kernels.persistent.kernel", "kernels.persistent.ops",
              "core.mega", "core.clusters", "core.elastic", "core.system",
              "system", "kernels.ssd_scan.kernel", "kernels.ssd_scan.ops",
              "models.ssm", "configs.mamba2_780m", "models.hybrid",
              "models.encdec", "configs.zamba2_7b", "configs.whisper_tiny",
              "models.moe", "configs.llama4_maverick_400b_a17b",
              "configs.grok1_314b", "configs.internvl2_76b",
              "optim.optimizer", "data.pipeline", "checkpoint.checkpoint",
              "training.train_loop", "distributed.fault_tolerance",
              "launch.train", "distributed.sharding", "launch.mesh",
              "launch.dryrun", "launch.roofline"):
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
            if k.isupper() and not k.startswith("_")
            and isinstance(v, (int, float, str, tuple))}


def test_training_modules_import_no_ml_dtypes():
    """The GPU host has no JAX, and nothing records ``ml_dtypes`` there:
    the training path (checkpoints' bf16 included) goes through torch."""
    mods = [m for m in _modules() if m.split(".")[1] in (
        "optim", "data", "checkpoint", "training", "launch", "models",
        "distributed")]
    assert "repro_torch.launch.train" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'ml_dtypes' or "
        "k.startswith('ml_dtypes.') or k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_optimizer_constants_equal_reference():
    import dataclasses
    import repro.optim.optimizer as j_opt
    import repro_torch.optim.optimizer as t_opt
    assert (t_opt.QBLOCK, t_opt.QALIGN) == (j_opt.QBLOCK, j_opt.QALIGN)
    assert dataclasses.asdict(t_opt.AdamWConfig()) == \
        dataclasses.asdict(j_opt.AdamWConfig())
    assert [f.name for f in dataclasses.fields(t_opt.AdamWConfig)] == \
        [f.name for f in dataclasses.fields(j_opt.AdamWConfig)]


def test_train_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal path is not reachable")
    from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "mamba2-780m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLoader(SyntheticLM(11), DataConfig(2, 8))


@pytest.mark.parametrize("ref,port", [
    (j_mb, t_mb), (j_sched, t_sched), (j_tel, t_tel), (j_engine, t_engine),
    (j_pk, t_pk), (j_pops, t_pops), (j_streams, t_streams),
], ids=["mailbox", "sched", "telemetry", "engine", "persistent_kernel",
        "persistent_ops", "streams"])
def test_copied_constants_equal_reference(ref, port):
    want = _upper_constants(ref)
    got = _upper_constants(port)
    assert want, ref.__name__
    assert got == want
    if ref is j_pk:
        assert {"TILE", "OP_REDUCE", "NUM_DRAIN_OPS", "SCALE_SHIFT"} <= set(got)
    if ref is j_pops:
        assert got["TILE_OP_NAMES"] == want["TILE_OP_NAMES"]
    if ref is j_streams:
        assert {"STREAM_ID_BASE", "PROMISE_ID_BASE", "OP_STREAM_HIGH",
                "OP_STREAM_LOW", "ST_PENDING", "ST_CLOSED"} <= set(got)
        # the stream work classes: the same fields in the port's WorkClass
        assert [vars(w) for w in port._STREAM_CLASSES] == \
            [vars(w) for w in ref._STREAM_CLASSES]


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
    from repro_torch.launch import serve, trace
    from repro_torch.models import build
    from repro_torch.system import LkSystem
    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)                                   # the default is cuda

    class Mesh:                                     # a (2, 4) mesh's shape
        mesh_dim_names, shape = ("data", "model"), (2, 4)
    from repro_torch.distributed.sharding import ShardCtx
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg, ShardCtx.for_mesh(Mesh(), "decode"), device="cuda")
    for arch in ("mamba2-780m", "zamba2-7b", "whisper-tiny",
                 "llama4-maverick-400b-a17b", "grok-1-314b", "internvl2-76b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(get_config(arch).reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        PersistentRuntime([("nop", lambda s, d: (s, s))],
                          result_template=torch.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])
    for arch in ("mamba2-780m", "zamba2-7b", "whisper-tiny",
                 "llama4-maverick-400b-a17b", "grok-1-314b", "internvl2-76b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--streams"])        # --smoke keeps cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.main(["--smoke", "--out", os.devnull])
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


# The reference's __init__ files define no __all__ (repro.core.telemetry
# aside): their public names are the names they import; a plain module's
# are the functions and classes it defines. The port must offer each,
# except the TPU entry point and what the roadmap still queues.
NOT_PORTED = {"persistent_drain_pallas",      # the Pallas TPU launch
              # the reference's parameter factory class: the port's
              # models.layers.Init draws the same scales from a
              # torch.Generator, and Init.axes_mode() is its "axes" mode
              "Builder"}


@pytest.mark.parametrize("name", [
    "repro.core", "repro.core.telemetry", "repro.serving",
    "repro.kernels.decode_attention", "repro.kernels.flash_attention",
    "repro.kernels.persistent", "repro.kernels.ssd_scan",
    "repro.models.hybrid", "repro.models.encdec", "repro.models.layers",
    "repro.models.moe", "repro.optim", "repro.optim.optimizer", "repro.data",
    "repro.checkpoint", "repro.training", "repro.distributed.fault_tolerance",
    "repro.distributed", "repro.distributed.sharding", "repro.launch.mesh",
    "repro.launch.roofline",
])
def test_reference_public_names_importable_from_port(name):
    import importlib
    import types
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    if not hasattr(ref, "__path__"):
        public = [k for k, v in vars(ref).items() if not k.startswith("_")
                  and getattr(v, "__module__", None) == name]
    else:
        public = getattr(ref, "__all__", None) or [
            k for k, v in vars(ref).items()
            if not k.startswith("_") and k != "annotations"
            and not (isinstance(v, types.ModuleType)
                     and v.__name__.startswith(name + "."))]
    assert public, name
    missing = sorted(set(public) - NOT_PORTED - set(vars(port)))
    assert not missing, missing
