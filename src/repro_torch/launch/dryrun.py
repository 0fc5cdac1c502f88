"""Dry run of the training and serving cells on the production meshes —
the port of ``repro.launch.dryrun`` (``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``).

One process plays every rank: a ``fake`` process group of 512 ranks (its
collectives move nothing), a ``DeviceMesh`` of the reference's shape over
it ((16, 16) or (2, 16, 16)), and parameters, caches and inputs as DTensors
whose local blocks are fake tensors (``FakeTensorMode``): nothing is
allocated and no kernel runs. A ``train_4k`` cell traces the whole train
step: forward, autograd's backward and AdamW (fp32 or 8-bit, in place as
the reference donates its state) over ``cfg.train_accum_steps``
microbatches, on the parameters and optimizer state of ``abstract_state``
and the batch of ``input_specs`` (``frames`` / ``vision_embeds`` included,
so the encdec and vlm cells run). The step runs eagerly through the card's path:
K4/K5/K6 take their shape-only branches, which tally the operations and
bytes they would have done (``kernels.SHAPE_ONLY_TALLY``). The fake tensors
are CUDA tensors where this PyTorch is built with CUDA; a CPU-only build
cannot take views of fake CUDA tensors, so there they are fake CPU tensors
(``record["device"]``), and the same branches run.

Per device (rank 0's blocks; the specs divide evenly) the record holds:

* ``argument_bytes``: the local blocks of parameters, optimizer state
  (train), caches (decode) and inputs;
* ``peak_bytes_per_device``: ``MemTracker``'s peak over the step, the
  arguments included;
* ``flops``: ``torch.utils.flop_counter``'s count of every aten op on local
  blocks, plus each kernel's own operation count from its shape branch;
* ``bytes_accessed``: the port's own definition, not XLA's: the bytes of
  every input and output tensor of each aten op that is not a view (a
  lookup's source counted as the rows it returns; an in-place op: twice
  its other inputs, not the tensor it writes into), plus each kernel's
  inputs and outputs, each counted once a call;
* ``collectives``: count and result bytes of each functional collective
  (all-reduce, all-gather, reduce-scatter, all-to-all), as the reference's
  ``collective_bytes`` sums HLO result shapes.

Ops DTensor runs on global shapes to propagate shardings are left out of
every tally (``_PROPAGATING``). The reference calibrates its costs at
one and two layer periods because XLA's cost analysis counts a scan body
once; eager tracing runs every layer (and every microbatch), so the counts
here are whole and no calibration is done.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --mesh pod
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape prefill_32k decode_32k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch [--resume]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import shape_applicable

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
WORLD = 512                       # serves both production meshes
GATHERS = (torch.ops.aten.index.Tensor, torch.ops.aten.embedding.default,
           torch.ops.aten.index_select.default, torch.ops.aten.gather.default)


def kind_of(shape) -> str:
    if shape.kind == "train":
        return "train"
    if shape.kind == "prefill":
        return "prefill"
    return "long_decode" if shape.name == "long_500k" else "decode"


def fake_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _ensure_group() -> None:
    """The fake process group of WORLD ranks, made once a process."""
    if dist.is_initialized():
        if dist.get_world_size() < WORLD:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the dry run needs {WORLD}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


# ---------------------------------------------------------------------------
# Per-device tallies
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    import torch.utils._pytree as pytree
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


# > 0 while DTensor propagates a sharding: it runs the op on fake tensors
# of the GLOBAL shapes (in the active fake mode) to learn its output's
# shape; those runs are no rank's work and are left out of every tally
_PROPAGATING = [0]


def _propagation_apart():
    """Mark DTensor's shape-propagation runs (``_PROPAGATING``)."""
    import contextlib
    from unittest import mock
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if hasattr(ShardingPropagator, n)]
    if not names:
        # without the mark every propagation run of a global shape would be
        # tallied as this rank's work (peaks many times the arguments)
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"_propagate_tensor_meta(_non_cached); the dry run cannot tell "
            f"DTensor's shape propagation from a rank's work")
    stack = contextlib.ExitStack()
    for name in names:

        def marked(self, *args, _orig=getattr(ShardingPropagator, name),
                   **kwargs):
            _PROPAGATING[0] += 1
            try:
                return _orig(self, *args, **kwargs)
            finally:
                _PROPAGATING[0] -= 1
        stack.enter_context(mock.patch.object(ShardingPropagator, name,
                                              marked))
    return stack


def _device_tally_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class DeviceTally(TorchDispatchMode):
        """Operations, bytes and collectives of the ops one rank runs on
        its local blocks (DTensor-level calls are left to DTensor, whose
        local ops come back here)."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.coll_bytes = {k: 0 for k in COLLECTIVES.values()}
            self.coll_counts = {k: 0 for k in COLLECTIVES.values()}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if _PROPAGATING[0]:
                return out
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            packet = func._overloadpacket
            name = packet.__name__
            if func.namespace in ("_c10d_functional", "c10d_functional") \
                    and name in COLLECTIVES:
                kind = COLLECTIVES[name]
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(
                    t.numel() * t.element_size() for t in outs)
                return out
            if func.namespace != "aten" or not ins or func.is_view:
                return out
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            # an in-place op (a cache write) moves what it reads and writes
            # in, not the whole tensor it writes into
            written = {id(a) for a, s in zip(args, func._schema.arguments)
                       if s.alias_info is not None and s.alias_info.is_write}
            moved = [t for t in (*ins, *outs) if id(t) not in written]
            nbytes = sum(t.numel() * t.element_size() for t in moved)
            if func in GATHERS:
                # a lookup reads the rows it returns, not its whole source
                nbytes += sum(t.numel() * t.element_size() for t in outs) \
                    - args[0].numel() * args[0].element_size()
            self.bytes += (2 if written else 1) * nbytes
            return out
    return DeviceTally()


def _mem_tracker():
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class LocalMemTracker(MemTracker):
        """MemTracker of the local blocks only: DTensor-level calls are
        left to DTensor (whose local ops come back here), and DTensor's
        propagation tensors are not tracked."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if _PROPAGATING[0]:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return LocalMemTracker()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None):
    """Returns (mesh, fake mode, step function, its arguments as fake
    DTensors); the step is run inside the fake mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.sharding import ShardCtx, attach_shardings
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build
    from repro_torch.training.train_loop import (abstract_state,
                                                 make_train_step,
                                                 opt_config_for)
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    kind = kind_of(shape)
    _ensure_group()
    dev = fake_device()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev)
    expert_on_model = (cfg.moe is not None
                       and cfg.moe.num_experts % mesh.size(
                           mesh.mesh_dim_names.index("model")) == 0)
    ctx = ShardCtx.for_mesh(mesh, kind, expert_on_model)
    mode = FakeTensorMode()
    with mode:
        model = build(cfg, ctx, device=dev)
        ocfg = opt_config_for(cfg)
        params, opt = abstract_state(model, ocfg, ctx)
        batch, batch_ax = model.input_specs(shape, device=dev)
        batch = attach_shardings(batch, ctx.tree_shardings(batch_ax, batch))
        if kind == "train":
            # the reference jits this step with its state donated
            fn = make_train_step(model, ocfg,
                                 accum_steps=cfg.train_accum_steps,
                                 donate=True)
            args = (params, opt, batch)
        elif kind == "prefill":
            def fn(p, b):
                return model.prefill(p, b, max_seq=shape.seq_len)
            args = (params, batch)
        else:   # decode / long_decode: one token against a seq_len cache
            B, S = shape.global_batch, shape.seq_len
            if cfg.family == "vlm":
                S = S + cfg.vision_tokens
            caches = model.init_caches(B, S)
            caches = attach_shardings(
                caches, ctx.tree_shardings(model.cache_axes(), caches))
            fn = model.decode_step
            args = (params, caches, batch["tokens"], batch["positions"])
    return mesh, mode, fn, args


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_override=None) -> dict:
    """One cell's record; ``cfg_override`` traces another config (a cut
    depth or width) under the arch's name."""
    from repro_torch import kernels
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": 512 if multi_pod else 256, "device": fake_device()}
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    try:
        t0 = time.time()
        mesh, mode, fn, args = build_cell(arch, shape_name, multi_pod,
                                          cfg_override)
        t_build = time.time() - t0
        leaves = [_local(t) for t in _tensors(args)]
        arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
        kernels.SHAPE_ONLY_TALLY.clear()
        t0 = time.time()
        with mode, _propagation_apart():
            tally = _device_tally_mode()
            mt = _mem_tracker()
            mt.track_external(*leaves)
            with mt, tally:
                fn(*args)
            snap = mt.get_tracker_snapshot("peak")
        t_run = time.time() - t0
        peak = max(int(v["Total"]) for v in snap.values())
        kern = {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                for k, v in sorted(kernels.SHAPE_ONLY_TALLY.items())}
        rec["memory"] = {"argument_bytes": int(arg_bytes),
                         "peak_bytes_per_device": peak}
        rec["cost"] = {
            "flops": tally.flops + sum(v["flops"] for v in kern.values()),
            "bytes_accessed": tally.bytes + sum(v["bytes"]
                                                for v in kern.values()),
            "kernels": kern,
            "note": ("per device; bytes_accessed is the port's count: "
                     "inputs and outputs of every non-view aten op and "
                     "kernel call")}
        rec["collectives"] = {
            "total_bytes": float(sum(tally.coll_bytes.values())),
            "bytes": tally.coll_bytes, "counts": tally.coll_counts}
        rec["model_params"] = cfg.param_count()
        rec["active_params"] = cfg.active_param_count()
        rec["timing"] = {"build_s": round(t_build, 2),
                         "trace_s": round(t_run, 2)}
        rec["status"] = "OK"
    except Exception as e:  # noqa: BLE001 — record, don't die mid-sweep
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _line(tag: str, rec: dict) -> str:
    msg = rec["status"]
    if rec["status"] == "OK":
        gib = 2 ** 30
        coll = ", ".join(f"{k} {v}x {rec['collectives']['bytes'][k]:.4g}B"
                         for k, v in rec["collectives"]["counts"].items()
                         if v)
        msg += (f" peak={rec['memory']['peak_bytes_per_device'] / gib:.3f}"
                f"GiB/dev args={rec['memory']['argument_bytes'] / gib:.3f}"
                f"GiB/dev flops/dev={rec['cost']['flops']:.4e}"
                f" bytes/dev={rec['cost']['bytes_accessed']:.4e}"
                f" coll/dev=[{coll or 'none'}]"
                f" build={rec['timing']['build_s']}s"
                f" trace={rec['timing']['trace_s']}s")
    elif rec["status"] == "FAIL":
        msg += " " + rec["error"][:300]
    else:
        msg += " " + rec["reason"][:80]
    return f"[dryrun] {tag}: {msg}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", nargs="+", default=None,
                    help="one or more of " + ", ".join(SHAPE_NAMES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPE_NAMES) if (args.all or args.shape is None)
              else args.shape)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                if args.resume and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("OK", "SKIP"):
                            print(f"[resume] {tag}")
                            continue
                rec = run_cell(arch, shape, mp)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                failed += rec["status"] == "FAIL"
                print(_line(tag, rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
