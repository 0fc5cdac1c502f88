"""Training entrypoint of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 10 --batch 8 --seq 256          # full width, on the GPU
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch llama3-8b --reduced --device cpu --steps 4   # a (2, 4) mesh

Features on display, as in the reference (``repro.launch.train``):
deterministic data pipeline, AdamW(+8bit), async checkpointing with
resume, WCET phase accounting, straggler detection. The flags are the
reference's plus ``--device`` (default ``cuda``, which raises where CUDA
is absent; nothing falls back to the CPU). Each logged step's line also
gives its host time (``step_ms``: the step's launch until its metrics are
on the host). ``main`` returns the last step's metrics as floats, equal on
every rank; ``main(argv, cfg=...)`` trains a config a caller made (a cut
depth) in place of ``--arch``'s.

On a mesh, as the reference trains on ``make_host_mesh()`` when it sees
more than one device: started under ``torchrun`` (more than one rank),
``main`` starts the process group itself (gloo on the CPU, NCCL on the
card, one process a card) and trains on ``make_host_mesh()`` with
``ShardCtx.for_mesh(mesh, "train")``; ``main(argv, mesh=...)`` trains on a
mesh the caller made over a group it started (a (1, 1) mesh on one card).
The parameters and optimizer state are placed by ``state_shardings``, the
loader hands out DTensor batches on the ``act_batch`` spec, and the
checkpoints gather and restore by placement. Only rank 0 prints.

The loader gives tokens only, so the encdec and vlm families, whose loss
also reads ``frames`` / ``vision_embeds``, are refused with a
``ValueError`` before the first step (the reference fails there with a
``KeyError``).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.persistent import check_device
from repro_torch.core.wcet import WcetTracker
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
from repro_torch.distributed import ShardCtx
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.distributed.sharding import axes, logical_to_spec
from repro_torch.models import build
from repro_torch.optim.optimizer import cosine_schedule
from repro_torch.training import (init_state, make_train_step,
                                  opt_config_for, place_state)

# batch keys a family's loss reads besides "tokens"
EXTRA_BATCH_KEYS = {"encdec": "frames", "vlm": "vision_embeds"}


def _launched_mesh(device: str):
    """Under a launcher that gives this process a rank among several
    (``torchrun``'s WORLD_SIZE > 1): the process group started (gloo on the
    CPU, NCCL on this rank's card) and ``make_host_mesh`` over it; else
    None."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and \
            not (dist.is_initialized() and dist.get_world_size() > 1):
        return None
    if not dist.is_initialized():
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local)
            dist.init_process_group("nccl",
                                    device_id=torch.device("cuda", local))
        else:
            dist.init_process_group("gloo")
    return make_host_mesh(device_type=device)


def main(argv=None, *, cfg=None, mesh=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (cuda raises when CUDA is "
                         "absent; nothing falls back to the CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.family in EXTRA_BATCH_KEYS:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} loss reads "
            f"batch[{EXTRA_BATCH_KEYS[cfg.family]!r}], which the tokens-only "
            f"loader does not give")
    device = check_device(args.device)
    if mesh is None:
        mesh = _launched_mesh(device.type)
    ctx = ShardCtx.for_mesh(mesh, "train") if mesh else ShardCtx.single()
    lead = mesh is None or mesh.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    model = build(cfg, ctx, device=device)
    ocfg = opt_config_for(
        cfg, lr=cosine_schedule(args.lr, args.steps // 10, args.steps))

    tracker = WcetTracker("train")
    straggler = StragglerDetector()
    with tracker.phase("init"):
        params, opt_state = init_state(model, ocfg, args.seed)
        batch_spec = None
        if mesh is not None:
            params, opt_state = place_state(model, ocfg, ctx, params,
                                            opt_state)
            batch_spec = logical_to_spec(axes("act_batch", None), ctx.rules,
                                         mesh, (args.batch, args.seq))
        step_fn = make_train_step(model, ocfg, args.accum, donate=True)
        loader = ShardedLoader(
            SyntheticLM(cfg.vocab_size, seed=args.seed),
            DataConfig(global_batch=args.batch, seq_len=args.seq),
            mesh=mesh, batch_spec=batch_spec, device=device)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        tpl = {"params": params, "opt": opt_state}
        restored = ckpt.restore(start, tpl)     # DTensors: their placements
        params, opt_state = restored["params"], restored["opt"]
        say(f"[train] resumed from step {start}")

    metrics = {}
    for step in range(start, args.steps):
        batch = loader.device_batch(step)
        t0 = time.perf_counter()
        with tracker.phase("trigger"):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        with tracker.phase("wait"):
            metrics = {k: float(v) for k, v in metrics.items()}
        step_ms = (time.perf_counter() - t0) * 1e3
        slow = straggler.observe(0, tracker.stats["wait"].best_ns)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step={step} loss={metrics['loss']:.4f} "
                  f"ce={metrics['ce']:.4f} gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} step_ms={step_ms:.1f}"
                  f"{' STRAGGLER' if slow else ''}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, {"params": params, "opt": opt_state},
                            {"arch": cfg.name})
    if ckpt:
        ckpt.save_async(args.steps, {"params": params, "opt": opt_state},
                        {"arch": cfg.name})
        ckpt.wait()
    with tracker.phase("dispose"):
        del params, opt_state
    say("[train] wcet:", {k: f"avg={v.avg_ns/1e6:.1f}ms "
                            f"worst={v.worst_ns/1e6:.1f}ms"
                            for k, v in tracker.stats.items()})
    return metrics


if __name__ == "__main__":
    main()
