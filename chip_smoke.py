#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints its own lines; any failure raises and exits nonzero):

1. device: torch/CUDA versions and the card's name and power limit;
2. build: compiles every hand-written kernel from ``src/repro_torch`` (one
   ``nvcc`` per source, all at once) and prints the seconds and the ptxas
   register report;
3. kernel checks: each kernel against its plain PyTorch version on the card
   (max abs error within the stated tolerance), with the kernel's, the plain
   version's and a library call's time, and the least time the card could
   take for the same work; K4's device kernels a call (one: the split
   partials and their merge are one launch) from a ``torch.profiler`` pass;
   The SSD chunk kernel (K6) likewise, at the serve shape (a 17-token
   chunk), at B=1 S=2048 (8 chunks of 256) and at B=4 S=256, printing the
   largest |want| beside the error, its bound on its route (3xTF32 on the
   tensor cores) with the FFMA bound beside it, and its device kernels a
   call (one). K4 and K5 also at gemma2-2b's shapes (D=256, GQA 8/4,
   softcap 50, window 4096): a 17-token prompt, the 4-slot decode, the
   4608-token prompt (windowed and global layers) and its decode step at
   one and at 4 slots, each
   K4 row with its split count, CTAs and clusters (the long cache's
   splits outnumber one cluster: merged through scratch). At
   a softcap row q is scaled so the scores reach the cap, and the row
   fails unless dropping the softcap moves the plain output by well over
   the tolerance; its library call, ``flex_attention`` with the softcap
   (checked against the plain version too; SDPA's time without the
   softcap beside it), is compiled and timed after phase 9, because the
   profiler drops device events once it has compiled;
4. serve: ``repro_torch.launch.serve.main`` on llama3-8b at full width
   (32 layers, d=4096, vocab 128256, bf16, random weights from the seed),
   4 requests x 8 new tokens, once with host prefill and once with chunked
   prefill; kernel launch counters are zeroed just before each run and read
   just after. Then one prefill + one decode step through the kernel path
   and through the plain-kernel path on the same weights: logits agree
   within a stated bf16 tolerance, and one 2048-token prompt (prefill +
   one decode step) through K5 and through the plain attention: last
   position's logits within the same tolerance, argmax agreement, both
   prefill wall times, K5's launches (one a layer) and its share of the
   prefill. Then the same two serve runs on
   mamba2-780m at full width (48 layers, d=1536, state 128, chunk 256,
   vocab 50280, tied, bf16): host prefill launches K6 once a layer a
   prompt, chunked prefill never; its decode step time at 4 slots; and one
   2048-token prompt (prefill + one decode step) through K6 and through
   its plain version: logits within a stated tolerance, argmax equal, and
   K6's share of that prefill;
4c. streams: ``serve --streams --elastic --metrics-file --trace`` on
   llama3-8b at full width, 8 streams (every 4th HIGH) over 4 slots, once
   with host prefill (under one ``torch.profiler`` pass) and once with
   chunked prefill: per-class TTFT and response p50/p99/worst with every
   sample beside them (a handful of streams a class), the stream
   and monitor counters, the registry's utilization (the share of wall
   time from a step's trigger to its readback: a host-window share) beside
   the profiler's device-busy share; fails unless closed == opened, zero
   bound violations, ``met == n``, K5 launched with host prefill only, K4
   on both, the metrics files written with device chunks, ``top --once``
   reads them, and each stream's tokens equal ``generate``'s on the same
   weights. Then ``launch.trace`` on the card passes its two checks;
4d. gemma2-2b at full width (26 layers, d=2304, D=256, vocab 256000) served
   with host and chunked prefill, its 17-token logits against the plain
   path (argmax equal), one 4608-token prompt past its 4096 window through
   K5 and the plain attention, and the kernel path's decode step at that
   4609-position cache timed (host and device-busy ms, K4's 26 launches a
   step; context only: the step is host-bound); beside each, controls
   (the plain path with the softcap removed, a window of 8, the window
   removed), of which the mask faults must move the logits by more than
   the tolerance;
   mistral-nemo-12b (40 layers, d=5120) served with host prefill and its
   logits against the plain path (its top-two margin printed);
4e. zamba2-7b at full width (81 mamba2 layers of 112 heads x 64, state
   64; one shared attention+MLP block, 32/32 heads x 112, applied 13
   times; vocab 32000, bf16) served with host prefill (K5 13 x 4 prompts,
   K6 81 x 4) and chunked prefill (neither), its 17-token logits against
   the plain path (tolerance 0.5, the largest |logits| beside it), its
   4-slot decode step's host time beside its device time
   (``torch.profiler``), one 2048-token prompt through K5 (13 launches)
   and K6 (81) against the plain path with the kernels' share of the
   prefill; whisper-tiny at full width (4+4 layers, d=384, 6/6 heads x 64,
   1500 stub frames a request from the seed) served with host prefill and
   with ``--chunked-prefill`` (requests with frames take the host prefill:
   K5 12 x 4 on both runs), its logits against the plain path. Their
   kernel rows (phase 3c, after phase 3b): K5 at D=112 (S=17 and 2048,
   causal), at whisper's encoder (S=1500, non-causal) and cross shapes (17
   queries against 1500 keys); K4 at D=112 (the 4-slot serve shape, 128
   clusters) and over whisper's 1500 frames (its decode cross-attention's
   route); K6 at 112 heads, N=64 (S=17 and 2048);
4f. the moe and vlm families at full width with their depth cut to what
   one card holds in bf16 (every width as published): llama4-maverick
   (2 of 48 layers: one dense and one 128-expert MoE layer), grok-1 (4 of
   64 layers, 8 experts top-2, softcaps 30) and internvl2-76b (24 of 80
   layers, 256 stub patch embeddings a request, 512-position cache), each
   served with host prefill (K5 layers x 4 prompts) and chunked prefill
   (K5 0 for moe; the vlm requests take the host prefill there too), peak
   memory printed; a MoE model's logits against the plain path with each
   MoE layer's top-k choices recorded on both paths through
   ``models.moe.route``: flipped choices counted, each a tie only where
   the plain path's router-logit gap at the top-k boundary is at most
   twice the largest router-logit difference between the paths, then the
   plain path replaying the kernel path's choices within the logits
   tolerance, argmax equal; internvl2-76b's logits with the 256 patch
   embeddings in the prompt against the plain path. Their kernel rows
   (phase 3d, after phase 3c): K5/K4 at 40/8 and 48/8 (softcap 30) heads
   x 128, K5 at 64/8 x 128 over 273 tokens, K4 over 262-290 of 512
   positions; K5/K4 at every reduced config's 4/2 heads x 32 in f32 and
   bf16; K6 at the reduced SSM shape (16 heads, P=16, N=16);
4g. ``serve --smoke`` with its default device for every registered arch
   (the reduced configs: f32, head dim 32): every request completes,
   ``met == n``, K5/K4 launched (K6 for ssm and hybrid), no plain
   attention or SSD called;
4h. training: first the training pair at every train-capable family's
   attention shapes (llama3-8b B=1 S=4096 / B=8 S=256 / B=1 S=2048,
   zamba2-7b D=112, gemma2-2b D=256 window 4096 softcap 50 S=4608, grok-1
   G=6 softcap 30, whisper-tiny's encoder and 17 x 1500 cross-attention,
   the reduced 4/2 x 32 f32): K5 with its lse and K5-bwd against their
   plain versions (2e-2 / 1e-4 x the largest |want|, lse 1e-4), K5-bwd's,
   its plain version's, K5-with-lse's and the library backward's times
   (SDPA's, or at a softcap row the compiled ``flex_attention``'s, timed
   after phase 9; each a CUDA-graph replay as the kernels are, its
   gradients held to the plain backward's) and the bound, with K5-bwd's
   share of its bound, its ratio to the library backward and the time of
   the FFMA kernels its bf16 path ran before (``FFMA_BWD_MS``); then ``repro_torch.launch.train.main`` runs, each launching K5
   (once an attention layer a microbatch, twice under remat) and K5-bwd
   (once) as its config implies, K4/K6 and K1-K3 0 times, the plain SSD
   above 0 where the model has one and no plain attention: 8 steps of every
   arch the tokens-only loader feeds (dense x4, ssm, hybrid, moe x2) at
   ``--reduced``, finite losses and grad norms, the last loss below the
   first (the two 8-bit moe configs again with fp32 AdamW for that check:
   the reference's 8-bit AdamW diverges there too); reduced llama3-8b with
   a checkpoint every 2 steps, a resume from ``step_2`` alone (restored
   tensors' sha256 equal to the manifest's on the card, step 3's loss
   within 1e-5 of the uninterrupted run); grok-1 reduced (adamw8bit) with
   ``moe_lb > 0`` and ``loss >= ce``; llama3-8b at full width with 8 of
   32 layers and mamba2-780m whole, 10 steps each (bf16; finite losses,
   the mean of the last three below the first), each step's host time,
   tokens per second, weights and peak memory, one profiled step's
   device-busy share, the optimizer's share of a step, and the matmul and
   optimizer-byte floors by arithmetic; one reduced llama3-8b train step
   x3 on the card and on the CPU from the same parameters and batches
   (f32, TF32 off): loss within 1e-5 relative, parameters within 1e-4;
   then llama3-8b 8 of 32 layers at B=1 S=4096, 5 steps on the kernel path
   and on the full-score path (``attn_backend="masked"``) in turns: step
   times, device-busy shares, step peaks and forward + backward peaks (the
   kernel path's must be lower), losses finite and falling, step 0's
   within 1e-3, and one forward + backward's gradients at the seed-0
   parameters within 5e-2 of each other (relative norm, each tensor);
4i. the mesh: K4's shard mode (``decode_attention_partial``) on 2, 4 and 16
   sequence shards of llama3-8b's B=4 S=4096 cache (valid lengths 3, 1000,
   2049, 4096: empty shards) and of gemma2-2b's B=1 S=4609 D=256 cache
   (window 4096 across shards, softcap 50), and at D=112 and D=32: each
   shard's (o, lse) against the plain partial, their merge on the card
   against the unsharded K4 and the plain version (bf16 2e-2, f32 1e-4),
   each shard call's device time, the merge's, and the plain partial's,
   SDPA's over the shard's live keys and the bound at the longest live
   shard, with that shard's split count, CTAs and clusters; llama3-8b at
   full width (32 layers) on a (1, 1) ('data', 'model') DeviceMesh over a
   one-rank NCCL group: a 2048-token prefill of 4 prompts (K5 32
   launches, each on the rank's query heads) and 8 decode
   steps at 4 slots over a 4096-position cache (K4's shard mode 32
   launches a step, the unsharded K4 none), tokens equal to the
   ShardCtx.single() path's and logits within 0.25 of the plain path's,
   each path's decode step time in this call and a profiled step's
   device-busy share; then the dry run on this host (llama3-8b's inference
   cells on the 16x16 mesh, mamba2-780m's long_500k on both meshes: fake
   tensors, a fake 512-rank group) and its roofline rows;
4j. training on a mesh, over a one-rank NCCL group on a (1, 1) ('data',
   'model') mesh: reduced llama3-8b (f32, TF32 off) for 3 steps through
   ``launch.train.main(..., mesh=)`` against the single path from the same
   parameters and batches (loss within 1e-5 relative, parameters within
   1e-4, elements whose clipped gradient is near AdamW's eps within 2 lr a
   step); a checkpoint saved on the mesh at step 2, restored with
   ``shardings=`` from the state's placements (sha256 equal to the
   manifest's), and a resume whose step-3 loss is within 1e-5 of the run
   without a break; llama3-8b at full width with 8 of 32 layers (bf16) for
   10 steps (finite losses, the mean of the last three below the first),
   its step time beside phase 4h's single path in this call, one profiled
   step's device-busy share and the peak memory; K5 and K5-bwd launched
   as each meshed train run's config implies (on the rank's heads), K4/K6
   0 times; ``LkSystem(state_shardings_factory=)``
   on two clusters, each a mesh over rank 0, against the same system
   without shardings (results equal, ``met == n``); then the dry run's
   train_4k for llama3-8b on the 16x16 mesh and its roofline row;
5. tile kernels: the drain megakernel (K1), its flight-recorder variant
   (K2) and the legacy executor (K3) against their plain versions at
   C = 132 clusters (one worker per SM), Q = 64 rows, nbuf = 8 tiles, on a
   matmul-only queue, a mixed queue (every opcode, a 3-chunk REDUCE, a
   [head, tail) window, a stopped cluster, out-of-range tile indices) and
   a chain of products (each row's dst the next row's operand, some rows
   D += A @ D); and K1/K2 at C = 1, the shape of every ``MegaRuntime``
   launch (a full matmul queue, the chain, a mixed queue with a window, a
   one-row launch): acks, control words, profile rows and ticks exact,
   workspaces, results and carries within 1e-4 (K1-K3 compute in
   3xTF32); kernel time (CUDA-graph replay), plain time, ``torch.bmm``
   over the same products, and the bounds: at the TF32 rate (three TF32
   products a tile product) with the f32 FFMA bound beside it, each also
   for one SM a cluster;
6. K3's own path: the tile-MLP demo program on 132 clusters, one launch,
   then K3 against its plain version at that shape;
7. mega vs scan: 512 tile ops with chunked reduces through
   ``LkSystem(runtime="mega")`` and ``runtime="scan"`` on one cluster;
   ticket results and final workspaces agree, no ack mismatches,
   ``work_drained`` equals the chunks submitted, and each runtime's wall
   time per item;
8. the full-width system: ``LkSystem(runtime="mega")`` with 132 clusters on
   the card and a ``TraceCollector`` (so K2 runs), 132 x 64 items with
   admitted deadlines of 3x the whole backlog's host time (measured by a
   warm-up round): every ticket resolves with ``met == n``, zero bound
   violations, device spans = drained rows = chunks submitted;
9. a preemption probe: a HIGH arrival's first trigger lands between the
   chunk retirements of an 8-chunk LOW item under ``MegaRuntime``;
10. the softcap rows' library call (``flex_attention``, phases 3 and 4h)
   timed;
   a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name/power-limit
   line, and last ``{"ok": true, "device": {...}}``.

Kernel launch counters are zeroed just before each path's run and read just
after; a kernel that its path never launched fails the run.

Imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import mailbox as mb  # noqa: E402
from repro_torch.core.dispatcher import Dispatcher  # noqa: E402
from repro_torch.core.mega import MegaRuntime, mega_work_classes  # noqa: E402
from repro_torch.core.persistent import (  # noqa: E402
    reap_deferred, tree_leaves, tree_map)
from repro_torch.core.sched import EdfPolicy  # noqa: E402
from repro_torch.core.telemetry import (EV_CHUNK_RETIRE,  # noqa: E402
                                        EV_TRIGGER, TraceCollector)
from repro_torch.core.telemetry.events import now_us  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import persistent as PK  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_partial,
    decode_attention_partial_plain, decode_attention_plain,
    merge_decode_partials)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kernel as DK)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_lse_plain, flash_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunk, ssd_chunk_plain)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import (  # noqa: E402
    _flatten_with_names, _sha256, _to_storable)
from repro_torch.launch import serve, top, trace  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim.optimizer import adamw_update  # noqa: E402
from repro_torch.training import (init_state, make_train_step,  # noqa: E402
                                  opt_config_for)
from repro_torch.training.train_loop import _value_and_grad  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import attention_layers, build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.system import LkSystem  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak operation rates by
# input type; the FFMA kernels' f32 inputs are held to the non-tensor rate,
# K1/K2's 3xTF32 products (three TF32 products each) to the TF32 rate
HBM_BYTES_PER_S = 3.35e12
N_SMS = 132
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # summation order
# K4 shard partials' lse: f32 on both sides from the same inputs in every
# dtype, so f32 summation order (one key lost at a shard boundary moves it
# by about 1 / live keys)
LSE_ATOL = 1e-4
# softcap rows: q times this, so the scaled scores (about N(0, 20^2)) reach
# the cap of 50; dropping the softcap must then move the plain output by
# more than SOFTCAP_WITNESS tolerances
SOFTCAP_Q_SCALE, SOFTCAP_WITNESS = 20.0, 10
# kernel vs plain attention, bf16 rounding through the layers: set from
# llama3-8b's 32 layers (0.17-0.19); gemma2-2b reads 0.07-0.09 and
# mistral-nemo-12b's 40 layers 0.18-0.23. gemma2-2b's controls (the plain
# path with a window of 8, or without its window past 4096 tokens) must
# differ by more, so the tolerance sees a mask fault of that size
LOGITS_ATOL = 0.25
SSD_TOL = 1e-4        # K6 vs plain, rtol and atol: f32 sums in another order
# kernel vs plain SSD through 48 bf16 layers: the f32 sums differ in the
# last bits, which flips an occasional bf16 rounding of y (one ulp, 2^-8
# relative) that the next layers carry on
SSM_LOGITS_ATOL = 0.25
LONG_PROMPT = 2048
GEMMA_LONG = 4608     # past gemma2-2b's 4096 local window
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0
TILE_TOL = 1e-4      # rtol and atol: f32 sums in another order
TILE_C, TILE_Q, TILE_NBUF = 132, 64, 8   # one worker per SM of the H100
DEVICE = torch.device("cuda")
SERVE_ARGS = ["--requests", "4", "--max-new", "8", "--max-batch", "4",
              "--max-seq", "128", "--seed", "0"]

KERNELS = {
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:23",
        wrapper=flash_attention),
    "flash_attention_bwd": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/models/attention.py:227",
        wrapper=flash_attention_bwd),
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:23",
        wrapper=decode_attention),
    "ssd_chunk": dict(
        route="cuda",
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:17",
        wrapper=ssd_chunk),
    "persistent_drain": dict(
        route="cuda",
        source="src/repro_torch/kernels/persistent/csrc/persistent.cu",
        replaces="src/repro/kernels/persistent/kernel.py:276",
        wrapper=PK.persistent_drain, plain=PK.drain_plain),
    "persistent_drain_prof": dict(
        route="cuda",
        source="src/repro_torch/kernels/persistent/csrc/persistent.cu",
        replaces="src/repro/kernels/persistent/kernel.py:289",
        wrapper=PK.persistent_drain_prof, plain=PK.drain_plain),
    "persistent_execute": dict(
        route="cuda",
        source="src/repro_torch/kernels/persistent/csrc/persistent.cu",
        replaces="src/repro/kernels/persistent/kernel.py:77",
        wrapper=PK.persistent_execute, plain=PK.execute_plain),
}
ATTENTION = ("flash_attention", "decode_attention")
TILE_KERNELS = ("persistent_drain", "persistent_drain_prof",
                "persistent_execute")


def zero_launches() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    decode_attention_partial.launches = 0


def read_launches() -> dict:
    """Each kernel's launches; K4's shard mode counted apart as
    ``decode_attention_partial``."""
    out = {n: s["wrapper"].launches for n, s in KERNELS.items()}
    out["decode_attention_partial"] = decode_attention_partial.launches
    return out


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's
    per-call launch cost (Python, allocation, ctypes) is not in the
    number. Warm-up calls on the side stream the graph captures come
    first, so libraries that plan or allocate on their first call (cuDNN,
    K4's arrival counters, kept a stream) do it outside capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def backward_ms(forward, inputs, dout, iters: int = 10,
                reps: int = 3) -> float:
    """Device time of one ``torch.autograd.grad(forward(), inputs, dout)``,
    timed as ``time_ms`` times a call: ``iters`` backward passes captured
    in a CUDA graph and replayed between CUDA events. The forward runs
    once, before the capture, on the stream the graph captures: autograd
    runs each backward op on its forward op's stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward()
        for _ in range(3):
            torch.autograd.grad(out, inputs, dout, retain_graph=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            torch.autograd.grad(out, inputs, dout, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph, out
    return ms


def host_ms(fn, iters: int = 20) -> float:
    """Wall time of one eager ``fn`` call, launch cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def kernels_per_call(fn, calls: int = 10, passes: int = 3):
    """(device kernels an eager ``fn`` call launches, their names), read
    from a ``torch.profiler`` pass over ``calls`` calls; (None, []) where
    the profiler records no device activity. Every ``fn`` here launches at
    least one kernel a call, so a pass that records fewer kernels than
    calls has lost activity records (seen on the card: 8 of 10): it is
    logged and the pass made again, up to ``passes`` passes; the last
    pass's count is returned either way."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for n in range(passes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if not kernels:
            return None, []
        if len(kernels) >= calls:
            break
        log(f"kernels_per_call: profiler pass {n + 1} recorded "
            f"{len(kernels)} device kernels for {calls} calls (lost "
            f"activity records)" + ("; passing again" if n + 1 < passes
                                    else ""))
    return len(kernels) / calls, sorted({e.name[:60] for e in kernels})


def bound(nbytes: float, ops, dtype=None) -> dict:
    """The least time for the work: the larger of its bytes over the HBM
    rate and its operations over the peak rate for its input type. ``ops``
    may be a {type: operations} dict for work on two units that run side
    by side (tensor cores and FMA pipes): the slower of the two counts."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = ops if isinstance(ops, dict) else {dtype: ops}
    t_ops = max(n / PEAK_OPS[t] * 1e3 for t, n in ops.items())
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops)


def k4_geometry(B, S, Hkv, D, dtype, window=0) -> dict:
    """K4's launch at a shape, as the wrapper picks it: splits a (sequence,
    kv head), CTAs, and clusters (one a (sequence, kv head), or one a
    CTA, merged through scratch: ``cluster_size``)."""
    bf16 = dtype == torch.bfloat16
    n = DK.split_count(B, S, Hkv, window, D, bf16)
    ctas = n * B * Hkv
    return dict(splits=n, ctas=ctas,
                clusters=ctas // DK.cluster_size(n, B, Hkv, D, bf16))


def _geometry_text(r) -> str:
    return (f"splits={r['splits']} ctas={r['ctas']} "
            f"clusters={r['clusters']}")


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _sdpa_gqa(q, k, v, **kw):
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def _compiled_flex():
    """``flex_attention`` compiled in this process (no compile workers),
    each row its own mask."""
    import torch._functorch.config
    from torch.nn.attention.flex_attention import flex_attention
    torch._inductor.config.compile_threads = 1
    torch._dynamo.config.recompile_limit = 64
    # the backward is timed with retain_graph, which donated buffers refuse
    torch._functorch.config.donated_buffer = False
    return torch.compile(flex_attention, dynamic=False)


def softcap_library_times(rows: list) -> None:
    """The library call at each softcap row (SDPA has no softcap):
    ``flex_attention`` with a ``softcap * tanh(s / softcap)`` score_mod,
    the row's mask as a block mask and GQA, compiled once a row in this
    process (no compile workers) and warmed before it is timed; held to
    the plain version at the row's tolerance (a row whose plain version
    is a shard partial (o, lse) asks flex_attention for its lse too and
    holds both, lse at the row's ``lse_tol``). Run after every
    ``torch.profiler`` pass of the smoke: once it has compiled, the
    profiler's passes drop device events. The port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask
    flex = _compiled_flex()
    for r in rows:
        if "flex" not in r:
            continue
        qt, kt, vt, softcap, mask_mod, B, Lq, Lkv, want = r.pop("flex")

        def score_mod(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)
        block_mask = create_block_mask(mask_mod, B, None, Lq, Lkv,
                                       device="cuda")

        with_lse = isinstance(want, tuple)

        def call():
            return flex(qt, kt, vt, score_mod=score_mod,
                        block_mask=block_mask, enable_gqa=True,
                        return_lse=with_lse)
        if with_lse:
            got, lse = call()
            lse_err = float((lse[:, :, 0].float() - want[1]).abs().max())
            r["library_lse_err"] = lse_err
            if not lse_err <= r["lse_tol"]:
                raise SystemExit(f"flex_attention's lse at {r['case']}: "
                                 f"{lse_err:.3e} > {r['lse_tol']:.0e}")
            want = want[0]
        else:
            got = call()
        got = got.transpose(1, 2)
        torch.cuda.synchronize()
        r["library_err"] = float((got.float() - want.float()).abs().max())
        r["library_ms"] = time_ms(call)
        log(f"library {r['kernel']:16s} {r['case']:34s} flex_attention with "
            f"the softcap: ms={r['library_ms']:.4f} max_abs_err="
            f"{r['library_err']:.3e} tol={r['tol']:.0e} (kernel_ms "
            f"{r['ms']:.4f}; sdpa without the softcap "
            f"{r['sdpa_without_softcap_ms']:.4f})")
        if "splits" in r:
            log(f"K4 {r['case']}: kernel_ms={r['ms']:.4f} flex_attention_ms="
                f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                f"plain_ms={r['plain_ms']:.4f} {_geometry_text(r)} "
                f"(kernel over flex {r['ms'] / r['library_ms']:.3f})")
    bad = [r["case"] for r in rows if r["library_err"] is not None and
           not r["library_err"] <= r["tol"]]
    if bad:
        raise SystemExit(f"flex_attention does not compute the softcap "
                         f"function at {bad}")


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def _softcap_q(q, softcap):
    """q scaled by SOFTCAP_Q_SCALE where a softcap is asked for, so that the
    scores reach the cap."""
    return (q.float() * SOFTCAP_Q_SCALE).to(q.dtype) if softcap else q


def softcap_witness(plain, args, kw, tol) -> float:
    """How far the plain version's output moves when the softcap is
    dropped: the row can fail a kernel that drops it only if this is well
    over the tolerance."""
    effect = float((plain(*args, **kw).float() - plain(
        *args, **dict(kw, attn_softcap=0.0)).float()).abs().max())
    if not effect > SOFTCAP_WITNESS * tol:
        raise SystemExit(f"softcap row: dropping the softcap moves the plain "
                         f"output by {effect:.3e}, not over "
                         f"{SOFTCAP_WITNESS} x {tol}")
    return effect


def _live_pairs(Sq: int, Skv: int, causal: bool, window: int,
                kv_len: int) -> float:
    """(query, key) pairs the masks leave live."""
    qpos = np.arange(Sq)
    hi = np.minimum(qpos if causal else np.full(Sq, Skv - 1), kv_len - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq, int)
    return float(np.maximum(hi - lo + 1, 0).sum())


def flash_case(name, B, S, dtype, gen, causal=True, window=0, softcap=0.0,
               Hq=32, Hkv=8, D=128, Skv=None) -> dict:
    """``Skv``: a key length other than the query length S (non-causal,
    no window: cross-attention)."""
    Skv = Skv or S
    q = _softcap_q(_randn((B, S, Hq, D), dtype, gen), softcap)
    k = _randn((B, Skv, Hkv, D), dtype, gen)
    v = _randn((B, Skv, Hkv, D), dtype, gen)
    kw = dict(causal=causal, window=window, attn_softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    effect = softcap_witness(flash_attention_plain, (q, k, v), kw,
                             ATOL[dtype]) if softcap else None
    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    eager_ms = host_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=5)
    # the library call: SDPA, or at a softcap shape (SDPA has none)
    # flex_attention with the softcap, SDPA without it beside it
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        qp = torch.arange(S, device="cuda")[:, None]
        kp = torch.arange(S, device="cuda")[None, :]
        mask = (kp <= qp) & (qp - kp < window)
    sdpa_kw = dict(attn_mask=mask) if mask is not None else \
        dict(is_causal=causal)
    sdpa_ms = time_ms(lambda: _sdpa_gqa(qt, kt, vt, **sdpa_kw))
    flex = {}
    if softcap:
        def mask_mod(b, h, q_idx, kv_idx):
            live = kv_idx <= q_idx if causal else kv_idx >= 0
            return live & (q_idx - kv_idx < window) if window else live
        flex["flex"] = (qt, kt, vt, softcap, mask_mod, None, S, S, want)
    # useful (q, k) pairs of this mask, each 4*D operations per head
    pairs = _live_pairs(S, Skv, causal, window, Skv)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    # at a softcap row library_ms and library_err are set at the end of
    # the run (softcap_library_times)
    return dict(kernel="flash_attention", case=name, max_abs_err=err,
                scale=float(want.float().abs().max()), tol=ATOL[dtype], ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=None if softcap else sdpa_ms, library_err=None,
                softcap_effect=effect,
                sdpa_without_softcap_ms=sdpa_ms if softcap else None,
                **flex, **bound(nbytes, 4.0 * D * Hq * B * pairs, dtype))


def decode_case(name, B, S, valid, dtype, gen, window=0, softcap=0.0,
                Hq=32, Hkv=8, D=128) -> dict:
    q = _softcap_q(_randn((B, 1, Hq, D), dtype, gen), softcap)
    k = _randn((B, S, Hkv, D), dtype, gen)
    v = _randn((B, S, Hkv, D), dtype, gen)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    kw = dict(attn_softcap=softcap, window=window)
    got = decode_attention(q, k, v, vl, **kw)
    want = decode_attention_plain(q, k, v, vl, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    effect = softcap_witness(decode_attention_plain, (q, k, v, vl), kw,
                             ATOL[dtype]) if softcap else None
    ms = time_ms(lambda: decode_attention(q, k, v, vl, **kw))
    eager_ms = host_ms(lambda: decode_attention(q, k, v, vl, **kw))
    plain_ms = time_ms(lambda: decode_attention_plain(q, k, v, vl, **kw),
                       iters=5)
    launches0 = decode_attention.launches
    per_call, names = kernels_per_call(
        lambda: decode_attention(q, k, v, vl, **kw))
    wrapper_per_call = (decode_attention.launches - launches0) / 11
    pos = torch.arange(S, device="cuda")[None, :]
    live = pos < vl[:, None]
    if window:
        live &= pos >= (vl[:, None] - window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = live[:, None, None, :]
    sdpa_ms = time_ms(lambda: _sdpa_gqa(qt, kt, vt, attn_mask=mask))
    flex = {}
    if softcap:
        def mask_mod(b, h, q_idx, kv_idx):
            live = kv_idx < vl[b]
            return live & (kv_idx >= vl[b] - window) if window else live
        flex["flex"] = (qt, kt, vt, softcap, mask_mod, B, 1, S, want)
    rows = float(live.sum())          # live cache rows this data needs
    nbytes = (2 * q.numel() + 2 * rows * Hkv * D) * q.element_size() + \
        vl.numel() * 4
    return dict(kernel="decode_attention", case=name, max_abs_err=err,
                scale=float(want.float().abs().max()), tol=ATOL[dtype], ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                **k4_geometry(B, S, Hkv, D, dtype, window),
                library_ms=None if softcap else sdpa_ms, library_err=None,
                softcap_effect=effect,
                sdpa_without_softcap_ms=sdpa_ms if softcap else None,
                device_kernels_per_call=per_call,
                device_kernel_names=names,
                wrapper_launches_per_call=wrapper_per_call, **flex,
                **bound(nbytes, 4.0 * D * Hq * rows, dtype))


def kernel_checks() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [
        flash_case("B1_S17_causal_bf16", 1, 17, bf16, gen),
        flash_case("B1_S128_causal_bf16", 1, 128, bf16, gen),
        flash_case("B1_S2048_causal_bf16", 1, 2048, bf16, gen),
        flash_case("B1_S512_window128_softcap50_bf16", 1, 512, bf16, gen,
                   window=128, softcap=50.0),
        flash_case("B1_S128_causal_f32", 1, 128, f32, gen),
        decode_case("B4_S128_ragged_bf16", 4, 128, [128, 1, 77, 64], bf16,
                    gen),
        decode_case("B4_S4096_ragged_bf16", 4, 4096, [4096, 3000, 1025, 17],
                    bf16, gen),
        decode_case("B4_S4096_window1024_bf16", 4, 4096,
                    [4096, 2048, 1000, 300], bf16, gen, window=1024),
    ]
    # gemma2-2b's shapes: D=256, GQA 8/4, attention softcap 50, its local
    # layers' 4096 window (a global layer has none): a 17-token prompt,
    # the 4-slot decode over the 128-position cache, the long prompt past
    # the window and its decode step
    gemma = dict(Hq=8, Hkv=4, D=256, softcap=GEMMA_SOFTCAP)
    rows += [
        flash_case("gemma_B1_S17_window4096_softcap50_D256_bf16", 1, 17,
                   bf16, gen, window=GEMMA_WINDOW, **gemma),
        decode_case("gemma_B4_S128_ragged_softcap50_D256_bf16", 4, 128,
                    [128, 1, 77, 64], bf16, gen, window=GEMMA_WINDOW,
                    **gemma),
        flash_case(f"gemma_B1_S{GEMMA_LONG}_window4096_softcap50_D256_bf16",
                   1, GEMMA_LONG, bf16, gen, window=GEMMA_WINDOW, **gemma),
        flash_case(f"gemma_B1_S{GEMMA_LONG}_causal_softcap50_D256_bf16", 1,
                   GEMMA_LONG, bf16, gen, **gemma),
        decode_case(f"gemma_B1_S{GEMMA_LONG + 1}_window4096_softcap50_D256_"
                    f"bf16", 1, GEMMA_LONG + 1, [GEMMA_LONG + 1], bf16, gen,
                    window=GEMMA_WINDOW, **gemma),
        decode_case(f"gemma_B4_S{GEMMA_LONG + 1}_window4096_softcap50_D256_"
                    f"bf16", 4, GEMMA_LONG + 1, [GEMMA_LONG + 1] * 4, bf16,
                    gen, window=GEMMA_WINDOW, **gemma),
    ]
    check_attention_rows(rows)
    # the main path's shapes: a 17-token prompt (serve draws 4..23) and a
    # 4-slot decode over the 128-position cache
    return {"flash_attention": rows[0], "decode_attention": rows[5],
            "s2048": rows[2], "cases": rows,
            "gemma": rows[8:]}


def check_attention_rows(rows: list) -> None:
    """Log each K4/K5 row; fail on an error past its tolerance or a K4
    call that is not one device kernel."""
    for r in rows:
        if r["softcap_effect"] is None:
            lib = f"sdpa_ms={r['library_ms']:.4f}"
        else:
            lib = (f"flex_attention_ms=at the end (sdpa without the softcap "
                   f"{r['sdpa_without_softcap_ms']:.4f}) q x{SOFTCAP_Q_SCALE:g}"
                   f", dropping the softcap moves the plain output by "
                   f"{r['softcap_effect']:.3e}")
        log(f"check {r['kernel']:16s} {r['case']:34s} "
            f"max_abs_err={r['max_abs_err']:.3e} max|want|={r['scale']:.3g} "
            f"tol={r['tol']:.0e} "
            f"kernel_ms={r['ms']:.4f} eager_call_ms={r['eager_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} "
            f"{lib} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}; "
            f"bytes {r['bytes_ms']:.5f}, ops {r['ops_ms']:.5f})")
        if r["kernel"] == "decode_attention":
            log(f"geometry decode_attention {r['case']}: "
                f"{_geometry_text(r)}")
            log(f"kernels_per_call decode_attention {r['case']}: "
                f"{r['device_kernels_per_call']} device kernels a call "
                f"(torch.profiler) {r['device_kernel_names']}, "
                f"{r['wrapper_launches_per_call']:.0f} wrapper launch a call")
    bad = [r for r in rows if not r["max_abs_err"] <= r["tol"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    many = [r for r in rows if r["kernel"] == "decode_attention" and
            r["device_kernels_per_call"] not in (None, 1.0)]
    if many:
        raise SystemExit(f"decode_attention is not one launch a call: {many}")


# ---------------------------------------------------------------------------
# phase 4: serve + logits check
# ---------------------------------------------------------------------------

def serve_run(arch: str, label: str, extra: list, cfg=None) -> dict:
    """``serve.main`` on ``arch`` with SERVE_ARGS + ``extra`` (4 requests x
    8 new tokens, 4 slots, EDF), or on ``cfg`` (a cut depth) in its place;
    launch counters zeroed just before and read just after."""
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(["--arch", arch] + SERVE_ARGS + extra, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ds = report.deadline_stats
    outs = report.outputs
    log(f"serve[{arch} {label}] wall={wall:.1f}s peak_mem={peak:.2f}GiB "
        f"launches={launches} n={ds['n']} met={ds['met']} "
        f"tokens={sum(len(o) for o in outs)}")
    if len(outs) != 4 or any(len(o) != 8 for o in outs):
        raise SystemExit(f"serve[{label}]: not every request completed: {outs}")
    if ds["met"] != ds["n"]:
        raise SystemExit(f"serve[{label}]: met={ds['met']} != n={ds['n']}")
    del report
    reap_deferred()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def top2_margin(logits) -> list:
    """The gap between the two largest logits of each row."""
    top = torch.topk(logits.float().reshape(-1, logits.shape[-1]), 2).values
    return [float(t[0] - t[1]) for t in top]


def controls_check(arch: str, out: dict, witness: str | None) -> dict:
    """Each control's largest logits difference from the plain path, the
    control being the plain path with its attention changed (``out``
    holds each run's logits). The ``witness`` control must differ by more
    than LOGITS_ATOL: the tolerance then fails an attention fault of that
    size."""
    ctrl = {name: max(float((a - b).abs().max())
                      for a, b in zip(logits, out["plain"]))
            for name, logits in out.items() if name not in ("kernel", "plain")}
    if ctrl:
        log(f"logits[{arch}] controls, plain path with its attention changed, "
            f"max_abs_err from the plain path: "
            f"{ {k: round(v, 4) for k, v in ctrl.items()} } (tol "
            f"{LOGITS_ATOL})")
    if witness is not None and not ctrl[witness] > LOGITS_ATOL:
        raise SystemExit(f"{arch}: the {witness} control moves the logits by "
                         f"{ctrl[witness]:.3e}, within the tolerance")
    return ctrl


def logits_batch(cfg) -> tuple[dict, int]:
    """A 17-token prompt from seed 0 (an encdec arch's with its stub
    frames, a vlm arch's with its stub patch embeddings) and the position
    its first decode step writes (17, or 17 + vision_tokens)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 17)).astype(np.int32)).cuda()}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            1, cfg.encoder_frames, cfg.d_model)).astype(np.float32)).cuda()
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.normal(size=(
            1, cfg.vision_tokens, cfg.d_model)).astype(np.float32)).cuda()
    return batch, 17 + (cfg.vision_tokens if cfg.family == "vlm" else 0)


def two_steps(m, params, batch, pos: int, nxt=None, max_seq: int = 128):
    """(prefill logits, decode logits, the next token fed): one prefill of
    ``batch`` and one decode step at ``pos`` of ``nxt`` (the prefill's
    argmax when None)."""
    logits0, caches = m.prefill(params, batch, max_seq)
    if nxt is None:
        nxt = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)[:, None]
    logits1, _ = m.decode_step(params, caches, nxt, torch.tensor(
        [pos], dtype=torch.int32, device="cuda"))
    del caches
    return logits0.float(), logits1.float(), nxt


def logits_check(arch: str = "llama3-8b", need_argmax: bool = False,
                 controls: dict | None = None,
                 witness: str | None = None, tol: float = LOGITS_ATOL,
                 params=None, cfg=None, max_seq: int = 128) -> dict:
    """One 17-token prefill and one decode step of ``arch`` at full width
    (or of ``cfg``, a cut depth) through the kernel path and the plain path
    on the same weights (seed 0's, or ``params``); both paths decode the
    kernel path's next token; the prompt carries an encdec arch's stub
    frames or a vlm arch's patch embeddings (``logits_batch``). Logits
    within ``tol``; with ``need_argmax`` both steps' argmax equal too (the
    plain path's top-two margins are printed beside it). Each of
    ``controls`` ({name: config fields}) runs the plain path with those
    fields replaced; see ``controls_check``."""
    cfg = cfg or get_config(arch)
    model = build(cfg, device="cuda")
    plain = build(cfg, device="cuda", plain_kernels=True)
    params = model.init(0) if params is None else params
    batch, pos = logits_batch(cfg)
    runs = [("kernel", model), ("plain", plain)] + [
        (name, build(dataclasses.replace(cfg, **kw), device="cuda",
                     plain_kernels=True))
        for name, kw in (controls or {}).items()]
    out, nxt = {}, None
    for name, m in runs:
        logits0, logits1, nxt = two_steps(m, params, batch, pos, nxt,
                                          max_seq)
        out[name] = (logits0, logits1)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max())
            for a, b in zip(out["kernel"], out["plain"])]
    scale = float(out["plain"][0].abs().max())
    same = [bool((a.argmax(-1) == b.argmax(-1)).all())
            for a, b in zip(out["kernel"], out["plain"])]
    margins = [top2_margin(b)[0] for b in out["plain"]]
    log(f"logits[{arch}] kernel vs plain attention: prefill max_abs_err="
        f"{errs[0]:.3e} decode max_abs_err={errs[1]:.3e} (|logits| max "
        f"{scale:.2f}, tol {tol}) argmax_equal={same} plain top-two "
        f"margins={[round(m, 4) for m in margins]}")
    if max(errs) > tol or not all(math.isfinite(e) for e in errs):
        raise SystemExit(f"{arch}: kernel-path logits disagree with the "
                         f"plain path")
    if need_argmax and not all(same):
        raise SystemExit(f"{arch}: kernel-path argmax differs from the plain "
                         f"path's (top-two margins {margins})")
    ctrl = controls_check(arch, out, witness)
    del params, out, model, plain, runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(errs=errs, same=same, margins=margins, controls=ctrl,
                scale=scale)


# ---------------------------------------------------------------------------
# phase 3b: the SSD chunk kernel (K6) vs plain
# ---------------------------------------------------------------------------

def ssd_chunk_args(B, C, L, H, P, N, rng):
    """K6's operands made as tests/test_kernels_ssd.py makes them (dt in
    [1e-3, 0.1], A in [-2, -0.5]), cum formed as ``ssd`` forms it."""
    S = C * L
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    x, dt, A, Bm, Cm = (t.to(DEVICE) for t in (x, dt, A, Bm, Cm))
    cum = torch.cumsum((dt * A).reshape(B, C, L, H), dim=2)
    return (x.reshape(B, C, L, H, P), dt.reshape(B, C, L, H), cum,
            Bm.reshape(B, C, L, N), Cm.reshape(B, C, L, N))


def ssd_work(B, C, L, H, P, N) -> tuple[float, float, float]:
    """(bytes, product operations, other f32 operations): each input read
    and each output written once; the products are the causal lower
    triangle of the intra-chunk product and G = C B^T once per (b, c), plus
    the chunk-end states' (P x L)(L x N) per head; the rest is what the
    kernel does outside them: W = G exp(cum_i - cum_j) dt_j per live (i, j,
    h) (a subtraction, a scaling, the exponential, two products), the
    states' B * w per (l, n, h) and w per (l, h), and one add of each
    32-deep k-block's fresh sum per output element."""
    nbytes = 4.0 * (2 * B * C * L * H * P + 2 * B * C * L * H
                    + 2 * B * C * L * N + B * C * H * P * N)
    ops = 2.0 * B * C * (L * (L + 1) / 2 * (N + H * P) + H * L * P * N)
    kblocks = -(-L // 32)
    f32_ops = B * C * (5.0 * L * (L + 1) / 2 * H + L * N * H + 4.0 * L * H
                       + (L * H * P + H * P * N) * kblocks)
    return nbytes, ops, f32_ops


def ssd_bound(B, C, L, H, P, N) -> dict:
    """K6's bound on its route — each product as three TF32 products
    (3xTF32) at the tensor cores' rate, the rest at the f32 rate — with
    the f32 FFMA bound (products and rest at the f32 rate) beside it."""
    nbytes, ops, f32_ops = ssd_work(B, C, L, H, P, N)
    ffma = bound(nbytes, ops + f32_ops, torch.float32)
    route = bound(nbytes, {"tf32": 3 * ops, torch.float32: f32_ops})
    return dict(route, ffma_bound_ms=ffma["bound_ms"])


def ssd_case(name, B, C, L, H, P, N, rng) -> dict:
    args = ssd_chunk_args(B, C, L, H, P, N, rng)
    got = ssd_chunk(*args)
    want = ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    ok = all(bool(torch.allclose(g, w, rtol=SSD_TOL, atol=SSD_TOL))
             for g, w in zip(got, want))
    ms = time_ms(lambda: ssd_chunk(*args))
    eager_ms = host_ms(lambda: ssd_chunk(*args))
    plain_ms = time_ms(lambda: ssd_chunk_plain(*args), iters=3)
    per_call, names = kernels_per_call(lambda: ssd_chunk(*args))
    return dict(kernel="ssd_chunk", case=name, max_abs_err=err, scale=scale,
                ok=ok, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=None, device_kernels_per_call=per_call,
                device_kernel_names=names,
                **ssd_bound(B, C, L, H, P, N))


def ssd_split_us(args, calls: int = 10) -> dict:
    """Device time of K6's kernel (by instance) per call, from
    ``torch.profiler``: {kernel name: us}; empty when the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ssd_chunk(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"ssd_chunk_kernel(<\d+>)?", e.key)
        if m and e.self_device_time_total > 0:
            out[m.group(0)] = e.self_device_time_total / calls
    return out


def ssd_checks() -> dict:
    """K6 against its plain version at the serve shape (one 17-token
    chunk, mamba2-780m's 48 heads x 64 x state 128), at B=1 S=2048 and at
    B=4 S=256 (chunks of 256)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    rows = [ssd_case("B1_C1_L17_serve", 1, 1, 17, 48, 64, 128, rng),
            ssd_case("B1_S2048_C8_L256", 1, 8, 256, 48, 64, 128, rng),
            ssd_case("B4_S256_C1_L256", 4, 1, 256, 48, 64, 128, rng)]
    check_ssd_rows(rows)
    for r, shape in zip(rows, ((1, 1, 17), (1, 8, 256))):
        split = ssd_split_us(ssd_chunk_args(*shape, 48, 64, 128, rng))
        log(f"ssd_chunk {r['case']} device time by kernel (torch.profiler): "
            + (" ".join(f"{k}={v:.1f}us" for k, v in split.items())
               or "not measured (no device time recorded)"))
    return {"serve": rows[0], "s2048": rows[1], "b4_s256": rows[2],
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def check_ssd_rows(rows: list) -> None:
    """Log each K6 row; fail on a disagreement with the plain version or a
    call that is not one device kernel."""
    for r in rows:
        log(f"check ssd_chunk {r['case']:18s} max_abs_err={r['max_abs_err']:.3e} "
            f"max|want|={r['scale']:.3g} allclose(rtol=atol={SSD_TOL:.0e})="
            f"{r['ok']} kernel_ms={r['ms']:.4f} eager_call_ms="
            f"{r['eager_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms=n/a bound_ms={r['bound_ms']:.5f} ({r['bound_by']}, "
            f"3xTF32 route; bytes {r['bytes_ms']:.5f}, ops {r['ops_ms']:.5f}) "
            f"ffma_bound_ms={r['ffma_bound_ms']:.5f} device_kernels_per_call="
            f"{r['device_kernels_per_call']} {r['device_kernel_names']}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"ssd_chunk disagrees with its plain version: {bad}")
    many = [r["case"] for r in rows
            if r["device_kernels_per_call"] not in (None, 1.0)]
    if many:
        raise SystemExit(f"ssd_chunk is not one launch a call: {many}")


# ---------------------------------------------------------------------------
# phase 4b: mamba2-780m decode step and a long prompt
# ---------------------------------------------------------------------------

def ssm_decode_step_ms(model, params, steps: int = 10) -> list:
    """Host-clock time of synchronized decode steps at 4 slots, after two
    warm-up steps (the serve runs' batch)."""
    caches = model.init_caches(4, 128)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=DEVICE)
    out = []
    for i in range(steps + 2):
        pos = torch.full((4,), i, dtype=torch.int32, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, caches, tok, pos)
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        if i >= 2:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def long_decode_step(model, params, caches, nxt, pos: int,
                     steps: int = 10) -> dict:
    """The kernel path's decode step at position ``pos`` of a long cache,
    repeated (each writes the same cache row): each synchronized step's
    host wall time (ms), one ``torch.profiler`` pass's device-busy ms a
    step, and K4's launches a step."""
    from torch.profiler import ProfilerActivity, profile
    posv = torch.tensor([pos], dtype=torch.int32, device=DEVICE)

    def step():
        model.decode_step(params, caches, nxt, posv)
    step()
    torch.cuda.synchronize()
    host = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    busy_ms, _ = busy_share(prof, "")
    return dict(host_ms=host, device_ms=busy_ms / 3,
                k4_launches=read_launches()["decode_attention"] / 3)


def long_prompt_run(cfg, model, plain, params, length: int = LONG_PROMPT,
                    controls=(), decode_steps: int = 0) -> dict:
    """One ``length``-token prompt (prefill + one decode step) through the
    kernel path and through the plain path on the same weights (and
    through each of ``controls``, (name, model) pairs): last position's
    logits of both steps, warm prefill wall times, and every kernel's
    launches in each timed prefill ({path: {kernel: launches}}). With
    ``decode_steps`` the kernel path's decode step at the long cache is
    also timed (``long_decode_step``)."""
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, length)).astype(np.int32)).to(DEVICE)
    # one next token for both paths: with random weights the top logits
    # nearly tie, and each path's own argmax may differ
    nxt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 1)).astype(np.int32)).to(DEVICE)
    out, times, launches = {}, {}, {}
    for name, m in (("kernel", model), ("plain", plain), *controls):
        m.prefill(params, {"tokens": prompt}, length + 1)   # warm-up
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, caches = m.prefill(params, {"tokens": prompt}, length + 1)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = read_launches()
        logits1, _ = m.decode_step(params, caches, nxt, torch.tensor(
            [length], dtype=torch.int32, device=DEVICE))
        out[name] = (logits0.float(), logits1.float())
        if name == "kernel" and decode_steps:
            decode = long_decode_step(m, params, caches, nxt, length,
                                      decode_steps)
        del caches
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max())
            for a, b in zip(out["kernel"], out["plain"])]
    same = [bool((a.argmax(-1) == b.argmax(-1)).all())
            for a, b in zip(out["kernel"], out["plain"])]
    return dict(errs=errs, same=same, scale=float(out["plain"][0].abs().max()),
                prefill_ms=times, launches=launches, out=out,
                **({"decode": decode} if decode_steps else {}))


def attn_long_prompt_check(arch: str, length: int, k5_ms: float,
                           controls: dict | None = None,
                           witness: str | None = None,
                           decode_steps: int = 0) -> dict:
    """``arch`` at full width: one ``length``-token prompt through K5 and
    through the plain attention on the same weights (and through the plain
    path with each of ``controls``' config fields replaced; see
    ``controls_check``). K5's share of the prefill is ``k5_ms`` (its
    device time summed over the layers at this shape, phase 3) over the
    prefill's wall time."""
    cfg = get_config(arch)
    model = build(cfg, device="cuda")
    plain = build(cfg, device="cuda", plain_kernels=True)
    params = model.init(0)
    r = long_prompt_run(cfg, model, plain, params, length,
                        [(name, build(dataclasses.replace(cfg, **kw),
                                      device="cuda", plain_kernels=True))
                         for name, kw in (controls or {}).items()],
                        decode_steps)
    errs, t = r["errs"], r["prefill_ms"]
    n = {path: k["flash_attention"] for path, k in r["launches"].items()}
    r["launches"] = n
    share = k5_ms / t["kernel"]
    log(f"{arch} {length}-token prompt, K5 vs plain attention: "
        f"prefill max_abs_err={errs[0]:.3e} decode max_abs_err={errs[1]:.3e} "
        f"(|logits| max {r['scale']:.2f}, tol {LOGITS_ATOL}) argmax_equal="
        f"{r['same']} prefill_ms kernel={t['kernel']:.2f} "
        f"plain={t['plain']:.2f} flash_attention launches kernel="
        f"{n['kernel']} plain={n['plain']} K5 share of the kernel-path "
        f"prefill={share:.3f} ({k5_ms:.4f} ms over {n['kernel']} launches)")
    if decode_steps:
        d = r["decode"]
        log(f"{arch} decode step at the {length + 1}-position cache (for "
            f"context: host-bound): host_ms median="
            f"{sorted(d['host_ms'])[len(d['host_ms']) // 2]:.3f} all="
            f"{[round(x, 3) for x in d['host_ms']]} device_busy_ms="
            f"{d['device_ms']:.4f} decode_attention launches a step="
            f"{d['k4_launches']:.0f}")
        if d["k4_launches"] != cfg.num_layers:
            raise SystemExit(f"{arch} long decode step: decode_attention "
                             f"launches {d['k4_launches']} a step")
    if max(errs) > LOGITS_ATOL or not all(math.isfinite(e) for e in errs):
        raise SystemExit(f"{arch} long prompt: K5-path logits disagree "
                         f"with the plain path")
    if n["kernel"] != cfg.num_layers or n["plain"] != 0:
        raise SystemExit(f"{arch} long prompt: flash_attention launches {n}")
    ctrl = controls_check(f"{arch} {length}-token", r.pop("out"), witness)
    del params, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return dict(r, k5_share=share, controls=ctrl)


def ssm_long_prompt_check(k6_ms: float) -> dict:
    """mamba2-780m at full width: the 4-slot decode step time, then one
    2048-token prompt (prefill + one decode step) through K6 and through
    its plain version on the same weights. K6's share of the prefill is its
    launches times its device time at this shape (phase 3) over the
    prefill's wall time."""
    cfg = get_config("mamba2-780m")
    model = build(cfg, device="cuda")
    plain = build(cfg, device="cuda", plain_kernels=True)
    params = model.init(0)
    steps = ssm_decode_step_ms(model, params)
    log(f"mamba2-780m decode step, 4 slots: mean {np.mean(steps):.2f} ms "
        f"min {min(steps):.2f} max {max(steps):.2f} ({len(steps)} steps, "
        f"host clock, synchronized)")
    r = long_prompt_run(cfg, model, plain, params)
    errs, times, same = r["errs"], r["prefill_ms"], r["same"]
    launches = {path: k["ssd_chunk"] for path, k in r["launches"].items()}
    share = launches["kernel"] * k6_ms / times["kernel"]
    log(f"mamba2-780m {LONG_PROMPT}-token prompt, K6 vs plain SSD: prefill "
        f"max_abs_err={errs[0]:.3e} decode max_abs_err={errs[1]:.3e} "
        f"(|logits| max {r['scale']:.2f}, tol {SSM_LOGITS_ATOL}) argmax_equal="
        f"{same} prefill_ms kernel={times['kernel']:.2f} "
        f"plain={times['plain']:.2f} ssd_chunk launches kernel="
        f"{launches['kernel']} plain={launches['plain']} K6 share of the "
        f"kernel-path prefill={share:.3f} ({launches['kernel']} x "
        f"{k6_ms:.4f} ms)")
    if max(errs) > SSM_LOGITS_ATOL or not all(same) or \
            not all(math.isfinite(e) for e in errs):
        raise SystemExit("mamba2 K6-path logits disagree with the plain path")
    if launches["kernel"] != cfg.num_layers or launches["plain"] != 0:
        raise SystemExit(f"long prompt: ssd_chunk launches {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(decode_step_ms=steps, prefill_ms=times, err=max(errs),
                k6_share=share, launches=launches["kernel"])


# ---------------------------------------------------------------------------
# phase 4c: the stream frontend at full width (HIGH under LOW)
# ---------------------------------------------------------------------------

STREAM_ARGS = ["--arch", "llama3-8b", "--requests", "8", "--max-new", "8",
               "--max-batch", "4", "--max-seq", "128", "--seed", "0"]
OUT = ROOT / "build" / "chip_smoke"       # metrics and traces of this run


def busy_share(prof, first_kernel: str) -> tuple[float, float]:
    """(device busy ms, its share of the window) from a ``torch.profiler``
    pass: the union of every device interval from the first kernel whose
    name holds ``first_kernel`` to the last interval's end."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA"
                   and e.time_range.end > e.time_range.start)
    starts = [e.time_range.start for e in prof.events()
              if e.device_type.name == "CUDA" and first_kernel in e.name]
    if not spans or not starts:
        raise SystemExit("torch.profiler recorded no device time")
    t0 = min(starts)
    t1 = max(e for _, e in spans)
    busy, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy / 1e3, busy / (t1 - t0)


def stream_samples(trace_path: Path) -> dict:
    """Every TTFT and response the stream frontend recorded, exact, as
    {(class, "ttft"|"response"): [(request id, ms), ...]}, read from the
    chrome trace ``serve --trace`` wrote (a re-admitted stream records a
    TTFT each time it is admitted, as the histogram does)."""
    out = {}
    for ev in json.loads(trace_path.read_text())["traceEvents"]:
        args = ev.get("args", {})
        for key in ("ttft_us", "response_us"):
            if key in args:
                out.setdefault((ev["name"].split(":", 1)[1], key[:-3]),
                               []).append((args["request_id"],
                                           round(args[key] / 1e3, 1)))
    return out


def token_identity(label: str, streams: list, extra: list) -> None:
    """A stream's tokens equal ``engine.generate``'s for the same prompts
    on the same weights (serve without --streams). At the first difference
    the position and the top-two margin of the kernel path's logits there
    are printed, and the run fails."""
    gen = serve.main(STREAM_ARGS + extra).outputs
    reap_deferred()
    gc.collect()
    torch.cuda.empty_cache()
    diff = [(i, next(j for j, (a, b) in enumerate(zip(s_, g)) if a != b))
            for i, (s_, g) in enumerate(zip(streams, gen)) if s_ != g]
    log(f"streams[{label}] tokens equal generate's: {not diff} "
        f"({len(streams)} streams)")
    if not diff:
        return
    cfg = get_config("llama3-8b")
    model = build(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
               for _ in range(len(streams))]
    for i, j in diff:
        seq = np.concatenate([prompts[i], np.asarray(gen[i][:j])])
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(
            seq.astype(np.int32))[None].cuda()}, 128)
        log(f"streams[{label}] stream {i} differs at new token {j}: "
            f"stream {streams[i][j]} generate {gen[i][j]}, top-two margin "
            f"{top2_margin(logits[:, -1])[0]:.4f}")
    raise SystemExit(f"streams[{label}]: tokens differ from generate's")


def streams_run(label: str, extra: list, profiled: bool) -> dict:
    """``serve --streams`` on llama3-8b at full width, 8 streams (every 4th
    HIGH) over 4 slots, elastic advisory controller, metrics pump and
    trace on; launch counters zeroed just before and read just after; with
    ``profiled`` under one ``torch.profiler`` pass (device activity)."""
    OUT.mkdir(parents=True, exist_ok=True)
    mfile = OUT / f"streams_{label}.jsonl"
    tfile = OUT / f"streams_{label}.trace.json"
    for f in (mfile, mfile.with_name(mfile.name + ".prom")):
        f.unlink(missing_ok=True)
    from torch.profiler import ProfilerActivity, profile
    zero_launches()
    t0 = time.perf_counter()
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        report = serve.main(STREAM_ARGS + [
            "--streams", "--high-every", "4", "--elastic",
            "--metrics-file", str(mfile),
            "--trace", str(tfile)] + extra)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    reap_deferred()
    gc.collect()
    torch.cuda.empty_cache()
    st, mc, ds, met = (report.streams, report.monitor,
                       report.deadline_stats, report.metrics)
    log(f"streams[{label}] wall={wall:.1f}s launches={launches} "
        f"opened={st['opened']} shed={st['shed']} readmitted="
        f"{st['readmitted']} closed={st['closed']} evictions="
        f"{st['evictions']} n={ds['n']} met={ds['met']} monitor={mc}")
    # a handful of streams a class: the log-bucket p99 of so few is not a
    # tail, so every sample is printed beside the summary
    samples = stream_samples(tfile)
    for metric, summ in (("ttft", report.stream_ttft_us),
                         ("response", report.stream_response_us)):
        for cls in ("stream_high", "stream_low"):
            q = summ[cls]
            log(f"streams[{label}] {cls} {metric}_ms n={q['count']} "
                f"p50={q['p50_us'] / 1e3:.2f} p99={q['p99_us'] / 1e3:.2f} "
                f"worst={q['worst_us'] / 1e3:.2f} samples (request id, ms) "
                f"{sorted(samples[cls, metric], key=lambda x: x[1])}")
    util = met["utilization"]
    dev = ""
    if profiled:
        busy_ms, share = busy_share(prof, "decode_")
        dev = (f"; device-busy share (torch.profiler, first K4 launch to "
               f"the end) {share:.3f} ({busy_ms:.1f} ms busy)")
    # the histogram's summary keys say _us; the values are percent
    dist = {c: dict(n=q["count"], avg=round(q["avg_us"], 2),
                    p50=round(q["p50_us"], 2), worst=round(q["worst_us"], 2))
            for c, q in met["utilization_pct"].items()}
    log(f"streams[{label}] metrics samples={met['samples']} device_chunks="
        f"{met['device_chunks']:.0f} host-window share (trigger to readback, "
        f"the registry's cluster_utilization) at the last sample {util}, "
        f"over every 0.25 s sample in percent {dist}{dev}; elastic "
        f"{report.elastic}")
    bad = []
    if st["closed"] != st["opened"]:
        bad.append("closed != opened")
    if mc["bound_violations"]:
        bad.append(f"bound_violations={mc['bound_violations']}")
    if ds["met"] != ds["n"]:
        bad.append(f"met={ds['met']} != n={ds['n']}")
    if any(len(o) != 8 for o in report.outputs):
        bad.append("a stream did not complete")
    if not met["device_chunks"] > 0 or not mfile.stat().st_size or \
            not mfile.with_name(mfile.name + ".prom").stat().st_size:
        bad.append("metrics files or device chunks missing")
    if top.main(["--once", "--file", str(mfile)]) != 0:
        bad.append("top --once failed")
    if bad:
        raise SystemExit(f"streams[{label}]: {bad}")
    token_identity(label, report.outputs, extra)
    return dict(launches=launches, streams=st, monitor=mc, samples=samples,
                ttft=report.stream_ttft_us, response=report.stream_response_us,
                utilization=util, utilization_pct=met["utilization_pct"],
                wall_s=wall)


def streams_phase(chunked_args: list) -> dict:
    host = streams_run("host_prefill", [], profiled=True)
    chunked = streams_run("chunked_prefill", chunked_args, profiled=False)
    if not host["launches"]["flash_attention"] or \
            chunked["launches"]["flash_attention"] or \
            not host["launches"]["decode_attention"] or \
            not chunked["launches"]["decode_attention"]:
        raise SystemExit(f"streams: K5/K4 launches host "
                         f"{host['launches']} chunked {chunked['launches']}")
    rc = trace.main(["--out", str(OUT / "trace_cli.json")])
    log(f"trace CLI on the card: rc={rc}")
    if rc != 0:
        raise SystemExit("trace CLI failed its checks on the card")
    return dict(host=host, chunked=chunked)


# ---------------------------------------------------------------------------
# phase 4d: gemma2-2b and mistral-nemo-12b at full width
# ---------------------------------------------------------------------------

def dense_configs_phase(chunked_args: list, gemma_rows: list) -> dict:
    """gemma2-2b (D=256, GQA 8/4, window 4096, softcaps) served with host
    and chunked prefill, its logits against the plain path, one
    GEMMA_LONG-token prompt past the window; mistral-nemo-12b served with
    host prefill and its logits against the plain path. Each model is
    freed before the next."""
    g = get_config("gemma2-2b")
    host = serve_run("gemma2-2b", "host_prefill", [])
    chunked = serve_run("gemma2-2b", "chunked_prefill", chunked_args)
    if host["flash_attention"] != g.num_layers * 4 or \
            chunked["flash_attention"] or not host["decode_attention"] or \
            not chunked["decode_attention"]:
        raise SystemExit(f"gemma2-2b serve: launches host {host} chunked "
                         f"{chunked}")
    # controls: the plain path without the attention softcap, and with a
    # window of 8 on the local layers (a mask fault the tolerance must see)
    g_logits = logits_check(
        "gemma2-2b", need_argmax=True, witness="window8",
        controls={"softcap_removed": dict(attn_softcap=0.0),
                  "window8": dict(local_window=8)})
    by_case = {r["case"]: r for r in gemma_rows}
    half = g.num_layers // 2       # local and global layers alternate
    k5_ms = half * (
        by_case[f"gemma_B1_S{GEMMA_LONG}_window4096_softcap50_D256_bf16"]
        ["ms"] +
        by_case[f"gemma_B1_S{GEMMA_LONG}_causal_softcap50_D256_bf16"]["ms"])
    # control: the plain path without the 4096 window (the tolerance must
    # see it past the window)
    g_long = attn_long_prompt_check(
        "gemma2-2b", GEMMA_LONG, k5_ms, witness="window_removed",
        controls={"window_removed": dict(local_window=0)}, decode_steps=10)
    mistral = serve_run("mistral-nemo-12b", "host_prefill", [])
    if not mistral["flash_attention"] or not mistral["decode_attention"]:
        raise SystemExit(f"mistral-nemo-12b serve: launches {mistral}")
    # argmax equality is not asked of mistral-nemo-12b: its plain top-two
    # margin (0.031 at the prefill) is far inside the tolerance
    m_logits = logits_check("mistral-nemo-12b")
    return dict(gemma_host=host, gemma_chunked=chunked, gemma_logits=g_logits,
                gemma_long=g_long, mistral_host=mistral,
                mistral_logits=m_logits)


# ---------------------------------------------------------------------------
# phase 3c: K4/K5/K6 at zamba2-7b's and whisper-tiny's shapes
# ---------------------------------------------------------------------------

ZAMBA_ATTN = dict(Hq=32, Hkv=32, D=112)       # the shared block's heads
WHISPER_ATTN = dict(Hq=6, Hkv=6, D=64)


def hybrid_encdec_kernel_checks() -> dict:
    """K5 at D=112 (zamba2-7b's shared block: a 17-token prompt and the
    2048-token one, causal), K5 at whisper-tiny's encoder (1500 frames,
    non-causal) and cross-attention shapes (17 queries against the 1500
    frames), and its decoder's 17-token causal prompt; K4 at zamba2-7b's
    serve shape (4 slots, 128 positions, 32 kv heads of 112: 128 clusters)
    and at whisper-tiny's decode self- and cross-attention (all 1500
    frames live: the cross path's route); K6 at zamba2-7b's SSM shape (112
    heads, P=64, N=64) for a 17-token prompt and 2048 tokens. Each against
    its plain version at bf16 2e-2 (K6 f32 rtol and atol 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    bf16, F = torch.bfloat16, get_config("whisper-tiny").encoder_frames
    z, w = ZAMBA_ATTN, WHISPER_ATTN
    attn = [
        flash_case("zamba2_B1_S17_causal_D112_bf16", 1, 17, bf16, gen, **z),
        flash_case(f"zamba2_B1_S{LONG_PROMPT}_causal_D112_bf16", 1,
                   LONG_PROMPT, bf16, gen, **z),
        flash_case(f"whisper_encoder_B1_S{F}_D64_bf16", 1, F, bf16, gen,
                   causal=False, **w),
        flash_case(f"whisper_cross_B1_Sq17_Skv{F}_D64_bf16", 1, 17, bf16,
                   gen, causal=False, Skv=F, **w),
        flash_case("whisper_B1_S17_causal_D64_bf16", 1, 17, bf16, gen, **w),
        decode_case("zamba2_B4_S128_ragged_D112_bf16", 4, 128,
                    [128, 1, 77, 64], bf16, gen, **z),
        decode_case(f"whisper_cross_decode_B4_S{F}_D64_bf16", 4, F, [F] * 4,
                    bf16, gen, **w),
        decode_case("whisper_B4_S128_ragged_D64_bf16", 4, 128,
                    [128, 1, 77, 64], bf16, gen, **w),
    ]
    check_attention_rows(attn)
    rng = np.random.default_rng(19)
    ssd = [ssd_case("zamba2_B1_C1_L17_H112_N64", 1, 1, 17, 112, 64, 64, rng),
           ssd_case(f"zamba2_B1_S{LONG_PROMPT}_C8_L256_H112_N64", 1, 8, 256,
                    112, 64, 64, rng)]
    check_ssd_rows(ssd)
    return {r["case"]: r for r in attn + ssd}


# ---------------------------------------------------------------------------
# phase 4e: zamba2-7b (hybrid) and whisper-tiny (encdec) at full width
# ---------------------------------------------------------------------------

# kernel vs plain logits through zamba2-7b's 81 SSM layers and 13
# shared-block invocations, bf16 rounding carried through 94 blocks: set
# from the spread measured on the card, 0.23-0.29 at |logits| max 4.4-4.6
# (17-token and 2048-token prompts, prefill and decode); llama3-8b's 0.25
# over 32 layers would sit inside that spread
HYBRID_LOGITS_ATOL = 0.5


def decode_device_ms(model, params, steps: int = 3) -> tuple[float, float]:
    """(device busy ms, device kernels) a synchronized 4-slot decode step,
    from one ``torch.profiler`` pass over ``steps`` steps after one warm-up
    step: the union of the device intervals over the pass, per step."""
    from torch.profiler import ProfilerActivity, profile
    caches = model.init_caches(4, 128)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=DEVICE)

    def step(i):
        model.decode_step(params, caches, tok, torch.full(
            (4,), i, dtype=torch.int32, device=DEVICE))
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i + 1)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    busy_ms, _ = busy_share(prof, "")
    return busy_ms / steps, n / steps


def hybrid_phase(chunked_args: list, rows: dict) -> dict:
    """zamba2-7b at full width (81 mamba2 layers of 112 heads x 64, state
    64; one shared attention+MLP block of 32/32 heads x 112 applied 13
    times; bf16, random weights from seed 0): served with host prefill (K5
    13 invocations x 4 prompts, K6 81 layers x 4 prompts) and with chunked
    prefill (neither); a 17-token prompt's logits against the plain path;
    the 4-slot decode step's host time beside its device time; one
    2048-token prompt through K5 (13 launches) and K6 (81) against the
    plain path, with their share of the prefill."""
    cfg = get_config("zamba2-7b")
    groups = cfg.num_layers // cfg.shared_attn_every
    host = serve_run("zamba2-7b", "host_prefill", [])
    chunked = serve_run("zamba2-7b", "chunked_prefill", chunked_args)
    if host["flash_attention"] != groups * 4 or \
            host["ssd_chunk"] != cfg.num_layers * 4 or \
            not host["decode_attention"] or chunked["flash_attention"] or \
            chunked["ssd_chunk"] or not chunked["decode_attention"]:
        raise SystemExit(f"zamba2-7b serve: launches host {host} (want K5 "
                         f"{groups} x 4, K6 {cfg.num_layers} x 4) chunked "
                         f"{chunked} (want K5 and K6 0)")
    model = build(cfg, device="cuda")
    plain = build(cfg, device="cuda", plain_kernels=True)
    params = model.init(0)
    logits = logits_check("zamba2-7b", tol=HYBRID_LOGITS_ATOL, params=params)
    steps = ssm_decode_step_ms(model, params)
    dev_ms, dev_kernels = decode_device_ms(model, params)
    log(f"zamba2-7b decode step, 4 slots: mean {np.mean(steps):.2f} ms min "
        f"{min(steps):.2f} max {max(steps):.2f} ({len(steps)} steps, host "
        f"clock, synchronized); device busy {dev_ms:.2f} ms a step "
        f"({dev_kernels:.0f} device kernels a step, torch.profiler)")
    r = long_prompt_run(cfg, model, plain, params)
    errs, t, n = r["errs"], r["prefill_ms"], r["launches"]
    k5_ms = groups * rows[f"zamba2_B1_S{LONG_PROMPT}_causal_D112_bf16"]["ms"]
    k6_ms = cfg.num_layers * \
        rows[f"zamba2_B1_S{LONG_PROMPT}_C8_L256_H112_N64"]["ms"]
    log(f"zamba2-7b {LONG_PROMPT}-token prompt, K5+K6 vs plain: prefill "
        f"max_abs_err={errs[0]:.3e} decode max_abs_err={errs[1]:.3e} "
        f"(|logits| max {r['scale']:.2f}, tol {HYBRID_LOGITS_ATOL}) "
        f"argmax_equal={r['same']} prefill_ms kernel={t['kernel']:.2f} "
        f"plain={t['plain']:.2f} launches kernel flash_attention="
        f"{n['kernel']['flash_attention']} ssd_chunk="
        f"{n['kernel']['ssd_chunk']} plain flash_attention="
        f"{n['plain']['flash_attention']} ssd_chunk={n['plain']['ssd_chunk']}"
        f" share of the kernel-path prefill K5={k5_ms / t['kernel']:.3f} "
        f"K6={k6_ms / t['kernel']:.3f} ({k5_ms:.3f} + {k6_ms:.3f} ms)")
    if max(errs) > HYBRID_LOGITS_ATOL or \
            not all(math.isfinite(e) for e in errs):
        raise SystemExit("zamba2-7b long prompt: kernel-path logits disagree "
                         "with the plain path")
    if n["kernel"]["flash_attention"] != groups or \
            n["kernel"]["ssd_chunk"] != cfg.num_layers or \
            n["plain"]["flash_attention"] or n["plain"]["ssd_chunk"]:
        raise SystemExit(f"zamba2-7b long prompt: launches {n}")
    del params, model, plain, r["out"]
    gc.collect()
    torch.cuda.empty_cache()
    return dict(zamba2_7b_host_prefill=host,
                zamba2_7b_chunked_prefill=chunked, logits=logits,
                decode_step_ms=steps, decode_device_ms=dev_ms,
                long_prefill_ms=t, long_errs=errs, long_launches=n["kernel"],
                k5_share=k5_ms / t["kernel"], k6_share=k6_ms / t["kernel"])


def encdec_phase(chunked_args: list) -> dict:
    """whisper-tiny at full width (4 encoder and 4 decoder layers, d=384,
    6/6 heads x 64, vocab 51865, 1500 stub frames a request drawn from the
    seed): served with host prefill and with ``--chunked-prefill``, where
    requests with frames still take the host prefill (K5 launched once an
    encoder layer and twice a decoder layer a prompt on both runs; K4 for
    decode self- and cross-attention); a 17-token prompt's logits (its
    frames drawn from the seed) against the plain path."""
    cfg = get_config("whisper-tiny")
    per_prompt = cfg.encoder_layers + 2 * cfg.num_layers
    host = serve_run("whisper-tiny", "host_prefill", [])
    chunked = serve_run("whisper-tiny", "chunked_prefill", chunked_args)
    for label, run in (("host", host), ("chunked", chunked)):
        if run["flash_attention"] != per_prompt * 4 or \
                not run["decode_attention"]:
            raise SystemExit(f"whisper-tiny serve ({label}): launches {run} "
                             f"(want K5 {per_prompt} x 4: the host prefill "
                             f"on both runs)")
    logits = logits_check("whisper-tiny")
    return dict(whisper_tiny_host_prefill=host,
                whisper_tiny_chunked_prefill=chunked, logits=logits)


# ---------------------------------------------------------------------------
# phase 3d: K4/K5 at the moe and vlm families' shapes and at head dim 32
# ---------------------------------------------------------------------------

LLAMA4_ATTN = dict(Hq=40, Hkv=8, D=128)                   # GQA 5
GROK_ATTN = dict(Hq=48, Hkv=8, D=128, softcap=30.0)       # GQA 6, softcap 30
INTERNVL_ATTN = dict(Hq=64, Hkv=8, D=128)                 # GQA 8
REDUCED_ATTN = dict(Hq=4, Hkv=2, D=32)                    # every --reduced
INTERNVL_PROMPT = 256 + 17        # the image prefix and a 17-token prompt
INTERNVL_VALID = [262, 270, 279, 290]   # 4 slots: prefix + 4..23 + decoded
RAGGED_128 = [128, 1, 77, 64]


def moe_vlm_kernel_checks() -> dict:
    """K5 and K4 at llama4's 40/8 heads x 128 (a 17-token prompt, the
    4-slot decode over 128 positions), at grok-1's 48/8 x 128 with its
    attention softcap of 30 (q scaled so the cap bites), at internvl2-76b's
    64/8 x 128 (the 256-row image prefix plus a 17-token prompt, causal;
    4 slots over a 512-position cache with 262-290 live rows), and at every
    reduced config's 4/2 heads x 32 in f32 and bf16 (the --smoke path);
    K6 at the reduced SSM shape (16 heads, P=16, N=16, a 17-token chunk).
    Each against its plain version at bf16 2e-2, f32 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    bf16, f32 = torch.bfloat16, torch.float32
    attn = [
        flash_case("llama4_B1_S17_causal_G5_bf16", 1, 17, bf16, gen,
                   **LLAMA4_ATTN),
        decode_case("llama4_B4_S128_ragged_G5_bf16", 4, 128, RAGGED_128,
                    bf16, gen, **LLAMA4_ATTN),
        flash_case("grok1_B1_S17_causal_softcap30_G6_bf16", 1, 17, bf16,
                   gen, **GROK_ATTN),
        decode_case("grok1_B4_S128_ragged_softcap30_G6_bf16", 4, 128,
                    RAGGED_128, bf16, gen, **GROK_ATTN),
        flash_case(f"internvl2_B1_S{INTERNVL_PROMPT}_causal_G8_bf16", 1,
                   INTERNVL_PROMPT, bf16, gen, **INTERNVL_ATTN),
        decode_case("internvl2_B4_S512_valid262-290_G8_bf16", 4, 512,
                    INTERNVL_VALID, bf16, gen, **INTERNVL_ATTN),
    ]
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        attn += [
            flash_case(f"reduced_B1_S17_causal_D32_{tag}", 1, 17, dtype, gen,
                       **REDUCED_ATTN),
            decode_case(f"reduced_B4_S128_ragged_D32_{tag}", 4, 128,
                        RAGGED_128, dtype, gen, **REDUCED_ATTN)]
    check_attention_rows(attn)
    rng = np.random.default_rng(20)
    ssd = [ssd_case("reduced_B1_C1_L17_H16_P16_N16", 1, 1, 17, 16, 16, 16,
                    rng)]
    check_ssd_rows(ssd)
    return {r["case"]: r for r in attn + ssd}


# ---------------------------------------------------------------------------
# phase 4f: llama4-maverick, grok-1 (moe) and internvl2-76b (vlm) at full
# width, depth cut
# ---------------------------------------------------------------------------

# (arch, layers, max_seq): every width as published, the depth cut to what
# one 80 GB card holds in bf16 with room for two engines' caches and the
# plain path: llama4 one (dense, MoE) period (one MoE layer alone is 16.2 G
# parameters), grok-1 4 of 64 layers, internvl2-76b 24 of 80 (its prompts
# carry the 256-row image prefix, hence the 512-position cache)
CUT_DEPTH = (("llama4-maverick-400b-a17b", 2, 128), ("grok-1-314b", 4, 128),
             ("internvl2-76b", 24, 512))


@contextlib.contextmanager
def routes(replay=None):
    """``moe.route`` wrapped for the block: every call's f32 router logits
    and top-k choices recorded in call order ([(logits, idx)], yielded).
    With ``replay`` (such a record) call i takes the recorded choices
    instead of its own top-k, its gates recomputed from its own
    probabilities; ``moe.slots`` then places them."""
    own = moe_mod.route
    calls = []

    def wrapped(logits, top_k, capacity):
        if replay is None:
            out = own(logits, top_k, capacity)
        else:
            idx = replay[len(calls)][1]
            probs = torch.softmax(logits, dim=-1)
            gates = probs.gather(-1, idx)
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
            out = (probs, idx, gates,
                   *moe_mod.slots(idx, gates, logits.shape[-1], capacity))
        calls.append((logits.detach().clone(), out[1].clone()))
        return out

    moe_mod.route = wrapped
    try:
        yield calls
    finally:
        moe_mod.route = own


def moe_logits_check(cfg, params) -> dict:
    """A MoE model's 17-token prefill and one decode step through the kernel
    path and the plain path, each MoE layer's routing recorded. A top-k
    choice that differs between the paths (a flip) is a routing tie only
    where the plain path's router-logit gap at the top-k boundary is at
    most twice the largest router-logit difference between the paths; any
    other flip fails. Then the plain path again with the kernel path's
    choices replayed: its logits within LOGITS_ATOL of the kernel path's,
    argmax equal. (Host and chunked prefill may drop different tokens at
    capacity, so served tokens are not compared across them.)"""
    model = build(cfg, device="cuda")
    plain = build(cfg, device="cuda", plain_kernels=True)
    batch, pos = logits_batch(cfg)
    with routes() as k_calls:
        k0, k1, nxt = two_steps(model, params, batch, pos)
    with routes() as p_calls:
        p0, p1, _ = two_steps(plain, params, batch, pos, nxt)
    with routes(replay=k_calls) as r_calls:
        r0, r1, _ = two_steps(plain, params, batch, pos, nxt)
    torch.cuda.synchronize()
    if not len(k_calls) == len(p_calls) == len(r_calls) > 0:
        raise SystemExit(f"{cfg.name}: route calls kernel {len(k_calls)} "
                         f"plain {len(p_calls)} replay {len(r_calls)}")
    K = cfg.moe.top_k
    diff = max(float((a[0] - b[0]).abs().max())
               for a, b in zip(k_calls, p_calls))
    gaps = []                     # the plain gap at each flipped choice
    for (_, ik), (lp, ip) in zip(k_calls, p_calls):
        same = (ik.sort(dim=-1).values == ip.sort(dim=-1).values).all(-1)
        top = lp.topk(K + 1, dim=-1).values
        gaps += (top[..., K - 1] - top[..., K])[~same].tolist()
    untied = [g for g in gaps if g > 2 * diff]
    choices = sum(int(c[1].numel()) // K for c in k_calls)
    errs = [float((a - b).abs().max()) for a, b in ((k0, r0), (k1, r1))]
    plain_errs = [float((a - b).abs().max()) for a, b in ((k0, p0), (k1, p1))]
    same = [bool((a.argmax(-1) == b.argmax(-1)).all())
            for a, b in ((k0, r0), (k1, r1))]
    margins = [top2_margin(b)[0] for b in (r0, r1)]
    log(f"logits[{cfg.name} {cfg.num_layers} layers] routing: {len(k_calls)} "
        f"route calls, {choices} (token, layer) choices, {len(gaps)} flipped "
        f"between the kernel and plain paths; largest router-logit "
        f"difference {diff:.3e}; plain gaps at the flips "
        f"{[round(g, 5) for g in gaps]} (a tie when <= {2 * diff:.3e}); "
        f"untied flips {len(untied)}")
    log(f"logits[{cfg.name} {cfg.num_layers} layers] kernel path vs the plain "
        f"path replaying its routing: prefill max_abs_err={errs[0]:.3e} "
        f"decode max_abs_err={errs[1]:.3e} (|logits| max "
        f"{float(r0.abs().max()):.2f}, tol {LOGITS_ATOL}) argmax_equal={same} "
        f"replayed top-two margins={[round(m, 4) for m in margins]}; without "
        f"the replay {plain_errs[0]:.3e} / {plain_errs[1]:.3e}")
    if untied:
        raise SystemExit(f"{cfg.name}: routing flips that are no tie: gaps "
                         f"{untied} > 2 x {diff:.3e}")
    if max(errs) > LOGITS_ATOL or not all(math.isfinite(e) for e in errs) \
            or not all(same):
        raise SystemExit(f"{cfg.name}: kernel-path logits disagree with the "
                         f"plain path replaying its routing")
    return dict(errs=errs, plain_errs=plain_errs, same=same, flips=len(gaps),
                choices=choices, router_diff=diff, gaps=gaps,
                margins=margins)


def moe_vlm_phase(chunked_args: list) -> dict:
    """Each of CUT_DEPTH at full width, its depth cut: served as
    ``serve.main`` serves (4 requests x 8 new tokens, 4 slots, EDF) with
    host prefill (K5 layers x 4 prompts) and with chunked prefill (K5 0
    for moe; internvl2-76b's requests carry patch embeddings and take the
    host prefill there too), peak memory printed; then the logits against
    the plain path on seed 0's weights (``moe_logits_check``, or
    ``logits_check`` with the 256 patch embeddings in the prompt)."""
    out = {}
    for arch, layers, max_seq in CUT_DEPTH:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        kind = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
                if cfg.moe else f", {cfg.vision_tokens} vision tokens")
        log(f"{arch}: {layers} of {get_config(arch).num_layers} layers, "
            f"full width (d={cfg.d_model}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}{kind}), bf16 weights "
            f"{cfg.param_count() * 2 / 2**30:.1f} GiB (param_count)")
        key = arch.replace("-", "_")
        extra = ["--max-seq", str(max_seq)]
        host = serve_run(arch, "host_prefill", extra, cfg=cfg)
        chunked = serve_run(arch, "chunked_prefill", chunked_args + extra,
                            cfg=cfg)
        want = layers * 4 if cfg.family == "vlm" else 0
        if host["flash_attention"] != layers * 4 or \
                chunked["flash_attention"] != want or \
                not host["decode_attention"] or \
                not chunked["decode_attention"]:
            raise SystemExit(f"{arch} serve: launches host {host} (want K5 "
                             f"{layers} x 4) chunked {chunked} (want K5 "
                             f"{want})")
        out[f"{key}_host_prefill"] = host
        out[f"{key}_chunked_prefill"] = chunked
        params = build(cfg, device="cuda").init(0)
        gib = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params)) / 2**30
        log(f"{arch} {layers} layers: weights {gib:.2f} GiB on the card")
        if cfg.family == "moe":
            out[f"{key}_logits"] = moe_logits_check(cfg, params)
        else:
            out[f"{key}_logits"] = logits_check(arch, cfg=cfg, params=params,
                                                max_seq=max_seq)
        out[f"{key}_weights_gib"] = gib
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4g: serve --smoke on the card, every registered arch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_calls():
    """Counts of the plain attention and SSD versions the models call for
    the block ({name: calls}, yielded): a CUDA path must make none."""
    counts = {}
    sites = [(attn_mod, "flash_attention_plain"),
             (attn_mod, "decode_attention_plain"),
             (fa_kernel, "flash_attention_lse_plain"),
             (fa_kernel, "flash_attention_bwd_plain"),
             (ssd_ops, "ssd_chunk_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]

    def counting(name, own):
        def fn(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return own(*args, **kw)
        return fn

    for mod, name, own in saved:
        setattr(mod, name, counting(name, own))
    try:
        yield counts
    finally:
        for mod, name, own in saved:
            setattr(mod, name, own)


def smoke_phase() -> dict:
    """``serve.main(["--smoke", "--arch", X])`` with its default device
    (cuda) for every registered arch: the reduced config (f32, head dim 32,
    4/2 heads), 6 requests x 4 new tokens. Every request completes,
    ``met == n``, K5 and K4 launched for an arch with attention, K6 for
    the ssm and hybrid ones, and no plain attention or SSD on the path."""
    runs = {}
    for arch in list_configs():
        fam = get_config(arch).family
        with plain_calls() as plain:
            zero_launches()
            t0 = time.perf_counter()
            report = serve.main(["--smoke", "--arch", arch])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        ds, outs = report.deadline_stats, report.outputs
        log(f"smoke[{arch}] wall={wall:.1f}s launches={launches} n={ds['n']} "
            f"met={ds['met']} tokens={[len(o) for o in outs]} plain calls "
            f"{plain}")
        bad = []
        if len(outs) != 6 or any(len(o) != 4 for o in outs):
            bad.append("a request did not complete")
        if ds["met"] != ds["n"]:
            bad.append(f"met={ds['met']} != n={ds['n']}")
        if fam != "ssm" and not (launches["flash_attention"] and
                                 launches["decode_attention"]):
            bad.append("K5/K4 not launched")
        if fam in ("ssm", "hybrid") and not launches["ssd_chunk"]:
            bad.append("K6 not launched")
        if plain:
            bad.append(f"plain versions ran: {plain}")
        if bad:
            raise SystemExit(f"smoke[{arch}]: {bad}")
        runs[arch] = launches
        del report
        reap_deferred()
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 4h: training on the card
# ---------------------------------------------------------------------------

# every arch the tokens-only loader feeds (encdec and vlm need frames /
# patch embeddings in the batch: launch.train refuses them)
TRAIN_ARCHS = ("llama3-8b", "gemma2-2b", "mistral-nemo-12b", "qwen2-72b",
               "mamba2-780m", "zamba2-7b", "llama4-maverick-400b-a17b",
               "grok-1-314b")
TRAIN_REDUCED = ["--reduced", "--steps", "8", "--batch", "4", "--seq", "64",
                 "--log-every", "1"]
TRAIN_FULL = ["--batch", "8", "--seq", "256", "--steps", "10",
              "--log-every", "1"]
STEP_LINE = re.compile(r"\[train\] step=(\d+) loss=(\S+) ce=(\S+) "
                       r"gnorm=(\S+) lr=(\S+) step_ms=(\S+)")
OPT_BYTES_PER_PARAM = 22   # bf16 p, g read; f32 m, v read and written; p written
RESUME_TOL = 1e-5
CARD_CPU_LOSS_RTOL, CARD_CPU_PARAM_ATOL = 1e-5, 1e-4
ADAM_ILL = 100        # x AdamW's eps: a clipped gradient below it is near eps


class _Tee:
    """Standard output copied into a buffer as it is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def train_launches(cfg, steps: int) -> dict:
    """The kernel launches ``steps`` train steps of ``cfg`` make, one
    microbatch a step as every run here: K5 (with its lse) once an
    attention call and again in the recompute under remat, K5-bwd once;
    none with the 'masked' backend
    (its full-score plain attention) and no other kernel."""
    want = {n: 0 for n in KERNELS}
    want["decode_attention_partial"] = 0
    if cfg.attn_backend != "masked":
        n = attention_layers(cfg) * steps
        remat = cfg.remat and cfg.remat_policy != "none"
        want["flash_attention"] = n * (2 if remat else 1)
        want["flash_attention_bwd"] = n
    return want


def check_train_paths(label: str, cfg, launches: dict, plain: dict,
                      steps: int) -> None:
    """A train run's launches are ``train_launches``'; it called the plain
    SSD where the model has one and no plain attention (but the full-score
    version, the 'masked' backend's train path)."""
    want = train_launches(cfg, steps)
    bad = []
    if launches != want:
        bad.append(f"launches {launches}, want {want}")
    if cfg.family in ("ssm", "hybrid") and not plain.get("ssd_chunk_plain"):
        bad.append("the plain SSD was never called")
    masked = cfg.attn_backend == "masked" and cfg.family != "ssm"
    attn_plain = {n: c for n, c in plain.items() if n != "ssd_chunk_plain"}
    if masked != bool(attn_plain.get("flash_attention_plain")) or \
            set(attn_plain) - {"flash_attention_plain"}:
        bad.append(f"plain attention calls {attn_plain}")
    if bad:
        raise SystemExit(f"train[{label}]: {bad}")


def train_run(label: str, cfg, argv: list, mesh=None) -> dict:
    """``launch.train.main(argv, cfg=cfg, mesh=mesh)`` with every launch
    counter zeroed before and read after, and the plain attention/SSD
    calls counted; the run's K5 and K5-bwd launches must be what its
    config and steps imply and every other kernel's 0
    (``check_train_paths``; every run here logs each step). Returns the
    logged steps, the final metrics, the launches, the plain calls and the
    run's peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    with plain_calls() as plain, contextlib.redirect_stdout(tee):
        zero_launches()
        metrics = train_cli.main(argv, cfg=cfg, mesh=mesh)
        torch.cuda.synchronize()
        launches = read_launches()
    steps = [dict(step=int(m[1]), loss=float(m[2]), ce=float(m[3]),
                  gnorm=float(m[4]), lr=float(m[5]), step_ms=float(m[6]))
             for m in STEP_LINE.finditer("".join(tee.text))]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_train_paths(label, cfg, launches, plain, len(steps))
    finite = all(math.isfinite(x) for st in steps
                 for x in (st["loss"], st["gnorm"])) and \
        all(math.isfinite(v) for v in metrics.values())
    if not steps or not finite:
        raise SystemExit(f"train[{label}]: non-finite or missing steps "
                         f"{steps} {metrics}")
    return dict(steps=steps, metrics=metrics, launches=launches,
                plain=dict(plain), peak_gib=peak)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def flash_bwd_case(name, B, Sq, Skv, Hq, Hkv, D, dtype, gen, **kw) -> dict:
    """The training pair at one shape: K5 with its lse against
    ``flash_attention_lse_plain``, then K5-bwd against
    ``flash_attention_bwd_plain`` on the same (out, lse, dout): out, dq,
    dk and dv within ATOL x their largest |want|, lse within LSE_ATOL x
    its largest |want|. Times: K5-bwd, its plain version, K5 with its
    lse, and the library call's backward: SDPA's where the shape has
    neither a softcap nor a window (``backward_ms``, its gradients held
    to the plain backward's at the row's tolerance), else the compiled
    ``flex_attention``'s, left in the row under "flex_bwd" for
    ``flex_backward_times`` at the end of the run. The bound is 2.5x the
    forward's operations over the live pairs at the input type's rate,
    with q, k, v, out, lse and dout read once and dq, dk, dv written."""
    q = _softcap_q(_randn((B, Sq, Hq, D), dtype, gen), kw.get("attn_softcap"))
    k = _randn((B, Skv, Hkv, D), dtype, gen)
    v = _randn((B, Skv, Hkv, D), dtype, gen)
    do = _randn((B, Sq, Hq, D), dtype, gen)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    w_out, w_lse = flash_attention_lse_plain(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()

    def err(a, b):
        return (float((a.float() - b.float()).abs().max()),
                float(b.float().abs().max()))
    errs = {n: err(a, b) for n, a, b in zip(
        ("out", "dq", "dk", "dv"), (out, *grads), (w_out, *want))}
    errs["lse"] = err(lse, w_lse)
    tols = {n: (LSE_ATOL if n == "lse" else ATOL[dtype]) * sc
            for n, (_, sc) in errs.items()}
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw),
                 iters=5)
    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=2, reps=2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    do_t = do.transpose(1, 2)
    causal = kw.get("causal", True)
    lib = dict(library_ms=None, library_err=None, library_ok=None)
    if not kw.get("attn_softcap") and not kw.get("window"):
        def sdpa():
            return _sdpa_gqa(qt, kt, vt, is_causal=causal)
        got = torch.autograd.grad(sdpa(), (qt, kt, vt), do_t)
        lib.update(_library_grad_errs(got, want, ATOL[dtype]),
                   library_ms=backward_ms(sdpa, (qt, kt, vt), do_t))
        del got
    else:
        lib["flex_bwd"] = (qt, kt, vt, do_t, kw.get("attn_softcap", 0.0),
                           causal, kw.get("window", 0), want)
    kv_len = Skv if kw.get("seq_len") is None else kw["seq_len"]
    pairs = _live_pairs(Sq, Skv, kw.get("causal", True), kw.get("window", 0),
                        kv_len)
    # q, out, dout, dq and k, v, dk, dv: four of each size, and lse
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() + lse.numel() * 4
    dq_err = max(errs[n][0] for n in ("dq", "dk", "dv"))
    row = dict(kernel="flash_attention_bwd", case=name, max_abs_err=dq_err,
               errs={n: e for n, (e, _) in errs.items()},
               scales={n: sc for n, (_, sc) in errs.items()},
               ok=all(errs[n][0] <= tols[n] for n in errs),
               ms=ms, fwd_lse_ms=fwd_ms, plain_ms=plain_ms, tol=ATOL[dtype],
               **lib, **bound(nbytes, 2.5 * 4.0 * D * Hq * B * pairs, dtype))
    del q, k, v, do, out, lse, grads, w_out, w_lse
    return row


def _library_grad_errs(got, want, atol: float) -> dict:
    """A library backward's (dq, dk, dv), laid out (B, H, S, D), against
    the plain backward's: the largest abs error, and whether each tensor
    is within ``atol`` x its largest |want|."""
    errs = [(float((g.transpose(1, 2).float() - w.float()).abs().max()),
             float(w.float().abs().max())) for g, w in zip(got, want)]
    return dict(library_err=max(e for e, _ in errs),
                library_ok=all(e <= atol * sc for e, sc in errs))


def flex_backward_times(rows) -> None:
    """K5-bwd's library call at its softcap/window rows (SDPA has no
    softcap): the gradient of the compiled ``flex_attention`` (the
    softcap as a ``softcap * tanh(s / softcap)`` score_mod, the causal
    mask and window as a block mask, GQA) through autograd, warmed and
    timed by ``backward_ms``; its gradients held to the plain backward's
    at the row's tolerance. Run with ``softcap_library_times``, after
    every profiler pass. The port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask
    flex = _compiled_flex()
    for r in rows:
        if "flex_bwd" not in r:
            continue
        qt, kt, vt, do_t, softcap, causal, window, want = r.pop("flex_bwd")
        B, _, Sq, _ = qt.shape

        def score_mod(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)

        def mask_mod(b, h, q_idx, kv_idx):
            live = kv_idx <= q_idx if causal else kv_idx >= 0
            return live & (q_idx - kv_idx < window) if window else live
        block_mask = create_block_mask(mask_mod, B, None, Sq, kt.shape[2],
                                       device="cuda")

        def call():
            return flex(qt, kt, vt, score_mod=score_mod if softcap else None,
                        block_mask=block_mask, enable_gqa=True)
        got = torch.autograd.grad(call(), (qt, kt, vt), do_t)
        r.update(_library_grad_errs(got, want, r["tol"]))
        del got
        r["library_ms"] = backward_ms(call, (qt, kt, vt), do_t)
        log(f"library flash_attention_bwd {r['case']:50s} flex_attention's "
            f"backward: ms={r['library_ms']:.4f} max_abs_err="
            f"{r['library_err']:.3e} within {r['tol']:.0e} x max|want|: "
            f"{r['library_ok']} (K5-bwd ms {r['ms']:.4f}; {bwd_standing(r)})")
    bad = [r["case"] for r in rows if r["library_ok"] is False]
    if bad:
        raise SystemExit(f"the library backward disagrees with the plain "
                         f"backward at {bad}")


# the training pair's shapes: the long-sequence run's (the main row), phase
# 4h's full-width and reduced runs', and every train-capable family's
TRAIN_ATTN_ROWS = [
    ("llama3_8b_B1_S4096_bf16", 1, 4096, 4096, 32, 8, 128,
     torch.bfloat16, {}),
    ("llama3_8b_B8_S256_bf16", 8, 256, 256, 32, 8, 128, torch.bfloat16, {}),
    ("llama3_8b_B1_S2048_bf16", 1, 2048, 2048, 32, 8, 128, torch.bfloat16,
     {}),
    ("zamba2_7b_B1_S2048_D112_bf16", 1, 2048, 2048, 32, 32, 112,
     torch.bfloat16, {}),
    ("gemma2_2b_B1_S4608_window4096_softcap50_D256_bf16", 1, 4608, 4608, 8,
     4, 256, torch.bfloat16,
     dict(window=GEMMA_WINDOW, attn_softcap=GEMMA_SOFTCAP)),
    ("grok1_B1_S2048_G6_softcap30_bf16", 1, 2048, 2048, 48, 8, 128,
     torch.bfloat16, dict(attn_softcap=30.0)),
    ("whisper_encoder_S1500_bf16", 1, 1500, 1500, 6, 6, 64, torch.bfloat16,
     dict(causal=False)),
    ("whisper_cross_17x1500_bf16", 1, 17, 1500, 6, 6, 64, torch.bfloat16,
     dict(causal=False)),
    ("reduced_B4_S64_f32", 4, 64, 64, 4, 2, 32, torch.float32, {}),
]


# K5-bwd's time at each row when FFMA kernels ran both dtypes, before the
# bf16 path moved to wgmma (PERF.md section 6, in brackets); each row logs
# this run's time beside it
FFMA_BWD_MS = {
    "llama3_8b_B1_S4096_bf16": 28.254, "llama3_8b_B8_S256_bf16": 1.3528,
    "llama3_8b_B1_S2048_bf16": 8.786, "zamba2_7b_B1_S2048_D112_bf16": 5.411,
    "gemma2_2b_B1_S4608_window4096_softcap50_D256_bf16": 22.432,
    "grok1_B1_S2048_G6_softcap30_bf16": 13.622,
    "whisper_encoder_S1500_bf16": 0.9100,
    "whisper_cross_17x1500_bf16": 0.2579, "reduced_B4_S64_f32": 0.0322,
}


def bwd_standing(r) -> str:
    """K5-bwd's share of its bound, its ratio to the library backward
    (where timed) and the FFMA kernels' time at the row."""
    out = f"share of bound {r['bound_ms'] / r['ms']:.4f}"
    if r.get("library_ms"):
        out += f", {r['ms'] / r['library_ms']:.2f}x the library's backward"
    was = FFMA_BWD_MS.get(r["case"])
    if was is not None:
        out += f", FFMA {was:.4f} ms ({was / r['ms']:.1f}x this)"
    return out


def train_kernel_checks() -> dict:
    """``flash_bwd_case`` at TRAIN_ATTN_ROWS; fails on any error past its
    tolerance."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for name, B, Sq, Skv, Hq, Hkv, D, dtype, kw in TRAIN_ATTN_ROWS:
        r = flash_bwd_case(name, B, Sq, Skv, Hq, Hkv, D, dtype, gen, **kw)
        lib = "flex_attention's at the end" if "flex_bwd" in r else \
            f"{r['library_ms']:.4f} (SDPA's, max_abs_err " \
            f"{r['library_err']:.3e})"
        log(f"check flash_attention_bwd {name}: errs "
            f"{ {n: f'{e:.3e}' for n, e in r['errs'].items()} } max|want| "
            f"{ {n: f'{x:.3g}' for n, x in r['scales'].items()} } tol "
            f"{r['tol']:.0e} (lse {LSE_ATOL:.0e}) x max|want|; K5-bwd "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_backward_ms={lib} K5-with-lse ms={r['fwd_lse_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}; bytes "
            f"{r['bytes_ms']:.5f}, ops {r['ops_ms']:.5f}); {bwd_standing(r)}")
        rows[name] = r
        _free()
    bad = [n for n, r in rows.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"the training pair disagrees with its plain "
                         f"versions at {bad}")
    bad = [n for n, r in rows.items() if r["library_ok"] is False]
    if bad:
        raise SystemExit(f"SDPA's backward disagrees with the plain "
                         f"backward at {bad}")
    return rows


LONG_TRAIN_SEQ, LONG_TRAIN_STEPS = 4096, 5
# kernel path vs full-score path, from the same seed-0 parameters: step 0's
# loss (read 2.06e-4 on the card) and one forward + backward's gradients,
# each tensor's |got - want| / |want| in the 2-norm (the worst read 2.5e-2;
# the kernel path rounds P to bf16 for P V, the full-score path keeps f32)
LONG_LOSS_ATOL = 1e-3
LONG_GRAD_RTOL = 5e-2


def long_seq_train_run(smi: str) -> dict:
    """llama3-8b, 8 of 32 layers at full width (bf16, remat "full"), B=1
    S=LONG_TRAIN_SEQ, LONG_TRAIN_STEPS steps of ``make_train_step`` from
    the same seed-0 parameters on one batch (so the loss falls step by
    step; batches of random tokens move it more than 5 steps of training
    do) on the kernel path (K5 with lse, K5-bwd) and on the full-score
    path (``attn_backend="masked"``, the plain attention through
    autograd), in turns in this call: each step's host time, a profiled
    step's device-busy share, the step's peak memory and the peak of one
    forward + backward alone at the seed-0 parameters (the optimizer's
    temporaries set the step's peak on both paths); then the two paths'
    gradients at those parameters (``long_grad_check``). Fails unless the
    launches are what the config implies, the losses are finite and
    falling, step 0's losses agree within LONG_LOSS_ATOL, every gradient
    tensor within LONG_GRAD_RTOL and the kernel path's forward + backward
    peak is below the full-score path's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLM
    base = dataclasses.replace(get_config("llama3-8b"), num_layers=8)
    S = LONG_TRAIN_SEQ
    batch = {"tokens": torch.from_numpy(SyntheticLM(
        base.vocab_size, seed=0).batch(0, 1, S)).cuda()}
    out = {}
    for label, cfg in (("kernel", base),
                       ("masked", dataclasses.replace(
                           base, attn_backend="masked"))):
        model = build(cfg, device="cuda")
        ocfg = opt_config_for(cfg, lr=3e-4)
        params, opt = init_state(model, ocfg, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads, _ = _value_and_grad(model.loss, params, batch)
        torch.cuda.synchronize()
        fb_peak = torch.cuda.max_memory_allocated() / 2**30
        del grads
        _free()
        step = make_train_step(model, ocfg, donate=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        with plain_calls() as plain:
            zero_launches()
            for _ in range(LONG_TRAIN_STEPS):
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_launches()
        plain = dict(plain)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_train_paths(f"long {label}", cfg, launches, plain,
                          LONG_TRAIN_STEPS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, busy = busy_share(prof, "")
        del prof, params, opt, m, model, step
        _free()
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        out[label] = dict(losses=losses, step_ms=step_ms, steady_step_ms=steady,
                          busy_ms=busy_ms, busy_share=busy,
                          profiled_step_ms=prof_ms, peak_gib=peak,
                          fwd_bwd_peak_gib=fb_peak, launches=launches,
                          plain=plain)
        log(f"train[llama3-8b 8L B=1 S={S} {label}] losses {losses}; step "
            f"host ms {[round(x, 2) for x in step_ms]} (median of steps 1+ "
            f"{steady:.2f}); profiled step {prof_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms, share {busy:.3f}; peak {peak:.2f} GiB a "
            f"step, {fb_peak:.2f} GiB forward + backward alone; launches "
            f"{ {n: c for n, c in launches.items() if c} }; plain calls "
            f"{plain} | {smi}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise SystemExit(f"train[long {label}]: losses not finite and "
                             f"falling: {losses}")
    k, f = out["kernel"], out["masked"]
    g = out["grad_rel_err"] = long_grad_check(base, batch)
    d0 = abs(k["losses"][0] - f["losses"][0])
    log(f"train[llama3-8b 8L B=1 S={S}] kernel path against full scores: "
        f"step {k['steady_step_ms']:.2f} vs {f['steady_step_ms']:.2f} ms, "
        f"busy {k['busy_share']:.3f} vs {f['busy_share']:.3f}, forward + "
        f"backward peak {k['fwd_bwd_peak_gib']:.2f} vs "
        f"{f['fwd_bwd_peak_gib']:.2f} GiB, step peak {k['peak_gib']:.2f} vs "
        f"{f['peak_gib']:.2f} GiB; step 0 loss |diff| {d0:.3g} (tolerance "
        f"{LONG_LOSS_ATOL}); gradients at the seed-0 parameters, "
        f"|diff| / |full-score| a tensor: worst {g['worst']:.3e} "
        f"({g['worst_tensor']}), median {g['median']:.3e} (tolerance "
        f"{LONG_GRAD_RTOL}) | {smi}")
    if d0 > LONG_LOSS_ATOL or not g["worst"] <= LONG_GRAD_RTOL or \
            not k["fwd_bwd_peak_gib"] < f["fwd_bwd_peak_gib"]:
        raise SystemExit("train[long]: the kernel path's loss, gradients or "
                         "memory are off against the full-score path")
    return out


def long_grad_check(cfg, batch) -> dict:
    """One forward + backward of ``cfg`` on ``batch`` at the seed-0
    parameters through the kernel path and through the full-score path
    (``attn_backend="masked"``): each gradient tensor's |kernel -
    full-score| / |full-score| in the 2-norm; the worst (and its tensor)
    and the median."""
    kernel = build(cfg, device="cuda")
    masked = build(dataclasses.replace(cfg, attn_backend="masked"),
                   device="cuda")
    params = kernel.init(0)
    got, _ = _value_and_grad(kernel.loss, params, batch)
    want, _ = _value_and_grad(masked.loss, params, batch)
    rel = sorted((float((a.float() - b.float()).norm() /
                        b.float().norm().clamp_min(1e-30)), n)
                 for (n, a), (_, b) in zip(_flatten_with_names(got),
                                           _flatten_with_names(want)))
    del params, got, want
    _free()
    return dict(worst=rel[-1][0], worst_tensor=rel[-1][1],
                median=rel[len(rel) // 2][0])


def train_reduced_runs() -> dict:
    """8 steps of each TRAIN_ARCHS config at --reduced: finite, the last
    loss below the first. The 8-bit AdamW configs (llama4, grok-1) diverge
    in both packages (its int8 second moment rounds small entries to 0,
    where the update is m / eps); their runs are held to finiteness and
    repeated with fp32 AdamW for the falling-loss check."""
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        runs = [(arch, None)]
        if cfg.optimizer != "adamw":
            runs.append((f"{arch}+adamw",
                         dataclasses.replace(cfg, optimizer="adamw")))
        for label, over in runs:
            r = train_run(label, over or cfg, TRAIN_REDUCED)
            first, last = r["steps"][0]["loss"], r["steps"][-1]["loss"]
            falls = last < first
            log(f"train[{label}] reduced losses "
                f"{[st['loss'] for st in r['steps']]} gnorms "
                f"{[st['gnorm'] for st in r['steps']]} plain calls "
                f"{r['plain']} launches {r['launches']}")
            eightbit = (over or cfg).optimizer != "adamw"
            if not falls and not eightbit:
                raise SystemExit(f"train[{label}]: last loss {last} not below "
                                 f"the first {first}")
            out[label] = dict(first=first, last=last, falls=falls,
                              plain=r["plain"], launches=r["launches"])
            _free()
    return out


def train_resume_check() -> dict:
    """Reduced llama3-8b, 4 steps with a checkpoint every 2; a second run
    resumes from a directory holding ``step_2`` alone. The restored
    tensors on the card are the saved bytes (sha256 against the
    manifest); step 3's loss agrees within RESUME_TOL."""
    root = OUT / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    base = ["--arch", "llama3-8b", "--reduced", "--steps", "4", "--batch",
            "4", "--seq", "64", "--log-every", "1", "--ckpt-every", "2"]
    cfg = get_config("llama3-8b").reduced()
    full = train_run("ckpt", cfg, base + ["--ckpt-dir", str(root / "full")])
    steps = CheckpointManager(str(root / "full")).all_steps()
    if steps != [2, 4]:
        raise SystemExit(f"train[ckpt]: checkpoints {steps}, want [2, 4]")
    shutil.copytree(root / "full" / "step_0000000002",
                    root / "resume" / "step_0000000002")
    # the restored tensors on the card carry the saved bytes
    cm = CheckpointManager(str(root / "resume"))
    model = build(cfg, device="cuda")
    params, opt = init_state(model, opt_config_for(cfg), 0)
    back = cm.restore(2, {"params": params, "opt": opt})
    entries = cm.manifest(2)["entries"]
    named = _flatten_with_names(back)
    bad = [n for n, t in named
           if _sha256(_to_storable(t)[0]) != entries[n]["sha256"]
           or t.device.type != "cuda"]
    if bad or len(named) != len(entries):
        raise SystemExit(f"train[resume]: restored tensors differ from the "
                         f"saved ones: {bad[:5]}")
    del params, opt, back
    resumed = train_run("resume", cfg, base + ["--ckpt-dir",
                                               str(root / "resume"),
                                               "--resume"])
    a, b = full["metrics"]["loss"], resumed["metrics"]["loss"]
    log(f"train[resume] {len(named)} tensors restored on the card, sha256 "
        f"equal to the manifest; step 3 loss uninterrupted {a!r} resumed "
        f"{b!r} (|diff| {abs(a - b):.3g}, tolerance {RESUME_TOL})")
    if abs(a - b) > RESUME_TOL or [s["step"] for s in resumed["steps"]] \
            != [2, 3]:
        raise SystemExit(f"train[resume]: step 3 loss {b} vs {a}, steps "
                         f"{resumed['steps']}")
    _free()
    return dict(tensors=len(named), loss=a, resumed_loss=b)


def train_moe_8bit_check() -> dict:
    """grok-1 reduced, adamw8bit, 4 steps: moe_lb > 0, loss >= ce."""
    r = train_run("grok-1 8bit", get_config("grok-1-314b").reduced(),
                  ["--steps", "4", "--batch", "4", "--seq", "64",
                   "--log-every", "1"])
    m = r["metrics"]
    log(f"train[grok-1 8bit] last metrics {m}")
    if not (m["moe_lb"] > 0 and m["loss"] >= m["ce"]):
        raise SystemExit(f"train[grok-1 8bit]: moe_lb {m['moe_lb']}, loss "
                         f"{m['loss']} < ce {m['ce']}")
    _free()
    return m


def matmul_params(cfg) -> int:
    """Parameters that enter a matmul once a token: all but the embedding
    table when it is not also the head, the norms' and the SSM's per-head
    vectors (small, counted in: a floor stays a floor)."""
    n = cfg.param_count()
    if not cfg.tie_embeddings:
        n -= cfg.padded_vocab * cfg.d_model
    return n


def train_full_width(label: str, cfg, argv: list, smi: str) -> dict:
    """10 steps through ``main(argv, cfg=cfg)``, then one profiled step
    and the optimizer's own time on fresh weights of the same config."""
    n_params = cfg.param_count()
    weights_gib = n_params * 2 / 2**30
    log(f"train[{label}] {cfg.num_layers} layers, d={cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} G parameters: bf16 weights "
        f"{weights_gib:.2f} GiB, state (bf16 p and g, f32 m and v) "
        f"{n_params * 12 / 2**30:.1f} GiB | {smi}")
    r = train_run(label, cfg, argv)
    losses = [st["loss"] for st in r["steps"]]
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise SystemExit(f"train[{label}]: mean of the last three losses not "
                         f"below the first: {losses}")
    _free()
    B, S = 8, 256
    tokens = B * S
    model = build(cfg, device="cuda")
    ocfg = opt_config_for(cfg, lr=3e-4)
    params, opt = init_state(model, ocfg, 0)
    step = make_train_step(model, ocfg, donate=True)
    gen = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(gen.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()}
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, busy = busy_share(prof, "")
    grads, _ = _value_and_grad(model.loss, params, batch)
    opt_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            params, opt, _ = adamw_update(ocfg, params, grads, opt,
                                          donate=True)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
    del grads, params, opt, m
    _free()
    step_ms = [st["step_ms"] for st in r["steps"]]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]    # median, steps 1+
    opt_share = min(opt_ms) / steady
    flops = 8 * matmul_params(cfg) * tokens   # fwd 2 + remat 2 + bwd 4
    mm_floor = flops / PEAK_OPS[torch.bfloat16] * 1e3
    opt_floor = n_params * OPT_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3
    out = dict(losses=losses, step_ms=step_ms, steady_step_ms=steady,
               tokens_per_s=tokens / steady * 1e3, busy_share=busy,
               busy_ms=busy_ms, profiled_step_ms=prof_ms,
               optimizer_ms=min(opt_ms), optimizer_share=opt_share,
               weights_gib=weights_gib, peak_gib=r["peak_gib"],
               matmul_floor_ms=mm_floor, optimizer_floor_ms=opt_floor,
               plain=r["plain"], launches=r["launches"])
    log(f"train[{label}] losses {losses}")
    log(f"train[{label}] step host ms {[round(x, 2) for x in step_ms]} "
        f"(median of steps 1+ {steady:.2f} ms, {tokens / steady * 1e3:.0f} "
        f"tokens/s); profiled step {prof_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, share {busy:.3f}; optimizer {min(opt_ms):.2f} ms "
        f"(runs {[round(x, 2) for x in opt_ms]}), share {opt_share:.3f}; "
        f"floors: matmul {mm_floor:.1f} ms ({flops / 1e12:.1f} TFLOP at "
        f"989 TFLOPS bf16), optimizer bytes {opt_floor:.1f} ms "
        f"({OPT_BYTES_PER_PARAM} B a parameter at 3.35 TB/s); weights "
        f"{weights_gib:.2f} GiB, peak memory {r['peak_gib']:.2f} GiB | {smi}")
    return out


def card_cpu_train_check() -> dict:
    """Reduced llama3-8b: ``make_train_step`` x3 on the card and on the
    CPU from the same parameters and batches, f32 with TF32 off: loss
    within 1e-5 relative, parameters within 1e-4. AdamW divides by
    |g| + eps (1e-8): where a clipped gradient is near eps, the f32
    rounding of g (1e-7 of a leaf's largest |g|, summed in another order
    on each device) moves the update by up to 2 lr a step. Elements whose
    clipped CPU gradient fell below ADAM_ILL (100 eps) but not to 0 at a
    step are counted and held to that bound instead."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim.optimizer import clip_by_global_norm
    cfg = get_config("llama3-8b").reduced()
    cpu_model = build(cfg, device="cpu")
    card_model = build(cfg, device="cuda")
    lr, steps = 1e-3, 3
    ocfg = opt_config_for(cfg, lr=lr)
    p_cpu, o_cpu = init_state(cpu_model, ocfg, 0)
    p_card = tree_map(lambda t: t.cuda(), p_cpu)
    o_card = tree_map(lambda t: t.cuda(), o_cpu)
    s_cpu = make_train_step(cpu_model, ocfg)
    s_card = make_train_step(card_model, ocfg)
    ds = SyntheticLM(cfg.vocab_size, seed=3)
    worst_loss = 0.0
    ill = [torch.zeros(t.shape, dtype=torch.bool) for t in tree_leaves(p_cpu)]
    for i in range(steps):
        toks = torch.from_numpy(ds.batch(i, 4, 64))
        grads, _ = _value_and_grad(cpu_model.loss, p_cpu, {"tokens": toks})
        clipped, _ = clip_by_global_norm(grads, ocfg.max_grad_norm)
        for m, g in zip(ill, tree_leaves(clipped)):
            m |= (g != 0) & (g.abs() < ADAM_ILL * ocfg.eps)
        p_cpu, o_cpu, m_cpu = s_cpu(p_cpu, o_cpu, {"tokens": toks})
        p_card, o_card, m_card = s_card(p_card, o_card,
                                        {"tokens": toks.cuda()})
        rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / \
            abs(float(m_cpu["loss"]))
        worst_loss = max(worst_loss, rel)
    worst_p = worst_ill = 0.0
    n_ill = 0
    for m, a, b in zip(ill, tree_leaves(p_card), tree_leaves(p_cpu)):
        d = (a.cpu() - b).abs()
        worst_p = max(worst_p, float(d[~m].max()) if (~m).any() else 0.0)
        if m.any():
            worst_ill = max(worst_ill, float(d[m].max()))
            n_ill += int(m.sum())
    ill_bound = 2 * lr * steps
    log(f"train[card vs cpu] reduced llama3-8b, {steps} steps: loss rel diff "
        f"{worst_loss:.3g} (tolerance {CARD_CPU_LOSS_RTOL}), params max abs "
        f"diff {worst_p:.3g} (tolerance {CARD_CPU_PARAM_ATOL}); {n_ill} "
        f"elements with a nonzero clipped gradient under {ADAM_ILL} eps: "
        f"max abs "
        f"diff {worst_ill:.3g} (bound {ill_bound})")
    if worst_loss > CARD_CPU_LOSS_RTOL or worst_p > CARD_CPU_PARAM_ATOL or \
            worst_ill > ill_bound:
        raise SystemExit("train[card vs cpu]: the card's train step "
                         "disagrees with the CPU's")
    return dict(loss_rel=worst_loss, param_abs=worst_p, ill_elements=n_ill,
                ill_param_abs=worst_ill)


def train_phase(smi: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = dict(kernel_rows=train_kernel_checks(),
               reduced=train_reduced_runs(), resume=train_resume_check(),
               grok_8bit=train_moe_8bit_check())
    out["llama3_8b_8_layers"] = train_full_width(
        "llama3-8b 8L", dataclasses.replace(get_config("llama3-8b"),
                                            num_layers=8),
        TRAIN_FULL + ["--lr", "3e-4"], smi)
    out["mamba2_780m"] = train_full_width(
        "mamba2-780m", get_config("mamba2-780m"),
        ["--arch", "mamba2-780m"] + TRAIN_FULL, smi)
    out["card_vs_cpu"] = card_cpu_train_check()
    out["long"] = long_seq_train_run(smi)
    log(f"train phase {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4i: the mesh — K4's shard mode, the sharded model, the dry run
# ---------------------------------------------------------------------------

MESH_STEPS = 8        # meshed decode steps at 4 slots
DECODE_PEAK_MARGIN = 0.02   # dry-run decode peak over arguments (1.0002)
MESH_PROMPT = 2048
MESH_CACHE = 4096


def _shard_bounds(S: int, n: int) -> list:
    """n contiguous shards of S positions (the last ones shorter when n
    does not divide S): [(off, S_loc), ...]."""
    step = -(-S // n)
    return [(o, min(step, S - o)) for o in range(0, S, step)]


def shard_case(name, B, S, valid, n, dtype, gen, Hq=32, Hkv=8, D=128,
               window=0, softcap=0.0) -> dict:
    """K4's shard mode on n sequence shards of one cache: each shard's (o,
    lse) against the plain partial, their merge on the card against the
    unsharded K4 and the plain version; each shard call's device time, the
    merge's, and at the longest live shard the plain partial's, SDPA over
    the shard's live keys, and the bound."""
    q = _softcap_q(_randn((B, 1, Hq, D), dtype, gen), softcap)
    k = _randn((B, S, Hkv, D), dtype, gen)
    v = _randn((B, S, Hkv, D), dtype, gen)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    kw = dict(attn_softcap=softcap, window=window)
    tol = ATOL[dtype]
    shards = [(o, L, k[:, o:o + L].contiguous(), v[:, o:o + L].contiguous())
              for o, L in _shard_bounds(S, n)]
    before = decode_attention_partial.launches
    parts, wants, err, lse_err, empty = [], [], 0.0, 0.0, 0
    for o, L, ks, vs in shards:
        got = decode_attention_partial(q, ks, vs, vl, off=o, seq_len=S, **kw)
        want = decode_attention_partial_plain(q, ks, vs, vl, off=o,
                                              seq_len=S, **kw)
        if not torch.equal(torch.isinf(got[1]), torch.isinf(want[1])):
            raise SystemExit(f"shard {name} n={n} off={o}: empty rows differ")
        live = torch.isfinite(want[1])
        empty += int((~live).all(dim=1).sum())
        err = max(err, float((got[0].float() - want[0].float()).abs().max()))
        if live.any():
            lse_err = max(lse_err,
                          float((got[1][live] - want[1][live]).abs().max()))
        parts.append(got)
        wants.append(want)
    launched = decode_attention_partial.launches - before
    merged = merge_decode_partials([p[0] for p in parts],
                                   [p[1] for p in parts])
    plain = decode_attention_plain(q, k, v, vl, **kw)
    whole = decode_attention(q, k, v, vl, **kw)
    torch.cuda.synchronize()
    err_plain = float((merged.float() - plain.float()).abs().max())
    err_whole = float((merged.float() - whole.float()).abs().max())
    if max(err, err_plain, err_whole) > tol or lse_err > LSE_ATOL or \
            launched != len(shards):
        raise SystemExit(
            f"K4 shard mode {name} n={n}: partial err {err:.3e}, lse err "
            f"{lse_err:.3e} (tol {LSE_ATOL}), merged vs plain "
            f"{err_plain:.3e}, vs unsharded K4 {err_whole:.3e} (tol {tol}); "
            f"{launched} launches for {len(shards)} shards")
    shard_ms = [time_ms(lambda o=o, ks=ks, vs=vs: decode_attention_partial(
        q, ks, vs, vl, off=o, seq_len=S, **kw)) for o, _, ks, vs in shards]
    merge_ms = time_ms(lambda: merge_decode_partials(
        [p[0] for p in parts], [p[1] for p in parts]))
    pos = torch.arange(S, device="cuda")[None, :]
    live = pos < vl[:, None]
    if window:
        live &= pos >= (vl[:, None] - window)
    i = max(range(len(shards)),
            key=lambda j: int(live[:, shards[j][0]:shards[j][0]
                                   + shards[j][1]].sum()))
    o, L, ks, vs = shards[i]
    rows = float(live[:, o:o + L].sum())
    plain_ms = time_ms(lambda: decode_attention_partial_plain(
        q, ks, vs, vl, off=o, seq_len=S, **kw), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, ks, vs))
    mask = live[:, None, None, o:o + L]
    sdpa_ms = time_ms(lambda: _sdpa_gqa(qt, kt, vt, attn_mask=mask))
    flex = {}
    if softcap:
        # the same function in one library call (softcap_library_times):
        # flex_attention over the shard's live range, with its lse
        def mask_mod(b, h, q_idx, kv_idx):
            g = kv_idx + o
            live = g < vl[b]
            return live & (g >= vl[b] - window) if window else live
        flex["flex"] = (qt, kt, vt, softcap, mask_mod, B, 1, L, wants[i])
    nbytes = (2 * q.numel() + 2 * rows * Hkv * D) * q.element_size() + \
        B * Hq * 4 + vl.numel() * 4
    geometry = k4_geometry(B, L, Hkv, D, dtype, window)
    row = dict(kernel="decode_attention_partial", case=f"{name}_n{n}",
               **geometry,
               shards=len(shards), empty_shard_rows=empty,
               max_abs_err=max(err, err_plain, err_whole),
               lse_err=lse_err, lse_tol=LSE_ATOL,
               err_vs_plain=err_plain, err_vs_unsharded=err_whole,
               scale=float(plain.float().abs().max()), tol=tol,
               shard_ms=shard_ms, merge_ms=merge_ms, ms=shard_ms[i],
               timed_shard=i, plain_ms=plain_ms,
               library_ms=None if softcap else sdpa_ms, library_err=None,
               library_lse_err=None, sdpa_without_softcap_ms=sdpa_ms if softcap else None,
               **flex, **bound(nbytes, 4.0 * D * Hq * rows, dtype))
    log(f"K4 shard {row['case']}: {len(shards)} shards ({empty} empty "
        f"(seq, head) rows) err {row['max_abs_err']:.3e} lse err "
        f"{lse_err:.3e} (tol {LSE_ATOL}) (vs plain "
        f"{err_plain:.3e}, vs unsharded {err_whole:.3e}, |want| max "
        f"{row['scale']:.3f}, tol {tol}) shard ms "
        f"{[round(t, 5) for t in shard_ms]} merge {merge_ms:.5f} ms; shard "
        f"{i}: plain {plain_ms:.4f} sdpa {sdpa_ms:.4f} bound "
        f"{row['bound_ms']:.5f} ({row['bound_by']}); launches {launched}; "
        f"shard {i}: {_geometry_text(row)}")
    return row


def shard_mode_checks() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for n in (2, 4, 16):
        rows.append(shard_case("llama3_b4_s4096", 4, 4096,
                               [3, 1000, 2049, 4096], n, bf16, gen))
        rows.append(shard_case(
            "gemma2_b1_s4609", 1, 4609, [4609], n, bf16, gen, Hq=8, Hkv=4,
            D=256, window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP))
    rows.append(shard_case("d112_b2_s1024", 2, 1024, [1024, 300], 4, bf16,
                           gen, Hq=32, Hkv=32, D=112, window=500))
    rows.append(shard_case("d32_b2_s512_f32", 2, 512, [512, 77], 4, f32,
                           gen, Hq=4, Hkv=2, D=32))
    rows.append(shard_case("d32_b2_s512", 2, 512, [512, 77], 4, bf16, gen,
                           Hq=4, Hkv=2, D=32))
    return {r["case"]: r for r in rows}


def _step_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def meshed_model_run() -> dict:
    """llama3-8b at full width (32 layers, seed 0) on a (1, 1) ('data',
    'model') DeviceMesh over a one-rank NCCL group: a 2048-token prefill of
    4 prompts (K5 once a layer, on the rank's heads) and 8 decode steps at
    4 slots over a 4096-position cache (K4's shard mode once a layer a
    step), against the ShardCtx.single() path (tokens equal) and the plain
    path (logits within LOGITS_ATOL); each path's decode step time in this
    call, and one profiled step's device-busy share on each."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore(),
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        cfg = get_config("llama3-8b")
        single = build(cfg, device="cuda")
        plain = build(cfg, device="cuda", plain_kernels=True)
        pctx = ShardCtx.for_mesh(mesh, "prefill")
        dctx = ShardCtx.for_mesh(mesh, "decode")
        pm = build(cfg, pctx, device="cuda")
        dm = build(cfg, dctx, device="cuda")
        params = single.init(0)
        dparams = pctx.distribute(params, pm.param_axes())
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, MESH_PROMPT)).astype(np.int32)).cuda()
        runs = {}
        for label, m, p in (("single", single, params),
                            ("plain", plain, params)):
            logits, caches = m.prefill(p, {"tokens": tokens}, MESH_CACHE)
            runs[label] = dict(model=m, params=p, caches=caches,
                               logits=[logits[:, -1].float()])
        zero_launches()
        batch = pctx.distribute({"tokens": tokens},
                                {"tokens": pm.input_specs(
                                    SHAPES["prefill_32k"])[1]["tokens"]})
        t_pre = time.perf_counter()
        logits, caches = pm.prefill(dparams, batch, MESH_CACHE)
        caches = dctx.constrain_tree(caches, dm.cache_axes())
        torch.cuda.synchronize()
        t_pre = (time.perf_counter() - t_pre) * 1e3
        pre_launches = read_launches()
        runs["mesh"] = dict(model=dm, params=dparams, caches=caches,
                            logits=[logits.full_tensor()[:, -1].float()])
        if pre_launches["flash_attention"] != cfg.num_layers:
            raise SystemExit(f"meshed prefill: K5 launched "
                             f"{pre_launches['flash_attention']} times, want "
                             f"{cfg.num_layers}")
        toks = {k: [torch.argmax(r["logits"][0], -1)] for k, r in runs.items()}
        times = {k: [] for k in runs}
        per_step = []
        for step in range(MESH_STEPS):
            pos = torch.full((4,), MESH_PROMPT + step, dtype=torch.int32,
                             device="cuda")
            nxt = toks["single"][-1].to(torch.int32)[:, None]
            for label, r in runs.items():
                zero_launches()
                out = {}

                def go(r=r, out=out):
                    out["l"], r["caches"] = r["model"].decode_step(
                        r["params"], r["caches"], nxt, pos)
                times[label].append(_step_ms(go))
                lg = out["l"]
                lg = lg.full_tensor() if label == "mesh" else lg
                r["logits"].append(lg[:, -1].float())
                toks[label].append(torch.argmax(lg[:, -1], -1))
                if label == "mesh":
                    per_step.append(read_launches())
        for i, ln in enumerate(per_step):
            if ln["decode_attention_partial"] != cfg.num_layers or \
                    ln["decode_attention"]:
                raise SystemExit(f"meshed decode step {i}: K4 shard mode "
                                 f"{ln['decode_attention_partial']} launches "
                                 f"(want {cfg.num_layers}), unsharded K4 "
                                 f"{ln['decode_attention']} (want 0)")
        same = all(bool(torch.equal(a, b))
                   for a, b in zip(toks["mesh"], toks["single"]))
        err_plain = max(float((a - b).abs().max()) for a, b in
                        zip(runs["mesh"]["logits"], runs["plain"]["logits"]))
        err_single = max(float((a - b).abs().max()) for a, b in
                         zip(runs["mesh"]["logits"], runs["single"]["logits"]))
        if not same or not math.isfinite(err_plain) or \
                err_plain > LOGITS_ATOL:
            raise SystemExit(f"meshed llama3-8b: tokens equal {same}, logits "
                             f"vs plain {err_plain:.3e} (tol {LOGITS_ATOL})")
        busy = {}
        for label in ("single", "mesh"):
            r = runs[label]
            pos = torch.full((4,), MESH_PROMPT + MESH_STEPS,
                             dtype=torch.int32, device="cuda")
            nxt = toks["single"][-1].to(torch.int32)[:, None]
            r["model"].decode_step(r["params"], r["caches"], nxt, pos)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                r["model"].decode_step(r["params"], r["caches"], nxt, pos)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy_ms, share = busy_share(prof, "")
            busy[label] = dict(busy_ms=busy_ms, wall_ms=wall,
                               share=busy_ms / wall)
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        log(f"mesh llama3-8b (32 layers, mesh {tuple(mesh.shape)}): prefill "
            f"{MESH_PROMPT} x4 {t_pre:.1f} ms, K5 "
            f"{pre_launches['flash_attention']}; decode K4 shard mode "
            f"{[ln['decode_attention_partial'] for ln in per_step]} a step; "
            f"tokens equal single {same}; logits vs plain {err_plain:.4f} "
            f"vs single {err_single:.3e} (tol {LOGITS_ATOL})")
        log(f"mesh decode step ms (median of {MESH_STEPS}): single "
            f"{med['single']:.2f} mesh {med['mesh']:.2f} plain "
            f"{med['plain']:.2f}; all single "
            f"{[round(t, 2) for t in times['single']]} mesh "
            f"{[round(t, 2) for t in times['mesh']]}; profiled step busy "
            + ", ".join(f"{k} {v['busy_ms']:.2f}/{v['wall_ms']:.2f} ms "
                        f"({v['share']:.3f})" for k, v in busy.items()))
        out = dict(prefill_ms=t_pre, prefill_launches=pre_launches,
                   step_launches=per_step, tokens_equal=same,
                   err_plain=err_plain, err_single=err_single,
                   step_ms=times, median_ms=med, busy=busy)
        del runs, params, dparams, caches, logits
        gc.collect()
        torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


def dryrun_cells() -> dict:
    """The dry run on this host (fake tensors, a fake 512-rank group: host
    work): llama3-8b's inference cells on the pod mesh and mamba2-780m's
    long_500k on both meshes, then their roofline rows."""
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    recs = {}
    for args in (["--arch", "llama3-8b", "--shape", "prefill_32k",
                  "decode_32k", "long_500k", "--mesh", "pod"],
                 ["--arch", "mamba2-780m", "--shape", "long_500k", "--mesh",
                  "both"]):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(out_dir)], env=env, capture_output=True,
            text=True, timeout=300)
        for line in res.stdout.splitlines():
            log(line)
        if res.returncode:
            raise SystemExit(f"dry run {args} failed: {res.stderr[-2000:]}")
        log(f"dry run {' '.join(args)}: {time.perf_counter() - t0:.1f}s")
    for path in sorted(out_dir.glob("*.json")):
        rec = json.loads(path.read_text())
        recs[path.stem] = {k: rec.get(k) for k in (
            "status", "memory", "collectives", "timing", "device")}
        if rec["status"] == "OK":
            recs[path.stem]["flops"] = rec["cost"]["flops"]
            recs[path.stem]["bytes_accessed"] = rec["cost"]["bytes_accessed"]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--results",
         str(out_dir)], env=env, capture_output=True, text=True, timeout=120)
    if res.returncode:
        raise SystemExit(f"roofline failed: {res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        if line.strip():
            log(f"roofline {line}")
    bad = [k for k, r in recs.items() if r["status"] == "FAIL"]
    if bad or not any(r["status"] == "OK" for r in recs.values()):
        raise SystemExit(f"dry run cells failed: {bad}")
    # a decode cell holds little beside its arguments: a peak above them by
    # more than DECODE_PEAK_MARGIN is DTensor's global-shape propagation
    # tallied as a rank's work (it read 75x on this host once)
    over = {k: r["memory"]["peak_bytes_per_device"]
            / r["memory"]["argument_bytes"] for k, r in recs.items()
            if r["status"] == "OK" and ("decode_32k" in k or "long_500k" in k)}
    log(f"dry run decode cells' peak / arguments: {over}")
    if not over or max(over.values()) > 1 + DECODE_PEAK_MARGIN:
        raise SystemExit(f"dry run decode peaks over their arguments beyond "
                         f"{DECODE_PEAK_MARGIN}: {over}")
    return recs


def mesh_phase() -> dict:
    t0 = time.perf_counter()
    out = dict(shards=shard_mode_checks(), model=meshed_model_run(),
               dryrun=dryrun_cells())
    log(f"mesh phase {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 4j: training on a mesh, cluster meshes, the dry run's train_4k
# ---------------------------------------------------------------------------

MESH_TRAIN_LR = 1e-3        # the reduced meshed-vs-single check's lr


def _ckpt_arrays(path: Path, step: int) -> dict:
    with np.load(path / f"step_{step:010d}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def mesh_train_reduced(mesh) -> dict:
    """Reduced llama3-8b (f32, TF32 off), 3 steps through
    ``launch.train.main`` on the (1, 1) mesh and through the single path,
    from the same seed-0 parameters and batches: the last loss within
    CARD_CPU_LOSS_RTOL relative, every logged loss equal, parameters (the
    step-3 checkpoints) within CARD_CPU_PARAM_ATOL; elements whose clipped
    gradient (a replay of the single path's steps) was under ADAM_ILL eps
    but not 0 at some step held to 2 lr a step."""
    from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
    from repro_torch.optim.optimizer import (clip_by_global_norm,
                                             cosine_schedule)
    root = OUT / "mesh_train"
    shutil.rmtree(root, ignore_errors=True)
    steps, B, S = 3, 4, 64
    argv = ["--arch", "llama3-8b", "--reduced", "--steps", str(steps),
            "--batch", str(B), "--seq", str(S), "--log-every", "1",
            "--lr", str(MESH_TRAIN_LR), "--ckpt-every", "100"]
    cfg = get_config("llama3-8b").reduced()
    meshed = train_run("mesh reduced", cfg,
                       argv + ["--ckpt-dir", str(root / "mesh")], mesh=mesh)
    single = train_run("single reduced", cfg,
                       argv + ["--ckpt-dir", str(root / "single")])
    # the single path's steps replayed for the near-eps gradients
    model = build(cfg, device="cuda")
    ocfg = opt_config_for(cfg, lr=cosine_schedule(MESH_TRAIN_LR,
                                                  steps // 10, steps))
    params, opt = init_state(model, ocfg, 0)
    step = make_train_step(model, ocfg, donate=True)
    loader = ShardedLoader(SyntheticLM(cfg.vocab_size, seed=0),
                           DataConfig(global_batch=B, seq_len=S),
                           device="cuda")
    names = [n for n, _ in _flatten_with_names({"params": params})]
    ill = {n: torch.zeros(t.shape, dtype=torch.bool, device="cuda")
           for n, t in _flatten_with_names({"params": params})}
    for i in range(steps):
        batch = loader.device_batch(i)
        grads, _ = _value_and_grad(model.loss, params, batch)
        clipped, _ = clip_by_global_norm(grads, ocfg.max_grad_norm)
        for n, g in _flatten_with_names({"params": clipped}):
            ill[n] |= (g != 0) & (g.abs() < ADAM_ILL * ocfg.eps)
        params, opt, _ = step(params, opt, batch)
    a = _ckpt_arrays(root / "mesh", steps)
    b = _ckpt_arrays(root / "single", steps)
    worst_p = worst_ill = 0.0
    n_ill = 0
    for n in names:
        m = ill[n].cpu().numpy()
        d = np.abs(a[n] - b[n])
        if (~m).any():
            worst_p = max(worst_p, float(d[~m].max()))
        if m.any():
            worst_ill = max(worst_ill, float(d[m].max()))
            n_ill += int(m.sum())
    la, lb = meshed["metrics"]["loss"], single["metrics"]["loss"]
    rel = abs(la - lb) / abs(lb)
    logged = [s["loss"] for s in meshed["steps"]] == \
        [s["loss"] for s in single["steps"]]
    ill_bound = 2 * MESH_TRAIN_LR * steps
    log(f"mesh train[reduced llama3-8b, (1, 1) mesh vs single, {steps} "
        f"steps, f32, TF32 off]: last loss {la!r} vs {lb!r} (rel "
        f"{rel:.3g}, tolerance {CARD_CPU_LOSS_RTOL}); logged losses equal "
        f"{logged}; params max abs diff {worst_p:.3g} (tolerance "
        f"{CARD_CPU_PARAM_ATOL}); {n_ill} near-eps elements: max abs diff "
        f"{worst_ill:.3g} (bound {ill_bound}); launches "
        f"{meshed['launches']}; plain calls {meshed['plain']}")
    if rel > CARD_CPU_LOSS_RTOL or not logged or \
            worst_p > CARD_CPU_PARAM_ATOL or worst_ill > ill_bound or \
            set(names) - set(a):
        raise SystemExit("mesh train[reduced]: the meshed train step "
                         "disagrees with the single path")
    del params, opt, grads, clipped
    _free()
    return dict(loss_rel=rel, param_abs=worst_p, ill_elements=n_ill,
                ill_param_abs=worst_ill, launches=meshed["launches"])


def mesh_train_ckpt(mesh) -> dict:
    """Reduced llama3-8b on the (1, 1) mesh, 4 steps, a checkpoint every 2;
    ``step_2`` restored with ``shardings=`` from the placed state's
    placements (DTensors on them, sha256 of each gathered tensor equal to
    the manifest's), then a resume from ``step_2`` alone: step 3's loss
    within RESUME_TOL of the run without a break."""
    from repro_torch.distributed.sharding import ShardCtx, Sharding
    from repro_torch.training import place_state
    from torch.distributed.tensor import DTensor
    root = OUT / "mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    base = ["--arch", "llama3-8b", "--reduced", "--steps", "4", "--batch",
            "4", "--seq", "64", "--log-every", "1", "--ckpt-every", "2"]
    cfg = get_config("llama3-8b").reduced()
    full = train_run("mesh ckpt", cfg,
                     base + ["--ckpt-dir", str(root / "full")], mesh=mesh)
    if CheckpointManager(str(root / "full")).all_steps() != [2, 4]:
        raise SystemExit("mesh train[ckpt]: checkpoints are not [2, 4]")
    shutil.copytree(root / "full" / "step_0000000002",
                    root / "resume" / "step_0000000002")
    ctx = ShardCtx.for_mesh(mesh, "train")
    model = build(cfg, ctx, device="cuda")
    ocfg = opt_config_for(cfg)
    params, opt = place_state(model, ocfg, ctx,
                              *init_state(model, ocfg, 0))
    tpl = {"params": params, "opt": opt}
    shardings = tree_map(
        lambda t: Sharding(mesh, (), tuple(t.placements)), tpl)
    cm = CheckpointManager(str(root / "resume"))
    back = cm.restore(2, tpl, shardings=shardings)
    entries = cm.manifest(2)["entries"]
    named = _flatten_with_names(back)
    bad = [n for n, t in named
           if not isinstance(t, DTensor)
           or _sha256(_to_storable(t.full_tensor())[0])
           != entries[n]["sha256"] or t.to_local().device.type != "cuda"]
    if bad or len(named) != len(entries):
        raise SystemExit(f"mesh train[ckpt]: restored tensors differ from "
                         f"the saved ones: {bad[:5]}")
    del params, opt, back, tpl
    resumed = train_run("mesh resume", cfg,
                        base + ["--ckpt-dir", str(root / "resume"),
                                "--resume"], mesh=mesh)
    a, b = full["metrics"]["loss"], resumed["metrics"]["loss"]
    log(f"mesh train[ckpt] saved on the (1, 1) mesh at steps 2 and 4; "
        f"{len(named)} DTensors restored with shardings=, sha256 equal to "
        f"the manifest; step 3 loss uninterrupted {a!r} resumed {b!r} "
        f"(|diff| {abs(a - b):.3g}, tolerance {RESUME_TOL})")
    if abs(a - b) > RESUME_TOL or [s["step"] for s in resumed["steps"]] \
            != [2, 3]:
        raise SystemExit(f"mesh train[ckpt]: step 3 loss {b} vs {a}")
    _free()
    return dict(tensors=len(named), loss=a, resumed_loss=b)


def mesh_train_full(mesh, single: dict, smi: str) -> dict:
    """llama3-8b at full width, 8 of 32 layers (bf16, as phase 4h), 10
    steps through ``main(..., mesh=)`` on the (1, 1) mesh (finite losses,
    the mean of the last three below the first; K5 and K5-bwd launched as
    the config implies, K4/K6 0),
    then one profiled meshed step's device-busy share; the single path's
    numbers are phase 4h's in this call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.training import place_state
    layers = 8
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=layers)
    label = f"llama3-8b {layers}L mesh"
    r = train_run(label, cfg, TRAIN_FULL + ["--lr", "3e-4"], mesh=mesh)
    losses = [st["loss"] for st in r["steps"]]
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise SystemExit(f"mesh train[{label}]: mean of the last three "
                         f"losses not below the first: {losses}")
    _free()
    ctx = ShardCtx.for_mesh(mesh, "train")
    model = build(cfg, ctx, device="cuda")
    ocfg = opt_config_for(cfg, lr=3e-4)
    params, opt = place_state(model, ocfg, ctx, *init_state(model, ocfg, 0))
    step = make_train_step(model, ocfg, donate=True)
    gen = np.random.default_rng(0)
    tokens = torch.from_numpy(gen.integers(
        0, cfg.vocab_size, (8, 256)).astype(np.int32)).cuda()
    batch = ctx.distribute({"tokens": tokens}, {"tokens": model.input_specs(
        SHAPES["train_4k"])[1]["tokens"]})
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, busy = busy_share(prof, "")
    del params, opt, m, batch
    _free()
    step_ms = [st["step_ms"] for st in r["steps"]]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"mesh train[{label}] losses {losses}")
    log(f"mesh train[{label}] step host ms {[round(x, 2) for x in step_ms]} "
        f"(median of steps 1+ {steady:.2f} ms) against the single path's "
        f"{single['steady_step_ms']:.2f} ms (phase 4h, this call; ratio "
        f"{steady / single['steady_step_ms']:.2f}); profiled meshed step "
        f"{prof_ms:.2f} ms, device busy {busy_ms:.2f} ms, share {busy:.3f} "
        f"(single {single['busy_share']:.3f}); peak memory "
        f"{r['peak_gib']:.2f} GiB (single {single['peak_gib']:.2f}); "
        f"launches {r['launches']} | {smi}")
    return dict(layers=layers, losses=losses, step_ms=step_ms,
                steady_step_ms=steady, single_steady_step_ms=single[
                    "steady_step_ms"], busy_share=busy, busy_ms=busy_ms,
                profiled_step_ms=prof_ms, peak_gib=r["peak_gib"],
                launches=r["launches"])


def cluster_mesh_run() -> dict:
    """``LkSystem`` on [cuda] x 2 clusters, each a mesh over rank 0, with
    ``state_shardings_factory`` (state as DTensors on its cluster's mesh)
    and without: two classes pinned one a cluster, 4 items each; results
    equal, ``met == n`` on both; rank 0 drives both clusters, so it runs
    both pinned classes."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.system import WorkClass
    from repro_torch.distributed.sharding import Sharding, spec_to_placements

    def fn(state, desc):
        state = dict(state)
        state["x"] = state["x"] + 1.0
        return state, state["x"].sum()[None]

    def shard(cl):
        return {"x": Sharding(cl.mesh, ("data",),
                              spec_to_placements(("data",), cl.mesh))}
    runs = {}
    for label, factory in (("sharded", shard), ("plain", None)):
        sys_ = LkSystem(
            devices=[torch.device("cuda")] * 2, n_clusters=2,
            axis_names=("data",),
            state_factory=lambda cl: {"x": torch.zeros(
                1024, device="cuda")},
            result_template=torch.zeros(1, device="cuda"),
            state_shardings_factory=factory,
            work_classes=[WorkClass("w0", fn=fn, pin=0),
                          WorkClass("w1", fn=fn, pin=1)])
        with sys_:
            meshes = [rt.state["x"].device_mesh if isinstance(
                rt.state["x"], DTensor) else None
                for rt in sys_.runtimes.values()]
            driven = [sys_.drives_class(c) for c in ("w0", "w1")]
            tickets = [sys_.submit(c) for _ in range(4)
                       for c in ("w0", "w1")]
            res = [float(t.result()[0]) for t in tickets]
            st = sys_.stats()
        runs[label] = dict(results=res, met=st["met"], n=st["n"],
                           dtensor=[m is not None for m in meshes],
                           driven=driven)
    ok = runs["sharded"]["results"] == runs["plain"]["results"] and \
        all(r["met"] == r["n"] == 8 for r in runs.values()) and \
        all(runs["sharded"]["dtensor"]) and not any(runs["plain"]["dtensor"]) \
        and all(runs["sharded"]["driven"])
    log(f"cluster meshes: LkSystem 2 clusters on [cuda] x 2, each a mesh "
        f"over rank 0: sharded results {runs['sharded']['results']} plain "
        f"{runs['plain']['results']}; met/n {runs['sharded']['met']}/"
        f"{runs['sharded']['n']} and {runs['plain']['met']}/"
        f"{runs['plain']['n']}; state DTensors {runs['sharded']['dtensor']}")
    if not ok:
        raise SystemExit(f"cluster meshes: {runs}")
    return runs


def dryrun_train_cell(smi: str) -> dict:
    """The dry run's train_4k for llama3-8b on the (16, 16) mesh (fake
    tensors, a fake 512-rank group: host work) and its roofline row."""
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3-8b", "--shape", "train_4k", "--mesh", "pod", "--out",
         str(out_dir)], env=env, capture_output=True, text=True,
        timeout=300)
    for line in res.stdout.splitlines():
        log(line)
    took = time.perf_counter() - t0
    rec = json.loads((out_dir / "llama3-8b__train_4k__16x16.json")
                     .read_text())
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--results",
         str(out_dir)], env=env, capture_output=True, text=True, timeout=120)
    if res.returncode or rec["status"] != "OK":
        raise SystemExit(f"dry run train_4k: {rec['status']} "
                         f"{rec.get('traceback', '')} {res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        if line.strip():
            log(f"roofline {line}")
    log(f"dry run train_4k llama3-8b 16x16: {took:.1f}s | {smi}")
    return {k: rec.get(k) for k in ("status", "memory", "collectives",
                                    "timing", "cost")}


def mesh_train_phase(smi: str, single: dict) -> dict:
    """Phase 4j over a one-rank NCCL group (as phase 4i starts it)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore(),
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        out = dict(reduced=mesh_train_reduced(mesh),
                   ckpt=mesh_train_ckpt(mesh),
                   full=mesh_train_full(mesh, single, smi),
                   clusters=cluster_mesh_run())
    finally:
        dist.destroy_process_group()
    out["dryrun"] = dryrun_train_cell(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh train phase {out['seconds']:.1f}s | {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 5: tile kernels vs plain at 132 clusters
# ---------------------------------------------------------------------------

CHAIN_SCALE = 0.25    # the chained queue's workspace: the smoke's times this


def _ring(programs, windows, device=DEVICE):
    """(ctrl, queue) int32 tensors from per-cluster descriptor lists and
    (head, tail, stop) windows."""
    ring = np.stack([mb.descriptor_ring(p, TILE_Q) for p in programs])
    ctrl = np.stack([mb.queue_control(tail=t, head=h, stop=s)
                     for h, t, s in windows])
    return (torch.from_numpy(ctrl).to(device),
            torch.from_numpy(ring).to(device))


def matmul_queue(C=TILE_C, device=DEVICE):
    """Every row a matmul of tiles 0 and 1 (never written) into tiles
    2..7: 8448 tile products at C = 132, all active. No row reads another
    row's dst, so K1/K2 prefetch every next row."""
    WD = mb.WorkDescriptor
    progs = [[WD(opcode=PK.OP_MATMUL, request_id=c * TILE_Q + i,
                 arg0=PK.pack_args(2 + (i + c) % 6, (i + c) % 2)[0],
                 arg1=(i + c + 1) % 2) for i in range(TILE_Q)]
             for c in range(C)]
    return _ring(progs, [(0, TILE_Q, 0)] * C, device)


def mixed_queue(rng, C=TILE_C, device=DEVICE):
    """Every opcode (and -1 / 9, which clip), random tiles with aliasing
    and out-of-range indices (-1, 9, 300: tile 7), a 3-chunk REDUCE at rows
    30-32, per-cluster [head, tail) windows and one stopped cluster. Tiles
    0 and 1 are never written and give one operand of every product and
    sum, so the values stay near 1; rows 10 and 40 are products whose dst
    is their first operand."""
    WD = mb.WorkDescriptor
    progs = []
    for c in range(C):
        prog = []
        for i in range(TILE_Q):
            rid = c * TILE_Q + i
            if 30 <= i <= 32:
                prog.append(WD(opcode=PK.OP_REDUCE, request_id=c * TILE_Q + 30,
                               arg0=PK.pack_args(0, 1)[0], chunk=i - 30,
                               n_chunks=3))
                continue
            if i in (10, 40):
                d = 2 + c % 6
                prog.append(WD(opcode=PK.OP_MATMUL, request_id=rid,
                               arg0=PK.pack_args(d, d)[0], arg1=c % 2))
                continue
            op = int(rng.choice([-1, 0, 1, 2, 3, 4, 5, 9]))
            dst = int(rng.choice([-1, 9, 300])) if rng.random() < 0.1 \
                else int(rng.integers(2, TILE_NBUF))
            a, b = int(rng.integers(0, TILE_NBUF)), int(rng.integers(0, 2))
            if op == PK.OP_MATMUL:
                a = int(rng.integers(0, 2))
            a0, a1 = (PK.pack_scale(dst, a, float(rng.uniform(-1, 1)))
                      if op == PK.OP_SCALE else PK.pack_args(dst, a, b))
            prog.append(WD(opcode=op, arg0=a0, arg1=a1, request_id=rid))
        progs.append(prog)
    windows = [(c % 4, TILE_Q - c % 7, int(c == C - 1)) for c in range(C)]
    return _ring(progs, windows, device)


def chained_queue(C=TILE_C, device=DEVICE):
    """A chain of products: row i writes tile 2 + (i + c + 1) % 6 from tile
    2 + (i + c) % 6, so each row's dst is the next row's first operand and
    K1/K2 may prefetch no row; every 8th row's second operand is its own
    dst (D += A @ D), the others take tile 0 or 1. Run on the smoke's
    workspace times CHAIN_SCALE, which keeps every workspace value below
    ~5 over 64 rows; at the smoke's own scale the chain grows without
    bound, and a much larger chain makes a row's tile sum differ between
    two f32 summation orders by more than the 1e-4 tolerance."""
    WD = mb.WorkDescriptor
    progs = []
    for c in range(C):
        prog = []
        for i in range(TILE_Q):
            a, dst = 2 + (i + c) % 6, 2 + (i + c + 1) % 6
            b = dst if i % 8 == 7 else (i + c) % 2
            prog.append(WD(opcode=PK.OP_MATMUL, request_id=c * TILE_Q + i,
                           arg0=PK.pack_args(dst, a)[0], arg1=b))
        progs.append(prog)
    return _ring(progs, [(0, TILE_Q, 0)] * C, device)


def tile_inputs(C=TILE_C, device=DEVICE) -> dict:
    """The tile checks' state (ws, carry, tick) and their matmul, mixed
    and chained queues, all from seed 0."""
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.standard_normal(
        (C, TILE_NBUF, PK.TILE, PK.TILE)) * 0.1).astype(np.float32))
    carry = torch.from_numpy(rng.uniform(-1, 1, (C, 1)).astype(np.float32))
    tick = torch.from_numpy(rng.integers(0, 100, (C, 1)).astype(np.int32))
    return dict(ws=ws.to(device), carry=carry.to(device),
                tick=tick.to(device), matmul=matmul_queue(C, device),
                mixed=mixed_queue(rng, C, device),
                chained=chained_queue(C, device))


def _tile_args(name, ctrl, ring, ws, carry, tick):
    """Fresh copies of the state the kernel updates in place."""
    if name == "persistent_execute":
        return ring, ws.clone()
    if name == "persistent_drain":
        return ctrl, ring, ws.clone(), carry.clone()
    return ctrl, ring, ws.clone(), carry.clone(), tick.clone()


def _tile_work(name, ctrl, ring, nbuf) -> tuple[float, float, float]:
    """(bytes, tile products, other f32 operations) the launch needs on
    this data: each input read and each output written once; a 128^3
    product per active matmul row, plus 2*T^2 f32 operations (the add to D
    and the row's sum) per active matmul, elementwise or reduce row;
    nothing for NOP rows."""
    q = ring.cpu().numpy()
    C, Q, _ = q.shape
    T = PK.TILE
    work = q[:, :, mb.W_STATUS] >= mb.THREAD_WORK
    n_ops = PK.NUM_OPS
    if name != "persistent_execute":
        c = ctrl.cpu().numpy()
        i = np.arange(Q)[None, :]
        work &= (i >= c[:, mb.QC_HEAD:mb.QC_HEAD + 1]) & \
            (i < c[:, mb.QC_TAIL:mb.QC_TAIL + 1]) & \
            (c[:, mb.QC_STOP:mb.QC_STOP + 1] == 0)
        n_ops = PK.NUM_DRAIN_OPS
    op = np.clip(q[:, :, mb.W_OPCODE], 0, n_ops - 1)
    products = float(((op == PK.OP_MATMUL) & work).sum())
    f32_ops = float(((op >= PK.OP_MATMUL) & work).sum()) * 2 * T**2
    ws_bytes = C * nbuf * T * T * 4
    nbytes = 2 * ws_bytes + q.nbytes
    if name == "persistent_execute":
        nbytes += C * mb.DESC_WIDTH * 4
    else:
        nbytes += 2 * C * mb.QCTRL_WIDTH * 4 + 2 * C * 4          # ctrl, carry
        nbytes += C * Q * (mb.DESC_WIDTH + 1) * 4                 # acks, res
        if name == "persistent_drain_prof":
            nbytes += C * Q * mb.PROF_WIDTH * 4 + 2 * C * 4       # prof, tick
    return nbytes, products, f32_ops


def tile_bound(name, ctrl, ring, nbuf) -> dict:
    """The launch's bound on the route its kernel takes — three TF32
    products a tile product (3xTF32) on the tensor cores (K1/K2 by
    ``mma.sync``, K3 by ``wgmma``) — with the f32 FFMA bound beside it,
    and each as one SM a cluster allows: a launch of C < 132 clusters
    runs on C SMs."""
    nbytes, products, f32_ops = _tile_work(name, ctrl, ring, nbuf)
    flop = 2 * PK.TILE**3 * products
    ffma = bound(nbytes, flop + f32_ops, torch.float32)
    route = bound(nbytes, {"tf32": 3 * flop, torch.float32: f32_ops})
    share = N_SMS / min(ring.shape[0], N_SMS)
    return dict(route, ffma_bound_ms=ffma["bound_ms"],
                sm_bound_ms=max(route["bytes_ms"], route["ops_ms"] * share),
                sm_ffma_bound_ms=max(ffma["bytes_ms"],
                                     ffma["ops_ms"] * share),
                products=products)


def tile_case(name, label, ctrl, ring, ws, carry, tick, time_it,
              library_ms=None) -> dict:
    spec = KERNELS[name]
    got = spec["wrapper"](*_tile_args(name, ctrl, ring, ws, carry, tick))
    want = spec["plain"](*_tile_args(name, ctrl, ring, ws, carry, tick))
    torch.cuda.synchronize()
    err, exact = 0.0, True
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            exact &= bool(torch.equal(g, w))
        else:
            err = max(err, float((g - w).abs().max()))
            exact &= bool(torch.allclose(g, w, rtol=TILE_TOL, atol=TILE_TOL))
    scale = max(float(t.abs().max()) for t in want
                if t.dtype == torch.float32)
    row = dict(kernel=name, case=label, max_abs_err=err, ok=exact,
               scale=scale, library_ms=library_ms)
    row.update(tile_bound(name, ctrl, ring, ws.shape[1]))
    if time_it:
        args = _tile_args(name, ctrl, ring, ws, carry, tick)
        row["ms"] = time_ms(lambda: spec["wrapper"](*args))
        plain = _tile_args(name, ctrl, ring, ws, carry, tick)
        row["plain_ms"] = host_ms(lambda: spec["plain"](*plain), iters=3)
    return row


def log_tile_row(r) -> None:
    t = "" if "ms" not in r else (
        f"kernel_ms={r['ms']:.4f} plain_eager_ms={r['plain_ms']:.3f} ")
    if r["library_ms"] is not None:
        t += f"bmm_same_products_no_queue_order_ms={r['library_ms']:.4f} "
    log(f"check {r['kernel']:22s} {r['case']:28s} "
        f"max_abs_err={r['max_abs_err']:.3e} exact_ints_and_tol={r['ok']} "
        f"max|value|={r['scale']:.3g} {t}bound_ms={r['bound_ms']:.5f} "
        f"(3xTF32, {r['bound_by']}; bytes {r['bytes_ms']:.5f}, ops "
        f"{r['ops_ms']:.5f}) one_sm_a_cluster_bound_ms="
        f"{r['sm_bound_ms']:.5f} ffma_bound_ms={r['ffma_bound_ms']:.5f} "
        f"(one SM a cluster {r['sm_ffma_bound_ms']:.5f})")


def bmm_ms(ring, ws) -> float:
    """``torch.bmm`` (TF32 off) over the tile products of a matmul-only
    queue: the same arithmetic without the queue's order."""
    q = ring.cpu().numpy()
    C, Q, _ = q.shape
    cl = np.repeat(np.arange(C), Q) * ws.shape[1]
    flat = ws.reshape(-1, PK.TILE, PK.TILE)
    ia = torch.from_numpy(cl + (q[:, :, mb.W_ARG0] & 255).ravel())
    ib = torch.from_numpy(cl + q[:, :, mb.W_ARG1].ravel())
    A, B = flat[ia.to(DEVICE)], flat[ib.to(DEVICE)]
    out = torch.empty_like(A)
    return time_ms(lambda: torch.bmm(A, B, out=out))


def one_cluster(ctrl, ring, c, window=None):
    """Cluster ``c`` of a queue as a launch of its own, the shape every
    ``MegaRuntime`` launch has, optionally with another (head, tail)."""
    ctrl1 = ctrl[c:c + 1].clone()
    if window is not None:
        ctrl1[0, mb.QC_HEAD], ctrl1[0, mb.QC_TAIL] = window
    return ctrl1, ring[c:c + 1].contiguous()


def tile_kernel_checks() -> dict:
    """K1-K3 against their plain versions at C = 132 (one worker per SM),
    and K1/K2 at C = 1: each ``MegaRuntime`` is one cluster, so every
    launch of the mega paths has that shape (a full matmul queue, a chain
    of products, a mixed queue with a window, a one-row launch as the
    reduce remainders are)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = tile_inputs()
    ws, carry, tick = inp["ws"], inp["carry"], inp["tick"]
    mm, mixed, chain = inp["matmul"], inp["mixed"], inp["chained"]
    ws_chain = ws * CHAIN_SCALE
    mm1 = one_cluster(*mm, 0)
    st1 = (ws[:1], carry[:1], tick[:1])
    lib, lib1 = bmm_ms(mm[1], ws), bmm_ms(mm1[1], ws[:1])
    big = f"C{TILE_C}_Q{TILE_Q}_nbuf{TILE_NBUF}"
    one = f"C1_Q{TILE_Q}_nbuf{TILE_NBUF}"
    out = {}
    for name in TILE_KERNELS:
        rows = [tile_case(name, f"matmul_{big}", *mm, ws, carry, tick,
                          time_it=True, library_ms=lib),
                tile_case(name, f"mixed_{big}", *mixed, ws, carry, tick,
                          time_it=False),
                tile_case(name, f"chained_{big}", *chain, ws_chain, carry,
                          tick, time_it=False)]
        if name != "persistent_execute":      # K3's path: phase 6
            rows += [
                tile_case(name, f"matmul_{one}", *mm1, *st1, time_it=True,
                          library_ms=lib1),
                tile_case(name, f"chained_{one}", *one_cluster(*chain, 0),
                          ws_chain[:1], carry[:1], tick[:1], time_it=True),
                tile_case(name, f"mixed_{one}_window", *one_cluster(
                    *mixed, min(5, TILE_C - 1)), *st1, time_it=False),
                tile_case(name, f"mixed_{one}_one_row", *one_cluster(
                    *mixed, 0, (0, 1)), *st1, time_it=False)]
        for r in rows:
            log_tile_row(r)
        bad = [r for r in rows if not r["ok"]]
        if bad:
            raise SystemExit(
                f"tile kernel disagrees with its plain version: {bad}")
        out[name] = dict(c132=rows[0], path=rows[3] if len(rows) > 3
                         else None, chained_c1=rows[4] if len(rows) > 4
                         else None,
                         max_abs_err=max(r["max_abs_err"] for r in rows))
    for name in TILE_KERNELS[:2]:
        k, ch = out[name]["path"], out[name]["chained_c1"]
        T = PK.TILE
        floor_ffma = 2 * T**3 / (PEAK_OPS[torch.float32] / N_SMS) * 1e6
        floor_tf32 = 3 * 2 * T**3 / (PEAK_OPS["tf32"] / N_SMS) * 1e6
        log(f"one cluster (C=1), {name}: {TILE_Q} tile products in "
            f"{k['ms']:.4f} ms = {k['ms'] * 1e3 / TILE_Q:.2f} us each "
            f"(every next row prefetched), chained {ch['ms']:.4f} ms = "
            f"{ch['ms'] * 1e3 / TILE_Q:.2f} us each (no row prefetched); "
            f"one CTA per cluster caps a C=1 launch at one SM's share: "
            f"{floor_tf32:.2f} us a product at the TF32 rate (3xTF32), "
            f"{floor_ffma:.2f} us at the f32 rate (FFMA)")
    return out


# ---------------------------------------------------------------------------
# phase 6: K3's path — the tile-MLP demo on every cluster
# ---------------------------------------------------------------------------

def mlp_demo_run() -> tuple[dict, dict]:
    """``mlp_program`` (t3 += t0@t1; relu t3; t4 += t3@t2) on 132 clusters
    through ``persistent_execute``, held to torch.matmul (TF32 off); then
    K3 against its plain version at this shape. Returns the path's
    launches and the check's row."""
    rng = np.random.default_rng(1)
    ws = np.zeros((TILE_C, 5, PK.TILE, PK.TILE), np.float32)
    ws[:, :3] = rng.standard_normal((TILE_C, 3, PK.TILE, PK.TILE)) * 0.1
    ws = torch.from_numpy(ws).to(DEVICE)
    queue = torch.from_numpy(PK.build_queue(
        [PK.mlp_program()] * TILE_C, 4)).to(DEVICE)
    want = torch.relu(ws[:, 0] @ ws[:, 1]) @ ws[:, 2]
    run = ws.clone()
    zero_launches()
    _, fromgpu = PK.persistent_execute(queue, run)
    torch.cuda.synchronize()
    launches = read_launches()
    err = float((run[:, 4] - want).abs().max())
    done = fromgpu[:, mb.W_ARG0].cpu().tolist()
    log(f"mlp demo (K3 path): {TILE_C} clusters max_abs_err={err:.3e} "
        f"work rows per cluster={set(done)} launches={launches}")
    if err > TILE_TOL or set(done) != {3}:
        raise SystemExit("tile-MLP demo through K3 is wrong")
    row = tile_case("persistent_execute", f"mlp_demo_C{TILE_C}_Q4_nbuf5",
                    None, queue, ws, None, None, time_it=True)
    log_tile_row(row)
    if not row["ok"]:
        raise SystemExit(f"K3 disagrees with its plain version: {row}")
    return launches, row


# ---------------------------------------------------------------------------
# phase 7: mega vs scan on one cluster
# ---------------------------------------------------------------------------

def tile_items(rng, n: int) -> list:
    """(class, arg0, arg1, n_chunks): every 16th a 3-chunk reduce of tile 1;
    the rest random tile ops writing tiles 2..7 from tiles 0..7 (products
    and sums take an operand from the never-written tiles 0 and 1)."""
    items = []
    for i in range(n):
        if i % 16 == 5:
            items.append(("reduce", PK.pack_args(0, 1)[0], 0, 3))
            continue
        name = ("matmul", "add", "scale", "relu", "copy",
                "nop")[int(rng.integers(0, 6))]
        dst, a = int(rng.integers(2, TILE_NBUF)), int(rng.integers(0, 8))
        b = int(rng.integers(0, 2))
        if name == "matmul":
            a = int(rng.integers(0, 2))
        a0, a1 = (PK.pack_scale(dst, a, float(rng.uniform(-1, 1)))
                  if name == "scale" else PK.pack_args(dst, a, b))
        items.append((name, a0, a1, 1))
    return items


def mega_vs_scan_run(around=contextlib.nullcontext) -> dict:
    """512 tile items through ``LkSystem(runtime="mega")`` and then
    ``runtime="scan"`` on one cluster. ``around(label)`` wraps each timed
    submit-and-drain (``scripts/profile_mega.py`` traces it)."""
    items = tile_items(np.random.default_rng(2), 512)
    out = {}
    for runtime in ("mega", "scan"):
        sys_ = LkSystem(
            devices=[DEVICE], n_clusters=1, runtime=runtime,
            state_factory=lambda cl: PK.tile_state(TILE_NBUF, seed=11),
            result_template=PK.TILE_RESULT_TEMPLATE,
            work_classes=mega_work_classes(), max_steps=TILE_Q,
            max_inflight=len(items) + 1).boot()
        sys_.submit("relu", arg0=PK.pack_args(2, 0)[0])
        sys_.drain()                              # warm-up, counted below
        zero_launches()
        with around(f"mega_vs_scan[{runtime}]"):
            t0 = time.perf_counter()
            tickets = [sys_.submit(n, arg0=a0, arg1=a1, n_chunks=k)
                       for n, a0, a1, k in items]
            sys_.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        rt = list(sys_.runtimes.values())[0]
        ws = rt.state["ws"] if isinstance(rt.state, dict) else rt.state[0]
        out[runtime] = dict(
            results=np.array([float(t.result()[0]) for t in tickets]),
            ws=ws.cpu().clone(),
            us_per_item=wall / len(items) * 1e6, launches=launches,
            drained=getattr(rt, "work_drained", None),
            doorbells=rt.doorbells, stats=sys_.stats())
        sys_.dispose()
    chunks = 1 + sum(k for *_, k in items)
    m, s = out["mega"], out["scan"]
    err = float(np.abs(m["results"] - s["results"]).max())
    ws_err = float((m["ws"] - s["ws"]).abs().max())
    ok = bool(np.allclose(m["results"], s["results"], rtol=TILE_TOL,
                          atol=TILE_TOL)) and np.isfinite(m["results"]).all()
    ok &= bool(torch.allclose(m["ws"], s["ws"], rtol=TILE_TOL, atol=TILE_TOL))
    acks = [o["stats"]["ack_mismatches"] for o in (m, s)]
    log(f"mega vs scan (1 cluster, {len(items)} items, {chunks} chunks incl. "
        f"warm-up): results max_abs_err={err:.3e} final workspace "
        f"max_abs_err={ws_err:.3e} agree={ok} ack_mismatches={acks} "
        f"work_drained={m['drained']} mega_doorbells={m['doorbells']} "
        f"scan_doorbells={s['doorbells']} launches={m['launches']} "
        f"wall_us_per_item mega={m['us_per_item']:.1f} "
        f"scan={s['us_per_item']:.1f} met={m['stats']['met']}/"
        f"{m['stats']['n']} chunks={m['stats']['chunks']}")
    if not ok or m["drained"] != chunks or any(acks):
        raise SystemExit("mega and scan disagree, or work_drained != chunks")
    return m["launches"]


# ---------------------------------------------------------------------------
# phase 8: the full-width system, 132 clusters, flight recorder on
# ---------------------------------------------------------------------------

def full_width_system_run(around=contextlib.nullcontext) -> dict:
    """132 x 64 items through ``LkSystem(runtime="mega")`` on 132 clusters
    of the card with the flight recorder (K2) and admitted deadlines.
    ``around(label)`` wraps the timed submit-and-drain."""
    # class WCETs as launch/trace.py calibrates them: the worst of 3
    # synchronous items on a runtime of the same shape, doubled
    rt = MegaRuntime(max_steps=TILE_Q, device=DEVICE)
    rt.boot(PK.tile_state(TILE_NBUF, seed=0))
    worst_us = 0.0
    for i in range(4):
        t1 = time.perf_counter_ns()
        rt.run_sync(mb.WorkDescriptor(
            opcode=PK.OP_MATMUL, arg0=PK.pack_args(3, 0, 1)[0], arg1=1,
            request_id=900 + i))
        if i:                                    # the first call warms up
            worst_us = max(worst_us, (time.perf_counter_ns() - t1) / 1e3)
    rt.dispose()
    tc = TraceCollector()
    t0 = time.perf_counter()
    sys_ = LkSystem(
        devices=[DEVICE] * TILE_C, n_clusters=TILE_C,
        runtime="mega", telemetry=tc, max_steps=TILE_Q, max_inflight=TILE_Q,
        state_factory=lambda cl: PK.tile_state(TILE_NBUF, seed=cl.cid),
        result_template=PK.TILE_RESULT_TEMPLATE,
        work_classes=mega_work_classes(
            matmul={"wcet_us": 2 * worst_us},
            reduce={"wcet_us": 4 * worst_us, "chunk_us": 2 * worst_us}))
    sys_.boot()
    boot_s = time.perf_counter() - t0
    rts = list(sys_.runtimes.values())
    # the deadline: one host thread pumps every cluster and retires one
    # item per round, so an item's response time is bound by the host time
    # of the whole backlog, not of its own cluster's queue. A warm-up round
    # of one matmul per cluster measures that host time per item on this
    # system; each item's deadline is 3x it for every item submitted, which
    # a run 3x slower than the warm-up misses
    t0 = time.perf_counter()
    for i in range(TILE_C):
        sys_.submit("matmul", arg0=PK.pack_args(2, 0)[0], arg1=1)
    sys_.drain()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / TILE_C * 1e6
    n = TILE_C * TILE_Q
    slack = int(3 * n * host_us)
    before = dict(sys_.stats(), drained=sum(r.work_drained for r in rts),
                  spans=sum(r.device_spans for r in rts))
    zero_launches()
    with around("system_132_clusters"):
        t0 = time.perf_counter()
        tickets = []
        for i in range(n):
            if i % 8 == 7:
                tickets.append(sys_.submit(
                    "reduce", arg0=PK.pack_args(0, 1)[0], n_chunks=2,
                    deadline_us=now_us() + slack))
            else:
                tickets.append(sys_.submit(
                    "matmul", arg0=PK.pack_args(2 + i % 6, i % 2)[0],
                    arg1=(i + 1) % 2, deadline_us=now_us() + slack))
        sys_.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    chunks = sum(2 if i % 8 == 7 else 1 for i in range(n))
    stats = sys_.stats()
    done, met = stats["n"] - before["n"], stats["met"] - before["met"]
    drained = sum(rt.work_drained for rt in rts) - before["drained"]
    spans = sum(rt.device_spans for rt in rts) - before["spans"]
    mon = tc.monitor.counts()
    worst_resp = max(q["worst_us"] for q in tc.quantiles("response_us")
                     .values())
    finite = all(math.isfinite(float(t.result()[0])) for t in tickets)
    log(f"system {TILE_C} clusters: boot {boot_s:.2f}s class WCET 2x "
        f"{worst_us:.0f}us | warm-up {host_us:.1f} us/item, slack "
        f"3x{n}x that = {slack / 1e6:.2f}s | {n} items, {chunks} chunks in "
        f"{wall:.2f}s ({wall / n * 1e6:.1f} us/item) worst response "
        f"{worst_resp / 1e6:.2f}s | n={done} met={met} "
        f"rejected={stats['rejected']} bound_violations="
        f"{mon['bound_violations']} admitted_checked={mon['admitted_checked']}"
        f" device_spans={spans} work_drained={drained} clusters="
        f"{stats['clusters']} launches={launches} finite={finite}")
    ok = (all(t.done() for t in tickets) and met == done == n
          and mon["bound_violations"] == 0 and spans == drained == chunks
          and finite)
    sys_.dispose()
    if not ok:
        raise SystemExit("full-width mega system run failed its checks")
    return launches


# ---------------------------------------------------------------------------
# phase 9: preemption probe under MegaRuntime
# ---------------------------------------------------------------------------

def preemption_probe() -> int:
    """bench_kernels' probe: an 8-chunk LOW matmul in flight one chunk at a
    time, a HIGH relu arriving mid-item; its first trigger must land
    between LOW chunk retirements. Returns K1's launches in the probe."""
    LO, HI = 40_000, 30_000
    rt = MegaRuntime(max_inflight=1, max_steps=4, device=DEVICE)
    rt.boot(PK.tile_state(4, seed=0))
    WD = mb.WorkDescriptor
    mm = dict(opcode=PK.OP_MATMUL, arg0=PK.pack_args(3, 0, 1)[0], arg1=1)
    relu = dict(opcode=PK.OP_RELU, arg0=PK.pack_args(2, 0)[0])
    rt.run_sync(WD(request_id=990, **mm))
    rt.run_sync(WD(request_id=991, **relu))
    tc = TraceCollector()
    disp = Dispatcher({0: rt}, policy=EdfPolicy(preemptive=True),
                      telemetry=tc)
    zero_launches()
    disp.submit(WD(request_id=LO, deadline_us=now_us() + 60_000_000,
                   n_chunks=8, **mm), admission=False)
    disp.kick(0)                      # LOW's first chunk enters the device
    disp.submit(WD(request_id=HI, deadline_us=now_us() + 2_000_000, **relu),
                admission=False)
    disp.drain()
    torch.cuda.synchronize()
    launches = read_launches()["persistent_drain"]
    lo = [e.t_us for e in tc.events_of(EV_CHUNK_RETIRE, LO)]
    hi = tc.events_of(EV_TRIGGER, HI)[0].t_us
    between = any(t <= hi for t in lo) and any(t > hi for t in lo)
    log(f"preemption probe: LOW chunk retirements {len(lo)}, HIGH first "
        f"trigger between them: {between} (LOW retired before it: "
        f"{sum(t <= hi for t in lo)}), preemptions={disp.preemptions} "
        f"bound_violations={tc.monitor.counts()['bound_violations']} "
        f"K1 launches={launches}")
    rt.dispose()
    reap_deferred()
    if not between or launches == 0:
        raise SystemExit("HIGH did not land between LOW chunk retirements")
    return launches


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = smi_line()
    log(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"build {len(took)} sources in {time.perf_counter() - t0:.1f}s "
        + " ".join(f"{s.name}={t:.1f}s" for s, t in took.items()))
    for src in _build.sources():
        logf = _build.library_path(src).with_name(
            _build.library_path(src).name + ".log")
        fn, injected = "?", 0
        for line in logf.read_text().splitlines() if logf.exists() else ():
            if "Compiling entry function" in line:
                # the kernel's name and its mangled template arguments
                m = re.search(r"([a-z_]+kernel)(I\w+?EE)?", line)
                fn = "".join(g or "" for g in m.groups()) if m else "?"
            elif "C7519" in line:         # a wgmma wait ptxas added
                injected += 1
            elif "registers" in line or "spill stores" in line:
                log(f"ptxas {src.stem} {fn}: {line.split(':', 1)[-1].strip()}")
        if injected:
            log(f"ptxas {src.stem}: {injected} warpgroup.arrive injected by "
                f"the compiler around wgmma (C7519)")

    last = [time.perf_counter()]

    def took(what: str) -> None:
        now = time.perf_counter()
        log(f"{what} took {now - last[0]:.1f}s")
        last[0] = now

    checks = kernel_checks()
    ssd = ssd_checks()
    hyb_rows = hybrid_encdec_kernel_checks()
    mv_rows = moe_vlm_kernel_checks()
    took("kernel checks (phase 3)")
    chunked_args = ["--chunked-prefill", "--prefill-chunk", "8"]
    host = serve_run("llama3-8b", "host_prefill", [])
    chunked = serve_run("llama3-8b", "chunked_prefill", chunked_args)
    missing = [n for n in ATTENTION if host[n] == 0]
    if chunked["decode_attention"] == 0:
        missing.append("decode_attention (chunked prefill)")
    if missing:
        raise SystemExit(f"main path never launched: {missing}")
    logits_check()
    llama_long = attn_long_prompt_check(
        "llama3-8b", LONG_PROMPT,
        get_config("llama3-8b").num_layers * checks["s2048"]["ms"])
    streams = streams_phase(chunked_args)
    took("llama3-8b serve, logits, long prompt, streams")
    dense = dense_configs_phase(chunked_args, checks["gemma"])
    ssm_host = serve_run("mamba2-780m", "host_prefill", [])
    ssm_chunked = serve_run("mamba2-780m", "chunked_prefill", chunked_args)
    layers = get_config("mamba2-780m").num_layers
    if ssm_host["ssd_chunk"] != layers * 4 or ssm_chunked["ssd_chunk"]:
        raise SystemExit(
            f"mamba2 serve: ssd_chunk launches {ssm_host['ssd_chunk']} on "
            f"host prefill (want {layers} layers x 4 prompts), "
            f"{ssm_chunked['ssd_chunk']} on chunked prefill (want 0)")
    ssm_long = ssm_long_prompt_check(ssd["s2048"]["ms"])
    took("dense configs and mamba2 serve")
    hybrid = hybrid_phase(chunked_args, hyb_rows)
    encdec = encdec_phase(chunked_args)
    moe_vlm = moe_vlm_phase(chunked_args)
    smoke = smoke_phase()
    took("hybrid, encdec, moe/vlm and --smoke serve")
    training = train_phase(smi)
    mesh = mesh_phase()
    mesh_train = mesh_train_phase(smi, training["llama3_8b_8_layers"])
    took("train, mesh and mesh train")
    new_runs = {k: v for phase in (hybrid, encdec, moe_vlm)
                for k, v in phase.items() if k.endswith("_prefill")}
    new_runs.update({f"smoke_{arch.replace('-', '_')}": launched
                     for arch, launched in smoke.items()})

    tiles = tile_kernel_checks()
    paths = {}
    paths["persistent_execute"], tiles["persistent_execute"]["path"] = \
        mlp_demo_run()
    paths["persistent_drain"] = mega_vs_scan_run()
    paths["persistent_drain_prof"] = full_width_system_run()
    probe = preemption_probe()
    took("tile kernels and the mega paths")
    missing = [n for n in TILE_KERNELS if paths[n][n] == 0]
    if missing:
        raise SystemExit(f"tile path never launched: {missing}")
    softcap_library_times(checks["cases"] + [
        r for r in mv_rows.values() if r["kernel"] in ATTENTION] +
        list(mesh["shards"].values()))
    took("flex_attention, forward")
    flex_backward_times(training["kernel_rows"].values())
    took("flex_attention, backward")

    kernels = []
    for name, spec in KERNELS.items():
        extra = {}
        if name in ATTENTION:
            row, launches = checks[name], host[name]
            extra["launches_chunked_prefill"] = chunked[name]
            extra["eager_call_ms"] = row["eager_ms"]
            for run in ("host", "chunked"):
                extra[f"launches_streams_{run}_prefill"] = \
                    streams[run]["launches"][name]
            for key, run in (("gemma_host", "gemma2_2b_host_prefill"),
                             ("gemma_chunked", "gemma2_2b_chunked_prefill"),
                             ("mistral_host",
                              "mistral_nemo_12b_host_prefill")):
                extra["launches_" + run] = dense[key][name]
            for big in checks["gemma"]:
                if big["kernel"] == name:
                    extra["at_" + big["case"]] = {
                        k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "library_err",
                                            "sdpa_without_softcap_ms",
                                            "softcap_effect",
                                            "max_abs_err")}
            if name == "decode_attention":
                extra["device_kernels_per_call"] = \
                    row["device_kernels_per_call"]
                # K4's shard mode: its launches on the meshed decode steps,
                # and each shard case's times beside its bound
                extra["launches_mesh_decode_shard_mode"] = [
                    ln["decode_attention_partial"]
                    for ln in mesh["model"]["step_launches"]]
                extra["shard_mode"] = {
                    c: {k: r[k] for k in (
                        "ms", "shard_ms", "merge_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms",
                        "library_err", "library_lse_err",
                        "sdpa_without_softcap_ms", "max_abs_err",
                        "lse_err", "empty_shard_rows")}
                    for c, r in mesh["shards"].items()}
                big = checks["cases"][6]
                extra["at_" + big["case"]] = {
                    k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "device_kernels_per_call")}
            if name == "flash_attention":
                extra["launches_mesh_prefill"] = \
                    mesh["model"]["prefill_launches"][name]
                # the training forward (with its lse) on the long train run
                extra["launches_train_long_seq"] = \
                    training["long"]["kernel"]["launches"][name]
                extra["lse_max_abs_err_train"] = max(
                    r["errs"]["lse"] for r in training["kernel_rows"].values())
                big = checks["s2048"]
                extra["at_" + big["case"]] = {
                    k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
                extra["launches_long_prompt"] = \
                    llama_long["launches"]["kernel"]
                extra["long_prompt_prefill_ms"] = llama_long["prefill_ms"]
                extra["long_prompt_k5_share"] = llama_long["k5_share"]
                g_long = dense["gemma_long"]
                extra["gemma2_2b_long_prompt"] = dict(
                    tokens=GEMMA_LONG, launches=g_long["launches"]["kernel"],
                    prefill_ms=g_long["prefill_ms"],
                    k5_share=g_long["k5_share"])
        elif name == "flash_attention_bwd":
            # launches on the long-sequence train run (the main row's
            # shape) and on every other train run; the other shapes beside
            rows = training["kernel_rows"]
            row = rows[TRAIN_ATTN_ROWS[0][0]]
            launches = training["long"]["kernel"]["launches"][name]
            extra["shape"] = row["case"]
            extra["fwd_lse_ms"] = row["fwd_lse_ms"]
            extra["errs"] = row["errs"]
            extra["library_err"] = row["library_err"]
            for r in rows.values():
                if r is not row:
                    extra["at_" + r["case"]] = {
                        k: r[k] for k in ("ms", "fwd_lse_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "library_err",
                                          "max_abs_err")}
            extra["launches_train_reduced"] = {
                label: v["launches"][name]
                for label, v in training["reduced"].items()}
            extra["launches_train_llama3_8b_8_layers"] = \
                training["llama3_8b_8_layers"]["launches"][name]
            extra["launches_mesh_train_llama3_8b_8_layers"] = \
                mesh_train["full"]["launches"][name]
            long = training["long"]
            extra["long_seq_train"] = {
                path: {k: long[path][k] for k in (
                    "steady_step_ms", "busy_share", "peak_gib",
                    "fwd_bwd_peak_gib", "losses")}
                for path in ("kernel", "masked")}
            extra["long_seq_train"]["grad_rel_err"] = long["grad_rel_err"]
        elif name == "ssd_chunk":
            # launches on mamba2-780m's serve runs; times at the serve
            # shape, the 2048-token and the B=4 S=256 shapes beside them
            row, launches = ssd["serve"], ssm_host[name]
            extra["launches_chunked_prefill"] = ssm_chunked[name]
            extra["shape"] = row["case"]
            extra["ffma_bound_ms"] = row["ffma_bound_ms"]
            extra["eager_call_ms"] = row["eager_ms"]
            extra["device_kernels_per_call"] = row["device_kernels_per_call"]
            for big in (ssd["s2048"], ssd["b4_s256"]):
                extra["at_" + big["case"]] = {
                    k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "ffma_bound_ms", "eager_ms",
                                        "device_kernels_per_call")}
            extra["launches_long_prompt"] = ssm_long["launches"]
            extra["long_prompt_prefill_ms"] = ssm_long["prefill_ms"]
            extra["long_prompt_k6_share"] = ssm_long["k6_share"]
            row = dict(row, max_abs_err=ssd["max_abs_err"])
        else:
            # times at the shape the path launches; the 132-cluster
            # launch of the same kernel beside them
            row, launches = tiles[name]["path"], paths[name][name]
            big = tiles[name]["c132"]
            extra["shape"] = row["case"]
            extra["one_sm_a_cluster_bound_ms"] = row["sm_bound_ms"]
            extra["ffma_bound_ms"] = row["ffma_bound_ms"]
            keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "ffma_bound_ms")
            extra["at_" + big["case"]] = {k: big[k] for k in keys}
            chained = tiles[name].get("chained_c1")
            if chained is not None:
                extra["at_" + chained["case"]] = {k: chained[k]
                                                  for k in keys}
            row = dict(row, max_abs_err=max(row["max_abs_err"],
                                            tiles[name]["max_abs_err"]))
        if name in ATTENTION + ("ssd_chunk",):
            # the serve runs and shapes of zamba2-7b, whisper-tiny, the
            # moe and vlm configs at cut depth, and --smoke
            for run, launched in new_runs.items():
                extra["launches_" + run] = launched[name]
            for r in (*hyb_rows.values(), *mv_rows.values()):
                if r["kernel"] == name:
                    extra["at_" + r["case"]] = {
                        k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "max_abs_err")}
        if name == "flash_attention":
            extra["zamba2_7b_long_prompt"] = dict(
                tokens=LONG_PROMPT,
                launches=hybrid["long_launches"]["flash_attention"],
                prefill_ms=hybrid["long_prefill_ms"],
                k5_share=hybrid["k5_share"])
        if name == "ssd_chunk":
            extra["zamba2_7b_long_prompt"] = dict(
                tokens=LONG_PROMPT,
                launches=hybrid["long_launches"]["ssd_chunk"],
                k6_share=hybrid["k6_share"])
        if name == "persistent_drain":
            extra["launches_preemption_probe"] = probe
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **extra})
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
