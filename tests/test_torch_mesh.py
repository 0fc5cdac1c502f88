"""The port on a mesh against the reference on a mesh, on the CPU.

One JAX subprocess with 8 forced host devices (as ``tests/test_multidevice.py``
runs the reference) computes every reference output once; one
``torch.multiprocessing`` job of 8 gloo ranks (a ``FileStore`` in
``tmp_path``, one thread a rank) computes the port's, each rank on its own
blocks of DTensors on a ``DeviceMesh``. Both start at once; inputs and
parameters come from numpy, keyed by leaf path, so neither side waits for
the other.

* ``decode_attention_sharded`` (f32, atol 1e-4) and ``cache_update_sharded``
  (exact) on a (2, 4) ('data', 'model') mesh: ``tests/test_multidevice.py``'s
  inputs, a softcap, a window that crosses shards, shards past the live keys
  (empty), and the long_decode rules with B = 1 (the sequence over all 8
  ranks).
* Each rank's block under a multi-axis spec starts where JAX's block of
  the device at the same mesh coordinate does.
* Reduced llama3-8b, llama4-maverick (experts on the model axis),
  mamba2-780m and whisper-tiny in f32: a 16-token prefill and two decode
  steps on the (2, 4) mesh, logits within 1e-4 of the reference's model on
  the same mesh; llama3-8b also on (1, 8), where ``pad_heads_for_tp`` pads
  4 heads to 8. There it is held to the reference's single-device model:
  the reference pads at the end of the head axis, which regroups GQA heads
  and moves its own (1, 8) logits (printed) away from its single-device
  ones.
* The dry run (in this process, on a fake 512-rank group) and the roofline.
"""
import json
import math
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
WORLD = 8
ARCHS = ["llama3-8b", "llama4-maverick-400b-a17b", "mamba2-780m",
         "whisper-tiny"]
B, S, MAX_SEQ = 4, 16, 32

# Shared by both sides: parameters from numpy, keyed by leaf path.
NP_PARAMS = r'''
def np_leaf(path, shape):
    import numpy as np, zlib
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    if len(shape) == 1:
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def np_inputs(cfg, seed=1):
    import numpy as np
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (4, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (4, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, (2, 4, 1)).astype(np.int32)
    return batch, steps


def decode_cases():
    import numpy as np
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 4, 64, 8, 2, 16
    def t(*s):
        return rng.normal(size=s).astype(np.float32)
    q, kc, vc = t(B, 1, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D)
    base = dict(q=q, kc=kc, vc=vc, kind="decode")
    return {
        "base": dict(base, vl=[3, 17, 42, 64], cap=0.0, window=0),
        "softcap": dict(base, q=10 * q, vl=[3, 17, 42, 64], cap=30.0,
                        window=0),
        "window": dict(base, vl=[30, 40, 50, 64], cap=0.0, window=20),
        "empty": dict(base, vl=[1, 2, 16, 17], cap=0.0, window=0),
        "long_b1": dict(q=q[:1], kc=kc[:1], vc=vc[:1], kind="long_decode",
                        vl=[37], cap=0.0, window=0),
    }


def update_cases():
    import numpy as np
    rng = np.random.default_rng(1)
    return {"decode": dict(n=4, pos=[0, 17, 42, 63], kind="decode",
                           kn=rng.normal(size=(4, 1, 2, 16)).astype(np.float32),
                           vn=rng.normal(size=(4, 1, 2, 16)).astype(np.float32)),
            "long_b1": dict(n=1, pos=[37], kind="long_decode",
                            kn=rng.normal(size=(1, 1, 2, 16)).astype(np.float32),
                            vn=rng.normal(size=(1, 1, 2, 16)).astype(np.float32))}


# multi-axis specs whose per-device blocks are compared: (shape, spec)
BLOCK_SPECS = [((64,), (("data", "model"),)), ((4, 64), ("data", "model")),
               ((8, 16), (("data", "model"), None))]
'''
exec(NP_PARAMS)

JAX_SNIPPET = NP_PARAMS + r'''
import dataclasses, functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed import ShardCtx
from repro.models import build
from repro.models.attention import decode_attention_sharded, cache_update_sharded

out = {}
AT = (jax.sharding.AxisType.Auto,) * 2
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=AT)

for name, c in decode_cases().items():
    ctx = ShardCtx.for_mesh(mesh, c["kind"])
    cspec = P(ctx.rules["cache_batch"], ctx.rules["cache_seq"])
    kc = jax.device_put(jnp.asarray(c["kc"]), NamedSharding(mesh, cspec))
    vc = jax.device_put(jnp.asarray(c["vc"]), NamedSharding(mesh, cspec))
    f = functools.partial(decode_attention_sharded, ctx=ctx,
                          attn_softcap=c["cap"], window=c["window"])
    with mesh:
        o = jax.jit(lambda q, k, v, l: f(q, k, v, l))(
            jnp.asarray(c["q"]), kc, vc, jnp.asarray(c["vl"], jnp.int32))
    out[f"dec/{name}"] = np.asarray(o)

kc0 = decode_cases()["base"]["kc"]
vc0 = decode_cases()["base"]["vc"]
for name, c in update_cases().items():
    ctx = ShardCtx.for_mesh(mesh, c["kind"])
    cspec = P(ctx.rules["cache_batch"], ctx.rules["cache_seq"])
    kc = jax.device_put(jnp.asarray(kc0[:c["n"]]), NamedSharding(mesh, cspec))
    vc = jax.device_put(jnp.asarray(vc0[:c["n"]]), NamedSharding(mesh, cspec))
    with mesh:
        k2, v2 = jax.jit(lambda a, b, kn, vn, p: cache_update_sharded(
            a, b, kn, vn, p, ctx))(kc, vc, jnp.asarray(c["kn"]),
                                   jnp.asarray(c["vn"]),
                                   jnp.asarray(c["pos"], jnp.int32))
    out[f"upd/{name}/k"] = np.asarray(k2)
    out[f"upd/{name}/v"] = np.asarray(v2)

devs = mesh.devices
for i, (shape, spec) in enumerate(BLOCK_SPECS):
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    starts = np.zeros((2, 4, len(shape)), np.int64)
    for a in range(2):
        for b in range(4):
            sl = idx[devs[a, b]]
            starts[a, b] = [s.start or 0 for s in sl]
    out[f"blocks/{i}"] = starts


def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def run_model(arch, mesh_shape):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              param_dtype="float32")
    abstract = jax.eval_shape(build(cfg, ShardCtx.single()).init,
                              jax.random.key(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(np_leaf(path_str(p), s.shape)), abstract)
    batch, steps = np_inputs(cfg)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    off = cfg.vision_tokens if cfg.family == "vlm" else 0
    if mesh_shape is None:
        pm = dm = build(cfg, ShardCtx.single("decode"))
        m = None
    else:
        m = jax.make_mesh(mesh_shape, ("data", "model"), axis_types=AT)
        eom = cfg.moe is not None and cfg.moe.num_experts % mesh_shape[1] == 0
        pm = build(cfg, ShardCtx.for_mesh(m, "prefill", eom))
        dm = build(cfg, ShardCtx.for_mesh(m, "decode", eom))
    import contextlib
    with (m if m is not None else contextlib.nullcontext()):
        logits, caches = jax.jit(lambda p, b: pm.prefill(p, b, 32))(params, batch)
        outs = [np.asarray(logits)]
        step = jax.jit(dm.decode_step)
        for i in range(2):
            pos = jnp.full((4,), 16 + off + i, jnp.int32)
            logits, caches = step(params, caches, jnp.asarray(steps[i]), pos)
            outs.append(np.asarray(logits))
    return np.stack([o[:, -1] for o in outs])


for arch in ["llama3-8b", "llama4-maverick-400b-a17b", "mamba2-780m",
             "whisper-tiny"]:
    out[f"model/{arch}/2x4"] = run_model(arch, (2, 4))
out["model/llama3-8b/single"] = run_model("llama3-8b", None)
out["model/llama3-8b/ref1x8"] = run_model("llama3-8b", (1, 8))
np.savez(sys.argv[1], **out)
print("JAX SIDE OK")
'''


# ---------------------------------------------------------------------------
# The port's side: 8 gloo ranks
# ---------------------------------------------------------------------------

def _port_model(arch, mesh, np_leaf, np_inputs):
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.persistent import tree_map
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              param_dtype="float32")
    eom = cfg.moe is not None and \
        cfg.moe.num_experts % mesh.size(1) == 0
    pctx = ShardCtx.for_mesh(mesh, "prefill", eom)
    dctx = ShardCtx.for_mesh(mesh, "decode", eom)
    pm = build(cfg, pctx, device="cpu")
    dm = build(cfg, dctx, device="cpu")
    axes_tree = pm.param_axes()
    flat = _flat_paths(axes_tree)
    it = iter([torch.from_numpy(np_leaf(p, shp)) for p, shp in
               _param_shapes(pm, flat)])
    params = tree_map(lambda _: next(it), axes_tree)
    params = pctx.distribute(params, axes_tree)
    batch, steps = np_inputs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch = pctx.distribute(batch, pm.input_specs(SHAPES["prefill_32k"])[1])
    off = cfg.vision_tokens if cfg.family == "vlm" else 0
    logits, caches = pm.prefill(params, batch, MAX_SEQ)
    caches = dctx.constrain_tree(caches, dm.cache_axes())
    outs = [logits.full_tensor()]
    dax = dm.input_specs(SHAPES["decode_32k"])[1]
    for i in range(2):
        pos = torch.full((B,), S + off + i, dtype=torch.int32)
        tok = torch.from_numpy(steps[i])
        logits, caches = dm.decode_step(
            params, caches, dctx.distribute(tok, dax["tokens"]),
            dctx.distribute(pos, dax["positions"]))
        outs.append(logits.full_tensor())
    return torch.stack([o[:, -1] for o in outs]).numpy()


def _flat_paths(tree, path=()):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _flat_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree)
                for q in _flat_paths(v, path + (i,))]
    return [path]


def _param_shapes(model, paths):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = model.init(0)
    out = []
    for path in paths:
        leaf = p
        for k in path:
            leaf = leaf[k]
        out.append(("/".join(map(str, path)), tuple(leaf.shape)))
    return out


def _worker(rank, store_path, out_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=WORLD)
    try:
        _rank_work(rank, out_path)
    finally:
        dist.destroy_process_group()


def _rank_work(rank, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.sharding import ShardCtx, spec_to_placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import (cache_update_sharded,
                                              decode_attention_sharded)
    ns = {}
    exec(NP_PARAMS, ns)
    mesh = make_host_mesh(device_type="cpu")
    assert tuple(mesh.shape) == (2, 4), mesh
    out = {}
    for name, c in ns["decode_cases"]().items():
        ctx = ShardCtx.for_mesh(mesh, c["kind"])
        q, kc, vc = (torch.from_numpy(c[k]) for k in ("q", "kc", "vc"))
        cpl = ctx.placements(kc, "cache_batch", "cache_seq", "cache_heads")
        kc = distribute_tensor(kc, mesh, cpl, src_data_rank=None)
        vc = distribute_tensor(vc, mesh, cpl, src_data_rank=None)
        o = decode_attention_sharded(
            q, kc, vc, torch.tensor(c["vl"], dtype=torch.int32), ctx,
            attn_softcap=c["cap"], window=c["window"])
        out[f"dec/{name}"] = o.full_tensor().numpy()
    base = ns["decode_cases"]()["base"]
    for name, c in ns["update_cases"]().items():
        ctx = ShardCtx.for_mesh(mesh, c["kind"])
        kc = torch.from_numpy(base["kc"][:c["n"]].copy())
        vc = torch.from_numpy(base["vc"][:c["n"]].copy())
        cpl = ctx.placements(kc, "cache_batch", "cache_seq", "cache_heads")
        kc = distribute_tensor(kc, mesh, cpl, src_data_rank=None)
        vc = distribute_tensor(vc, mesh, cpl, src_data_rank=None)
        k2, v2 = cache_update_sharded(
            kc, vc, torch.from_numpy(c["kn"]), torch.from_numpy(c["vn"]),
            torch.tensor(c["pos"], dtype=torch.int32), ctx)
        assert k2 is kc and v2 is vc          # in place
        out[f"upd/{name}/k"] = k2.full_tensor().numpy()
        out[f"upd/{name}/v"] = v2.full_tensor().numpy()
    for i, (shape, spec) in enumerate(ns["BLOCK_SPECS"]):
        _, offset = compute_local_shape_and_global_offset(
            shape, mesh, spec_to_placements(spec, mesh))
        starts = [None] * WORLD
        dist.all_gather_object(starts, tuple(offset))
        out[f"blocks/{i}"] = np.asarray(starts, np.int64).reshape(
            2, 4, len(shape))
    for arch in ARCHS:
        out[f"model/{arch}/2x4"] = _port_model(arch, mesh, ns["np_leaf"],
                                               ns["np_inputs"])
    mesh18 = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
    out["model/llama3-8b/1x8"] = _port_model("llama3-8b", mesh18,
                                             ns["np_leaf"], ns["np_inputs"])
    if rank == 0:
        np.savez(out_path, **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference outputs, port outputs), computed at once."""
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_path, port_path = str(d / "ref.npz"), str(d / "port.npz")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SNIPPET, ref_path], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    import torch.multiprocessing as mp
    ctx = mp.spawn(_worker, args=(str(d / "store"), port_path),
                   nprocs=WORLD, join=False)
    deadline = time.time() + 180
    while not ctx.join(timeout=max(1, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the 8-rank gloo job did not finish in 180 s")
    out, err = jax_proc.communicate(timeout=max(30, deadline - time.time()))
    assert jax_proc.returncode == 0, err[-3000:]
    return dict(np.load(ref_path)), dict(np.load(port_path))


@pytest.mark.parametrize("case", ["base", "softcap", "window", "empty",
                                  "long_b1"])
def test_decode_attention_sharded_matches_reference(results, case):
    ref, port = results
    np.testing.assert_allclose(port[f"dec/{case}"], ref[f"dec/{case}"],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["decode", "long_b1"])
def test_cache_update_sharded_is_exact(results, case):
    ref, port = results
    for kv in ("k", "v"):
        np.testing.assert_array_equal(port[f"upd/{case}/{kv}"],
                                      ref[f"upd/{case}/{kv}"])


@pytest.mark.parametrize("i", range(3))
def test_blocks_start_where_jax_puts_them(results, i):
    ref, port = results
    np.testing.assert_array_equal(port[f"blocks/{i}"], ref[f"blocks/{i}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_decode_on_mesh_matches_reference(results, arch):
    ref, port = results
    got, want = port[f"model/{arch}/2x4"], ref[f"model/{arch}/2x4"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_padded_heads_keep_their_kv_group(results):
    ref, port = results
    want = ref["model/llama3-8b/single"]
    np.testing.assert_allclose(port["model/llama3-8b/1x8"], want, atol=ATOL,
                               rtol=0)
    print("reference (1, 8) vs its single device:",
          float(np.abs(ref["model/llama3-8b/ref1x8"] - want).max()))


# ---------------------------------------------------------------------------
# Dry run and roofline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref_argument_bytes(arch, shape_name, multi_pod, reduced=False):
    """Sum of the reference's local shard sizes of parameters, caches
    (decode), optimizer state (train) and inputs (its own specs and
    eval_shape)."""
    import functools
    import jax
    from repro.configs import SHAPES, get_config
    from repro.distributed.sharding import ShardCtx as JCtx
    from repro.distributed.sharding import logical_to_spec, make_rules
    from repro.models import build as j_build
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.launch.dryrun import kind_of

    class FakeMesh:
        def __init__(self, shape):
            self.shape = dict(shape)
            self.axis_names = tuple(shape)
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    shape = SHAPES[shape_name]
    # experts on the model axis only where it divides them (the dry run's
    # rule: reduced grok-1 has 4 experts for 16 model ranks)
    eom = cfg.moe is not None and cfg.moe.num_experts % 16 == 0
    rules = make_rules(mesh, kind_of(shape), eom)
    m = j_build(cfg, JCtx.single())
    pshape = jax.eval_shape(m.init, jax.random.key(0))
    trees = [(pshape, m.param_axes())]
    batch, bax = m.input_specs(shape)
    if shape.kind == "train":
        from repro.optim.optimizer import adamw_init, adamw_state_axes
        from repro.training import opt_config_for
        ocfg = opt_config_for(cfg)
        trees.append((jax.eval_shape(functools.partial(adamw_init, ocfg),
                                     pshape),
                      adamw_state_axes(ocfg, m.param_axes())))
        trees.append((batch, bax))
    else:
        Sx = shape.seq_len + (cfg.vision_tokens if cfg.family == "vlm"
                              else 0)
        trees.append((jax.eval_shape(functools.partial(
            m.init_caches, shape.global_batch, Sx)), m.cache_axes()))
        trees.append(({"tokens": batch["tokens"],
                       "positions": batch["positions"]}, bax))
    is_ax = lambda x: hasattr(x, "names")  # noqa: E731
    total = 0
    for sds, ax in trees:
        for s, a in zip(jax.tree.leaves(sds),
                        jax.tree.leaves(ax, is_leaf=is_ax)):
            spec = tuple(logical_to_spec(a, rules, mesh, s.shape))
            total += math.prod(local_shape(tuple(s.shape), spec, mesh)) * \
                s.dtype.itemsize
    return total


# decode cells' peak over their arguments: read 1.0002 (llama3-8b
# decode_32k) and 1.0022 (mamba2-780m long_500k) on the CPU and the H100
# host alike; the propagation over-count gave 75x
DECODE_PEAK_MARGIN = 0.02


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("llama3-8b", "decode_32k", False), ("mamba2-780m", "long_500k", True)])
def test_dry_run_cell(fake_world, arch, shape_name, multi_pod):
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(arch, shape_name, multi_pod)
    assert rec["status"] == "OK", rec.get("traceback")
    mem = rec["memory"]
    assert mem["argument_bytes"] == _ref_argument_bytes(arch, shape_name,
                                                        multi_pod)
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"]
    # a decode step holds little beside its arguments: a peak far above
    # them is DTensor's global-shape propagation tallied as a rank's work
    assert mem["peak_bytes_per_device"] <= \
        (1 + DECODE_PEAK_MARGIN) * mem["argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    if shape_name == "decode_32k":
        assert rec["collectives"]["counts"]["all-reduce"] > 0
        assert rec["cost"]["kernels"]["K4"]["calls"] == 32
    json.dumps(rec)


def test_dry_run_needs_the_propagation_mark(monkeypatch):
    """Without the methods that mark DTensor's propagation runs the dry run
    raises instead of over-counting."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from repro_torch.launch.dryrun import _propagation_apart
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        monkeypatch.delattr(ShardingPropagator, name, raising=False)
    with pytest.raises(RuntimeError, match="shape propagation"):
        _propagation_apart()


@pytest.mark.parametrize("arch,multi_pod", [
    ("llama3-8b", False), ("grok-1-314b", True), ("whisper-tiny", False)])
def test_dry_run_refuses_train(fake_world, arch, multi_pod):
    """A train_4k cell (forward, backward and AdamW on fake DTensors) of a
    reduced config is OK: its arguments (parameters, fp32 or 8-bit
    optimizer state, the batch with its frames) are the reference's
    shards by arithmetic, its peak holds at least them, its collectives
    include the fsdp gathers and their reduce-scatters, and its kernel
    tally holds K5 (with its lse) and K5-bwd once an attention call a
    microbatch (the reduced configs have no remat), the backward's
    operations 2.5x the forward's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import attention_layers
    cfg = get_config(arch).reduced()
    if cfg.train_accum_steps > 1:      # grok-1's 8 microbatches, cut to 2
        cfg = dataclasses.replace(cfg, train_accum_steps=2)
    rec = run_cell(arch, "train_4k", multi_pod, cfg_override=cfg)
    assert rec["status"] == "OK", rec.get("traceback")
    mem = rec["memory"]
    assert mem["argument_bytes"] == _ref_argument_bytes(
        arch, "train_4k", multi_pod, reduced=True)
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"]
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    kern = rec["cost"]["kernels"]
    calls = attention_layers(cfg) * cfg.train_accum_steps
    assert not cfg.remat and set(kern) == {"K5", "K5-bwd"}
    assert kern["K5"]["calls"] == kern["K5-bwd"]["calls"] == calls
    assert kern["K5-bwd"]["flops"] == pytest.approx(
        2.5 * kern["K5"]["flops"])
    row = roofline.analyse(rec)
    assert row.model_flops == pytest.approx(
        6 * rec["active_params"] * 4096 * 256 / rec["chips"])
    json.dumps(rec)


def test_roofline_terms_use_h100_figures():
    from repro_torch.launch import roofline
    rec = {"arch": "llama3-8b", "shape": "decode_32k", "mesh": "16x16",
           "chips": 256, "status": "OK", "active_params": 8.0e9,
           "model_params": 8.0e9,
           "cost": {"flops": 2.0e10, "bytes_accessed": 1.2e10},
           "collectives": {"total_bytes": 1.0e7},
           "memory": {"peak_bytes_per_device": 3 * 2**30}}
    row = roofline.analyse(rec)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert row.compute_s == pytest.approx(2.0e10 / 989e12)
    assert row.memory_s == pytest.approx(1.2e10 / 3.35e12)
    assert row.collective_s == pytest.approx(1.0e7 / 50e9)
    assert row.dominant == "memory"
    assert row.model_flops == pytest.approx(2 * 8.0e9 * 128 / 256)
    assert row.peak_gib == pytest.approx(3.0)
    assert "| llama3-8b | decode_32k | 16x16 | OK" in \
        roofline.markdown_table([row])
