"""Training on a mesh and the cluster submeshes: the port against the
reference, on the CPU.

One JAX subprocess with 8 forced host devices, its mesh from the
reference's own ``repro.launch.mesh.make_host_mesh()`` (Auto axes: the
``jax.make_mesh`` of ``tests/test_multidevice.py`` gives Explicit axes in
jax 0.9, which ``ShardCtx.constrain`` refuses), and one
``torch.multiprocessing`` job of 8 gloo ranks start together; parameters
and batches come from numpy, keyed by leaf path (the harness of
``tests/test_torch_mesh.py``). Files pass between them where one side
restores what the other saved.

* One train step on the (2, 4) ('data', 'model') mesh, the port's against
  the reference's meshed step, lr 1e-3, f32: reduced llama3-8b and
  mamba2-780m (AdamW), grok-1-314b (8-bit AdamW, from the same zero
  state) and llama3-8b with two microbatches. Loss and ce within 1e-5
  relative; parameters within 1e-4, except elements whose clipped
  gradient is nonzero but under 100 AdamW eps: AdamW divides by |g| + eps
  there, so f32 rounding of g moves the update by up to 2 lr (held to
  that, as ``chip_smoke.py`` phase 4h holds the card to the CPU).
* Each rank's block of every parameter and optimizer-state leaf (fp32 and
  8-bit state) starts where JAX's block of the device at the same mesh
  coordinate does, under the train rules (fsdp ``embed`` over 'data').
* Checkpoints, exactly: the meshed port state saved on (2, 4) writes the
  files a single-device save of the same values writes, and the reference
  restores it onto its (2, 4) shardings; a reference checkpoint saved on
  an (8,) mesh restores in the port onto (2, 4) with ``P("model",
  "data")`` (``test_multidevice.py``'s elastic restore).
* Cluster submeshes (``test_multidevice.py``'s
  ``test_cluster_submesh_isolation``): two clusters of 4 ranks, a
  ``PersistentRuntime`` each with state sharded on its own mesh, results
  [8.0, 8.0] and each cluster's state on its own ranks only; the same
  through ``LkSystem(state_shardings_factory=...)``; ``make_cluster_mesh``'s
  shapes against the reference's ``_best_2d``.
* 8-bit quantization of a DTensor whose shards would split a block.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
STATE_RTOL = 1e-5       # moments, leaf-relative (read <= 2.6e-6)
ADAM_ILL = 100          # clipped |g| under this many eps: the 2 lr rule
# (name, arch, microbatches)
RUNS = [("llama3-8b", "llama3-8b", 1), ("mamba2-780m", "mamba2-780m", 1),
        ("grok-1-314b", "grok-1-314b", 1), ("llama3-8b-accum2", "llama3-8b", 2)]
BLOCK_RUNS = ("llama3-8b", "grok-1-314b")       # fp32 and 8-bit state
CKPT_RUN = "llama3-8b"
CLUSTER_SIZES = (1, 2, 3, 4, 6, 8)

SHARED = r'''
RUNS = %r
CKPT_RUN = %r


def np_leaf(path, shape):
    import numpy as np, zlib
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    if len(shape) == 1:
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def np_tokens(cfg):
    import numpy as np
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)


def elastic_w():
    import numpy as np
    return np.arange(64 * 8, dtype=np.float32).reshape(64, 8)


def wait_for(path, seconds=240):
    import os, time
    end = time.time() + seconds
    while not os.path.exists(path):
        if time.time() > end:
            raise TimeoutError(path)
        time.sleep(0.2)
''' % (RUNS, CKPT_RUN)
exec(SHARED)

JAX_SNIPPET = SHARED + r'''
import functools, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.distributed import ShardCtx
from repro.launch.mesh import make_host_mesh
from repro.models import build
from repro.optim.optimizer import adamw_init
from repro.training import make_train_step, opt_config_for, state_shardings

out_path, work = sys.argv[1], sys.argv[2]
out = {}

# the reference's elastic checkpoint: saved on an (8,) mesh, first, so the
# port side can restore it while this side trains
mesh8 = make_host_mesh(("data",))
w8 = jax.device_put(jnp.asarray(elastic_w()), NamedSharding(mesh8, P("data")))
CheckpointManager(os.path.join(work, "ref_ckpt")).save(1, {"w": w8})
open(os.path.join(work, "ref_ckpt.done"), "w").close()

mesh = make_host_mesh()
assert tuple(mesh.devices.shape) == (2, 4)


def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def named(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(path_str(p), leaf) for p, leaf in flat]


def starts(sharding, shape):
    idx = sharding.devices_indices_map(tuple(shape))
    st = np.zeros((2, 4, len(shape)), np.int64)
    for a in range(2):
        for b in range(4):
            st[a, b] = [s.start or 0 for s in idx[mesh.devices[a, b]]]
    return st


ctx = ShardCtx.for_mesh(mesh, "train")
for name, arch, accum in RUNS:
    cfg = get_config(arch).reduced()
    model = build(cfg, ctx)
    ocfg = opt_config_for(cfg, lr=1e-3)
    abstract = jax.eval_shape(model.init, jax.random.key(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(np_leaf(path_str(p), s.shape)), abstract)
    opt = adamw_init(ocfg, params)
    psh, osh = state_shardings(model, ocfg, ctx, params, opt)
    if name in ("llama3-8b", "grok-1-314b"):
        for tag, tree, shs in (("params", params, psh), ("opt", opt, osh)):
            for (n, leaf), (_, sh) in zip(named(tree), named(shs)):
                out[f"blocks/{name}/{tag}/{n}"] = starts(sh, leaf.shape)
    params = jax.device_put(params, psh)
    opt = jax.device_put(opt, osh)
    with mesh:
        step = jax.jit(make_train_step(model, ocfg, accum))
        p2, o2, met = step(params, opt, {"tokens": jnp.asarray(np_tokens(cfg))})
    for k in ("loss", "ce", "acc", "grad_norm"):
        out[f"metric/{name}/{k}"] = np.asarray(met[k])
    for n, leaf in named(p2):
        out[f"params/{name}/{n}"] = np.asarray(leaf)
    for n, leaf in named(o2):
        out[f"state/{name}/{n}"] = np.asarray(leaf)
    if name == CKPT_RUN:
        # the port's meshed checkpoint, restored onto this mesh's train
        # shardings
        wait_for(os.path.join(work, "port_ckpt.done"))
        tpl = {"params": p2, "opt": o2}
        shs = {"params": psh, "opt": osh}
        back = CheckpointManager(os.path.join(work, "port_ckpt")).restore(
            1, tpl, shardings=shs)
        for (n, leaf), (_, sh) in zip(named(back), named(shs)):
            assert leaf.sharding == sh, n
            out[f"ck/{n}"] = np.asarray(leaf)
np.savez(out_path, **out)
print("JAX SIDE OK")
'''


# ---------------------------------------------------------------------------
# The port's side: 8 gloo ranks
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree) for q in _flat(v, path + (i,))]
    return [("/".join(map(str, path)), tree)]


def _offsets(tree) -> dict:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return {n: tuple(compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)[1]) for n, t in _flat(tree)}


def _train_run(name, arch, accum, ns, work, out):
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.persistent import tree_map
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim.optimizer import adamw_init, clip_by_global_norm
    from repro_torch.training import (make_train_step, opt_config_for,
                                      place_state)
    from repro_torch.training.train_loop import _replicating, _value_and_grad
    from repro_torch.distributed.sharding import full_value
    mesh = make_host_mesh(device_type="cpu")
    ctx = ShardCtx.for_mesh(mesh, "train")
    cfg = get_config(arch).reduced()
    model = build(cfg, ctx, device="cpu")
    ocfg = opt_config_for(cfg, lr=LR)
    axes_tree = model.param_axes()
    shapes = dict(_flat(_shape_tree(model)))
    it = iter([torch.from_numpy(ns["np_leaf"](n, shapes[n]))
               for n, _ in _flat(axes_tree)])
    params = _unflat(axes_tree, it)
    params, opt = place_state(model, ocfg, ctx, params,
                              adamw_init(ocfg, params))
    if name in BLOCK_RUNS:
        offs = {f"params/{n}": o for n, o in _offsets(params).items()}
        offs.update({f"opt/{n}": o for n, o in _offsets(opt).items()})
        every = [None] * WORLD
        dist.all_gather_object(every, offs)
        for n in offs:
            out[f"blocks/{name}/{n}"] = np.asarray(
                [e[n] for e in every], np.int64).reshape(2, 4, len(offs[n]))
    tokens = torch.from_numpy(ns["np_tokens"](cfg))
    batch = ctx.distribute({"tokens": tokens}, {"tokens": model.input_specs(
        SHAPES["train_4k"])[1]["tokens"]})
    # the elements AdamW divides by a near-eps gradient (the 2 lr rule)
    with _replicating(params):
        grads, _ = _value_and_grad(model.loss, params, batch)
        clipped, _ = clip_by_global_norm(grads, ocfg.max_grad_norm)
    for n, g in _flat(clipped):
        g = full_value(g)
        out[f"ill/{name}/{n}"] = ((g != 0) & (g.abs() < ADAM_ILL * ocfg.eps)
                                  ).numpy()
    step = make_train_step(model, ocfg, accum)
    p2, o2, met = step(params, opt, batch)
    for k in ("loss", "ce", "acc", "grad_norm"):
        assert not hasattr(met[k], "placements"), k      # plain, every rank
        out[f"metric/{name}/{k}"] = met[k].numpy()
    for n, t in _flat(p2):
        out[f"params/{name}/{n}"] = full_value(t).numpy()
    for n, t in _flat(o2):
        out[f"state/{name}/{n}"] = full_value(t).numpy()
    if name == CKPT_RUN:
        state = {"params": p2, "opt": o2}
        CheckpointManager(os.path.join(work, "port_ckpt")).save(1, state)
        full = tree_map(full_value, state)
        if dist.get_rank() == 0:
            one = CheckpointManager(os.path.join(work, "port_single"))
            one.save(1, full)
            open(os.path.join(work, "port_ckpt.done"), "w").close()
            for n, t in _flat(full):
                out[f"ck/{n}"] = t.numpy()


def _shape_tree(model):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = model.init(0)
    from repro_torch.core.persistent import tree_map
    return tree_map(lambda t: tuple(t.shape), p)


def _unflat(tree, it):
    if isinstance(tree, dict):
        return {k: _unflat(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_unflat(v, it) for v in tree]
    return next(it)


def _elastic_restore(ns, work, out):
    """The reference's (8,)-mesh checkpoint onto (2, 4), P("model",
    "data"): each rank's block, and the whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import Sharding, spec_to_placements
    ns["wait_for"](os.path.join(work, "ref_ckpt.done"))
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    spec = ("model", "data")
    sh = Sharding(mesh, spec, spec_to_placements(spec, mesh))
    w = ns["elastic_w"]()
    back = CheckpointManager(os.path.join(work, "ref_ckpt")).restore(
        1, {"w": torch.zeros(w.shape)}, shardings={"w": sh})["w"]
    assert tuple(back.placements) == sh.placements
    shape, off = compute_local_shape_and_global_offset(
        w.shape, mesh, sh.placements)
    want = w[off[0]:off[0] + shape[0], off[1]:off[1] + shape[1]]
    assert np.array_equal(back.to_local().numpy(), want)
    out["elastic/w"] = back.full_tensor().numpy()


def _clusters(out):
    """Two clusters of 4 ranks: a PersistentRuntime each (and an LkSystem)
    with state sharded on the cluster's own mesh."""
    import torch.distributed as dist
    from repro_torch.core import mailbox as mb
    from repro_torch.core.clusters import ClusterManager, make_cluster_mesh
    from repro_torch.core.persistent import PersistentRuntime
    from repro_torch.core.system import LkSystem, WorkClass
    from repro_torch.distributed.sharding import Sharding, spec_to_placements
    rank = dist.get_rank()

    def sharding(mesh):
        return {"x": Sharding(mesh, ("data",),
                              spec_to_placements(("data",), mesh))}

    def fn(state, desc):
        state = dict(state)
        state["x"] = state["x"] + 1.0
        return state, state["x"].sum()[None]

    cm = ClusterManager(devices=list(range(WORLD)), n_clusters=2,
                        axis_names=("data",), meshed=True)
    assert cm.check_disjoint() and all(c.n_devices == 4 for c in cm.clusters)
    mine = None
    for c in cm.clusters:
        if c.mesh.get_coordinate() is None:
            continue
        rt = PersistentRuntime([("w", fn)], result_template=torch.zeros(1),
                               mesh=c.mesh, state_shardings=sharding(c.mesh))
        rt.boot({"x": torch.zeros(8)})
        res, _ = rt.run_sync(mb.WorkDescriptor(opcode=0))
        ranks = set(rt.state["x"].device_mesh.mesh.flatten().tolist())
        assert ranks == {int(d) for d in c.devices}, (ranks, c.cid)
        assert rt.state["x"].to_local().numel() == 2
        mine = (c.cid, float(res[0]))
        rt.dispose()
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    out["clusters/runtime"] = np.asarray(
        [r for _, r in sorted(set(every))], np.float64)
    sys_ = LkSystem(devices=list(range(WORLD)), n_clusters=2,
                    axis_names=("data",),
                    state_factory=lambda cl: {"x": torch.zeros(8)},
                    result_template=torch.zeros(1),
                    state_shardings_factory=lambda cl: sharding(cl.mesh),
                    work_classes=[WorkClass("w", fn=fn)])
    with sys_:
        assert len(sys_.runtimes) == 1          # this rank's cluster only
        got = [float(sys_.submit("w").result()[0]) for _ in range(2)]
        met = sys_.stats()
    every = [None] * WORLD
    dist.all_gather_object(every, (rank // 4, got, met["met"], met["n"]))
    out["clusters/system"] = np.asarray(
        [r for _, r, _, _ in sorted(set((a, tuple(b), c, d)
                                        for a, b, c, d in every))])
    out["clusters/system_met"] = np.asarray([(c, n) for *_, c, n in every])
    out["clusters/pinned"] = _pinned_classes(sharding)
    out["clusters/recarve"] = _recarve_meshes(cm)
    shapes = []
    for n in CLUSTER_SIZES:
        shapes.append(tuple(make_cluster_mesh(list(range(n))).shape))
    out["clusters/shapes"] = np.asarray(shapes, np.int64)


def _bump(k):
    def fn(state, desc):
        state = dict(state)
        state["x"] = state["x"] + k
        return state, state["x"].sum()[None]
    return fn


def _pinned_classes(sharding):
    """Class w0 pinned to cluster 0 (+1 a call), w1 to cluster 1 (+10): each
    rank runs only its own cluster's class, and the other's submit raises.
    Returns each rank's (rank, its results, its block of x after, the warm
    pool's size) — the warm pool is off with meshed state."""
    import torch.distributed as dist
    from repro_torch.core.system import LkSystem, WorkClass
    rank = dist.get_rank()
    names = ["w0", "w1"]
    own = rank // 4
    sys_ = LkSystem(devices=list(range(WORLD)), n_clusters=2,
                    axis_names=("data",),
                    state_factory=lambda cl: {"x": torch.zeros(8)},
                    result_template=torch.zeros(1),
                    state_shardings_factory=lambda cl: sharding(cl.mesh),
                    work_classes=[WorkClass("w0", fn=_bump(1.0), pin=0),
                                  WorkClass("w1", fn=_bump(10.0), pin=1)],
                    warm_pool=1)
    with sys_:
        assert sys_.drives_class(names[own])
        assert not sys_.drives_class(names[1 - own])
        with pytest.raises(ValueError, match="pinned to cluster"):
            sys_.submit(names[1 - own])
        got = [float(sys_.submit(names[own]).result()[0]) for _ in range(2)]
        (rt,) = sys_.runtimes.values()
        block = rt.state["x"].to_local().tolist()
        warm = sys_.stats()["warm_pool"]
    every = [None] * WORLD
    dist.all_gather_object(every, [rank] + got + block + [warm])
    return np.asarray(every, np.float64)


def _recarve_meshes(cm):
    """A recarve to the same partition keeps the meshes; one to 4 clusters
    retires them, and ``release_retired`` destroys this rank's group of
    the old mesh; the new 2-rank meshes reduce. Returns each rank's (kept,
    groups destroyed, old group gone, the new mesh's all-reduce of 1)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _world
    rank = dist.get_rank()
    first = [c.mesh for c in cm.clusters]
    cm.recarve(2)
    kept = all(a is c.mesh for a, c in zip(first, cm.clusters)) and \
        not cm.retired_meshes
    old = first[rank // 4].get_group(0)
    cm.recarve(4)
    n = cm.release_retired()
    t = torch.ones(1)
    dist.all_reduce(t, group=cm.clusters[rank // 2].mesh.get_group(0))
    every = [None] * WORLD
    dist.all_gather_object(every, [float(kept), n, float(old not in
                                                         _world.pg_map),
                                   float(t)])
    return np.asarray(every, np.float64)


def _quantize_across_shards(out):
    """A (4, 48) leaf sharded 4 ways on its last dim: B = 16, 3 blocks,
    which 4 shards would split; the quantization gathers that dim."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.distributed.sharding import full_value
    from repro_torch.optim.optimizer import dequantize_8bit, quantize_8bit
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 48)).astype(np.float32))
    xd = distribute_tensor(x, mesh, (Shard(0), Shard(1)))
    q, s = quantize_8bit(xd)
    back = dequantize_8bit(q, s, x.shape)
    out["q8/q"], out["q8/s"] = full_value(q).numpy(), full_value(s).numpy()
    out["q8/back"] = full_value(back).numpy()


def _worker(rank, store_path, out_path, work):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=WORLD)
    try:
        ns = {}
        exec(SHARED, ns)
        out = {}
        for name, arch, accum in RUNS:
            _train_run(name, arch, accum, ns, work, out)
        _clusters(out)
        _quantize_across_shards(out)
        _elastic_restore(ns, work, out)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference outputs, port outputs, work dir), computed at once."""
    d = tmp_path_factory.mktemp("mesh_train")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    ref_path, port_path = str(d / "ref.npz"), str(d / "port.npz")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SNIPPET, ref_path, str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    import torch.multiprocessing as mp
    ctx = mp.spawn(_worker, args=(str(d / "store"), port_path, str(d)),
                   nprocs=WORLD, join=False)
    deadline = time.time() + 240
    while not ctx.join(timeout=max(1, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            jax_proc.kill()
            pytest.fail("the 8-rank gloo job did not finish in 240 s")
    out, err = jax_proc.communicate(timeout=max(30, deadline - time.time()))
    assert jax_proc.returncode == 0, err[-3000:]
    return dict(np.load(ref_path)), dict(np.load(port_path)), d


def _names(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_meshed_train_step_matches_reference_mesh(results, name):
    ref, port, _ = results
    for k in ("loss", "ce"):
        want = float(ref[f"metric/{name}/{k}"])
        got = float(port[f"metric/{name}/{k}"])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
    assert float(port[f"metric/{name}/acc"]) == pytest.approx(
        float(ref[f"metric/{name}/acc"]), abs=1e-6)
    assert float(port[f"metric/{name}/grad_norm"]) == pytest.approx(
        float(ref[f"metric/{name}/grad_norm"]), rel=1e-4)
    leaves = _names(ref, f"params/{name}/")
    assert leaves == _names(port, f"params/{name}/")
    worst = worst_ill = 0.0
    for n in leaves:
        d = np.abs(port[f"params/{name}/{n}"] - ref[f"params/{name}/{n}"])
        ill = port[f"ill/{name}/{n}"]
        if (~ill).any():
            worst = max(worst, float(d[~ill].max()))
        if ill.any():
            worst_ill = max(worst_ill, float(d[ill].max()))
    assert worst <= PARAM_ATOL, worst
    assert worst_ill <= 2 * LR, worst_ill


@pytest.mark.parametrize("name", BLOCK_RUNS)
def test_state_blocks_start_where_jax_puts_them(results, name):
    ref, port, _ = results
    keys = _names(ref, f"blocks/{name}/")
    assert keys and keys == _names(port, f"blocks/{name}/")
    assert any(k.startswith("opt/mv/") for k in keys)
    for k in keys:
        want = ref[f"blocks/{name}/{k}"]
        np.testing.assert_array_equal(
            port[f"blocks/{name}/{k}"].reshape(want.shape), want, err_msg=k)


def test_meshed_checkpoint_restores_in_the_reference(results):
    ref, port, work = results
    keys = _names(port, "ck/")
    assert keys and keys == _names(ref, "ck/")
    for k in keys:
        np.testing.assert_array_equal(ref[f"ck/{k}"], port[f"ck/{k}"],
                                      err_msg=k)
    from repro_torch.checkpoint import CheckpointManager
    meshed = CheckpointManager(str(work / "port_ckpt")).manifest(1)
    single = CheckpointManager(str(work / "port_single")).manifest(1)
    assert meshed["entries"] == single["entries"]


def test_reference_elastic_checkpoint_restores_on_another_mesh(results):
    _, port, _ = results
    np.testing.assert_array_equal(port["elastic/w"], elastic_w())


def test_cluster_submesh_isolation(results):
    _, port, _ = results
    assert port["clusters/runtime"].tolist() == [8.0, 8.0]
    # two items on each cluster's LkSystem: x grows by 1 each time
    assert port["clusters/system"].tolist() == [[8.0, 16.0], [8.0, 16.0]]
    assert all(met == n == 2 for met, n in port["clusters/system_met"])


def test_pinned_classes_run_on_their_own_cluster_only(results):
    _, port, _ = results
    for rank, *got in port["clusters/pinned"].tolist():
        k = 1.0 if rank < 4 else 10.0        # w0 on ranks 0-3, w1 on 4-7
        assert got == [8 * k, 16 * k, 2 * k, 2 * k, 0], (rank, got)


def test_recarve_keeps_or_releases_cluster_meshes(results):
    _, port, _ = results
    assert port["clusters/recarve"].tolist() == [[1.0, 1.0, 1.0, 2.0]] * WORLD


def test_cluster_mesh_shapes_follow_best_2d(results):
    from repro.core.clusters import _best_2d
    _, port, _ = results
    assert [tuple(s) for s in port["clusters/shapes"]] == \
        [_best_2d(n) for n in CLUSTER_SIZES]


def test_8bit_blocks_across_shards_match_plain(results):
    from repro_torch.optim.optimizer import dequantize_8bit, quantize_8bit
    _, port, _ = results
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 48)).astype(np.float32))
    q, s = quantize_8bit(x)
    np.testing.assert_array_equal(port["q8/q"], q.numpy())
    np.testing.assert_array_equal(port["q8/s"], s.numpy())
    np.testing.assert_array_equal(port["q8/back"],
                                  dequantize_8bit(q, s, x.shape).numpy())


def _leaf_rel(got, want) -> float:
    """max |got - want| over the leaf's max |want| (0 where both are 0)."""
    scale = float(np.abs(want).max()) if want.size else 0.0
    d = float(np.abs(got.astype(np.float64) - want).max()) if want.size \
        else 0.0
    return d / scale if scale else d


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_meshed_optimizer_state_matches_reference(results, name):
    """The moments after the step, leaf by leaf, each held to the leaf's
    largest value: a leaf whose gradient came out k times too large (which
    AdamW's first step hides in the parameters) moves its m, v and their
    8-bit scales by k and k**2. The 8-bit values may sit one int8 step
    apart where f32 rounding crosses a rounding boundary."""
    ref, port, _ = results
    keys = _names(ref, f"state/{name}/")
    assert keys and keys == _names(port, f"state/{name}/")
    worst, steps = ("", 0.0), 0
    for k in keys:
        got, want = port[f"state/{name}/{k}"], ref[f"state/{name}/{k}"]
        if k.endswith(("_q",)):
            steps = max(steps, int(np.abs(got.astype(np.int32)
                                          - want).max()))
        elif k.startswith("mv/"):
            worst = max(worst, (k, _leaf_rel(got, want)), key=lambda r: r[1])
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    print(f"{name}: worst leaf-relative {worst}, int8 steps apart {steps}")
    assert worst[1] <= STATE_RTOL, worst
    assert steps <= 1, steps
