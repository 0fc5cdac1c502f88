"""The port's data pipeline, checkpoints and fault-tolerance logic against
the reference: ``SyntheticLM``, ``MemmapDataset`` and ``ShardedLoader``
batches equal to the reference's bit for bit; a checkpoint either package
writes restores in the other with every tensor exactly equal (bf16 leaves,
the 8-bit optimizer state, the hybrid's lists, the 0-d int32 step); and the
cases of ``tests/test_checkpoint.py`` and ``tests/test_fault_tolerance.py``
on the port (against its own ``ClusterManager``)."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import DataConfig as JDataConfig
from repro.data import MemmapDataset as JMemmapDataset
from repro.data import ShardedLoader as JShardedLoader
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro.optim.optimizer import adamw_init as j_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.clusters import ClusterManager
from repro_torch.core.persistent import tree_leaves, tree_map
from repro_torch.data import DataConfig, MemmapDataset, ShardedLoader, \
    SyntheticLM
from repro_torch.distributed.fault_tolerance import (ElasticPlanner,
                                                     HeartbeatMonitor,
                                                     StragglerDetector)
from repro_torch.optim.optimizer import AdamWConfig, adamw_init
from tests_util_devs import devs


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed,noise,n_rules", [
    (97, 5, 0.05, 8), (512, 0, 0.05, 8), (101, 2, 0.0, 1), (128256, 3, 0.2, 4),
])
def test_synthetic_lm_batches_equal_reference(vocab, seed, noise, n_rules):
    ours = SyntheticLM(vocab, seed=seed, noise=noise, n_rules=n_rules)
    ref = JSyntheticLM(vocab, seed=seed, noise=noise, n_rules=n_rules)
    assert ours.rules == ref.rules
    for step in (0, 1, 7, 123):
        a, b = ours.batch(step, 4, 33), ref.batch(step, 4, 33)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_memmap_batches_equal_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(9).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    ours = MemmapDataset(path, vocab_size=32000, seed=4)
    ref = JMemmapDataset(path, vocab_size=32000, seed=4)
    for step in (0, 3, 50):
        a, b = ours.batch(step, 6, 64), ref.batch(step, 6, 64)
        assert a.dtype == np.int32 and a.max() < 32000
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_sharded_loader_batches_equal_reference(hosts):
    src, jsrc = SyntheticLM(101, seed=1), JSyntheticLM(101, seed=1)
    parts = []
    for h in range(hosts):
        ld = ShardedLoader(src, DataConfig(16, 8, host_index=h,
                                           host_count=hosts), device="cpu")
        jld = JShardedLoader(jsrc, JDataConfig(16, 8, host_index=h,
                                               host_count=hosts))
        for step in (0, 5):
            b, jb = ld.device_batch(step), jld.device_batch(step)
            assert set(b) == set(jb) == {"tokens"}
            assert b["tokens"].dtype == torch.int32
            assert b["tokens"].device.type == "cpu"
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          np.asarray(jb["tokens"]))
        parts.append(ld.host_batch(2))
    np.testing.assert_array_equal(np.concatenate(parts), src.batch(2, 16, 8))
    it = iter(ShardedLoader(src, DataConfig(4, 8), device="cpu"))
    np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                  src.batch(0, 4, 8))


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1, 1) ('data', 'model') mesh over a one-rank gloo group, torn
    down after the test (tests/test_torch_mesh_train.py runs 8 ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_sharded_loader_refuses_a_mesh_and_a_ragged_split(one_rank_mesh):
    """A mesh and a batch spec give DTensor batches on the spec's
    placements, equal to the reference's; a ragged split still raises."""
    from torch.distributed.tensor import DTensor, Shard
    src = SyntheticLM(11)
    ld = ShardedLoader(src, DataConfig(4, 8), mesh=one_rank_mesh,
                       batch_spec=("data",), device="cpu")
    b = ld.device_batch(3)["tokens"]
    assert isinstance(b, DTensor)
    assert tuple(b.placements)[0] == Shard(0)
    np.testing.assert_array_equal(b.full_tensor().numpy(),
                                  JSyntheticLM(11).batch(3, 4, 8))
    with pytest.raises(ValueError):
        ShardedLoader(SyntheticLM(11), DataConfig(6, 8, host_count=4),
                      device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints: the reference's cases on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
                       "b": torch.ones(3, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_roundtrip_with_bf16(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, tree, {"note": "hi"})
    back = cm.restore(5, tree)
    assert _equal(tree, back)
    assert cm.manifest(5)["metadata"]["note"] == "hi"
    assert cm.manifest(5)["entries"]["params/b"]["dtype"] == "bfloat16"


def test_async_save(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(1, tree)
    tree["params"]["w"].add_(100.0)       # the snapshot was taken at the call
    cm.wait()
    assert cm.latest_step() == 1
    back = cm.restore(1, tree)
    assert float(back["params"]["w"][0, 1]) == 1.0


def test_async_save_error_surfaces_at_wait(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    os.rmdir(cm.dir)
    open(cm.dir, "w").close()             # the writer cannot make step dirs
    cm.save_async(3, tree)
    with pytest.raises(OSError):
        cm.wait()
    cm.wait()                             # raised once, then cleared


def test_gc_keeps_last_k(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    assert cm.all_steps() == [3, 4]


def test_corruption_detected(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    path = cm.save(9, tree)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    key = "params/w"
    assert key in manifest["entries"]
    data = dict(np.load(os.path.join(path, "arrays.npz")))
    arr = data[key].copy()
    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
    data[key] = arr
    np.savez(os.path.join(path, "arrays.npz"), **data)
    with pytest.raises(IOError, match="checksum"):
        cm.restore(9, tree)
    cm.restore(9, tree, verify=False)


def test_shape_mismatch_rejected(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree)
    bad = dict(tree, params=dict(tree["params"], w=torch.zeros(5, 6)))
    with pytest.raises(ValueError, match="shape"):
        cm.restore(1, bad)


def test_restore_onto_shardings_waits_for_distribution(tmp_path, tree,
                                                       one_rank_mesh):
    """``shardings=`` gives DTensors on the given placements, exactly the
    saved values (8 ranks and other meshes: test_torch_mesh_train.py); a
    save of those DTensors writes the single-device files."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import Sharding, spec_to_placements
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(2, tree)
    spec = ("model", "data")
    sh = Sharding(one_rank_mesh, spec,
                  spec_to_placements(spec, one_rank_mesh))
    shardings = {"params": {"w": sh, "b": None}, "opt": {"step": None}}
    back = cm.restore(2, tree, shardings=shardings)
    assert isinstance(back["params"]["w"], DTensor)
    assert tuple(back["params"]["w"].placements) == sh.placements
    assert torch.equal(back["params"]["w"].full_tensor(), tree["params"]["w"])
    assert torch.equal(back["params"]["b"], tree["params"]["b"])
    cm.save(3, back)
    assert cm.manifest(3)["entries"] == cm.manifest(2)["entries"]


def test_restore_takes_the_template_dtype(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, tree)
    tpl = tree_map(lambda x: x.to(torch.float64), tree)
    back = cm.restore(2, tpl)
    assert back["params"]["b"].dtype == torch.float64
    assert torch.equal(back["params"]["w"], tree["params"]["w"].double())


def test_atomicity_no_tmp_left(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, tree)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

def _state_pair(seed: int = 0):
    """The same training-state tree in both packages: bf16 and f32
    parameters with a hybrid-style list, their 8-bit AdamW state (int8
    moments, f32 scales) and the 0-d int32 step (3)."""
    rng = np.random.default_rng(seed)
    np_params = {
        "embed": {"table": rng.normal(size=(64, 32)).astype(np.float32)},
        "stack": {"groups": [{"ln": rng.normal(size=(2, 32)).astype(
                                  np.float32)},
                             {"ln": rng.normal(size=(2, 32)).astype(
                                 np.float32)}],
                  "w": rng.normal(size=(2, 32, 48)).astype(np.float32)},
    }
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_params["stack"]["w"] = j_params["stack"]["w"].astype(jnp.bfloat16)
    j_opt = j_adamw_init(JAdamWConfig(eightbit=True), j_params)
    j_opt = jax.tree.map(
        lambda a: (jnp.asarray(rng.integers(-127, 128, a.shape), a.dtype)
                   if a.dtype == jnp.int8 else
                   jnp.asarray(rng.random(a.shape), a.dtype)
                   if a.ndim else a), j_opt)
    j_opt["step"] = jnp.asarray(3, jnp.int32)
    to_t = {np.dtype(ml_dtypes.bfloat16): torch.bfloat16}

    def t(a):
        a = np.asarray(a)
        if a.dtype in to_t:
            return torch.tensor(a.astype(np.float32), dtype=to_t[a.dtype])
        return torch.tensor(a)
    j_tree = {"params": j_params, "opt": j_opt}
    return j_tree, jax.tree.map(t, j_tree)


def _assert_same(j_tree, t_tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(j_tree)[0]:
        got = t_tree
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        want = np.asarray(leaf)
        if want.dtype == np.dtype(ml_dtypes.bfloat16):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        else:
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), want)


def test_reference_checkpoint_restores_in_port(tmp_path):
    j_tree, t_tree = _state_pair()
    JCheckpointManager(str(tmp_path)).save(3, j_tree, {"arch": "x"})
    tpl = tree_map(torch.zeros_like, t_tree)
    back = CheckpointManager(str(tmp_path)).restore(3, tpl)
    _assert_same(j_tree, back)
    assert back["opt"]["step"].dim() == 0


def test_port_checkpoint_restores_in_reference(tmp_path):
    j_tree, t_tree = _state_pair(1)
    cm = CheckpointManager(str(tmp_path))
    cm.save(4, t_tree, {"arch": "x"})
    tpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                       j_tree)
    back = JCheckpointManager(str(tmp_path)).restore(4, tpl)
    _assert_same(back, t_tree)
    j_dir = tmp_path / "ref"
    JCheckpointManager(str(j_dir)).save(4, j_tree, {"arch": "x"})
    ours, theirs = cm.manifest(4), JCheckpointManager(str(j_dir)).manifest(4)
    assert ours["entries"] == theirs["entries"]       # names, dtypes, sha256
    assert list(ours["entries"]) == list(theirs["entries"])


def test_port_checkpoint_with_optimizer_state_of_port(tmp_path):
    """An 8-bit and an fp32 state made by the port keep their layout
    through save and restore."""
    params = {"a": torch.randn(4, 32), "b": [torch.randn(16)]}
    for cfg in (AdamWConfig(), AdamWConfig(eightbit=True)):
        state = {"params": params, "opt": adamw_init(cfg, params)}
        cm = CheckpointManager(str(tmp_path / str(cfg.eightbit)))
        cm.save(1, state)
        assert _equal(cm.restore(1, tree_map(torch.zeros_like, state)), state)


# ---------------------------------------------------------------------------
# Fault tolerance: the reference's cases on the port
# ---------------------------------------------------------------------------

def test_straggler_flags_outlier():
    det = StragglerDetector(min_samples=4)
    flags = [det.observe(0, 1.0) for _ in range(10)]
    assert not any(flags)
    assert det.observe(0, 10.0)


def test_straggler_adapts_to_new_normal():
    det = StragglerDetector(min_samples=4, alpha=0.5)
    for _ in range(10):
        det.observe(0, 1.0)
    for _ in range(20):
        det.observe(0, 3.0)
    assert not det.observe(0, 3.2)
    assert det.slowest() == 0


def test_heartbeat_detects_dead():
    t = [0.0]
    hb = HeartbeatMonitor(timeout_factor=3.0, min_timeout_s=1.0,
                          clock=lambda: t[0])
    for _ in range(5):
        t[0] += 1.0
        hb.beat(0)
        hb.beat(1)
    t[0] += 10.0
    hb.beat(1)
    assert hb.dead_clusters() == [0]


def test_elastic_planner_end_to_end(tmp_path):
    cm = ClusterManager(devices=devs(16), n_clusters=4)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(42, {"w": torch.ones(4)})
    planner = ElasticPlanner(cm, ckpt)
    plan = planner.plan([1, 3])
    assert plan.failed_clusters == [1, 3]
    assert plan.surviving_devices == 8
    assert plan.new_n_clusters == 2
    assert plan.restore_step == 42
    clusters = planner.execute(plan, request_classes=("rt", "batch"))
    assert len(clusters) == 2
    assert cm.check_disjoint()
    assert set(plan.repin.values()) <= {0, 1}


def test_planner_no_survivors():
    planner = ElasticPlanner(ClusterManager(devices=devs(4), n_clusters=2))
    with pytest.raises(RuntimeError):
        planner.plan([0, 1])
