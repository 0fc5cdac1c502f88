"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``).

Every case of ``tests/test_sharding.py`` runs on the port's functions. Then,
for all ten configs, the port's logical-axis trees (``param_axes``,
``cache_axes``, ``input_specs``) carry the reference's names letter for
letter; and for every inference shape a config runs × both production
meshes, every parameter, cache and input leaf gets the reference's spec
(``logical_to_spec`` with the divisibility fallback, on the reference
tests' ``FakeMesh``) and, as a DTensor on the port's ``DeviceMesh`` (over a
fake process group of 512 ranks in this process), the local block shape
that spec gives each device. Shapes come from ``jax.eval_shape`` on the
reference side and ``FakeTensorMode`` on the port's; they must agree too.
"""
import functools

import jax
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.distributed.sharding import Axes as JAxes
from repro.distributed.sharding import logical_to_spec as j_logical_to_spec
from repro.distributed.sharding import make_rules as j_make_rules
from repro.models import build as j_build
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import shape_applicable
from repro_torch.distributed.sharding import (Axes, ShardCtx, _fit_axes,
                                              axes, local_shape,
                                              logical_to_spec, make_rules,
                                              spec_to_placements)
from repro_torch.launch.dryrun import kind_of
from repro_torch.launch.mesh import production_shape
from repro_torch.models import build


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
INFERENCE = ("prefill_32k", "decode_32k", "long_500k")


# ---------------------------------------------------------------------------
# tests/test_sharding.py, on the port
# ---------------------------------------------------------------------------

def test_fit_axes_exact():
    assert _fit_axes(64, "model", MESH) == "model"
    assert _fit_axes(8, "model", MESH) is None
    assert _fit_axes(256, ("data", "model"), MESH) == ("data", "model")


def test_fit_axes_greedy_prefix():
    assert _fit_axes(32, ("pod", "data"), POD) == ("pod", "data")
    assert _fit_axes(8, ("pod", "data"), POD) == "pod"
    assert _fit_axes(1, ("pod", "data"), POD) is None


@given(dim=st.integers(1, 10_000))
@settings(max_examples=200, deadline=None)
def test_fit_axes_always_divides(dim):
    got = _fit_axes(dim, ("pod", "data", "model"), POD)
    if got is None:
        assert dim % 2 != 0
    else:
        names = (got,) if isinstance(got, str) else got
        prod = 1
        for n in names:
            prod *= POD.shape[n]
        assert dim % prod == 0


def test_train_rules_sequence_parallel():
    rules = make_rules(MESH, "train")
    assert rules["act_seq"] == "model"
    assert rules["embed"] == "data"
    assert rules["heads"] == "model"


def test_inference_rules():
    rules = make_rules(MESH, "decode")
    assert rules["act_seq"] is None
    assert rules["embed"] is None
    assert rules["cache_seq"] == "model"
    assert rules["expert_embed"] == "data"
    long = make_rules(MESH, "long_decode")
    assert long["cache_seq"] == ("data", "model")
    assert long["cache_batch"] is None


def test_multipod_rules():
    rules = make_rules(POD, "train")
    assert rules["act_batch"] == ("pod", "data")
    long = make_rules(POD, "long_decode")
    assert long["cache_seq"] == ("pod", "data", "model")


def test_logical_to_spec_with_shapes():
    rules = make_rules(MESH, "train")
    spec = logical_to_spec(axes("act_batch", None, "act_heads"), rules,
                           MESH, (256, 128, 8))
    assert spec == ("data",)


def test_expert_placement_rule():
    em = make_rules(MESH, "train", expert_on_model=True)
    assert em["expert"] == "model" and em["expert_mlp"] is None
    tp = make_rules(MESH, "train", expert_on_model=False)
    assert tp["expert"] is None and tp["expert_mlp"] == "model"


def test_single_ctx_noop():
    ctx = ShardCtx.single()
    x = torch.ones((4, 4))
    assert ctx.constrain(x, "act_batch", "act_seq") is x
    assert ctx.model_axis_size == 1


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "long_decode"])
@pytest.mark.parametrize("mesh", [MESH, POD], ids=["pod", "multipod"])
@pytest.mark.parametrize("eom", [True, False])
def test_rule_tables_equal_reference(kind, mesh, eom):
    assert make_rules(mesh, kind, eom) == j_make_rules(mesh, kind, eom)


def test_placements_of_multi_axis_dims():
    """A dim over several mesh axes is Shard(dim) on each, in mesh order;
    an axis order against the mesh's is refused."""
    from torch.distributed.tensor import Replicate, Shard
    assert spec_to_placements((("pod", "data"), None, "model"), POD) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_to_placements((None, ("pod", "data", "model")), POD) == (
        Shard(1),) * 3
    assert spec_to_placements((), MESH) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        spec_to_placements((("model", "data"),), MESH)


# ---------------------------------------------------------------------------
# The ten configs: logical axes, specs and local shard shapes
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    """{path: leaf} of nested dicts/lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (Axes,
                                                                 JAxes)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


def _names(tree):
    return {k: tuple(v.names) for k, v in _flat(tree).items()}


@functools.lru_cache(maxsize=None)
def _models(arch):
    return j_build(j_get_config(arch)), build(get_config(arch), device="cpu")


@pytest.mark.parametrize("arch", list_configs())
def test_logical_axes_equal_reference(arch):
    jm, m = _models(arch)
    assert _names(m.param_axes()) == _names(jm.param_axes())
    assert _names(m.cache_axes()) == _names(jm.cache_axes())
    for shape in INFERENCE + ("train_4k",):
        batch, ax = m.input_specs(SHAPES[shape])
        jbatch, jax_ = jm.input_specs(J_SHAPES[shape])
        assert _names(ax) == _names(jax_)
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _flat(batch).items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in
             _flat(jbatch).items()}


@functools.lru_cache(maxsize=None)
def _shapes(arch, shape_name):
    """{leaf path: global shape} of params, caches and inputs, both sides."""
    jm, m = _models(arch)
    cfg = m.cfg
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        S = S + cfg.vision_tokens
    with FakeTensorMode():
        params = m.init(0)
        caches = m.init_caches(B, S)
    batch, _ = m.input_specs(shape)
    port = {"params": params, "caches": caches, "batch": batch}
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    jc = jax.eval_shape(functools.partial(jm.init_caches, B, S))
    jb, _ = jm.input_specs(J_SHAPES[shape_name])
    ref = {"params": jp, "caches": jc, "batch": jb}
    return ({k: tuple(v.shape) for k, v in _flat(port).items()},
            {k: tuple(v.shape) for k, v in _flat(ref).items()})


@pytest.fixture(scope="module")
def device_meshes():
    """The port's production meshes over a fake 512-rank process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512)
    try:
        yield {mp: make_production_mesh(multi_pod=mp, device_type="cpu")
               for mp in (False, True)}
    finally:
        if made:
            dist.destroy_process_group()


CELLS = [(a, s) for a in list_configs() for s in INFERENCE
         if shape_applicable(get_config(a), SHAPES[s])[0]]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_specs_and_local_shapes_equal_reference(arch, shape_name, multi_pod,
                                                device_meshes):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    jm, m = _models(arch)
    cfg = m.cfg
    port_shapes, ref_shapes = _shapes(arch, shape_name)
    assert port_shapes == ref_shapes
    fmesh = POD if multi_pod else MESH
    mesh = device_meshes[multi_pod]
    assert production_shape(multi_pod) == (
        tuple(fmesh.shape.values()), fmesh.axis_names)
    kind = kind_of(SHAPES[shape_name])
    eom = cfg.moe is not None and cfg.moe.num_experts % 16 == 0
    ctx = ShardCtx.for_mesh(mesh, kind, eom)
    jrules = j_make_rules(fmesh, kind, eom)
    _, bax = m.input_specs(SHAPES[shape_name])
    _, jbax = jm.input_specs(J_SHAPES[shape_name])
    port_ax = _flat({"params": m.param_axes(), "caches": m.cache_axes(),
                     "batch": bax})
    ref_ax = _flat({"params": jm.param_axes(), "caches": jm.cache_axes(),
                    "batch": jbax})
    assert set(port_ax) == set(ref_ax) == set(port_shapes)
    for path, ax in port_ax.items():
        shape = port_shapes[path]
        want = tuple(j_logical_to_spec(ref_ax[path], jrules, fmesh, shape))
        sh = ctx.sharding_for(ax, shape)
        assert sh.spec == want, (path, sh.spec, want)
        loc, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                       sh.placements)
        assert tuple(loc) == local_shape(shape, want, fmesh), path
