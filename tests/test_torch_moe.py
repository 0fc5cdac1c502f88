"""The port's moe family (llama4-maverick-400b-a17b: 128 experts top-1 with
a shared expert, MoE every other layer; grok-1-314b: 8 experts top-2 every
layer, attention and final softcaps) against the reference, reduced (4
experts, d=128, f32), the reference's parameters converted by
``params_from_jax`` (unit norm weights replaced by random values on both
sides, so they really carry across).

``moe_apply`` in both group modes — ``local`` over fixed groups of 8
tokens and over whole sequences, ``global`` over every token at once —
gives the reference's output, ``moe_lb`` and ``moe_z`` to 1e-4 and its
top-k choices exactly, at the reduced config's drop-free capacity factor
(E) and at the published 1.25, where capacity drops tokens (the cases
assert that it does, so the drop order is what is compared). The models'
prefill and three decode steps' logits agree to 1e-4; the engine serves
the reference engine's tokens on host and chunked prefill."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro.models.layers import Builder
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.distributed import ShardCtx
from repro_torch.models import build, moe, params_from_jax
from repro_torch.models.transformer import period_spec
from repro_torch.serving import ServingEngine
from test_torch_dense_configs import _perturbed

ARCHS = ["llama4-maverick-400b-a17b", "grok-1-314b"]
ATOL = 1e-4
MAX_SEQ = 32


def _moe_cfgs(arch, cf, group):
    """(reference, port) reduced configs with the capacity factor ``cf``
    ('reduced' keeps the reduced config's E) and dispatch group length
    ``group`` set on both sides."""
    out = []
    for get in (j_get_config, get_config):
        cfg = get(arch).reduced()
        m = cfg.moe
        out.append(replace(cfg, moe=replace(
            m, group_size=group,
            capacity_factor=m.capacity_factor if cf == "reduced" else cf)))
    return out


def _reference_topk(x, router, cfg, group_mode):
    """The reference's grouping and f32 routing (repro/models/moe.py),
    written out: its top-k choices, (G, Sg, K)."""
    m = cfg.moe
    B, S, D = x.shape
    if group_mode == "global":
        xg = x.reshape(1, B * S, D)
    else:
        g = min(m.group_size, S)
        xg = x.reshape(B * (S // g), g, D) if S % g == 0 and S > g else x
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", jnp.asarray(xg),
                                      jnp.asarray(router)), axis=-1)
    return np.asarray(jax.lax.top_k(probs, m.top_k)[1])


@pytest.mark.parametrize("group_mode,group", [("local", 8), ("local", 512),
                                              ("global", 512)])
@pytest.mark.parametrize("cf", ["reduced", 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf, group_mode, group,
                                     monkeypatch):
    j_cfg, cfg = _moe_cfgs(arch, cf, group)
    j_p = j_moe.moe_params(Builder("init", jax.random.key(1), jnp.float32),
                           j_cfg)
    np_p = jax.tree.map(np.asarray, j_p)
    p = params_from_jax(np_p, cfg, "cpu")
    rng = np.random.default_rng(2)
    # a component every token shares skews the routing toward some
    # experts, as trained routers are skewed: at cf = 1.25 their
    # capacity then drops tokens in every grouping
    x = (rng.normal(size=(2, 24, cfg.d_model))
         + 2.0 * rng.normal(size=cfg.d_model)).astype(np.float32)
    j_y, j_aux = j_moe.moe_apply(j_p, jnp.asarray(x), j_cfg,
                                 JShardCtx.single(kind="decode"), group_mode)
    routed = []
    own_route = moe.route

    def recording_route(logits, top_k, capacity):
        out = own_route(logits, top_k, capacity)
        routed.append((out[1], out[3], capacity))
        return out

    monkeypatch.setattr(moe, "route", recording_route)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg,
                           ShardCtx.single(kind="decode"), group_mode)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=ATOL, rtol=0)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    (idx, dispatch, capacity), = routed
    want = _reference_topk(x, np_p["router"], cfg, group_mode)
    np.testing.assert_array_equal(idx.numpy(), want)
    G, Sg, K = idx.shape
    assert (G, Sg) == ((6, 8) if group_mode == "local" and group == 8 else
                       (1, 48) if group_mode == "global" else (2, 24))
    kept = int(dispatch.sum())
    if cf == "reduced":
        assert kept == G * Sg * K                # cf = E drops nothing
    else:
        assert kept < G * Sg * K                 # capacity drops tokens
        assert int(dispatch.sum(dim=1).max()) <= capacity


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    j_cfg = j_get_config(request.param).reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    np_params = _perturbed(jax.tree.map(np.asarray,
                                        j_model.init(jax.random.key(0))),
                           np.random.default_rng(5))
    j_params = jax.tree.map(jnp.asarray, np_params)
    cfg = get_config(request.param).reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    return cfg, j_model, j_params, model, params


def test_period_spec_and_parameter_tree_match_reference(pair):
    cfg, j_model, j_params, model, params = pair
    from repro.models.transformer import period_spec as j_period_spec
    assert period_spec(cfg) == j_period_spec(j_get_config(cfg.name[
        :-len("-reduced")]).reduced())
    shapes = jax.tree.map(lambda a: tuple(a.shape), j_params)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    # the port's own init draws the same tree
    own = model.init(0)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes


def test_prefill_and_decode_match_reference(pair):
    cfg, j_model, j_params, model, params = pair
    rng = np.random.default_rng(3)
    B, S = 2, 13
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_model.prefill(p, b, MAX_SEQ))(
            j_params, {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                   MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=0)
    for blk in caches:
        for kk in ("k", "v"):
            np.testing.assert_allclose(caches[blk][kk].numpy(),
                                       np.asarray(j_caches[blk][kk]),
                                       atol=ATOL, rtol=0)
    j_dec = jax.jit(j_model.decode_step)
    pos = np.full((B,), S, np.int32)
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        j_logits, j_caches = j_dec(j_params, j_caches, jnp.asarray(nxt),
                                   jnp.asarray(pos))
        logits, caches = model.decode_step(params, caches,
                                           torch.from_numpy(nxt),
                                           torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
        pos = pos + 1
    if cfg.logit_softcap:
        assert float(logits.abs().max()) <= cfg.logit_softcap


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["host_prefill", "chunked_prefill"])
def test_generate_matches_reference(pair, chunked):
    cfg, j_model, j_params, model, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(3, 14))
               for _ in range(4)]
    kw = dict(max_batch=2, max_seq=MAX_SEQ, chunked_prefill=chunked,
              prefill_chunk_tokens=4)
    j_eng = JServingEngine(j_model, j_params, **kw)
    want = j_eng.generate(prompts, max_new_tokens=5)
    j_eng.dispose()
    eng = ServingEngine(model, params, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=5)
    ds = eng.dispatcher.deadline_stats()
    eng.dispose()
    assert got == want
    assert ds["met"] == ds["n"]


def test_registry_lists_the_reference_configs():
    from repro.configs import list_configs as j_list_configs
    from repro_torch.configs import list_configs
    assert list_configs() == j_list_configs()
    assert len(list_configs()) == 10


def test_init_draws_big_leaves_by_slice_and_stacks_one_layer_as_a_view(
        monkeypatch):
    """A normal leaf whose f32 draw passes BIG_DRAW_BYTES is drawn one
    leading-axis slice at a time into its storage dtype (the same numbers
    as slice-by-slice f32 draws, cast); a smaller leaf is the one f32 draw
    it always was; ``stack(1, fn)`` is fn's layer under a view axis."""
    from repro_torch.models import layers
    shape = (3, 40, 50)
    monkeypatch.setattr(layers, "BIG_DRAW_BYTES", 4 * 40 * 50 * 2)
    big = layers.Init(9, torch.bfloat16, "cpu").p(shape)
    gen = torch.Generator().manual_seed(9)
    want = torch.stack([(torch.randn(shape[1:], generator=gen)
                         * 120 ** -0.5).to(torch.bfloat16)
                        for _ in range(3)])
    assert big.dtype == torch.bfloat16 and torch.equal(big, want)
    monkeypatch.setattr(layers, "BIG_DRAW_BYTES", 4 * 3 * 40 * 50)
    small = layers.Init(9, torch.bfloat16, "cpu").p(shape)
    gen = torch.Generator().manual_seed(9)
    assert torch.equal(small, (torch.randn(shape, generator=gen)
                               * 120 ** -0.5).to(torch.bfloat16))
    drawn = []

    def layer(b):
        drawn.append({"w": b.p((4, 6)), "n": b.p((6,), init="ones")})
        return drawn[-1]
    one = layers.Init(0, torch.float32, "cpu").stack(1, layer)
    assert len(drawn) == 1 and tuple(one["w"].shape) == (1, 4, 6)
    assert one["w"].data_ptr() == drawn[0]["w"].data_ptr()
    three = layers.Init(0, torch.float32, "cpu").stack(3, layer)
    assert tuple(three["w"].shape) == (3, 4, 6)
    assert torch.equal(three["w"][0], one["w"][0])
