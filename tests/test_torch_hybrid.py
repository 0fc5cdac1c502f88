"""The port's hybrid family (zamba2-7b) against the reference: reduced
zamba2-7b (4 layers = 2 groups of [shared attention block, 2 mamba
layers], d=128, f32), and the same with 5 layers, so a tail mamba layer
runs, and zamba2-7b's own SSM state width of 64 (the reduced config
keeps 16), with the reference's parameters converted by
``params_from_jax``.
Prefill and each decode step's logits agree to 1e-4 (f32, two frameworks
summing in different orders); the cache trees (the shared block's K/V per
invocation, the SSM states of each group position and of the tail) have
the reference's shapes and values after the prefill and after two decode
steps; the engine's tokens equal the reference engine's on host and
chunked prefill."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.distributed import ShardCtx
from repro_torch.models import build, params_from_jax
from repro_torch.models.hybrid import hybrid_forward
from repro_torch.serving import ServingEngine

ATOL = 1e-4
MAX_SEQ = 32


def flat(tree, path=""):
    """{path: numpy array} of a cache or parameter tree (dicts by sorted
    key, lists by index), for either framework's leaves."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{path}/{i}").items()}
    return {path: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                             else tree, np.float32)}


def assert_trees_close(got, want, what):
    g, w = flat(got), flat(want)
    assert list(g) == list(w), what
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=0,
                                   err_msg=f"{what} {k}")


def _cfg(get, layers, state_dim):
    cfg = get("zamba2-7b").reduced()
    return replace(cfg, num_layers=layers,
                   ssm=replace(cfg.ssm, state_dim=state_dim))


@pytest.fixture(scope="module", params=[(4, 16), (5, 64)],
                ids=["groups", "with_tail_state64"])
def pair(request):
    j_cfg = _cfg(j_get_config, *request.param)
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    j_params = j_model.init(jax.random.key(0))
    cfg = _cfg(get_config, *request.param)
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    return cfg, j_model, j_params, model, params


def test_params_carry_across(pair):
    """The converted tree keeps the reference's layout: one shared block,
    ``groups`` as a list of ``every`` layer trees stacked over groups, and
    a ``tail`` stack where the layer count leaves one; the port's own init
    builds the same tree; train mode runs that tree as the reference's."""
    cfg, j_model, j_params, model, params = pair
    assert_trees_close(params, jax.tree.map(np.asarray, j_params), "params")
    stack = params["stack"]
    assert isinstance(stack["groups"], list) and len(stack["groups"]) == 2
    assert tuple(stack["shared"]["w_cat"].shape) == (256, 128)
    assert ("tail" in stack) == (cfg.num_layers == 5)
    own = model.init(0)
    assert {k: v.shape for k, v in flat(own).items()} == \
        {k: v.shape for k, v in flat(params).items()}
    # train mode (slice 11) runs the same stack: (x, aux) as the reference's
    from repro.models.hybrid import hybrid_forward as j_hybrid_forward
    x = np.random.default_rng(4).normal(size=(1, 3, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(3, dtype=np.int32)[None]
    out, aux = hybrid_forward(params["stack"], torch.from_numpy(x), cfg,
                              ShardCtx.single(), mode="train",
                              pos=torch.from_numpy(pos))
    j_out, j_aux = j_hybrid_forward(j_params["stack"], jnp.asarray(x),
                                    j_model.cfg, JShardCtx.single(),
                                    mode="train",
                                    pos=jnp.asarray(pos))
    assert aux == {} and j_aux == {}
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)


def test_prefill_and_decode_match_reference(pair):
    cfg, j_model, j_params, model, params = pair
    rng = np.random.default_rng(3)
    B, S = 2, 11
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_model.prefill(p, b, MAX_SEQ))(
            j_params, {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                   MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=0)
    assert_trees_close(caches, j_caches, "prefill caches")
    j_dec = jax.jit(j_model.decode_step)
    pos = np.full((B,), S, np.int32)
    for step in range(2):
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
    assert_trees_close(caches, j_caches, "caches after two decode steps")
    init = model.init_caches(B, MAX_SEQ)
    assert {k: v.shape for k, v in flat(init).items()} == \
        {k: v.shape for k, v in flat(j_model.init_caches(B, MAX_SEQ)).items()}
    assert all(float(np.abs(v).max()) == 0 for v in flat(init).values())


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["host_prefill", "chunked_prefill"])
def test_generate_matches_reference(pair, chunked):
    cfg, j_model, j_params, model, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(5, 11))
               for _ in range(3)]
    kw = dict(max_batch=2, max_seq=MAX_SEQ, chunked_prefill=chunked,
              prefill_chunk_tokens=4)
    j_eng = JServingEngine(j_model, j_params, **kw)
    want = j_eng.generate(prompts, max_new_tokens=4)
    j_eng.dispose()
    eng = ServingEngine(model, params, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=4)
    ds = eng.dispatcher.deadline_stats()
    eng.dispose()
    assert got == want
    assert ds["met"] == ds["n"]
    assert (ds["chunks"] > 0) == chunked
