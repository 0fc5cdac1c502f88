"""The port's dense model against the reference: reduced llama3-8b (4
layers, d=128, f32), the reference's parameters converted by
``params_from_jax``. Prefill logits, prefill caches and three decode
steps' logits agree to 1e-4 (f32; the two frameworks sum in different
orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    j_cfg = j_get_config("llama3-8b").reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    j_params = j_model.init(jax.random.key(0))
    cfg = get_config("llama3-8b").reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    return j_model, j_params, model, params


def test_reduced_config_is_the_reference():
    cfg = get_config("llama3-8b").reduced()
    assert cfg == get_config("llama3-8b").reduced()
    ref = j_get_config("llama3-8b").reduced()
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}
    assert (cfg.num_layers, cfg.d_model, cfg.dtype) == (4, 128, "float32")


def test_prefill_and_decode_match_reference(pair):
    j_model, j_params, model, params = pair
    rng = np.random.default_rng(3)
    B, S, max_seq = 2, 11, 32
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_model.prefill(p, b, max_seq))(
            j_params, {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                   max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=0)
    for kk in ("k", "v"):
        np.testing.assert_allclose(caches["blk0"][kk].numpy(),
                                   np.asarray(j_caches["blk0"][kk]),
                                   atol=ATOL, rtol=0)
    j_dec = jax.jit(j_model.decode_step)
    pos = np.full((B,), S, np.int32)
    for step in range(3):
        nxt = rng.integers(0, 512, (B, 1)).astype(np.int32)
        j_logits, j_caches = j_dec(j_params, j_caches, jnp.asarray(nxt),
                                   jnp.asarray(pos))
        logits, caches = model.decode_step(params, caches,
                                           torch.from_numpy(nxt),
                                           torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
        pos = pos + 1


def test_init_scales_follow_reference():
    """The port's own init draws different numbers (torch.Generator) but
    with the reference's scales and layouts."""
    cfg = get_config("llama3-8b").reduced()
    model = build(cfg, device="cpu")
    p = model.init(0)
    assert tuple(p["stack"]["blk0"]["attn"]["wq"].shape) == (4, 128, 4, 32)
    assert tuple(p["stack"]["blk0"]["attn"]["wo"].shape) == (4, 4, 32, 128)
    assert tuple(p["embed"]["table"].shape) == (512, 128)
    assert torch.equal(p["final_norm"], torch.ones(128))
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.002
    w_in = p["stack"]["blk0"]["mlp"]["w_in"]
    assert abs(float(w_in.std()) - 128 ** -0.5) < 0.01
    assert not torch.equal(w_in[0], w_in[1])       # layers drawn apart
    assert torch.equal(model.init(0)["embed"]["table"], p["embed"]["table"])
