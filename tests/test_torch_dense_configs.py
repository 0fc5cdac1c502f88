"""The dense-family configs the port registers beside llama3-8b —
gemma2-2b (local/global attention with window, attention and final
softcaps, sandwich norms, scaled embeddings, gelu, tied embeddings),
mistral-nemo-12b and qwen2-72b (qkv bias) — held to the reference at
reduced size (4 layers, d=128, f32).

The reference's parameters go through ``params_from_jax``; its zero biases
and unit norm weights are first replaced by random values on both sides,
so the bias and post-norm leaves really carry across. gemma2-2b's window
is set to 8 on both sides (the reduced config keeps 64, which a 13-token
prompt never reaches), so its local layers differ from its global ones.
Prefill and three decode steps' logits agree to 1e-4 (f32, two
frameworks summing in different orders); served tokens are identical."""
from dataclasses import asdict, replace

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
from repro_torch.models import build, params_from_jax
from repro_torch.serving import ServingEngine

ARCHS = ["gemma2-2b", "mistral-nemo-12b", "qwen2-72b"]
ATOL = 1e-4
WINDOW = 8
MAX_SEQ = 32


def _reduced(get, arch):
    cfg = get(arch).reduced()
    return replace(cfg, local_window=WINDOW) if cfg.local_window else cfg


def _perturbed(np_tree, rng):
    """Unit norm weights and zero biases replaced by random values."""
    def fix(a):
        a = np.asarray(a, np.float32)
        if np.all(a == 1.0):
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if np.all(a == 0.0):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree.map(fix, np_tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    j_cfg = _reduced(j_get_config, request.param)
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    np_params = _perturbed(jax.tree.map(np.asarray,
                                        j_model.init(jax.random.key(0))),
                           np.random.default_rng(5))
    j_params = jax.tree.map(jnp.asarray, np_params)
    cfg = _reduced(get_config, request.param)
    model = build(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    return cfg, j_model, j_params, model, params


# the hybrid, encdec, moe and vlm configs registered beside them (their
# models: tests/test_torch_hybrid.py, test_torch_encdec.py,
# test_torch_moe.py, test_torch_vlm.py)
@pytest.mark.parametrize("arch", ARCHS + [
    "zamba2-7b", "whisper-tiny", "llama4-maverick-400b-a17b", "grok-1-314b",
    "internvl2-76b"])
def test_configs_are_the_reference(arch):
    for fn in (lambda c: c, lambda c: c.reduced()):
        cfg, ref = fn(get_config(arch)), fn(j_get_config(arch))
        # asdict: the nested SSM/MoE configs field by field (each package
        # has its own dataclass)
        assert asdict(cfg) == asdict(ref)
    assert get_config(arch).param_count() == j_get_config(arch).param_count()


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
    if cfg.local_window:
        # the window really masks: without it the logits move
        wide = build(replace(cfg, local_window=0), device="cpu")
        far, _ = wide.prefill(params, {"tokens": torch.from_numpy(toks)},
                              MAX_SEQ)
        assert float((far - model.prefill(
            params, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)[0]
        ).abs().max()) > 1e-2
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
