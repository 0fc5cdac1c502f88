"""The port's vlm family (internvl2-76b: stub patch embeddings prepended to
the prompt's token embeddings) against the reference, reduced (8 vision
tokens, d=128, f32), the reference's parameters converted by
``params_from_jax``.

Prefill logits and caches agree to 1e-4 with the image prefix in the
prompt; decode steps at positions ``L + vision_tokens`` onward (the
reference model's own contract, tests/test_models_smoke.py) agree to
1e-4. The port's engine serves the tokens of the reference MODEL decoded
greedily at those positions. (The reference ENGINE allocates and stages
the slot with the text length L, so its decode writes inside the image
prefix and drops the last text tokens out of attention: its tokens are
not the model's, and the port does not copy that.) The serve entry point
draws the reference CLI's prompts and patch embeddings, and the engine
refuses a request whose prefix, prompt and new tokens overflow the
cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build, params_from_jax
from repro_torch.serving import ServingEngine
from test_torch_dense_configs import _perturbed

ARCH = "internvl2-76b"
ATOL = 1e-4
MAX_SEQ = 48


@pytest.fixture(scope="module")
def pair():
    j_cfg = j_get_config(ARCH).reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    np_params = _perturbed(jax.tree.map(np.asarray,
                                        j_model.init(jax.random.key(0))),
                           np.random.default_rng(5))
    j_params = jax.tree.map(jnp.asarray, np_params)
    cfg = get_config(ARCH).reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    return cfg, j_model, j_params, model, params


def _vision(rng, cfg, n):
    return rng.normal(size=(n, cfg.vision_tokens,
                            cfg.d_model)).astype(np.float32)


def test_prefill_and_decode_match_reference(pair):
    cfg, j_model, j_params, model, params = pair
    assert cfg.family == "vlm" and cfg.vision_tokens == 8
    rng = np.random.default_rng(3)
    B, S = 2, 9
    V = cfg.vision_tokens
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vis = _vision(rng, cfg, B)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_model.prefill(p, b, MAX_SEQ))(
            j_params, {"tokens": jnp.asarray(toks),
                       "vision_embeds": jnp.asarray(vis)})
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(toks),
                 "vision_embeds": torch.from_numpy(vis)}, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=0)
    for blk in caches:
        for kk in ("k", "v"):
            c = caches[blk][kk]
            assert c.shape[2] == MAX_SEQ
            # the prefix's rows and the prompt's are written, none past
            assert float(c[:, :, V + S:].abs().max()) == 0.0
            assert float(c[:, :, V + S - 1].abs().max()) > 0.0
            np.testing.assert_allclose(c.numpy(),
                                       np.asarray(j_caches[blk][kk]),
                                       atol=ATOL, rtol=0)
    # the image prefix matters: without it the logits move
    blank = model.prefill(params, {
        "tokens": torch.from_numpy(toks),
        "vision_embeds": torch.zeros_like(torch.from_numpy(vis))},
        MAX_SEQ)[0]
    assert float((blank - logits).abs().max()) > 1e-2
    j_dec = jax.jit(j_model.decode_step)
    pos = np.full((B,), V + S, np.int32)
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


def _reference_model_tokens(j_model, j_params, cfg, prompt, vis, max_new):
    """Greedy tokens of the reference model for one request, decoded at
    positions L + vision_tokens, L + vision_tokens + 1, ..."""
    logits, caches = j_model.prefill(
        j_params, {"tokens": jnp.asarray(prompt[None]),
                   "vision_embeds": jnp.asarray(vis[None])}, MAX_SEQ)
    tok = int(jnp.argmax(logits[0, -1]))
    out = [tok]
    pos = cfg.vision_tokens + len(prompt)
    dec = jax.jit(j_model.decode_step)
    for _ in range(max_new - 1):
        logits, caches = dec(j_params, caches,
                             jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([pos], jnp.int32))
        tok = int(jnp.argmax(logits[0, -1]))
        out.append(tok)
        pos += 1
    return out


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["host_prefill", "chunked_prefill"])
def test_engine_serves_the_reference_model_tokens(pair, chunked):
    """Four requests over two slots (slot reuse), each with its patch
    embeddings: the engine's tokens are the reference model's at
    L + vision_tokens. A request with extras takes the host prefill on a
    chunked engine too."""
    cfg, j_model, j_params, model, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 14))
               for _ in range(4)]
    vis = _vision(rng, cfg, 4)
    want = [_reference_model_tokens(j_model, j_params, cfg, p, v, 5)
            for p, v in zip(prompts, vis)]
    eng = ServingEngine(model, params, max_batch=2, max_seq=MAX_SEQ,
                        device="cpu", chunked_prefill=chunked,
                        prefill_chunk_tokens=4)
    got = eng.generate(prompts, max_new_tokens=5,
                       extras=[{"vision_embeds": v} for v in vis])
    ds = eng.dispatcher.deadline_stats()
    eng.dispose()
    assert got == want
    assert ds["met"] == ds["n"]


def test_engine_refuses_an_overlong_prefix(pair):
    cfg, _, _, model, params = pair
    V = cfg.vision_tokens
    eng = ServingEngine(model, params, max_batch=2, max_seq=MAX_SEQ,
                        device="cpu")
    vis = {"vision_embeds": np.zeros((V, cfg.d_model), np.float32)}
    L = MAX_SEQ - V - 4             # V + L + 4 - 1 = max_seq - 1 fits
    assert eng.add_request(0, np.ones(L, np.int32), 4, vis) is not None
    with pytest.raises(ValueError, match="max_seq"):
        eng.add_request(1, np.ones(L + 1, np.int32), 4, vis)
    assert eng.slots.any_active and len(eng.slots.decoding_indices()) == 0
    eng.dispose()


def test_serve_draws_the_reference_cli_requests(monkeypatch):
    """``serve._requests`` gives the prompts and patch embeddings the
    reference CLI hands its engine (one numpy generator, same order); and
    the port's CLI serves them, while ``--streams`` refuses the arch."""
    from repro.launch import serve as j_serve
    seen = {}

    def record(self, prompts, max_new_tokens=16, extras=None):
        seen.update(prompts=prompts, extras=extras)
        return [[0] * max_new_tokens for _ in prompts]

    monkeypatch.setattr(j_serve.ServingEngine, "generate", record)
    argv = ["--arch", ARCH, "--reduced", "--requests", "3", "--max-new",
            "3", "--max-batch", "2", "--max-seq", "32", "--seed", "4"]
    j_serve.main(argv)
    cfg = get_config(ARCH).reduced()
    prompts, extras = serve._requests(cfg, 3, 4)
    assert len(prompts) == len(seen["prompts"]) == 3
    for a, b in zip(prompts, seen["prompts"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(extras, seen["extras"]):
        assert set(a) == set(b) == {"vision_embeds"}
        assert a["vision_embeds"].shape == (cfg.vision_tokens, cfg.d_model)
        np.testing.assert_array_equal(a["vision_embeds"], b["vision_embeds"])
    report = serve.main(argv + ["--device", "cpu"])
    assert [len(o) for o in report.outputs] == [3, 3, 3]
    assert report.deadline_stats["met"] == report.deadline_stats["n"]
    with pytest.raises(SystemExit, match="streams"):
        serve.main(argv + ["--device", "cpu", "--streams"])
