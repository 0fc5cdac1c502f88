"""The port's encoder-decoder family (whisper-tiny) against the reference:
reduced whisper-tiny (2 encoder and 4 decoder layers, 16 stub frames,
d=128, f32) with the reference's parameters converted by
``params_from_jax``, and the frames drawn with numpy. Prefill and each
decode step's logits agree to 1e-4 (f32, two frameworks summing in
different orders); the cache trees (causal self K/V padded to max_seq,
cross K/V over the frames) have the reference's shapes and values after
the prefill and after two decode steps; the engine's tokens equal the
reference engine's with frames extras, on a host-prefill engine and on a
chunked-prefill one, where a request with extras still takes the host
prefill; the layers the family adds (``layer_norm``, the sinusoidal
positions) equal the reference's. The serve CLI is held to the
reference's in tests/test_torch_serving.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro.models import layers as j_layers
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.core.telemetry import EV_ENGINE, TraceCollector
from repro_torch.models import build, layers, params_from_jax
from repro_torch.serving import ServingEngine
from test_torch_hybrid import assert_trees_close, flat

ATOL = 1e-4
MAX_SEQ = 32


@pytest.fixture(scope="module")
def pair():
    j_cfg = j_get_config("whisper-tiny").reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    j_params = j_model.init(jax.random.key(0))
    cfg = get_config("whisper-tiny").reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    return cfg, j_model, j_params, model, params


def _frames(rng, cfg, n):
    return rng.normal(size=(n, cfg.encoder_frames,
                            cfg.d_model)).astype(np.float32)


def test_prefill_and_decode_match_reference(pair):
    cfg, j_model, j_params, model, params = pair
    assert (cfg.encoder_layers, cfg.num_layers, cfg.encoder_frames) == \
        (2, 4, 16)
    assert_trees_close(params, jax.tree.map(np.asarray, j_params), "params")
    rng = np.random.default_rng(3)
    B, S = 2, 7
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(rng, cfg, B)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_model.prefill(p, b, MAX_SEQ))(
            j_params, {"tokens": jnp.asarray(toks),
                       "frames": jnp.asarray(frames)})
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(toks),
                 "frames": torch.from_numpy(frames)}, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=0)
    assert_trees_close(caches, j_caches, "prefill caches")
    assert tuple(caches["cross"]["k"].shape) == (4, B, 16, 2, 32)
    assert tuple(caches["self"]["k"].shape) == (4, B, MAX_SEQ, 2, 32)
    j_dec = jax.jit(j_model.decode_step)
    pos = np.array([S, S - 2], np.int32)          # ragged positions
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


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["host_prefill", "chunked_engine"])
def test_generate_with_frames_matches_reference(pair, chunked):
    """Tokens equal the reference engine's; on a chunked-prefill engine a
    request with extras still takes the host prefill (no prefill chunk
    runs, though every prompt spans two or more)."""
    cfg, j_model, j_params, model, params = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(5, 11))
               for _ in range(3)]
    extras = [{"frames": f} for f in _frames(rng, cfg, 3)]
    kw = dict(max_batch=2, max_seq=MAX_SEQ, chunked_prefill=chunked,
              prefill_chunk_tokens=4)
    j_eng = JServingEngine(j_model, j_params, **kw)
    want = j_eng.generate(prompts, max_new_tokens=4, extras=extras)
    j_eng.dispose()
    tc = TraceCollector()
    eng = ServingEngine(model, params, device="cpu", telemetry=tc, **kw)
    got = eng.generate(prompts, max_new_tokens=4, extras=extras)
    ds = eng.dispatcher.deadline_stats()
    eng.dispose()
    assert got == want
    assert ds["met"] == ds["n"] and ds["chunks"] == 0
    paths = [e.extra.get("path") for e in tc.events_of(EV_ENGINE)
             if e.extra.get("phase") == "add_request"]
    assert paths == ["host"] * 3


@pytest.mark.parametrize("name", ["layer_norm", "sinusoidal_positions",
                                  "sinusoidal_at"])
def test_layers_match_reference(name):
    """f32: layer_norm to 1e-5; the sinusoids at whisper-tiny's positions
    (up to its 1500 frames, d=384) to 2e-4: an f32 angle near 1500 rad
    carries an ulp of 1.2e-4, and the two frameworks' exp of the
    frequencies may differ in the last bit."""
    rng = np.random.default_rng(11)
    atol = 2e-4
    if name == "layer_norm":
        x, w, b = (rng.normal(size=s).astype(np.float32)
                   for s in ((2, 5, 48), (48,), (48,)))
        args, atol = (x * 3 + 1, w, b, 1e-5), 1e-5
    elif name == "sinusoidal_positions":
        args = (1500, 384)
    else:
        args = (rng.integers(0, 1500, (6,)).astype(np.int32), 384)
    want = np.asarray(getattr(j_layers, name)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(layers, name)(*[
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
