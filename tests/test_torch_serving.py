"""The port's ServingEngine against the reference's: reduced llama3-8b with
the reference's parameters converted, 5 requests through 2 slots (slot
reuse), host prefill and chunked prefill — the generated tokens must be
identical, request by request."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_jax
from repro_torch.serving import ServingEngine

MAX_SEQ = 48


@pytest.fixture(scope="module")
def models():
    j_cfg = j_get_config("llama3-8b").reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    j_params = j_model.init(jax.random.key(1))
    cfg = get_config("llama3-8b").reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(3, 12))
               for _ in range(5)]
    return j_model, j_params, model, params, prompts


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["host_prefill", "chunked_prefill"])
def test_generate_matches_reference(models, chunked):
    j_model, j_params, model, params, prompts = models
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
    assert all(len(o) == 5 for o in got)
    assert ds["met"] == ds["n"]
    if chunked:
        assert ds["chunks"] > 0


@pytest.mark.parametrize("extra", [[], ["--chunked-prefill", "--policy",
                                        "server"]],
                         ids=["host_prefill", "chunked_server"])
def test_serve_cli_on_cpu(tmp_path, extra):
    """The port's serve entry point, asked for the CPU, serves every
    request, meets every deadline and exports its trace."""
    from repro_torch.launch import serve
    trace = tmp_path / "trace.json"
    report = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                         "--max-new", "3", "--max-batch", "2",
                         "--max-seq", "32", "--prefill-chunk", "4",
                         "--trace", str(trace)] + extra)
    assert [len(o) for o in report.outputs] == [3, 3, 3]
    ds = report.deadline_stats
    assert ds["met"] == ds["n"] and ds["n"] >= 3 + 2    # inserts + steps
    assert trace.stat().st_size > 0
    assert report.tracker.time_phases()["trigger"].count > 0
