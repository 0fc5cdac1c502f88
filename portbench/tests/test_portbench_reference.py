"""The plain reference against the port at a reduced size on the CPU (the
port's plain kernels): a prefill's logits and keys and values, and a
decode step on the port's own caches against the reference run over the
prompt and the decoded token."""
import numpy as np
import torch

from portbench import weights
from portbench.reference import Reference
from portbench.serve import model_config
from portbench.tests import tiny


def _port(config, seed):
    from repro_torch.distributed import ShardCtx
    from repro_torch.models import build
    cfg = model_config(config)
    model = build(cfg, ShardCtx.single(kind="decode"), device="cpu")
    return model, weights.params(config["model"], seed, "cpu")


def test_prefill_and_decode_match_the_port():
    config = tiny.config()
    seed = 2**33 + 5
    model, params = _port(config, seed)
    ref = Reference(config, seed, "cpu")
    rng = np.random.default_rng(0)
    B, L, max_seq = 4, 32, 48
    prompts = [torch.as_tensor(rng.integers(0, 512, L)) for _ in range(B)]
    batch = {"tokens": torch.stack(prompts).int()}
    with torch.no_grad():
        logits, caches = model.prefill(params, batch, max_seq=max_seq)
    r = ref.forward(prompts, [[L - 1]] * B, kv=True)
    got = torch.stack([x[0] for x in r["logits"]])
    assert torch.allclose(logits[:, 0], got, atol=2e-4, rtol=1e-4)
    for i in range(B):
        for li, (k, v) in enumerate(r["kv"][i]):
            assert torch.allclose(caches["blk0"]["k"][li, i, :L], k,
                                  atol=1e-4)
            assert torch.allclose(caches["blk0"]["v"][li, i, :L], v,
                                  atol=1e-4)
    toks = logits[:, 0].argmax(-1).int()
    pos = torch.full((B,), L, dtype=torch.int32)
    with torch.no_grad():
        dl, _ = model.decode_step(params, caches, toks[:, None], pos)
    fed = [torch.cat([p, t[None].long()]) for p, t in zip(prompts, toks)]
    rd = ref.forward(fed, [[L]] * B, kv=True)
    want = torch.stack([x[0] for x in rd["logits"]])
    assert torch.allclose(dl[:, 0], want, atol=2e-4, rtol=1e-4)
    for i in range(B):
        for li, (k, v) in enumerate(rd["kv"][i]):
            assert torch.allclose(caches["blk0"]["k"][li, i, L], k[L],
                                  atol=1e-4)
            assert torch.allclose(caches["blk0"]["v"][li, i, L], v[L],
                                  atol=1e-4)


def test_the_control_rounds_to_float8():
    config = tiny.config()
    ref = Reference(config, 3, "cpu")
    low = Reference(config, 3, "cpu", precision="fp8")
    seq = [torch.arange(20) % 512]
    a = ref.forward(seq, [[19]])["logits"][0]
    b = low.forward(seq, [[19]])["logits"][0]
    err = float((a - b).abs().max() / a.abs().max())
    assert 1e-3 < err < 0.5
