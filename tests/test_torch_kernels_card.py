"""Prefill (K5, with its lse for training) and decode (K4) attention
kernels, attention's backward (K5-bwd), the SSD chunk kernel (K6), and the
persistent tile-op kernels (K1 drain, K2 drain + flight recorder, K3
executor), against their plain PyTorch versions, on the card. Every test carries the ``gpu`` marker and
skips where CUDA is absent. The module imports neither JAX nor the
reference package, so it also runs on a GPU host without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_card.py

Tolerances: bf16 2e-2, f32 1e-4 (the kernels and the plain versions sum
in different orders; K6 rtol and atol 1e-4; the training pair's outputs
and gradients 2e-2 / 1e-4 x each tensor's largest |want|, its lse 1e-4 x
its largest |want| in both dtypes: f32 on both sides); acks, control
words, profile rows and ticks exact."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.persistent as P
from repro_torch.kernels.persistent import kernel as PK
from repro_torch.core import mailbox as mb
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_partial,
    decode_attention_partial_plain, decode_attention_plain,
    merge_decode_partials)
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_grad, flash_attention_lse_plain,
    flash_attention_plain)
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk, ssd_chunk_plain,
                                          ssd_ref)
from repro_torch.kernels.ssd_scan import kernel as SK

BF16_ATOL = 2e-2
# a shard partial's lse: f32 on both sides from the same inputs, so held
# to f32 summation order in every dtype (one key lost at a shard boundary
# moves it by about 1 / live keys)
LSE_ATOL = 1e-4


def _qkv(seed, B, S, Hq, Hkv, D, Sq=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq or S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# softcap cases: q times this, so the scaled scores (about N(0, 20^2)) reach
# the cap; dropping the softcap must move the plain output by more than ten
# tolerances, so the case fails a kernel that drops it
SOFTCAP_Q_SCALE = 20.0


def _capped(q, kw):
    return q * SOFTCAP_Q_SCALE if kw.get("attn_softcap") else q


def _assert_softcap_matters(plain, args, kw, atol):
    if kw.get("attn_softcap"):
        moved = (plain(*args, **kw).float() - plain(
            *args, **dict(kw, attn_softcap=0.0)).float()).abs().max()
        assert float(moved) > 10 * atol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


GPU_FLASH = [
    # (B, S, Hq, Hkv, D, dtype, kwargs)
    (1, 17, 32, 8, 128, torch.bfloat16, {}),
    (1, 300, 32, 8, 128, torch.bfloat16, {}),
    (2, 130, 8, 8, 64, torch.float32, {}),
    (1, 200, 8, 2, 256, torch.float32, dict(window=48, attn_softcap=30.0)),
    (1, 96, 8, 2, 128, torch.bfloat16, dict(causal=False, seq_len=70)),
    (2, 77, 4, 4, 64, torch.bfloat16, {}),
    (1, 150, 8, 2, 256, torch.bfloat16, dict(window=40, attn_softcap=30.0)),
    # the bf16 kernel's tile edges: 128 query rows a CTA (two 64-row
    # warpgroups), 128 keys a stage (64 at D=256)
    (1, 129, 32, 8, 128, torch.bfloat16, {}),
    (1, 255, 32, 8, 128, torch.bfloat16, {}),
    (2, 2048, 32, 8, 128, torch.bfloat16, {}),
    (1, 300, 8, 2, 64, torch.bfloat16, dict(causal=False, seq_len=130)),
    (1, 200, 8, 2, 256, torch.bfloat16, dict(causal=False, seq_len=130)),
    (1, 384, 8, 2, 128, torch.bfloat16, dict(window=100)),
    # B=2 with S no multiple of the block: rows past S of the first
    # sequence must read zeros, not the second sequence
    (2, 200, 8, 2, 128, torch.bfloat16, {}),
    (2, 77, 8, 8, 256, torch.bfloat16, dict(causal=False)),
    # S <= 64: the 64-key short-prompt instance; S = 65: the 128-key one
    # with a second warpgroup holding a single row
    (2, 50, 8, 2, 64, torch.bfloat16, dict(window=20)),
    (1, 64, 8, 2, 128, torch.bfloat16, dict(causal=False, seq_len=33)),
    (3, 1, 4, 2, 64, torch.bfloat16, {}),
    (1, 65, 8, 2, 128, torch.bfloat16, {}),
    # D = 112 (zamba2-7b's shared block, 32/32 heads): the bf16 kernel at
    # its 128-wide compute width over 112-wide tensor maps, the serve
    # path's short prompt and the 2048-token prompt, a window, a ragged
    # seq_len with two sequences; the f32 FFMA kernel (4 threads a row,
    # 28 dims each) causal and with a window and softcap
    (1, 17, 32, 32, 112, torch.bfloat16, {}),
    (1, 2048, 32, 32, 112, torch.bfloat16, {}),
    (1, 300, 8, 8, 112, torch.bfloat16, dict(window=100)),
    (2, 65, 8, 8, 112, torch.bfloat16, dict(causal=False, seq_len=40)),
    (2, 150, 8, 4, 112, torch.float32, {}),
    (1, 200, 4, 4, 112, torch.float32, dict(window=48, attn_softcap=30.0)),
    # whisper-tiny's encoder: 1500 frames, 6/6 heads x 64, non-causal
    (1, 1500, 6, 6, 64, torch.bfloat16, dict(causal=False)),
    # D = 32 (every reduced config, 4/2 heads): the f32 FFMA kernel (4
    # threads a row of 8 dims) at the smoke's prompt and across query
    # blocks with a window and softcap; the bf16 kernel at its 64-wide
    # compute width over 32-wide tensor maps, short and long instances
    (1, 17, 4, 2, 32, torch.float32, {}),
    (2, 200, 4, 2, 32, torch.float32, dict(window=64, attn_softcap=30.0)),
    (1, 17, 4, 2, 32, torch.bfloat16, {}),
    (2, 300, 4, 2, 32, torch.bfloat16, dict(window=100)),
    # the moe and vlm families at full width, D = 128: GQA 5 (llama4,
    # 40/8), GQA 6 with softcap 30 (grok-1, 48/8), GQA 8 over a 256-token
    # image prefix plus a 17-token prompt (internvl2-76b, 64/8)
    (1, 17, 40, 8, 128, torch.bfloat16, {}),
    (1, 17, 48, 8, 128, torch.bfloat16, dict(attn_softcap=30.0)),
    (1, 300, 48, 8, 128, torch.bfloat16, dict(attn_softcap=30.0)),
    (1, 273, 64, 8, 128, torch.bfloat16, {}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,kw", GPU_FLASH)
def test_flash_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, dtype, kw):
    q, k, v = _qkv(5, B, S, Hq, Hkv, D)
    q, k, v = [t.to(cuda, dtype) for t in _t(_capped(q, kw), k, v)]
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, **kw)
    atol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    _assert_softcap_matters(flash_attention_plain, (q, k, v), kw, atol)


GPU_FLASH_CROSS = [
    # (B, Sq, Skv, Hq, Hkv, D, dtype, kwargs), non-causal: whisper-tiny's
    # cross-attention (a 4-23-token prompt, or one token, against 1500
    # encoder frames; the short-prompt instance chosen on Sq), f32 too;
    # two consumer warpgroups over more keys than queries with a seq_len;
    # fewer keys than queries at D = 112, bf16 and f32
    (1, 17, 1500, 6, 6, 64, torch.bfloat16, {}),
    (1, 1, 1500, 6, 6, 64, torch.bfloat16, {}),
    (4, 1, 1500, 6, 6, 64, torch.bfloat16, {}),
    (1, 23, 1500, 6, 6, 64, torch.float32, {}),
    (2, 100, 300, 8, 2, 128, torch.bfloat16, dict(seq_len=250)),
    (1, 300, 40, 4, 4, 112, torch.bfloat16, {}),
    (1, 70, 130, 4, 2, 112, torch.float32, dict(seq_len=100)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,dtype,kw", GPU_FLASH_CROSS)
def test_flash_kernel_unequal_lengths_match_plain_on_card(cuda, B, Sq, Skv,
                                                         Hq, Hkv, D, dtype,
                                                         kw):
    q, k, v = _qkv(12, B, Skv, Hq, Hkv, D, Sq=Sq)
    q, k, v = [t.to(cuda, dtype) for t in _t(q, k, v)]
    kw = dict(kw, causal=False)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape
    want = flash_attention_plain(q, k, v, **kw)
    atol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.gpu
def test_flash_launcher_raises_when_shared_memory_is_refused(cuda,
                                                             monkeypatch):
    """A shared-memory attribute the card refuses makes the wrapper raise
    and launch nothing (no count, the output it allocated unwritten); the
    next launch with the instance's own size runs."""
    lib = FK.library()
    q, k, v = [t.to(cuda, torch.bfloat16)
               for t in _t(*_qkv(9, 1, 130, 8, 2, 128))]
    sentinel = []

    def empty_like(t):
        out = torch.full_like(t, 7.0)
        sentinel.append(out)
        return out

    monkeypatch.setattr(FK.torch, "empty_like", empty_like)
    before = flash_attention.launches
    lib.k5_request_smem(300_000)                  # > 227 KB a block
    try:
        with pytest.raises(RuntimeError, match="flash_attention"):
            flash_attention(q, k, v)
    finally:
        lib.k5_request_smem(0)
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    assert len(sentinel) == 1 and bool((sentinel[0] == 7.0).all())
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got is sentinel[1]
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v).float(),
                               atol=BF16_ATOL, rtol=0)


RAGGED = [4096, 3000, 1025, 17]
GPU_DECODE = [
    # (B, S, Hq, Hkv, D, dtype, valid_len, kwargs)
    (4, 128, 32, 8, 128, torch.bfloat16, [128, 1, 77, 64], {}),
    (4, 1000, 32, 8, 128, torch.bfloat16, [1000, 999, 513, 2], {}),
    (2, 300, 16, 16, 64, torch.float32, [300, 45], {}),
    (2, 260, 8, 1, 256, torch.float32, [260, 100],
     dict(window=70, attn_softcap=20.0)),
    # the long ragged cache: G = 1 and G = 16, D = 64 and D = 256, a window
    (4, 4096, 32, 8, 128, torch.bfloat16, RAGGED, {}),
    (4, 4096, 8, 8, 128, torch.bfloat16, RAGGED, {}),
    (4, 4096, 16, 1, 64, torch.bfloat16, RAGGED, {}),
    (4, 4096, 32, 2, 256, torch.bfloat16, RAGGED, {}),
    (4, 4096, 32, 8, 128, torch.bfloat16, RAGGED, dict(window=1000)),
    (2, 1001, 32, 8, 128, torch.float32, [1001, 333],
     dict(window=100, attn_softcap=30.0)),
    # gemma2-2b's bf16 decode: D=256, GQA 8/4, softcap 50, window 4096
    (4, 128, 8, 4, 256, torch.bfloat16, [128, 1, 77, 64],
     dict(window=4096, attn_softcap=50.0)),
    (1, 4609, 8, 4, 256, torch.bfloat16, [4609],
     dict(window=4096, attn_softcap=50.0)),
    (4, 4609, 8, 4, 256, torch.bfloat16, [4609, 4097, 2000, 1],
     dict(window=4096, attn_softcap=50.0)),
    # zamba2-7b's shared block at D = 112 (32/32 heads): the serve shape,
    # B*Hkv = 128 clusters, ragged; a long cache with a window; f32 (28
    # lanes of 4 dims in P.V). whisper-tiny's decode cross-attention: every
    # slot over all 1500 frames (6/6 heads x 64)
    (4, 128, 32, 32, 112, torch.bfloat16, [128, 1, 77, 64], {}),
    (2, 3000, 8, 8, 112, torch.bfloat16, [3000, 1200], dict(window=1000)),
    (2, 300, 8, 4, 112, torch.float32, [300, 45], {}),
    (4, 1500, 6, 6, 64, torch.bfloat16, [1500] * 4, {}),
    # D = 32 (every reduced config: 4/2 heads, the 4-slot smoke decode):
    # f32 (8 lanes of 4 dims in P.V) and bf16 (2 k16 steps, 4 n8 tiles)
    (4, 128, 4, 2, 32, torch.float32, [128, 1, 77, 64], {}),
    (2, 300, 4, 1, 32, torch.float32, [300, 45],
     dict(window=64, attn_softcap=30.0)),
    (4, 128, 4, 2, 32, torch.bfloat16, [128, 1, 77, 64], {}),
    (2, 1000, 8, 2, 32, torch.bfloat16, [1000, 333], dict(window=300)),
    # full-width moe and vlm at D = 128: G = 5 and 6 leave rows of the
    # m16 tile unused (zero q rows, never stored); grok-1's softcap 30;
    # internvl2-76b's 4 slots over 256 prefix rows and their prompts
    (4, 128, 40, 8, 128, torch.bfloat16, [128, 1, 77, 64], {}),
    (4, 128, 48, 8, 128, torch.bfloat16, [128, 1, 77, 64],
     dict(attn_softcap=30.0)),
    (4, 512, 64, 8, 128, torch.bfloat16, [262, 270, 279, 290], {}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,valid,kw", GPU_DECODE)
def test_decode_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, dtype,
                                             valid, kw):
    q, k, v = _qkv(6, B, S, Hq, Hkv, D, Sq=1)
    q, k, v = [t.to(cuda, dtype) for t in _t(_capped(q, kw), k, v)]
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, vl, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, vl, **kw)
    atol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    _assert_softcap_matters(decode_attention_plain, (q, k, v, vl), kw, atol)


# K4's shard mode: the cache cut into n sequence shards, each shard's
# partial (o, lse) from the kernel, merged; every head dim and group size
# the kernel has, shards past the live keys (empty), windows across shard
# boundaries, a softcap
GPU_DECODE_SHARDS = [
    # (B, S, Hq, Hkv, D, dtype, valid, n_shards, kwargs)
    (4, 4096, 32, 8, 128, torch.bfloat16, [3, 1000, 2049, 4096], 4, {}),
    (4, 4096, 32, 8, 128, torch.bfloat16, [3, 1000, 2049, 4096], 16, {}),
    (1, 4608, 8, 4, 256, torch.bfloat16, [4600], 2,
     dict(window=4096, attn_softcap=50.0)),
    (2, 1024, 32, 32, 112, torch.bfloat16, [1024, 300], 4, dict(window=500)),
    (2, 512, 4, 2, 32, torch.bfloat16, [512, 77], 4, {}),
    (2, 512, 4, 2, 32, torch.float32, [512, 77], 4,
     dict(window=100, attn_softcap=30.0)),
    (2, 512, 16, 2, 64, torch.bfloat16, [512, 130], 8, {}),
    (2, 384, 8, 8, 64, torch.float32, [384, 5], 3, {}),
    (2, 256, 16, 2, 128, torch.float32, [256, 100], 2, {}),
    (2, 256, 8, 1, 256, torch.float32, [256, 200], 2, dict(window=64)),
    (2, 256, 8, 1, 112, torch.float32, [256, 31], 4, {}),
    # bf16 D = 256 at G = 16, ragged: 1024-position shards of 2 kv heads
    # take 16 splits a (sequence, kv head), past one cluster (merged
    # through scratch), empty ones included
    (4, 4096, 32, 2, 256, torch.bfloat16, [3, 1000, 2049, 4096], 4, {}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,valid,n,kw", GPU_DECODE_SHARDS)
def test_decode_shard_mode_matches_plain_on_card(cuda, B, S, Hq, Hkv, D,
                                                 dtype, valid, n, kw):
    q, k, v = _qkv(9, B, S, Hq, Hkv, D, Sq=1)
    q, k, v = [t.to(cuda, dtype) for t in _t(_capped(q, kw), k, v)]
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    L = S // n
    atol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    before = decode_attention_partial.launches
    os_, lses = [], []
    for i in range(n):
        ks, vs = k[:, i * L:(i + 1) * L].contiguous(), \
            v[:, i * L:(i + 1) * L].contiguous()
        o, lse = decode_attention_partial(q, ks, vs, vl, off=i * L,
                                          seq_len=S, **kw)
        po, plse = decode_attention_partial_plain(q, ks, vs, vl, off=i * L,
                                                  seq_len=S, **kw)
        torch.testing.assert_close(o.float(), po.float(), atol=atol, rtol=0)
        assert torch.equal(torch.isinf(lse), torch.isinf(plse))
        live = torch.isfinite(plse)
        torch.testing.assert_close(lse[live], plse[live], atol=LSE_ATOL,
                                   rtol=0)
        os_.append(o)
        lses.append(lse)
    torch.cuda.synchronize()
    assert decode_attention_partial.launches == before + n
    got = merge_decode_partials(os_, lses)
    want = decode_attention_plain(q, k, v, vl, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    whole = decode_attention(q, k, v, vl, **kw)
    torch.testing.assert_close(got.float(), whole.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_shard_mode_empty_shard_on_card(cuda, dtype):
    """A shard wholly past the live keys (and one before a window) writes
    o = 0 and lse = -inf; valid_len 0 is allowed in this mode."""
    q, k, v = [t.to(cuda, dtype) for t in _t(*_qkv(10, 3, 256, 32, 8, 128,
                                                   Sq=1))]
    vl = torch.tensor([0, 100, 256], dtype=torch.int32, device=cuda)
    o, lse = decode_attention_partial(q, k[:, 128:].contiguous(),
                                      v[:, 128:].contiguous(), vl, off=128,
                                      seq_len=256, window=64)
    torch.cuda.synchronize()
    assert torch.isinf(lse[:2]).all() and (lse[:2] < 0).all()
    assert torch.equal(o[:2].float(), torch.zeros_like(o[:2].float()))
    assert torch.isfinite(lse[2]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [1, 3, 5, 7, 8, 9, 12, 33])
def test_decode_kernel_split_counts_on_card(cuda, monkeypatch, n_split):
    """Every cluster size, none of which divides S or the live lengths, and
    split counts past one cluster (9, 12 and 33 CTAs, merged through
    scratch)."""
    monkeypatch.setattr(DK, "split_count", lambda *shape: n_split)
    q, k, v = [t.to(cuda, torch.bfloat16)
               for t in _t(*_qkv(8, 2, 1001, 16, 4, 128, Sq=1))]
    vl = torch.tensor([1001, 250], dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, vl, window=600)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, vl, window=600)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.gpu
def test_decode_launcher_raises_when_the_cluster_is_refused(cuda,
                                                            monkeypatch):
    """A cluster the card refuses (16 CTAs, past the portable 8, asked
    without the non-portable attribute) makes the wrapper raise and launch
    nothing: no count, the output it allocated unwritten. The next call
    with the wrapper's own split count and cluster size runs."""
    q, k, v = [t.to(cuda, torch.bfloat16)
               for t in _t(*_qkv(9, 4, 512, 32, 8, 128, Sq=1))]
    vl = torch.tensor([512, 100, 7, 1], dtype=torch.int32, device=cuda)
    sentinel = []

    def empty_like(t):
        out = torch.full_like(t, 7.0)
        sentinel.append(out)
        return out

    monkeypatch.setattr(DK.torch, "empty_like", empty_like)
    own = DK.split_count, DK.cluster_size
    monkeypatch.setattr(DK, "split_count", lambda *shape: 16)
    monkeypatch.setattr(DK, "cluster_size", lambda n, *shape: n)
    before = decode_attention.launches
    with pytest.raises(RuntimeError, match="decode_attention"):
        decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before
    assert len(sentinel) == 1 and bool((sentinel[0] == 7.0).all())
    monkeypatch.setattr(DK, "split_count", own[0])
    monkeypatch.setattr(DK, "cluster_size", own[1])
    got = decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert got is sentinel[1]
    torch.testing.assert_close(got.float(),
                               decode_attention_plain(q, k, v, vl).float(),
                               atol=BF16_ATOL, rtol=0)


# gemma2-2b's K4 shapes (D = 256, GQA 8/4, softcap 50, window 4096): the
# 4-slot decode, the long cache past the window, and its shard mode
GEMMA_DECODE = [
    # (B, S, valid, n_shards or None for the whole-cache mode)
    (4, 128, [128, 1, 77, 64], None),
    (1, 4609, [4609], None),
    (4, 4609, [4609] * 4, None),
    (1, 4609, [4609], 2),
    (1, 4609, [4609], 4),
    (1, 4609, [4609], 16),
]


def _gemma_decode(cuda, B, S, valid, n, seed=11):
    """One call of K4 at a GEMMA_DECODE row: the output, or every shard's
    (o, lse)."""
    q, k, v = _qkv(seed, B, S, 8, 4, 256, Sq=1)
    kw = dict(window=4096, attn_softcap=50.0)
    q, k, v = [t.to(cuda, torch.bfloat16) for t in _t(_capped(q, kw), k, v)]
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    if n is None:
        return lambda: [decode_attention(q, k, v, vl, **kw)]
    L = -(-S // n)
    shards = [(o, k[:, o:o + L].contiguous(), v[:, o:o + L].contiguous())
              for o in range(0, S, L)]
    return lambda: [t for o, ks, vs in shards
                    for t in decode_attention_partial(q, ks, vs, vl, off=o,
                                                      seq_len=S, **kw)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,valid,n", GEMMA_DECODE)
def test_decode_gemma2_repeats_bit_for_bit_on_card(cuda, B, S, valid, n):
    """K4 at gemma2-2b's shapes gives the same bits on every call: each
    split's, each cluster's and the clusters' merges sum in a fixed order,
    whichever cluster arrives last."""
    call = _gemma_decode(cuda, B, S, valid, n)
    first = call()
    for _ in range(5):
        again = call()
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_decode_gemma2_long_row_spans_several_clusters_on_card(
        cuda, monkeypatch):
    """gemma2-2b's decode over its 4096 window (B = 1, 4 kv heads) runs more
    CTAs a (sequence, kv head) than one cluster holds: the wrapper asks for
    scratch of one partial a CTA, every CTA writes its partial there (the
    scratch starts as NaN; each split's m is finite, since every split has
    live keys), the arrival counters are 0 again after the call, and the
    output agrees with the plain version."""
    n_split = DK.split_count(1, 4609, 4, 4096, 256, True)
    assert n_split > DK.MAX_CLUSTER and DK.cluster_size(n_split) == 1
    scratch = []
    empty = torch.empty

    def nan_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dtype == torch.float32 and t.is_cuda:
            t.fill_(float("nan"))
            scratch.append(t)
        return t

    call = _gemma_decode(cuda, 1, 4609, [4609], None)
    monkeypatch.setattr(DK.torch, "empty", nan_empty)
    before = decode_attention.launches
    (got,) = call()
    torch.cuda.synchronize()
    monkeypatch.setattr(DK.torch, "empty", empty)
    assert decode_attention.launches == before + 1
    assert len(scratch) == 1
    part = scratch[0].view(4, n_split, 2 * (256 + 4))
    assert bool(torch.isfinite(part[..., 512:516]).all())   # m and l
    assert bool(torch.isfinite(part[..., :516]).all())
    assert int(_counters_of(torch.cuda.current_stream(cuda)).abs().sum()) \
        == 0
    torch.testing.assert_close(got.float(), _gemma_long_want(cuda, 11),
                               atol=BF16_ATOL, rtol=0)


def _counters_of(stream):
    return DK._counters[(stream.device.index, stream.cuda_stream)]


def _gemma_long_want(cuda, seed):
    """The plain version of ``_gemma_decode``'s long row at ``seed``."""
    q, k, v = _qkv(seed, 1, 4609, 8, 4, 256, Sq=1)
    kw = dict(window=4096, attn_softcap=50.0)
    q, k, v = [t.to(cuda, torch.bfloat16) for t in _t(_capped(q, kw), k, v)]
    vl = torch.tensor([4609], dtype=torch.int32, device=cuda)
    return decode_attention_plain(q, k, v, vl, **kw).float()


@pytest.mark.gpu
def test_decode_past_one_cluster_on_two_streams_on_card(cuda):
    """gemma2-2b's long row (merged through scratch by arrival counters)
    called on two streams at once, in turns: every call on each stream
    agrees with the plain version and repeats bit for bit, and each
    stream's own counters are 0 after."""
    calls = [_gemma_decode(cuda, 1, 4609, [4609], None, seed=s)
             for s in (11, 12)]
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(8):
        for i, (call, st) in enumerate(zip(calls, streams)):
            with torch.cuda.stream(st):
                outs[i] += call()
    torch.cuda.synchronize()
    for seed, st, got in zip((11, 12), streams, outs):
        want = _gemma_long_want(cuda, seed)
        for o in got:
            assert torch.equal(o, got[0])
        torch.testing.assert_close(got[0].float(), want, atol=BF16_ATOL,
                                   rtol=0)
        assert int(_counters_of(st).abs().sum()) == 0
    assert _counters_of(streams[0]).data_ptr() != \
        _counters_of(streams[1]).data_ptr()


@pytest.mark.gpu
def test_decode_counters_are_not_made_under_capture_on_card(cuda,
                                                            monkeypatch):
    """A call past one cluster on a stream without arrival counters raises
    under CUDA-graph capture (their zeroing would only be recorded) and
    launches nothing; after one eager call on that stream a captured graph
    of it replays right and leaves the counters 0."""
    monkeypatch.setattr(DK, "_counters", {})
    call = _gemma_decode(cuda, 1, 4609, [4609], None)
    st = torch.cuda.Stream(cuda)
    st.wait_stream(torch.cuda.current_stream(cuda))
    before = decode_attention.launches
    with pytest.raises(RuntimeError, match="arrival counters"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=st):
            call()
    assert decode_attention.launches == before
    with torch.cuda.stream(st):
        call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=st):
        (got,) = call()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), _gemma_long_want(cuda, 11),
                               atol=BF16_ATOL, rtol=0)
    assert int(_counters_of(st).abs().sum()) == 0


# the training pair (K5 with lse, K5-bwd) at every train-capable family's
# attention shapes: (name, B, Sq, Skv, Hq, Hkv, D, dtype, kwargs)
GPU_FLASH_TRAIN = [
    ("llama3_8b", 1, 2048, 2048, 32, 8, 128, torch.bfloat16,
     dict(causal=True)),
    ("zamba2_7b_D112", 1, 1024, 1024, 32, 32, 112, torch.bfloat16,
     dict(causal=True)),
    ("gemma2_2b_D256_window_softcap", 1, 4608, 4608, 8, 4, 256,
     torch.bfloat16, dict(causal=True, window=4096, attn_softcap=50.0)),
    ("whisper_encoder", 1, 1500, 1500, 6, 6, 64, torch.bfloat16,
     dict(causal=False)),
    ("whisper_cross_17x1500", 1, 17, 1500, 6, 6, 64, torch.bfloat16,
     dict(causal=False)),
    ("grok1_G6_softcap30", 1, 1024, 1024, 48, 8, 128, torch.bfloat16,
     dict(causal=True, attn_softcap=30.0)),
    ("reduced_f32", 4, 64, 64, 4, 2, 32, torch.float32, dict(causal=True)),
    ("reduced_bf16", 4, 64, 64, 4, 2, 32, torch.bfloat16,
     dict(causal=True)),
    ("reduced_cross_f32", 2, 17, 16, 4, 2, 32, torch.float32,
     dict(causal=False)),
    ("seq_len_D128_bf16", 2, 300, 300, 8, 2, 128, torch.bfloat16,
     dict(causal=True, seq_len=250)),
    ("seq_len_D128_f32", 2, 200, 200, 8, 2, 128, torch.float32,
     dict(causal=True, seq_len=150)),
    ("window_softcap_D256_f32", 1, 130, 130, 4, 4, 256, torch.float32,
     dict(causal=True, window=64, attn_softcap=30.0)),
    ("D112_f32", 1, 150, 150, 4, 4, 112, torch.float32, dict(causal=True)),
    ("cross_D64_f32", 2, 17, 300, 6, 6, 64, torch.float32,
     dict(causal=False)),
    ("internvl2_G8_bf16", 1, 273, 273, 64, 8, 128, torch.bfloat16,
     dict(causal=True)),
    # the wgmma backward's edges: a window that is a multiple of no tile
    # with G = 4 and B = 2; cross-attention at D = 112 (its 112-wide maps
    # zero-fill the last slab) with G = 2; G = 1 at a training length
    ("window100_G4_B2_bf16", 2, 333, 333, 8, 2, 128, torch.bfloat16,
     dict(causal=True, window=100)),
    ("cross_17x300_D112_bf16", 1, 17, 300, 4, 2, 112, torch.bfloat16,
     dict(causal=False)),
    ("G1_S4096_D128_bf16", 1, 4096, 4096, 8, 8, 128, torch.bfloat16,
     dict(causal=True)),
]


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()), \
        float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,dtype,kw", GPU_FLASH_TRAIN,
                         ids=[c[0] for c in GPU_FLASH_TRAIN])
def test_flash_train_pair_matches_plain_on_card(cuda, name, B, Sq, Skv, Hq,
                                                Hkv, D, dtype, kw):
    """K5 with its lse against ``flash_attention_lse_plain``, then K5-bwd
    against ``flash_attention_bwd_plain`` on the same (out, lse, dout):
    each launches once; out and the gradients within 2e-2 (bf16) / 1e-4
    (f32) x their largest |want|, lse within 1e-4 x its largest |want|."""
    q, k, v = _qkv(0, B, Skv, Hq, Hkv, D, Sq=Sq)
    do = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    q = _capped(q, kw)
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, do))
    tol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    fwd0, bwd0 = flash_attention.launches, flash_attention_bwd.launches
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd0 + 1
    assert out.dtype == dtype and lse.shape == (B, Hq, Sq)
    err, scale = _rel_err(out, want_out)
    assert err <= tol * scale, ("out", err, scale)
    err, scale = _rel_err(lse, want_lse)
    assert err <= LSE_ATOL * scale, ("lse", err, scale)
    _assert_softcap_matters(flash_attention_plain, (q, k, v), kw,
                            tol * float(want_out.float().abs().max()))
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == bwd0 + 1
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        err, scale = _rel_err(g, w)
        assert err <= tol * scale, (gname, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_lse_of_rows_without_a_live_key_on_card(cuda, dtype):
    """Rows 115.. see keys q-15..q only, all past seq_len 100: K5 writes
    the reference's lse there, -1e30 exactly (m = -1e30, l clamped at
    1e-30), in both instances (wgmma bf16, FFMA f32). The live rows' lse
    and out agree with the plain versions, and so do the gradients, which
    the dead rows' dout reaches in neither (p = 0 on every masked key)."""
    kw = dict(causal=True, window=16, seq_len=100)
    q, k, v = _qkv(5, 1, 200, 8, 2, 128)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, do))
    tol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bool((lse[:, :, 115:] == -1e30).all())
    assert bool((want_lse[:, :, 115:] == -1e30).all())
    assert bool((lse[:, :, :115] > -1e29).all())
    err, scale = _rel_err(lse[:, :, :115], want_lse[:, :, :115])
    assert err <= LSE_ATOL * scale
    err, scale = _rel_err(out[:, :115], want_out[:, :115])
    assert err <= tol * scale
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        err, scale = _rel_err(g, w)
        assert err <= tol * scale
    live = do.clone()
    live[:, 115:] = 0
    for g, w in zip(got, flash_attention_bwd(q, k, v, out, lse, live, **kw)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_flash_grad_trains_through_the_kernels_on_card(cuda):
    """``flash_attention_grad`` on CUDA tensors launches K5 once forward
    and K5-bwd once backward; its gradients equal the wrappers' own, and
    a second call repeats them bit for bit (no atomics)."""
    q, k, v = _qkv(3, 2, 256, 8, 2, 64)
    do = torch.from_numpy(np.random.default_rng(4).normal(
        size=q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (q, k, v))
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fwd0, bwd0 = flash_attention.launches, flash_attention_bwd.launches
        out = flash_attention_grad(*leaves, causal=True, window=100)
        out.backward(do)
        torch.cuda.synchronize()
        assert flash_attention.launches == fwd0 + 1
        assert flash_attention_bwd.launches == bwd0 + 1
        grads.append([t.grad for t in leaves])
    o, lse = flash_attention_fwd(q, k, v, causal=True, window=100)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=100)
    for a, b, w in zip(*grads, want):
        assert torch.equal(a, b) and torch.equal(a, w)


GPU_FLASH_TRAIN_BF16 = [c for c in GPU_FLASH_TRAIN if c[7] == torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,dtype,kw",
                         GPU_FLASH_TRAIN_BF16,
                         ids=[c[0] for c in GPU_FLASH_TRAIN_BF16])
def test_flash_bwd_repeats_bit_for_bit_on_card(cuda, name, B, Sq, Skv, Hq,
                                               Hkv, D, dtype, kw):
    """K5-bwd's bf16 path at every bf16 training shape, D = 256 and the
    softcap rows included: a second call on the same inputs gives the
    same dq, dk and dv bit for bit (no atomics; the G query heads' partials
    summed in a fixed order)."""
    q, k, v = _qkv(7, B, Skv, Hq, Hkv, D, Sq=Sq)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    q = _capped(q, kw)
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, do))
    out, lse = flash_attention_fwd(q, k, v, **kw)
    first = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for gname, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), gname
        assert bool(torch.isfinite(a.float()).all()), gname


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_recompute_the_kernels_on_card(cuda, policy):
    """Reduced llama3-8b (f32) with activation checkpointing: the
    recompute runs K5 (with lse) again into fresh memory under both
    policies ("dots" recomputes every op but the projections' matmuls, so
    no cached output of the kernel's allocation is reused), and the loss
    and gradients equal the run without remat (1e-6 of each leaf's
    largest |grad|)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.persistent import tree_leaves
    from repro_torch.models import attention_layers, build
    from repro_torch.training.train_loop import _value_and_grad
    cfg = get_config("llama3-8b").reduced()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(cuda)
    params = build(cfg, device=cuda).init(0)
    runs = []
    for remat in (False, True):
        model = build(dataclasses.replace(cfg, remat=remat,
                                          remat_policy=policy), device=cuda)
        fwd0, bwd0 = flash_attention.launches, flash_attention_bwd.launches
        grads, m = _value_and_grad(model.loss, params, {"tokens": tokens})
        torch.cuda.synchronize()
        n = attention_layers(cfg)
        assert flash_attention.launches - fwd0 == n * (2 if remat else 1)
        assert flash_attention_bwd.launches - bwd0 == n
        runs.append((float(m["loss"]), tree_leaves(grads)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        scale = max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_flash_bwd_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    kv = torch.zeros((1, 64, 2, 64), device=cuda)
    lse = torch.zeros((1, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, kv, kv, q, lse[:, :, :32].contiguous(), q)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, kv, kv, q, lse.double(), q)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, kv, kv, q, lse, q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, kv, kv, q, lse, q.transpose(1, 2).contiguous(
        ).transpose(1, 2))
    with pytest.raises(ValueError, match="length"):
        flash_attention_bwd(q, kv[:, :40].contiguous(), kv[:, :40].contiguous(),
                            q, lse, q, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_chunk"])
def test_kernel_wrappers_refuse_grad_on_card(cuda, name):
    """The forward-only wrappers (K5's serving ``flash_attention``, K4,
    K6) have no backward: on the card each raises for
    an input that requires grad with grad mode on (its output would carry
    no gradient), launching nothing; under ``torch.no_grad()`` it launches
    and agrees with its plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    if name == "flash_attention":
        fn, plain, tol = flash_attention, flash_attention_plain, 1e-4
        args = (randn(1, 64, 4, 64), randn(1, 64, 2, 64), randn(1, 64, 2, 64))
    elif name == "decode_attention":
        fn, plain, tol = decode_attention, decode_attention_plain, 1e-4
        args = (randn(2, 1, 4, 64), randn(2, 128, 2, 64),
                randn(2, 128, 2, 64),
                torch.tensor([17, 128], dtype=torch.int32, device=cuda))
    else:
        fn, plain, tol = ssd_chunk, ssd_chunk_plain, 1e-4
        dt = torch.rand((1, 2, 32, 4), generator=g, device=cuda) * 0.1
        args = (randn(1, 2, 32, 4, 16), dt, torch.cumsum(-dt, dim=2),
                randn(1, 2, 32, 16), randn(1, 2, 32, 16))
    req = tuple(a.clone().requires_grad_(True) if a.is_floating_point()
                else a for a in args)
    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*req)
    assert fn.launches == before
    with torch.no_grad():
        got = fn(*req)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)            # D=48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    kv = torch.zeros((1, 40, 2, 64), device=cuda)          # Skv != Sq
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="length"):
            flash_attention(q, kv, kv, **kw)
    q = torch.zeros((1, 1, 4, 64), device=cuda)
    k = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int64,
                                             device=cuda))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
    args = [t.to(cuda) for t in _ssd_chunk_args(0, 1, 1, 8, 4, 16, 16)]
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(args[0].bfloat16(), *args[1:])
    x_t = args[0].transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x_t, *args[1:])
    with pytest.raises(ValueError, match="Bm"):
        ssd_chunk(*args[:4], args[4][..., :8].contiguous())   # N 16 vs 8
    x_wide = torch.zeros((1, 1, 8, 4, 128), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ssd_chunk(x_wide, *args[1:])
    wide = torch.zeros((1, 1, 8, 512), device=cuda)
    with pytest.raises(ValueError, match="state dim"):
        ssd_chunk(*args[:3], wide, wide)


def _ssd_inputs(seed, B, S, H, P, N):
    """tests/test_kernels_ssd.py's inputs: dt in [1e-3, 0.1], A in
    [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return [torch.from_numpy(a) for a in (
        rng.normal(size=(B, S, H, P)).astype(f32),
        rng.uniform(1e-3, 0.1, size=(B, S, H)).astype(f32),
        -rng.uniform(0.5, 2.0, size=(H,)).astype(f32),
        rng.normal(size=(B, S, N)).astype(f32),
        rng.normal(size=(B, S, N)).astype(f32))]


def _ssd_chunk_args(seed, B, C, L, H, P, N, scale=1.0, dt_max=None, A=None):
    """K6's operands as ``ssd`` forms them (cum: in-chunk cumsum of
    dt * A); x, Bm and Cm times ``scale``; dt at ``dt_max`` and every A at
    ``A`` where given (the strongest decays)."""
    x, dt, A_, Bm, Cm = _ssd_inputs(seed, B, C * L, H, P, N)
    if dt_max is not None:
        dt = torch.full_like(dt, dt_max)
    if A is not None:
        A_ = torch.full_like(A_, A)
    x, Bm, Cm = x * scale, Bm * scale, Cm * scale
    cum = torch.cumsum((dt * A_).reshape(B, C, L, H), dim=2)
    return (x.reshape(B, C, L, H, P), dt.reshape(B, C, L, H), cum,
            Bm.reshape(B, C, L, N), Cm.reshape(B, C, L, N))


GPU_SSD = [
    # (B, C, L, H, P, N): the serve shape (ragged L = 17); L = 256 with
    # C > 1; head counts that are no multiple of the kernel's 4-head
    # instance, with a ragged state width and P < 64, on a grid small enough
    # for one head a CTA and on one large enough for 4; a one-row chunk;
    # the 2048-token shape (8 chunks of 256, mamba2-780m's widths); an L
    # that is no multiple of the 32-row stage or the 128-row block; a state
    # width past one 128-row block, with N and P no multiple of 4 (the
    # 4-byte copies)
    (1, 1, 17, 48, 64, 128),
    (1, 3, 256, 16, 64, 128),
    (2, 2, 40, 12, 32, 48),
    (4, 4, 256, 12, 32, 48),
    (3, 1, 1, 5, 16, 16),
    (1, 8, 256, 48, 64, 128),
    (2, 1, 200, 48, 64, 128),
    (1, 2, 150, 6, 62, 202),
    # zamba2-7b's SSM layers: H = 112 heads, P = 64, N = 64 (the serve
    # shape, 2048 tokens, four 256-token prompts)
    (1, 1, 17, 112, 64, 64),
    (1, 8, 256, 112, 64, 64),
    (4, 1, 256, 112, 64, 64),
    # the reduced SSM (mamba2-780m and zamba2-7b --smoke): P = 16, N = 16,
    # 32-row chunks: a 17-token prompt and two full chunks
    (1, 1, 17, 16, 16, 16),
    (2, 2, 32, 16, 16, 16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,L,H,P,N", GPU_SSD)
def test_ssd_chunk_kernel_matches_plain_on_card(cuda, B, C, L, H, P, N):
    args = [t.to(cuda) for t in _ssd_chunk_args(7, B, C, L, H, P, N)]
    before = ssd_chunk.launches
    got_y, got_s = ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    want_y, want_s = ssd_chunk_plain(*args)
    torch.testing.assert_close(got_y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["scaled100", "near_underflow"])
@pytest.mark.parametrize("B,C,L,H,P,N", [(1, 2, 256, 8, 64, 128),
                                         (1, 1, 17, 48, 64, 128)])
def test_ssd_chunk_kernel_holds_its_split_on_card(cuda, case, B, C, L, H, P,
                                                   N):
    """x, B and C times 100 (the 3xTF32 split's accuracy is relative: y,
    100^3 times larger, and the states, 100^2, are compared in the inputs'
    units, divided by those factors), and decays near underflow (dt at
    mamba2's dt_max 0.1, A = -8: exp(cum) reaches e^-205 over a 256-row
    chunk), both within 1e-4 of the plain version."""
    kw = dict(scale=100.0) if case == "scaled100" else dict(dt_max=0.1, A=-8.0)
    unit_y, unit_s = (1e6, 1e4) if case == "scaled100" else (1.0, 1.0)
    args = [t.to(cuda) for t in _ssd_chunk_args(11, B, C, L, H, P, N, **kw)]
    got_y, got_s = ssd_chunk(*args)
    torch.cuda.synchronize()
    want_y, want_s = ssd_chunk_plain(*args)
    assert bool(torch.isfinite(got_y).all() and torch.isfinite(got_s).all())
    torch.testing.assert_close(got_y / unit_y, want_y / unit_y, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(got_s / unit_s, want_s / unit_s, atol=1e-4,
                               rtol=1e-4)


def _device_kernels(fn, calls=5, passes=3):
    """Names of the device kernels ``calls`` eager ``fn`` calls launch
    (``torch.profiler``); None where the profiler records no device
    activity. ``fn`` launches at least one kernel a call, so a pass with
    fewer names than calls lost activity records (seen on the card: 4 of
    5) and is made again, up to ``passes`` passes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        if len(names) >= calls:
            break
    return names or None


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [0, 1, 2, 4])
@pytest.mark.parametrize("B,C,L,H,P,N", [(1, 1, 17, 48, 64, 128),
                                         (1, 8, 256, 48, 64, 128),
                                         (2, 1, 200, 7, 64, 128)])
def test_ssd_chunk_is_one_device_kernel_a_call(cuda, monkeypatch, heads, B,
                                                C, L, H, P, N):
    """One call is one device kernel, for the instance the shape rule picks
    (heads=0: the rule's own, 1 at the serve shape and 4 at S=2048) and
    for each instance forced, all within 1e-4 of the plain version."""
    lib = SK.library()
    args = [t.to(cuda) for t in _ssd_chunk_args(3, B, C, L, H, P, N)]
    rule = lib.k6_heads_for(B, C, L, H, N)
    assert rule in (1, 2, 4)
    if (B, C, L) == (1, 1, 17):
        assert rule == 1
    if (B, C, L) == (1, 8, 256):
        assert rule == 4
    lib.k6_force_heads(heads)
    try:
        names = _device_kernels(lambda: ssd_chunk(*args))
        got = ssd_chunk(*args)
        torch.cuda.synchronize()
    finally:
        lib.k6_force_heads(0)
    if names is not None:
        assert len(names) == 5, names
        want = f"ssd_chunk_kernel<{heads or rule}>"
        assert all(want in n for n in names), names
    for g, w in zip(got, ssd_chunk_plain(*args)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_ssd_launcher_raises_when_shared_memory_is_refused(cuda,
                                                           monkeypatch):
    """A shared-memory size the card refuses makes the wrapper raise and
    launch nothing (no count, the outputs it allocated unwritten); the next
    launch with the instance's own size runs."""
    lib = SK.library()
    args = [t.to(cuda) for t in _ssd_chunk_args(9, 1, 2, 64, 8, 64, 128)]
    made = []

    def full(fn):
        def make(*a, **kw):
            out = fn(*a, **kw).fill_(7.0)
            made.append(out)
            return out
        return make

    monkeypatch.setattr(SK.torch, "empty_like", full(torch.empty_like))
    monkeypatch.setattr(SK.torch, "empty", full(torch.empty))
    before = ssd_chunk.launches
    lib.k6_request_smem(300_000)                  # > 227 KB a block
    try:
        with pytest.raises(RuntimeError, match="ssd_chunk"):
            ssd_chunk(*args)
    finally:
        lib.k6_request_smem(0)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before
    assert len(made) == 2 and all(bool((m == 7.0).all()) for m in made)
    got = ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    assert got[0] is made[2] and got[1] is made[3]
    for g, w in zip(got, ssd_chunk_plain(*args)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S,chunk", [(17, 256), (512, 128)])
def test_ssd_through_kernel_matches_sequential_oracle_on_card(cuda, S,
                                                              chunk):
    """The chunked SSD with K6 (and the inter-chunk recurrence) against
    the definitional sequential recurrence."""
    x, dt, A, Bm, Cm = [t.to(cuda) for t in _ssd_inputs(8, 2, S, 8, 64, 32)]
    before = ssd_chunk.launches
    y, st = ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    want_y, want_st = ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-4)


def _tile_queue(seed, C, Q, nbuf=4, scale=0.1):
    """Random programs over every drain opcode with dst/a/b drawn from
    -2..9 on an nbuf-tile workspace (aliasing and out-of-range indices), a
    chunked row per cluster, random [head, tail) windows, one stopped
    cluster."""
    rng = np.random.default_rng(seed)
    rings, ctrls = [], []
    for c in range(C):
        descs = []
        for i in range(Q):
            op = int(rng.integers(-1, P.NUM_DRAIN_OPS + 1))
            dst, a, b = (int(x) for x in rng.integers(-2, 10, 3))
            a0, a1 = (P.pack_scale(dst, a & 255, float(rng.uniform(-2, 2)))
                      if op == P.OP_SCALE else P.pack_args(dst, a & 255, b))
            descs.append(mb.WorkDescriptor(opcode=op, arg0=a0, arg1=a1,
                                           request_id=100 * c + i,
                                           chunk=i % 2, n_chunks=1 + i % 3))
        rings.append(mb.descriptor_ring(descs, Q))
        head = int(rng.integers(0, 3))
        ctrls.append(mb.queue_control(tail=int(rng.integers(head, Q + 1)),
                                      head=head, stop=int(c == C - 1)))
    return _tile_state(rng, np.stack(ctrls), np.stack(rings), nbuf, scale)


def _tile_state(rng, ctrl, ring, nbuf, scale):
    C = ring.shape[0]
    ws = (rng.standard_normal((C, nbuf, P.TILE, P.TILE)) * scale).astype(
        np.float32)
    return (torch.from_numpy(ctrl), torch.from_numpy(ring),
            torch.from_numpy(ws),
            torch.from_numpy(rng.uniform(-1, 1, (C, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 9, (C, 1)).astype(np.int32)))


def _program_queue(seed, programs, Q, nbuf=8, scale=0.1, window=None):
    """Per-cluster lists of (opcode, dst, a, b) rows (None: an inactive
    NOP-status row), all clusters with the same (head, tail) window."""
    rings, ctrls = [], []
    for c, prog in enumerate(programs):
        descs = [mb.nop_descriptor() if row is None else mb.WorkDescriptor(
            opcode=row[0], arg0=P.pack_args(row[1], row[2])[0], arg1=row[3],
            request_id=1000 * c + i) for i, row in enumerate(prog)]
        rings.append(mb.descriptor_ring(descs, Q))
        head, tail = window or (0, Q)
        ctrls.append(mb.queue_control(tail=tail, head=head))
    return _tile_state(np.random.default_rng(seed), np.stack(ctrls),
                       np.stack(rings), nbuf, scale)


MM, ADD, RELU = P.OP_MATMUL, P.OP_ADD, P.OP_RELU


def _chained(C, Q):
    """Each row's dst is the next row's a (no row may be prefetched);
    every 8th row is D += A @ D."""
    return [[(MM, 2 + (i + c + 1) % 6, 2 + (i + c) % 6,
              2 + (i + c + 1) % 6 if i % 8 == 7 else (i + c) % 2)
             for i in range(Q)] for c in range(C)]


def _independent(C, Q):
    """Products of the never-written tiles 0 and 1 (every next row is
    prefetched)."""
    return [[(MM, 2 + (i + c) % 6, (i + c) % 2, (i + c + 1) % 2)
             for i in range(Q)] for c in range(C)]


# prefetch taken (t) and refused (r), with inactive rows and other opcodes
# between products, and a last product whose next row lies past the tail
PREFETCH = [
    (MM, 2, 0, 1),        # t: the next product reads 0, 1
    (MM, 3, 0, 1),        # r: the next product reads 3
    (MM, 4, 3, 1),        # t: across two inactive rows
    None, None,
    (MM, 5, 1, 0),        # r: the next active row is an ADD
    (ADD, 6, 5, 1),
    (MM, 6, 0, 0),        # r: the next product reads 6 as b
    (MM, 7, 1, 6),        # t
    (MM, 2, 0, 1),        # t: it writes 2, the next writes 2 too
    (MM, 2, 1, 1),        # r: the next product reads 2 as b
    (MM, 4, 4, 2),        # r: dst == a; the next active row is a RELU
    (RELU, 3, 4, 0),
    (MM, 5, 0, 1),        # last row inside the window: nothing to prefetch
    (MM, 6, 0, 1),        # past the tail
]

DRAIN_CASES = {
    "random_seed0": lambda: _tile_queue(0, 4, 16),
    "random_seed1": lambda: _tile_queue(1, 4, 16),
    "chained_C4_Q64": lambda: _program_queue(
        5, _chained(4, 64), 64, scale=0.025),
    # dst == a (D += D @ B), dst == b (D += A @ D), dst == a == b
    "aliasing": lambda: _program_queue(6, [
        [(MM, 2, 2, 0), (MM, 3, 1, 3), (MM, 4, 4, 4), (MM, 2, 0, 2),
         (MM, 3, 3, 1), (MM, 5, 5, 5)]] * 2, 8, scale=0.05),
    "nbuf1": lambda: _tile_queue(7, 3, 12, nbuf=1, scale=0.02),
    "nbuf8": lambda: _tile_queue(8, 4, 16, nbuf=8),
    "C1_Q1": lambda: _program_queue(9, [[(MM, 3, 0, 1)]], 1),
    "C1_Q64": lambda: _program_queue(10, _independent(1, 64), 64),
    "C1_Q64_chained": lambda: _program_queue(
        11, _chained(1, 64), 64, scale=0.025),
    "prefetch_taken_and_refused": lambda: _program_queue(
        12, [PREFETCH, PREFETCH[::-1]], 16, window=(0, 14)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DRAIN_CASES))
@pytest.mark.parametrize("profile", [False, True])
def test_drain_kernel_matches_plain_on_card(cuda, case, profile):
    """K1/K2 (3xTF32 products from the cp.async ring) against the plain
    version: ints equal, floats within 1e-4."""
    ctrl, ring, ws, carry, tick = DRAIN_CASES[case]()
    plain_args = [t.to(cuda) for t in (ctrl, ring, ws, carry, tick)]
    kern_args = [t.to(cuda) for t in (ctrl, ring, ws, carry, tick)]
    fn = P.persistent_drain_prof if profile else P.persistent_drain
    before = fn.launches
    got = fn(*kern_args[:5 if profile else 4])
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = P.drain_plain(*plain_args[:5 if profile else 4])
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.int32:
            assert torch.equal(g, w), i
        else:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert got[4][:, mb.QC_DRAINED].sum() > 0
    assert float(want[0].abs().max()) < 1e4


@pytest.mark.gpu
def test_drain_launcher_raises_when_shared_memory_is_refused(cuda):
    """A shared-memory attribute the card refuses makes the wrapper raise
    and launch nothing (no count, workspace untouched); the next launch
    with the ring's own size runs."""
    lib = PK.library()
    ctrl, ring, ws, carry, _ = (t.to(cuda) for t in
                                _program_queue(13, [[(MM, 3, 0, 1)]], 1))
    ws0 = ws.clone()
    before = P.persistent_drain.launches
    lib.persistent_drain_request_smem(300_000)    # > 227 KB a block
    try:
        with pytest.raises(RuntimeError, match="persistent_drain"):
            P.persistent_drain(ctrl, ring, ws, carry)
    finally:
        lib.persistent_drain_request_smem(0)
    torch.cuda.synchronize()
    assert P.persistent_drain.launches == before
    assert torch.equal(ws, ws0)
    P.persistent_drain(ctrl, ring, ws, carry)
    torch.cuda.synchronize()
    assert P.persistent_drain.launches == before + 1
    assert not torch.equal(ws, ws0)


def _inf_queue():
    """A product whose A holds an inf: its row of the product is +inf
    (every B entry positive), as in f32 math, not NaN."""
    rng = np.random.default_rng(14)
    ws = rng.uniform(0.5, 1.0, (2, 4, P.TILE, P.TILE)).astype(np.float32)
    ws[:, 0, 3, 7] = np.inf
    ring = P.build_queue([[(MM, *P.pack_args(2, 0, 1)),
                           (MM, *P.pack_args(3, 1, 1))]] * 2, 4)
    return torch.from_numpy(ring), torch.from_numpy(ws)


def _demo_queue():
    rng = np.random.default_rng(1)
    ws = np.zeros((4, 5, P.TILE, P.TILE), np.float32)
    ws[:, :3] = rng.standard_normal((4, 3, P.TILE, P.TILE)) * 0.1
    return (torch.from_numpy(P.build_queue([P.mlp_program()] * 4, 4)),
            torch.from_numpy(ws))


EXECUTE_CASES = {
    "random_seed2": lambda: _tile_queue(2, 4, 12)[1:3],
    "random_seed3": lambda: _tile_queue(3, 4, 12)[1:3],
    # each row's dst the next row's a: the producer may load no row ahead
    "chained_C4_Q64": lambda: _program_queue(
        5, _chained(4, 64), 64, scale=0.025)[1:3],
    # dst == a, dst == b, dst == a == b
    "aliasing": lambda: DRAIN_CASES["aliasing"]()[1:3],
    # products loaded ahead and not, across inactive and elementwise rows
    "prefetch_taken_and_refused": lambda: _program_queue(
        12, [PREFETCH, PREFETCH[::-1]], 16)[1:3],
    "independent_C1_Q64": lambda: _program_queue(
        10, _independent(1, 64), 64)[1:3],
    "mlp_demo": _demo_queue,
    "inf": _inf_queue,
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EXECUTE_CASES))
def test_execute_kernel_matches_plain_on_card(cuda, case):
    """K3 (3xTF32 wgmma products fed by the producer warp) against the
    plain executor: from_gpu rows equal, workspaces within 1e-4."""
    ring, ws = EXECUTE_CASES[case]()
    before = P.persistent_execute.launches
    got = P.persistent_execute(ring.to(cuda), ws.to(cuda))
    torch.cuda.synchronize()
    assert P.persistent_execute.launches == before + 1
    want = P.execute_plain(ring.to(cuda), ws.to(cuda))
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(got[1], want[1])
    if case == "inf":
        assert bool(torch.isposinf(got[0][:, 2, 3]).all())
        assert not bool(torch.isnan(got[0]).any())
