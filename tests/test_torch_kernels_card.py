"""Prefill (K5) and decode (K4) attention kernels against their plain
PyTorch versions, on the card. Every test carries the ``gpu`` marker and
skips where CUDA is absent. The module imports neither JAX nor the
reference package, so it also runs on a GPU host without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_card.py

Tolerances: bf16 2e-2, f32 1e-4 (the kernels and the plain versions sum
in different orders)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

BF16_ATOL = 2e-2


def _qkv(seed, B, S, Hq, Hkv, D, Sq=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq or S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


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
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,kw", GPU_FLASH)
def test_flash_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, dtype, kw):
    q, k, v = [t.to(cuda, dtype) for t in _t(*_qkv(5, B, S, Hq, Hkv, D))]
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, **kw)
    atol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


GPU_DECODE = [
    # (B, S, Hq, Hkv, D, dtype, valid_len, kwargs)
    (4, 128, 32, 8, 128, torch.bfloat16, [128, 1, 77, 64], {}),
    (4, 1000, 32, 8, 128, torch.bfloat16, [1000, 999, 513, 2], {}),
    (2, 300, 16, 16, 64, torch.float32, [300, 45], {}),
    (2, 260, 8, 1, 256, torch.float32, [260, 100],
     dict(window=70, attn_softcap=20.0)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,dtype,valid,kw", GPU_DECODE)
def test_decode_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, dtype,
                                             valid, kw):
    q, k, v = [t.to(cuda, dtype)
               for t in _t(*_qkv(6, B, S, Hq, Hkv, D, Sq=1))]
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, k, v, vl, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, vl, **kw)
    atol = BF16_ATOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)            # D=48
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 1, 4, 64), device=cuda)
    k = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int64,
                                             device=cuda))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
