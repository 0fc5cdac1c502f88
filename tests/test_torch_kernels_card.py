"""Prefill (K5) and decode (K4) attention kernels, and the persistent
tile-op kernels (K1 drain, K2 drain + flight recorder, K3 executor), against
their plain PyTorch versions, on the card. Every test carries the ``gpu`` marker and
skips where CUDA is absent. The module imports neither JAX nor the
reference package, so it also runs on a GPU host without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_card.py

Tolerances: bf16 2e-2, f32 1e-4 (the kernels and the plain versions sum
in different orders); acks, control words, profile rows and ticks exact."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.persistent as P
from repro_torch.core import mailbox as mb
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


def _tile_queue(seed, C, Q):
    """Random programs over every drain opcode with dst/a/b drawn from
    -2..9 on a 4-tile workspace (aliasing and out-of-range indices), a
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
    ws = (rng.standard_normal((C, 4, P.TILE, P.TILE)) * 0.1).astype(
        np.float32)
    return (torch.from_numpy(np.stack(ctrls)),
            torch.from_numpy(np.stack(rings)), torch.from_numpy(ws),
            torch.from_numpy(rng.uniform(-1, 1, (C, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 9, (C, 1)).astype(np.int32)))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("profile", [False, True])
def test_drain_kernel_matches_plain_on_card(cuda, seed, profile):
    ctrl, ring, ws, carry, tick = _tile_queue(seed, 4, 16)
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


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2, 3])
def test_execute_kernel_matches_plain_on_card(cuda, seed):
    _, ring, ws, _, _ = _tile_queue(seed, 4, 12)
    before = P.persistent_execute.launches
    got = P.persistent_execute(ring.to(cuda), ws.to(cuda))
    torch.cuda.synchronize()
    assert P.persistent_execute.launches == before + 1
    want = P.execute_plain(ring.to(cuda), ws.to(cuda))
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(got[1], want[1])
