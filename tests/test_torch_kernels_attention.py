"""Prefill (K5) and decode (K4) attention of the port.

On the CPU the wrappers take their plain PyTorch versions; those are held
against the reference's Pallas kernels in interpret mode and against its
oracles, on inputs drawn with numpy: f32 to 2e-5 (summation order), bf16
to 2e-2 (one bf16 rounding of the output). The kernel-vs-plain cases are
in test_torch_kernels_card.py."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import decode_attention_ref
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.attention import decode_attention_local
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import kernel as FK

F32_ATOL = 2e-5
BF16_ATOL = 2e-2
H100_SMEM_OPTIN = 232_448      # dynamic shared memory a block may opt into


def _qkv(seed, B, S, Hq, Hkv, D, Sq=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq or S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# K5: prefill flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "gqa_causal": dict(B=2, S=32, Hq=4, Hkv=2, D=64, kw={}),
    "mha_ragged_17": dict(B=1, S=17, Hq=2, Hkv=2, D=32, kw={}),
    "window": dict(B=1, S=40, Hq=4, Hkv=1, D=32, kw=dict(window=8)),
    "softcap": dict(B=1, S=24, Hq=4, Hkv=2, D=32, kw=dict(attn_softcap=5.0)),
    "seq_len_pad": dict(B=2, S=24, Hq=2, Hkv=1, D=32,
                        kw=dict(causal=False, seq_len=13)),
    # across the card kernel's 128-row query blocks and 128-key stages
    # (and the Pallas kernel's 128-row blocks)
    "gqa_causal_256": dict(B=1, S=256, Hq=4, Hkv=2, D=64, kw={}),
    "window_100_256": dict(B=1, S=256, Hq=2, Hkv=1, D=32,
                           kw=dict(window=100)),
    "seq_len_200_256": dict(B=1, S=256, Hq=2, Hkv=1, D=32,
                            kw=dict(causal=False, seq_len=200)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_and_oracle(case):
    c = FLASH_CASES[case]
    q, k, v = _qkv(1, c["B"], c["S"], c["Hq"], c["Hkv"], c["D"])
    kw = c["kw"]
    before = flash_attention.launches
    got = flash_attention(*_t(q, k, v), **kw).numpy()
    assert flash_attention.launches == before      # CPU: no kernel launch
    np.testing.assert_allclose(
        got, flash_attention_plain(*_t(q, k, v), **kw).numpy(), rtol=0,
        atol=0)
    want_pallas = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)),
                                     interpret=True, **kw))
    want_ref = np.asarray(attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(got, want_pallas, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=F32_ATOL, rtol=0)


def _cuda_constants(path) -> dict:
    """The top-level ``constexpr int`` constants of a CUDA source, evaluated
    in order (literals, or C++ integer expressions of the ones before)."""
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+)\s*=\s*([^;]+);",
                                 path.read_text(), re.M):
        consts[name] = int(eval(expr.replace("/", "//"),
                                {"__builtins__": {}}, dict(consts)))
    return consts


def test_flash_cuda_geometry():
    """K5's bf16 kernel: each head dim's instance asks for no more dynamic
    shared memory than a block may opt into (and its ring has >= 2 stages
    and whole 64-row wgmma tiles of keys, the short-prompt instance's
    stages fitting in the same ring); the TMA's inner box is one
    128-byte swizzle row of bf16; a CTA's query rows are whole 64-row
    consumer warpgroups; its masked score equals the reference's."""
    k = _cuda_constants(FK.SOURCE)
    for d in FK.HEAD_DIMS:
        smem, bk, stages = (k[f"{n}_D{d}"] for n in ("SMEM", "BK", "STAGES"))
        assert 48 * 1024 < smem <= H100_SMEM_OPTIN, d
        assert stages >= 2 and bk % 64 == 0 and bk <= 256, d
        tiles = k["BQ"] * d * 2 + stages * 2 * bk * d * 2
        assert smem >= tiles + k["SMEM_ALIGN"] + 8 * (2 + 4 * stages), d
    assert k["BK_SHORT"] % 64 == 0
    assert all(k["BK_SHORT"] <= k[f"BK_D{d}"] for d in FK.HEAD_DIMS)
    assert k["TMA_BOX"] * 2 == k["SLAB_ROW_BYTES"] == 128
    assert k["BQ"] % 64 == 0 and k["WG_ROWS"] == 64
    assert k["CONSUMERS"] * k["WG_ROWS"] == k["BQ"]
    assert k["TC_THREADS"] == 128 * (k["CONSUMERS"] + 1)
    # setmaxnreg: multiples of 8 in [24, 256], within the SM's registers
    regs = (k["PRODUCER_REGS"], k["CONSUMER_REGS"])
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in regs)
    assert 128 * (regs[0] + k["CONSUMERS"] * regs[1]) <= 65536
    neg = re.search(r"constexpr float NEG = ([^;]+)f;", FK.SOURCE.read_text())
    assert float(neg.group(1)) == FK.NEG_INF


def test_flash_plain_bf16_matches_oracle():
    q, k, v = _qkv(2, 1, 33, 8, 2, 64)
    got = flash_attention(*[t.to(torch.bfloat16) for t in _t(q, k, v)],
                          window=16)
    assert got.dtype == torch.bfloat16
    want = attention_ref(*[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)],
                         window=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# K4: flash decoding
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "gqa_ragged": dict(B=3, S=64, Hq=8, Hkv=2, D=64, valid=[1, 17, 64],
                       kw={}),
    "mha": dict(B=2, S=40, Hq=2, Hkv=2, D=32, valid=[40, 9], kw={}),
    "window": dict(B=2, S=48, Hq=4, Hkv=1, D=32, valid=[48, 20],
                   kw=dict(window=8)),
    "softcap": dict(B=2, S=32, Hq=4, Hkv=2, D=32, valid=[5, 32],
                    kw=dict(attn_softcap=5.0)),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_pallas_and_reference(case):
    c = DECODE_CASES[case]
    q, k, v = _qkv(3, c["B"], c["S"], c["Hq"], c["Hkv"], c["D"], Sq=1)
    vl = np.asarray(c["valid"], np.int32)
    kw = c["kw"]
    before = decode_attention.launches
    got = decode_attention(*_t(q, k, v, vl), **kw).numpy()
    assert decode_attention.launches == before     # CPU: no kernel launch
    np.testing.assert_allclose(
        got, decode_attention_plain(*_t(q, k, v, vl), **kw).numpy(),
        rtol=0, atol=0)
    jargs = [jnp.asarray(a) for a in (q, k, v, vl)]
    np.testing.assert_allclose(
        got, np.asarray(j_decode(*jargs, interpret=True, **kw)),
        atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(decode_attention_ref(*jargs, **kw)),
        atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(decode_attention_local(*jargs, **kw)),
        atol=F32_ATOL, rtol=0)


def test_decode_plain_bf16_matches_reference():
    q, k, v = _qkv(4, 2, 96, 8, 2, 64, Sq=1)
    vl = np.asarray([96, 31], np.int32)
    got = decode_attention(*[t.to(torch.bfloat16) for t in _t(q, k, v)],
                           torch.from_numpy(vl))
    assert got.dtype == torch.bfloat16
    want = decode_attention_ref(
        *[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)], jnp.asarray(vl))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)
