"""Prefill (K5) and decode (K4) attention of the port.

On the CPU the wrappers take their plain PyTorch versions; those are held
against the reference's Pallas kernels in interpret mode and against its
oracles, on inputs drawn with numpy: f32 to 2e-5 (summation order), bf16
to 2e-2 (one bf16 rounding of the output). The kernel-vs-plain cases are
in test_torch_kernels_card.py."""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import decode_attention_ref
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.attention import decode_attention_local, flash_xla
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.decode_attention import kernel as DK
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
    # zamba2-7b's head dim, 112 (the card kernel computes at 128 over
    # zero-filled columns)
    "d112_gqa_causal": dict(B=2, S=32, Hq=4, Hkv=2, D=112, kw={}),
    "d112_window": dict(B=1, S=40, Hq=2, Hkv=2, D=112, kw=dict(window=8)),
    # every reduced config's head layout (4/2 heads x 32): the smoke's
    # 17-token prompt, and a prompt past the reduced local window (64)
    "d32_reduced_gqa_17": dict(B=1, S=17, Hq=4, Hkv=2, D=32, kw={}),
    "d32_reduced_window64_softcap": dict(B=1, S=96, Hq=4, Hkv=2, D=32,
                                         kw=dict(window=64,
                                                 attn_softcap=30.0)),
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


# Unequal query and key lengths (whisper's cross-attention: a prompt
# against the encoder's frames), non-causal. The reference's model path
# computes them with flash_xla (repro.models.attention.attention on the
# CPU); its Pallas kernel (flash_attention_pallas) takes its key blocks
# from q's length and so reads only the first Sq keys (max error 1.64
# against flash_xla at q 8 x 64, k/v 40 x 64): it is no oracle here.
CROSS_CASES = {
    # (B, Sq, Skv, Hq, Hkv, D, kwargs)
    "prompt_17_vs_40": (1, 17, 40, 4, 2, 32, {}),
    "one_token_vs_48": (2, 1, 48, 4, 4, 32, {}),
    "more_queries_than_keys": (1, 40, 9, 2, 1, 32, {}),
    "d112_8_vs_40": (1, 8, 40, 2, 2, 112, {}),
    "seq_len_30_of_40": (1, 9, 40, 2, 1, 32, dict(seq_len=30)),
    "softcap": (1, 12, 33, 4, 2, 64, dict(attn_softcap=5.0)),
}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_flash_plain_unequal_lengths_match_flash_xla(case):
    B, Sq, Skv, Hq, Hkv, D, kw = CROSS_CASES[case]
    q, k, v = _qkv(6, B, Skv, Hq, Hkv, D, Sq=Sq)
    before = flash_attention.launches
    got = flash_attention(*_t(q, k, v), causal=False, **kw).numpy()
    assert flash_attention.launches == before
    assert got.shape == q.shape
    want = np.asarray(flash_xla(*map(jnp.asarray, (q, k, v)), causal=False,
                                block_q=16, block_kv=16, **kw))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    # a causal mask or a window needs one length for queries and keys
    for bad in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="length"):
            flash_attention(*_t(q, k, v), **bad)


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
    # zamba2-7b's head dim: 7 k16 steps of Q.K^T, 14 n8 tiles of P.V on
    # the card
    "d112_ragged": dict(B=3, S=64, Hq=4, Hkv=4, D=112, valid=[64, 1, 30],
                        kw={}),
    # the reduced configs' 4-slot decode (4/2 heads x 32)
    "d32_reduced_4slot": dict(B=4, S=64, Hq=4, Hkv=2, D=32,
                              valid=[64, 1, 30, 17], kw={}),
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


# ---------------------------------------------------------------------------
# K4's one-launch design: the device-side split and the cluster merge,
# written out in PyTorch, against the plain version, the reference's
# interpret-mode Pallas kernel and its oracle
# ---------------------------------------------------------------------------

def split_ranges(valid_len, S: int, window: int, n_split: int):
    """The key ranges K4's CTAs take, as csrc/decode_attention.cu
    (``split_range``) derives them on the device: the live positions [lo, valid) of each sequence (valid =
    min(valid_len, S), lo = valid - window with a window, else 0) cut into
    n_split even ranges. Returns (a, e), each (B, n_split) int64: split s of
    sequence b covers [a[b, s], e[b, s]), empty where a >= e."""
    valid = valid_len.long().clamp(max=S)
    lo = (valid - window).clamp(min=0) if window > 0 else \
        torch.zeros_like(valid)
    chunk = ((valid - lo).clamp(min=0) + n_split - 1) // n_split
    sp = torch.arange(n_split, device=valid.device)
    a = lo[:, None] + sp[None, :] * chunk[:, None]
    e = torch.minimum(a + chunk[:, None], valid[:, None])
    return a, e


def _merge_partials(m, l, acc, dim: int):
    """decode_attention_sharded's merge of partials along ``dim`` (m, l:
    (..., Hq); acc: (..., Hq, D)): m = max, c = exp(m_s - m), 0 for empty
    partials (m_s = -inf); returns the merged (m, sum(c * l),
    sum(c * acc)), unnormalised."""
    mg = m.amax(dim=dim)
    mg_safe = torch.where(torch.isfinite(mg), mg, torch.zeros_like(mg))
    c = torch.where(torch.isfinite(m), torch.exp(m - mg_safe.unsqueeze(dim)),
                    torch.zeros_like(m))
    return mg, (c * l).sum(dim=dim), (c[..., None] * acc).sum(dim=dim)


def decode_attention_split_plain(q, k_cache, v_cache, valid_len, n_split: int,
                                 *, attn_softcap: float = 0.0,
                                 window: int = 0, cluster: int = None):
    """K4's algorithm in plain PyTorch: per-split partials (max,
    sum of exponentials, unnormalised output) in f32 over the ranges of
    ``split_ranges``; the merge every CTA of a cluster does
    (decode_attention_sharded's: m = max over splits, c = exp(m_s - m), 0
    for empty splits) over each cluster of ``cluster`` consecutive splits
    (``DK.cluster_size`` at the shape by default: all of them, or one);
    then, where there are several clusters, the
    same merge over the clusters' partials in order (the last CTA's to
    arrive, in the kernel); out = acc / max(l, 1e-30). Shapes as
    ``decode_attention_plain``."""
    B, S, Hkv, D = k_cache.shape
    G = q.shape[2] // Hkv
    kf = k_cache.float().repeat_interleave(G, dim=2)
    vf = v_cache.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhk", q.float(), kf) / math.sqrt(D)
    if attn_softcap > 0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    a, e = split_ranges(valid_len.to(q.device), S, window, n_split)
    pos = torch.arange(S, device=q.device)
    # (B, n_split, S): position in the split's range
    live = (pos[None, None, :] >= a[:, :, None]) & \
        (pos[None, None, :] < e[:, :, None])
    ss = torch.where(live[:, :, None, :], s[:, None], -math.inf)
    m = ss.amax(dim=-1)                                   # (B, n, Hq)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live[:, :, None, :], torch.exp(ss - m_safe[..., None]),
                    torch.zeros_like(ss))
    l = p.sum(dim=-1)
    acc = torch.einsum("bnhk,bkhd->bnhd", p, vf)
    cluster = cluster or DK.cluster_size(n_split, B, Hkv, D,
                                         q.dtype == torch.bfloat16)
    Hq = q.shape[2]
    m, l, acc = _merge_partials(m.reshape(B, -1, cluster, Hq),
                                l.reshape(B, -1, cluster, Hq),
                                acc.reshape(B, -1, cluster, Hq, D), dim=2)
    _, l, acc = _merge_partials(m, l, acc, dim=1)
    o = acc / l.clamp(min=1e-30)[..., None]
    return o[:, None].to(q.dtype)


SPLIT_CASES = {
    # (B, S, Hq, Hkv, D, valid_len, n_split, kwargs): lengths 1, 17 and S;
    # split counts that divide neither S nor the live lengths; a window
    # and a softcap; one split, and more splits than a short sequence has
    # keys (empty splits)
    "ragged_1_17_S_n8": (3, 64, 8, 2, 64, [1, 17, 64], 8, {}),
    "ragged_n3": (3, 64, 4, 1, 32, [64, 17, 1], 3, {}),
    "window_n5": (2, 48, 4, 1, 32, [48, 20], 5, dict(window=8)),
    "softcap_n7": (2, 32, 4, 2, 32, [5, 32], 7, dict(attn_softcap=5.0)),
    "window_softcap_n1": (2, 40, 4, 4, 32, [40, 9], 1,
                          dict(window=16, attn_softcap=20.0)),
    # gemma2-like (D = 256, G = 2, a window, softcap) cut down, with the
    # split counts of bf16 D = 256 past one cluster: one cluster (1, 8),
    # then 9, 33 and 64 partials merged through scratch; short sequences
    # leave splits empty
    "d256_window_softcap_n1": (2, 160, 4, 2, 256, [160, 37], 1,
                               dict(window=96, attn_softcap=50.0)),
    "d256_window_softcap_n8": (2, 160, 4, 2, 256, [160, 37], 8,
                               dict(window=96, attn_softcap=50.0)),
    "d256_window_softcap_n9": (2, 160, 4, 2, 256, [160, 37], 9,
                               dict(window=96, attn_softcap=50.0)),
    "d256_window_softcap_n33": (2, 160, 4, 2, 256, [160, 5], 33,
                                dict(window=96, attn_softcap=50.0)),
    "d256_window_softcap_n64": (3, 160, 4, 2, 256, [160, 20, 1], 64,
                                dict(window=96, attn_softcap=50.0)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_split_and_merge_match_plain_pallas_and_reference(case):
    B, S, Hq, Hkv, D, valid, n_split, kw = SPLIT_CASES[case]
    q, k, v = _qkv(5, B, S, Hq, Hkv, D, Sq=1)
    vl = np.asarray(valid, np.int32)
    got = decode_attention_split_plain(*_t(q, k, v, vl), n_split,
                                          **kw).numpy()
    np.testing.assert_allclose(
        got, decode_attention_plain(*_t(q, k, v, vl), **kw).numpy(),
        atol=F32_ATOL, rtol=0)
    jargs = [jnp.asarray(a) for a in (q, k, v, vl)]
    np.testing.assert_allclose(
        got, np.asarray(j_decode(*jargs, interpret=True, **kw)),
        atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(decode_attention_ref(*jargs, **kw)),
        atol=F32_ATOL, rtol=0)


def test_decode_split_ranges_cover_the_live_keys_evenly():
    """The ranges the kernel's CTAs derive from valid_len: disjoint, in
    order, covering exactly [max(0, valid - window), min(valid_len, S)),
    each at most ceil(live / n_split) keys; empty where a >= e."""
    S = 100
    for window in (0, 1, 30, 200):
        for n in (1, 2, 3, 7, 8):
            vl = torch.tensor([1, 2, 17, 33, 99, 100, 250], dtype=torch.int32)
            a, e = split_ranges(vl, S, window, n)
            for b, length in enumerate(vl.tolist()):
                valid = min(length, S)
                lo = max(0, valid - window) if window else 0
                keys = [x for s in range(n)
                        for x in range(int(a[b, s]), int(e[b, s]))]
                assert keys == list(range(lo, valid)), (window, n, length)
                live = -(-(valid - lo) // n)
                assert int((e[b] - a[b]).clamp(min=0).max()) <= live


def test_decode_split_count_and_cuda_geometry():
    """Every K4 instance asks for no more dynamic shared memory than a block
    may opt into at the largest group. FFMA (f32 only; bf16 at D = 256 has
    left it for the tensor cores): the ring of its cp.async stages, then q,
    the probabilities and the partial the cluster merge reads; tiles are
    whole 32-key warps. Tensor cores (bf16 at D = 32, 64, 112, 128 and 256):
    the ring (at D = 256 with the slabs' score exchange after it), or the
    warps' partials and the CTA's merged one laid over it once it has
    drained; 16 keys a slab, rows padded so the 8 rows of an ldmatrix read
    fall on distinct banks. Rings have >= 2 stages, padded rows keep
    16-byte copies aligned; D = 256's warps (two a 16-key slab, each with
    half of O's dims) fit a block. Clusters stay within
    the portable 8 CTAs: all the splits, or one CTA each past that. The
    split count stays in [1, MAX_CLUSTER] except for bf16 at D = 256,
    whose CTAs (one an SM: two do not fit its shared memory) may be more
    than one cluster holds, at most MAX_SPLITS, but never more than
    WIDE_TARGET_CTAS in all; no count exceeds the live keys over
    SPLIT_MIN_KEYS; gemma2-2b's decode over its 4096 window (1 sequence x
    4 kv heads) takes more CTAs than one cluster holds. At the serve
    path's long cache (llama3-8b's 32 sequence x kv-head pairs) the split
    count makes two CTAs an SM."""
    k = _cuda_constants(DK.SOURCE)
    assert k["MAX_CLUSTER"] == DK.MAX_CLUSTER <= 8
    assert k["MAX_SPLITS"] == DK.MAX_SPLITS
    assert k["MAX_WARPS"] == k["MMA_WARPS"] * k["DIM_SPLIT_D256"] <= 32
    assert 256 // 8 // k["DIM_SPLIT_D256"] % 2 == 0   # n8 tiles in pairs
    assert k["MAX_G"] == DK.MAX_GROUP <= 16
    assert "BK_BF16_D256" not in k and "STAGES_BF16_D256" not in k
    for d in DK.HEAD_DIMS:
        bk, stages = k[f"BK_F32_D{d}"], k[f"STAGES_F32_D{d}"]
        assert bk % 32 == 0 and 32 <= bk <= 64 and stages >= 2
        kstride = d + 4
        ring = stages * bk * (kstride + d) * 4
        extra = k["MAX_G"] * (2 * d + bk + 2) * 4
        assert ring + extra <= H100_SMEM_OPTIN, d
        assert (kstride * 4) % 16 == 0
    assert k["MMA_BK"] == 16 * k["MMA_WARPS"]
    mma_bytes = {}
    for d in DK.HEAD_DIMS:
        stages = k[f"STAGES_MMA_D{d}"]
        row = (d + 8) * 2
        ring = stages * 2 * k["MMA_BK"] * row
        if d == 256:                            # the slabs' score exchange
            ring += k["MMA_WARPS"] * k["DIM_SPLIT_D256"] * 32 * 8 * 4
        part = (k["MMA_WARPS"] + 1) * k["MAX_G"] * (d + 2) * 4
        assert stages >= 2 and max(ring, part) <= H100_SMEM_OPTIN
        mma_bytes[d] = ring
        assert row % 16 == 0
        banks = {(r * row // 4 + w) % 32 for r in range(8) for w in range(4)}
        assert len(banks) == 32, d
    # one CTA an SM at D = 256 (the SM's 228 KB hold one), so the wide
    # target is the SM count
    assert 2 * (mma_bytes[256] + 1024) > 228 * 1024   # 1 KB reserved a CTA
    assert DK.WIDE_TARGET_CTAS == 132
    for n in range(1, DK.MAX_SPLITS + 1):
        assert DK.cluster_size(n) == (n if n <= DK.MAX_CLUSTER else 1)
        for B, Hkv in ((1, 4), (4, 4), (16, 8)):
            c = DK.cluster_size(n, B, Hkv, 256, True)
            assert c in (1, n) and (c == 1 or B * Hkv * n <=
                                    DK.CLUSTER_WAVE_CTAS)
    # gemma2-2b's 4-slot decode at its long cache: 128 CTAs of one an SM,
    # in clusters of one; at the 128-position cache one cluster of 2
    assert DK.split_count(4, 4609, 4, 4096, 256, True) == 8
    assert DK.cluster_size(8, 4, 4, 256, True) == 1
    assert DK.cluster_size(2, 4, 4, 256, True) == 2
    assert DK.cluster_size(8, 4, 4, 128, True) == 8
    for B, S, Hkv, window in ((4, 128, 8, 0), (4, 4096, 8, 0), (1, 17, 8, 0),
                              (64, 8192, 8, 0), (1, 1, 1, 0), (2, 300, 16, 0),
                              (1, 4609, 4, 4096), (4, 128, 4, 4096),
                              (1, 2305, 4, 4096), (1, 1153, 4, 4096),
                              (1, 289, 4, 4096), (4, 4096, 2, 0),
                              (1, 100000, 1, 0), (2, 600, 1, 0)):
        live = min(S, window) if window else S
        for D in DK.HEAD_DIMS:
            for bf16 in (True, False):
                n = DK.split_count(B, S, Hkv, window, D, bf16)
                assert 1 <= n <= max(1, -(-live // DK.SPLIT_MIN_KEYS))
                assert n <= DK.MAX_SPLITS
                if bf16 and D == 256:
                    assert n == 1 or B * Hkv * n <= DK.WIDE_TARGET_CTAS
                else:
                    assert n <= DK.MAX_CLUSTER
    assert DK.split_count(4, 4096, 8) * 4 * 8 >= 2 * 128
    assert DK.split_count(1, 4609, 4, 4096, 256, True) > DK.MAX_CLUSTER
