"""Attention: GQA projections, prefill attention and decode attention — the
port of ``repro.models.attention`` (single device).

The reference picks its prefill implementation from ``cfg.attn_backend``
and ``jax.default_backend()``; every backend computes the same function.
The port picks it from the tensor: a CUDA tensor goes through the
hand-written Hopper kernels (``kernels.flash_attention`` for prefill,
``kernels.decode_attention`` for decode), a CPU tensor through their plain
PyTorch versions. ``plain=True`` asks for the plain versions on any device
— the reference path that ``chip_smoke.py`` holds the kernel path against;
nothing falls back to it on its own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.layers import Init


# ---------------------------------------------------------------------------
# Params / projections
# ---------------------------------------------------------------------------

def attn_params(b: Init, d_model: int, n_heads: int, n_kv: int,
                head_dim: int, qkv_bias: bool):
    p = {
        "wq": b.p((d_model, n_heads, head_dim)),
        "wk": b.p((d_model, n_kv, head_dim)),
        "wv": b.p((d_model, n_kv, head_dim)),
        "wo": b.p((n_heads, head_dim, d_model)),
    }
    if qkv_bias:
        p["bq"] = b.p((n_heads, head_dim), init="zeros")
        p["bk"] = b.p((n_kv, head_dim), init="zeros")
        p["bv"] = b.p((n_kv, head_dim), init="zeros")
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def qkv_project(p, x, ctx):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = ctx.constrain(q, "act_batch", None, "act_heads", None)
    return q, k, v


def out_project(p, o, ctx):
    h, k, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)
    return ctx.constrain(y, "act_batch", "act_seq", "act_embed")


# ---------------------------------------------------------------------------
# Prefill attention
# ---------------------------------------------------------------------------

def attention(q, k, v, cfg, ctx, *, causal: bool, window: int = 0,
              plain: bool = False):
    """q: (B,S,Hq,D); k,v: (B,S,Hkv,D) -> (B,S,Hq,D). Every
    ``cfg.attn_backend`` value ('xla' | 'masked' | 'pallas' | 'auto')
    computes this function; on CUDA all of them run the flash kernel."""
    fn = flash_attention_plain if plain else flash_attention
    return fn(q, k, v, causal=causal, window=window,
              attn_softcap=cfg.attn_softcap)


# ---------------------------------------------------------------------------
# Decode attention (one new token vs cache)
# ---------------------------------------------------------------------------

def decode_attention_local(q, k_cache, v_cache, valid_len, *,
                           attn_softcap: float = 0.0, window: int = 0,
                           plain: bool = False):
    """q: (B,1,Hq,D); caches: (B,Smax,Hkv,D); valid_len: (B,) int32 —
    number of valid cache positions INCLUDING the just-written token."""
    fn = decode_attention_plain if plain else decode_attention
    return fn(q, k_cache, v_cache, valid_len, attn_softcap=attn_softcap,
              window=window)


def cache_update_sharded(k_cache, v_cache, k_new, v_new, positions, ctx):
    """Write (B,1,Hkv,D) new K/V at per-sequence ``positions`` (B,) into
    (B,Smax,Hkv,D) caches — IN PLACE (the reference returns updated
    copies). Positions are clamped to [0, Smax) as the reference's
    ``dynamic_update_slice`` clamps its start index. Single-device body;
    the seq-sharded variant comes with the distribution slice."""
    B, smax = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    pos = positions.long().clamp(0, smax - 1)
    k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
