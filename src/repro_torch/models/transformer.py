"""Decoder-only transformer assembly, dense family — the port of
``repro.models.transformer``.

Parameters keep the reference's stacked layout (``stack["blk{i}"]`` leaves
carry a leading layers axis), but the reference's ``lax.scan`` over that
axis becomes a Python loop over the layer index ``li``. Decode writes each
layer's new K/V into the caches IN PLACE at the token's position; the
reference threads updated copies through the scan carry.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (Init, apply_rope, mlp_apply,
                                       mlp_params, rms_norm)


# ---------------------------------------------------------------------------
# Period spec
# ---------------------------------------------------------------------------

def period_spec(cfg) -> list[tuple[str, dict]]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (dense only)")
    if cfg.local_global_interleave == 2:
        return [("attn_mlp", {"local": True}), ("attn_mlp", {"local": False})]
    return [("attn_mlp", {})]


def num_periods(cfg) -> int:
    spec = period_spec(cfg)
    assert cfg.num_layers % len(spec) == 0, (cfg.name, cfg.num_layers, len(spec))
    return cfg.num_layers // len(spec)


# ---------------------------------------------------------------------------
# One composite layer
# ---------------------------------------------------------------------------

def layer_params(b: Init, cfg, kind: str):
    d = cfg.d_model
    p: dict[str, Any] = {}
    p["ln_attn"] = b.p((d,), init="ones")
    p["attn"] = attn.attn_params(b, d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, cfg.qkv_bias)
    p["ln_mlp"] = b.p((d,), init="ones")
    if cfg.sandwich_norm:
        p["ln_attn_post"] = b.p((d,), init="ones")
        p["ln_mlp_post"] = b.p((d,), init="ones")
    p["mlp"] = mlp_params(b, d, cfg.d_ff, cfg.gated_mlp)
    return p


def _attn_sub(p, x, cfg, ctx, *, local: bool, mode: str, pos,
              cache=None, valid_len=None, plain: bool = False):
    """Attention sub-block. Returns (out, new_cache)."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_project(p["attn"], h, ctx)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = cfg.local_window if local else 0
    new_cache = None
    if mode == "decode":
        # write into the cache at absolute positions (in place), then
        # flash-decode against it
        kc, vc = attn.cache_update_sharded(cache["k"], cache["v"], k, v,
                                           pos[:, 0], ctx)
        o = attn.decode_attention_local(
            q, kc, vc, valid_len, attn_softcap=cfg.attn_softcap,
            window=window, plain=plain)
        new_cache = {"k": kc, "v": vc}
    else:
        o = attn.attention(q, k, v, cfg, ctx, causal=True, window=window,
                           plain=plain)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    o = attn.out_project(p["attn"], o, ctx)
    if cfg.sandwich_norm:
        o = rms_norm(o, p["ln_attn_post"], cfg.norm_eps)
    return x + o, new_cache


def _ffn_sub(p, x, cfg, ctx):
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    o = mlp_apply(p["mlp"], h, cfg.mlp_act, cfg.gated_mlp, ctx)
    if cfg.sandwich_norm:
        o = rms_norm(o, p["ln_mlp_post"], cfg.norm_eps)
    return x + o


def layer_apply(p, x, cfg, ctx, kind: str, opts: dict, *, mode: str, pos,
                cache=None, valid_len=None, plain: bool = False):
    """Returns (x, aux, new_cache)."""
    local = bool(opts.get("local", False))
    x, new_cache = _attn_sub(p, x, cfg, ctx, local=local, mode=mode, pos=pos,
                             cache=cache, valid_len=valid_len, plain=plain)
    x = _ffn_sub(p, x, cfg, ctx)
    return x, {}, new_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def stack_params(b: Init, cfg):
    spec = period_spec(cfg)
    n = num_periods(cfg)
    return {f"blk{i}": b.stack(n, lambda bb, k=kind: layer_params(bb, cfg, k))
            for i, (kind, _) in enumerate(spec)}


def _layer(tree, li: int):
    """Layer ``li`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def forward_stack(params, x, cfg, ctx, *, mode: str, pos,
                  caches=None, valid_len=None, plain: bool = False):
    """Run the layer stack.

    mode='prefill': returns (x, aux, caches) — caches[f'blk{i}'] stacked
    (P, B, S, Hkv, D);
    mode='decode': caches required and updated in place; returns
    (x, aux, caches).
    """
    spec = period_spec(cfg)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode={mode!r} waits for the training slice")
    per_layer: dict[str, list] = {f"blk{i}": [] for i in range(len(spec))}
    for li in range(num_periods(cfg)):
        for i, (kind, opts) in enumerate(spec):
            key = f"blk{i}"
            cache_i = _layer(caches[key], li) if mode == "decode" else None
            x, _, nc = layer_apply(
                _layer(params[key], li), x, cfg, ctx, kind, opts, mode=mode,
                pos=pos, cache=cache_i, valid_len=valid_len, plain=plain)
            per_layer[key].append(nc)
    if mode == "decode":
        return x, {}, caches
    new_caches = {key: {"k": torch.stack([c["k"] for c in cs]),
                        "v": torch.stack([c["v"] for c in cs])}
                  for key, cs in per_layer.items()}
    return x, {}, new_caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_seq: int, device):
    """Decode caches for the layer stack, grouped by period element."""
    spec = period_spec(cfg)
    n = num_periods(cfg)
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    return {f"blk{i}": {
        "k": torch.zeros((n, batch, max_seq, hk, dh), dtype=dt, device=device),
        "v": torch.zeros((n, batch, max_seq, hk, dh), dtype=dt, device=device),
    } for i in range(len(spec))}
