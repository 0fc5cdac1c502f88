"""Zamba2-style hybrid: Mamba2 backbone + ONE shared attention+MLP block
applied every ``shared_attn_every`` layers on concat(hidden, embedding) —
the port of ``repro.models.hybrid``.

Weights of the shared block are a single copy; each invocation has its own
KV cache (13 invocations for 81/6). Per-invocation LoRA deltas of real
Zamba2 are omitted, as in the reference. Layout: ``groups`` of
[shared-attn → ``every`` mamba layers], then ``tail`` plain mamba layers
(81 = 13×6 + 3).

The reference's ``lax.scan`` over the groups becomes a Python loop over the
group index; decode writes each invocation's K/V and each layer's SSM state
into the caches IN PLACE, through views of the stacked cache tensors.
Train mode unbinds the stacks once and checkpoints each group's body by
``remat_wrap``, as the reference does (the tail layers are not wrapped).
"""
from __future__ import annotations

import torch

from repro_torch.core.persistent import tree_map
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init
from repro_torch.models.transformer import (KV_CACHE_AXES, _layer,
                                            layer_apply, layer_params,
                                            remat_wrap, stack_layers,
                                            stacked_axes, unstack_layers)


def _counts(cfg):
    every = cfg.shared_attn_every
    groups = cfg.num_layers // every
    tail = cfg.num_layers - groups * every
    return groups, every, tail


def hybrid_params(b: Init, cfg):
    groups, every, tail = _counts(cfg)
    d = cfg.d_model
    p = {
        "shared": {
            "w_cat": b.p((2 * d, d), ("embed", None)),
            "blk": layer_params(b, cfg, "attn_mlp"),
        },
        "groups": b.stack(
            groups,
            lambda bb: [layer_params(bb, cfg, "ssm") for _ in range(every)]),
    }
    if tail:
        p["tail"] = b.stack(tail, lambda bb: layer_params(bb, cfg, "ssm"))
    return p


def _shared_apply(p, x, x0, cfg, ctx, *, mode, pos, cache, valid_len,
                  plain):
    # on a mesh: the product on the gathered sequence (train mode), the
    # result back on the residual stream's placements
    h = ctx.gather_seq(torch.cat([x, x0], dim=-1)) @ p["w_cat"]
    h = ctx.constrain(h, "act_batch", "act_seq", "act_embed")
    h2, aux, new_cache = layer_apply(
        p["blk"], h, cfg, ctx, "attn_mlp", {}, mode=mode, pos=pos,
        cache=cache, valid_len=valid_len, plain=plain)
    # the reference's residual form: in bf16, x + (h2 - h) is not x + attn
    return x + (h2 - h), aux, new_cache


def hybrid_forward(params, x, cfg, ctx, *, mode: str, pos,
                   caches=None, valid_len=None, plain: bool = False):
    """x: (B,S,d) embedded input. Returns (x, aux, caches): prefill builds
    the caches (``shared_attn`` K/V (groups, B, S, Hkv, D), ``ssm_groups``
    a list of ``every`` state trees stacked over groups, ``ssm_tail``);
    decode updates ``caches`` in place and returns it. Train mode returns
    (x, aux)."""
    if mode == "train":
        return _train_forward(params, x, cfg, ctx, pos, plain)
    decode = mode == "decode"
    groups, every, tail = _counts(cfg)
    x0 = x
    kw = dict(mode=mode, pos=pos, valid_len=valid_len, plain=plain)
    attn_new, ssm_new = [], [[] for _ in range(every)]
    for gi in range(groups):
        cache = _layer(caches["shared_attn"], gi) if decode else None
        x, _, nc = _shared_apply(params["shared"], x, x0, cfg, ctx,
                                 cache=cache, **kw)
        attn_new.append(nc)
        for i in range(every):
            st = _layer(caches["ssm_groups"][i], gi) if decode else None
            x, _, ns = layer_apply(_layer(params["groups"][i], gi), x, cfg,
                                   ctx, "ssm", {}, cache=st, **kw)
            ssm_new[i].append(ns)
    tail_new = []
    for ti in range(tail):
        st = _layer(caches["ssm_tail"], ti) if decode else None
        x, _, ns = layer_apply(_layer(params["tail"], ti), x, cfg, ctx, "ssm",
                               {}, cache=st, **kw)
        tail_new.append(ns)
    if decode:
        return x, {}, caches
    new_caches = {"shared_attn": stack_layers(attn_new),
                  "ssm_groups": [stack_layers(s) for s in ssm_new]}
    if tail:
        new_caches["ssm_tail"] = stack_layers(tail_new)
    return x, {}, new_caches


def _train_forward(params, x, cfg, ctx, pos, plain):
    groups, every, tail = _counts(cfg)
    x0 = x
    stacks = [unstack_layers(g, groups) for g in params["groups"]]

    def group(x, *lps):
        # each use's fsdp gather (the shared block's too), inside remat
        x, _, _ = _shared_apply(ctx.gather_fsdp(params["shared"]), x, x0,
                                cfg, ctx, mode="train", pos=pos, cache=None,
                                valid_len=None, plain=plain)
        for lp in lps:
            x, _, _ = layer_apply(ctx.gather_fsdp(lp), x, cfg, ctx, "ssm",
                                  {}, mode="train", pos=pos)
        return x

    body = remat_wrap(group, cfg)
    for gi in range(groups):
        x = body(x, *(layers[gi] for layers in stacks))
    if tail:
        for lp in unstack_layers(params["tail"], tail):
            x, _, _ = layer_apply(ctx.gather_fsdp(lp), x, cfg, ctx, "ssm",
                                  {}, mode="train", pos=pos)
    return x, {}


def hybrid_init_caches(cfg, batch: int, max_seq: int, device):
    groups, every, tail = _counts(cfg)
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    st = ssm_mod.ssm_init_state(cfg, batch, device)

    def stacked(n):
        return tree_map(lambda a: a.new_zeros((n,) + tuple(a.shape)), st)

    caches = {
        "shared_attn": {
            "k": torch.zeros((groups, batch, max_seq, hk, dh), dtype=dt,
                             device=device),
            "v": torch.zeros((groups, batch, max_seq, hk, dh), dtype=dt,
                             device=device),
        },
        "ssm_groups": [stacked(groups) for _ in range(every)],
    }
    if tail:
        caches["ssm_tail"] = stacked(tail)
    return caches


def hybrid_cache_axes(cfg):
    groups, every, tail = _counts(cfg)
    stacked = stacked_axes(ssm_mod.ssm_state_axes(cfg))
    out = {
        "shared_attn": {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES},
        "ssm_groups": [stacked for _ in range(every)],
    }
    if tail:
        out["ssm_tail"] = stacked
    return out
