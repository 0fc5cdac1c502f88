"""Decoder-only stack assembly, dense, vlm, moe and ssm families — the
port of ``repro.models.transformer`` (the hybrid and encdec families
assemble their own stacks from its layers: ``models/hybrid.py``,
``models/encdec.py``).

Parameters keep the reference's stacked layout (``stack["blk{i}"]`` leaves
carry a leading layers axis), but the reference's ``lax.scan`` over that
axis becomes a Python loop over the layer index ``li``. Decode writes each
layer's new K/V (or SSM state) into the caches IN PLACE; the reference
threads updated copies through the scan carry. A MoE layer's aux scalars
(``moe_lb``, ``moe_z``) are summed over the layers into the returned aux,
as the reference's scan sums them.

Train mode (``mode="train"``, ``Model.loss``) differentiates through
autograd. Attention goes through ``flash_attention_grad``, the port of
``flash_xla``'s custom VJP: K5 with its log-sum-exp and the K5-bwd kernel
on CUDA tensors, their plain blockwise versions on the CPU (or with
``plain``); the SSD chunk through its plain PyTorch version on every
device, as the reference differentiates ``ssd_chunked`` by autodiff (K6
has no backward; its wrapper, like the forward-only K4/K5 ones, refuses a
tensor that requires grad). Each stacked leaf is ``torch.unbind``-ed once
a step (``unstack_layers``), and each period's body goes through
``remat_wrap``, the reference's activation-checkpoint policy.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.persistent import tree_leaves, tree_map
from repro_torch.core.telemetry import span
from repro_torch.distributed.sharding import axes, replicating
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Init, apply_rope, mlp_apply,
                                       mlp_params, rms_norm)


# ---------------------------------------------------------------------------
# Period spec
# ---------------------------------------------------------------------------

PORTED_FAMILIES = ("dense", "ssm", "hybrid", "encdec", "moe", "vlm")


def period_spec(cfg) -> list[tuple[str, dict]]:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (have "
            f"{', '.join(PORTED_FAMILIES)})")
    if cfg.family == "ssm":
        return [("ssm", {})]
    if cfg.family == "moe":
        if cfg.moe.interleave == 2:
            return [("attn_mlp", {}), ("attn_moe", {})]
        assert cfg.moe.interleave == 1
        return [("attn_moe", {})]
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
    if kind == "ssm":
        p["ln"] = b.p((d,), ("embed",), init="ones")
        p["ssm"] = ssm_mod.ssm_params(b, cfg)
        return p
    p["ln_attn"] = b.p((d,), ("embed",), init="ones")
    p["attn"] = attn.attn_params(b, d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, cfg.qkv_bias)
    p["ln_mlp"] = b.p((d,), ("embed",), init="ones")
    if cfg.sandwich_norm:
        p["ln_attn_post"] = b.p((d,), ("embed",), init="ones")
        p["ln_mlp_post"] = b.p((d,), ("embed",), init="ones")
    if kind == "attn_moe":
        p["moe"] = moe_mod.moe_params(b, cfg)
    else:
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
        o = attn.decode_attention_sharded(
            q, kc, vc, valid_len, ctx, attn_softcap=cfg.attn_softcap,
            window=window, plain=plain)
        new_cache = {"k": kc, "v": vc}
    else:
        o = attn.attention(q, k, v, cfg, ctx, causal=True, window=window,
                           plain=plain, train=mode == "train")
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    o = attn.out_project(p["attn"], o, ctx)
    if cfg.sandwich_norm:
        o = rms_norm(o, p["ln_attn_post"], cfg.norm_eps)
    return x + o, new_cache


def _ffn_sub(p, x, cfg, ctx, kind: str, group_mode: str):
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    aux = {}
    if kind == "attn_moe":
        o, aux = moe_mod.moe_apply(p["moe"], h, cfg, ctx, group_mode)
    else:
        o = mlp_apply(p["mlp"], h, cfg.mlp_act, cfg.gated_mlp, ctx)
    if cfg.sandwich_norm:
        o = rms_norm(o, p["ln_mlp_post"], cfg.norm_eps)
    return x + o, aux


def layer_apply(p, x, cfg, ctx, kind: str, opts: dict, *, mode: str, pos,
                cache=None, valid_len=None, plain: bool = False):
    """Returns (x, aux, new_cache); train mode returns no cache, takes the
    differentiable attention (``flash_attention_grad``; its plain versions
    with ``plain``) and the plain SSD on every device."""
    if kind == "ssm":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if mode == "train":
            o = ssm_mod.ssm_block(p["ssm"], h, cfg, ctx, plain=True)
            return x + o, {}, None
        if mode == "decode":
            o, state = ssm_mod.ssm_block_decode(p["ssm"], h, cache, cfg, ctx)
        else:
            o, state = ssm_mod.ssm_block(p["ssm"], h, cfg, ctx,
                                         return_state=True, plain=plain)
        return x + o, {}, state
    local = bool(opts.get("local", False))
    x, new_cache = _attn_sub(p, x, cfg, ctx, local=local, mode=mode, pos=pos,
                             cache=cache, valid_len=valid_len, plain=plain)
    # decode's one MoE group takes every slot's token, inactive ones too
    group_mode = "global" if mode == "decode" else "local"
    x, aux = _ffn_sub(p, x, cfg, ctx, kind, group_mode)
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matmuls without batch dims
    (the projections' ``mm``), recompute the rest — the reference's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body, cfg):
    """Apply the configured activation-checkpoint policy to a layer body:
    ``"full"`` recomputes everything in backward, ``"dots"`` keeps the
    matmul outputs, ``"none"`` (or ``cfg.remat=False``) keeps all."""
    if not cfg.remat or cfg.remat_policy == "none":
        return body
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(checkpoint, _replicating(body),
                             use_reentrant=False, **kw)


def _replicating(body):
    """``body`` under ``replicating()`` when it gets DTensors: its
    recomputation runs inside backward, outside the context the forward
    ran in, and mixes the same plain tensors (RoPE frequencies) in."""
    @functools.wraps(body)
    def run(*args):
        from torch.distributed.tensor import DTensor
        if not any(isinstance(a, DTensor) for a in args):
            return body(*args)
        with replicating():
            return body(*args)
    return run


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


def unstack_layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, one ``torch.unbind`` a
    leaf: under autograd, backward stacks the layers' gradients once
    (``tree[li]`` for each layer would write a full-stack-sized gradient
    per layer)."""
    cols = [torch.unbind(t) for t in tree_leaves(tree)]
    out = []
    for li in range(n):
        it = iter([c[li] for c in cols])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def stack_layers(trees: list):
    """Per-layer trees stacked leaf by leaf along a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def forward_stack(params, x, cfg, ctx, *, mode: str, pos,
                  caches=None, valid_len=None, plain: bool = False):
    """Run the layer stack.

    mode='train': returns (x, aux);
    mode='prefill': returns (x, aux, caches) — caches[f'blk{i}'] stacked
    over layers: attention K/V (P, B, S, Hkv, D), SSM state leaves
    (P, B, ...);
    mode='decode': caches required and updated in place; returns
    (x, aux, caches).
    """
    spec = period_spec(cfg)
    if mode == "train":
        return _train_stack(params, x, cfg, ctx, spec, pos, plain)
    per_layer: dict[str, list] = {f"blk{i}": [] for i in range(len(spec))}
    aux_acc: dict = {}
    for li in range(num_periods(cfg)):
        for i, (kind, opts) in enumerate(spec):
            key = f"blk{i}"
            cache_i = _layer(caches[key], li) if mode == "decode" else None
            p_i = _layer(params[key], li)
            with span("repro_torch.model.layer"):
                x, aux, nc = layer_apply(
                    p_i, x, cfg, ctx, kind, opts, mode=mode, pos=pos,
                    cache=cache_i, valid_len=valid_len, plain=plain)
            _merge_aux(aux_acc, aux)
            per_layer[key].append(nc)
    if mode == "decode":
        return x, aux_acc, caches
    new_caches = {key: stack_layers(cs) for key, cs in per_layer.items()}
    return x, aux_acc, new_caches


def _merge_aux(acc: dict, aux: dict) -> None:
    for k, v in aux.items():
        acc[k] = acc.get(k, 0.0) + v


def _train_stack(params, x, cfg, ctx, spec, pos, plain):
    n = num_periods(cfg)
    stacks = [unstack_layers(params[f"blk{i}"], n) for i in range(len(spec))]

    def period(x, *lps):
        aux: dict = {}
        for (kind, opts), lp in zip(spec, lps):
            lp = ctx.gather_fsdp(lp)      # a layer's fsdp gather at use
            x, a, _ = layer_apply(lp, x, cfg, ctx, kind, opts, mode="train",
                                  pos=pos, plain=plain)
            _merge_aux(aux, a)
        return x, aux

    body = remat_wrap(period, cfg)
    aux_acc: dict = {}
    for li in range(n):
        x, aux = body(x, *(layers[li] for layers in stacks))
        _merge_aux(aux_acc, aux)
    return x, aux_acc


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_seq: int, device):
    """Decode caches for the layer stack, grouped by period element."""
    spec = period_spec(cfg)
    n = num_periods(cfg)
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    caches = {}
    for i, (kind, _) in enumerate(spec):
        if kind == "ssm":
            st = ssm_mod.ssm_init_state(cfg, batch, device)
            caches[f"blk{i}"] = tree_map(
                lambda a: a.new_zeros((n,) + tuple(a.shape)), st)
        else:
            caches[f"blk{i}"] = {
                "k": torch.zeros((n, batch, max_seq, hk, dh), dtype=dt,
                                 device=device),
                "v": torch.zeros((n, batch, max_seq, hk, dh), dtype=dt,
                                 device=device),
            }
    return caches


def stacked_axes(tree):
    """An Axes tree under a leading "layers" axis."""
    return tree_map(lambda a: axes("layers", *a.names), tree)


KV_CACHE_AXES = axes("layers", "cache_batch", "cache_seq", "cache_heads", None)


def cache_axes(cfg):
    spec = period_spec(cfg)
    out = {}
    for i, (kind, _) in enumerate(spec):
        if kind == "ssm":
            out[f"blk{i}"] = stacked_axes(ssm_mod.ssm_state_axes(cfg))
        else:
            out[f"blk{i}"] = {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES}
    return out
