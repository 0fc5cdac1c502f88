"""Whisper-style encoder-decoder backbone — the port of
``repro.models.encdec``.

As in the reference, the conv/mel frontend is a stub: the encoder consumes
precomputed frame embeddings (B, F, d_model). Sinusoidal positions,
non-causal encoder self-attention, decoder = causal self-attention +
cross-attention + MLP, RMSNorm in place of LayerNorm (the reference's
simplification).

Attention goes through the port's kernels on CUDA tensors: the encoder's
self-attention and the prefill cross-attention (a prompt of S tokens
against F frames, S != F) through K5 (``flash_attention``), the decoder's
causal self-attention through K5 in prefill and K4 (``decode_attention``)
in decode. Decode's cross-attention (one token against all F cached
frames) goes through K4 with ``valid_len = F`` and no window: the same
function as K5 at Sq = 1, and K4 splits the 1500 frames over a cluster
of CTAs where K5 would give each (slot, head) one CTA. The reference's
``lax.scan`` over layers becomes a Python loop; decode writes the self
K/V caches IN PLACE. Train mode takes the differentiable attention (K5
with its lse and K5-bwd on CUDA, cross-attention's Sq != F included;
their plain versions on the CPU), unbinds the stacks once and
checkpoints each layer's body by ``remat_wrap``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (Init, mlp_apply, mlp_params, rms_norm,
                                       sinusoidal_positions)
from repro_torch.distributed.sharding import axes
from repro_torch.models.transformer import (KV_CACHE_AXES, _layer,
                                            remat_wrap, stack_layers,
                                            unstack_layers)


def _enc_layer_params(b: Init, cfg):
    d = cfg.d_model
    return {
        "ln_attn": b.p((d,), ("embed",), init="ones"),
        "attn": attn.attn_params(b, d, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, qkv_bias=False),
        "ln_mlp": b.p((d,), ("embed",), init="ones"),
        "mlp": mlp_params(b, d, cfg.d_ff, cfg.gated_mlp),
    }


def _dec_layer_params(b: Init, cfg):
    d = cfg.d_model
    return {
        "ln_self": b.p((d,), ("embed",), init="ones"),
        "self_attn": attn.attn_params(b, d, cfg.num_heads, cfg.num_kv_heads,
                                      cfg.resolved_head_dim, qkv_bias=False),
        "ln_cross": b.p((d,), ("embed",), init="ones"),
        "cross_attn": attn.attn_params(b, d, cfg.num_heads, cfg.num_kv_heads,
                                       cfg.resolved_head_dim, qkv_bias=False),
        "ln_mlp": b.p((d,), ("embed",), init="ones"),
        "mlp": mlp_params(b, d, cfg.d_ff, cfg.gated_mlp),
    }


def encdec_params(b: Init, cfg):
    return {
        "enc": b.stack(cfg.encoder_layers, lambda bb: _enc_layer_params(bb, cfg)),
        "enc_norm": b.p((cfg.d_model,), ("embed",), init="ones"),
        "dec": b.stack(cfg.num_layers, lambda bb: _dec_layer_params(bb, cfg)),
    }


def encode(params, frames, cfg, ctx, *, plain: bool = False,
           mode: str = "prefill"):
    """frames: (B,F,d_model) stub embeddings -> (B,F,d_model)."""
    B, F, d = frames.shape
    train = mode == "train"
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + sinusoidal_positions(F, d, x.device)[None].to(x.dtype)
    x = ctx.constrain(x, "act_batch", "act_seq", "act_embed")

    def body(x, lp):
        if train:
            lp = ctx.gather_fsdp(lp)      # a layer's fsdp gather at use
        h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["attn"], h, ctx)
        o = attn.attention(q, k, v, cfg, ctx, causal=False, plain=plain,
                           train=train)
        x = x + attn.out_project(lp["attn"], o, ctx)
        h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h, cfg.mlp_act, cfg.gated_mlp, ctx)

    if train:
        body = remat_wrap(body, cfg)
    for lp in unstack_layers(params["enc"], cfg.encoder_layers):
        x = body(x, lp)
    return rms_norm(x, ctx.gather_fsdp(params["enc_norm"]) if train
                    else params["enc_norm"], cfg.norm_eps)


def _cross_kv(lp, enc_out, ctx):
    enc_out = ctx.gather_seq(enc_out)
    k = attn._proj(enc_out, lp["cross_attn"]["wk"])
    v = attn._proj(enc_out, lp["cross_attn"]["wv"])
    return k, v


def decoder_forward(params, x, enc_out, cfg, ctx, *, mode: str, pos,
                    caches=None, valid_len=None, plain: bool = False):
    """x: (B,S,d) embedded tokens. enc_out: (B,F,d), or None in decode
    (which reads the cached cross K/V). Returns (x, caches): prefill builds
    them ({"self", "cross"}, K/V (L, B, S or F, Hkv, D)); decode updates
    the self caches in place and returns ``caches``; train mode returns
    (x, None)."""
    if mode == "train":
        return _train_decoder(params, x, enc_out, cfg, ctx, plain), None
    decode = mode == "decode"
    selfs, crosses = [], []
    frames_len = None
    if decode:
        F = caches["cross"]["k"].shape[2]
        frames_len = torch.full((x.shape[0],), F, dtype=torch.int32,
                                device=x.device)
    for li in range(cfg.num_layers):
        lp = _layer(params["dec"], li)
        # --- causal self attention ---
        h = rms_norm(x, lp["ln_self"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["self_attn"], h, ctx)
        if decode:
            cache = _layer(caches["self"], li)
            kc, vc = attn.cache_update_sharded(cache["k"], cache["v"], k, v,
                                               pos[:, 0], ctx)
            o = attn.decode_attention_sharded(q, kc, vc, valid_len, ctx,
                                              plain=plain)
        else:
            o = attn.attention(q, k, v, cfg, ctx, causal=True, plain=plain)
            selfs.append({"k": k, "v": v})
        x = x + attn.out_project(lp["self_attn"], o, ctx)
        # --- cross attention ---
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        qc = attn._proj(h, lp["cross_attn"]["wq"])
        if decode:
            cross = _layer(caches["cross"], li)
            oc = attn.decode_attention_local(
                qc, cross["k"], cross["v"], frames_len,
                attn_softcap=cfg.attn_softcap, plain=plain, ctx=ctx)
        else:
            kx, vx = _cross_kv(lp, enc_out, ctx)
            crosses.append({"k": kx, "v": vx})
            oc = attn.attention(qc, kx, vx, cfg, ctx, causal=False,
                                plain=plain)
        x = x + attn.out_project(lp["cross_attn"], oc, ctx)
        # --- mlp ---
        h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg.mlp_act, cfg.gated_mlp, ctx)
    if decode:
        return x, caches
    return x, {"self": stack_layers(selfs), "cross": stack_layers(crosses)}


def _train_decoder(params, x, enc_out, cfg, ctx, plain):
    def body(x, lp):
        lp = ctx.gather_fsdp(lp)          # a layer's fsdp gather at use
        h = rms_norm(x, lp["ln_self"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp["self_attn"], h, ctx)
        o = attn.attention(q, k, v, cfg, ctx, causal=True, plain=plain,
                           train=True)
        x = x + attn.out_project(lp["self_attn"], o, ctx)
        h = ctx.gather_seq(rms_norm(x, lp["ln_cross"], cfg.norm_eps))
        qc = attn._proj(h, lp["cross_attn"]["wq"])
        kx, vx = _cross_kv(lp, enc_out, ctx)
        oc = attn.attention(qc, kx, vx, cfg, ctx, causal=False, plain=plain,
                            train=True)
        x = x + attn.out_project(lp["cross_attn"], oc, ctx)
        h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h, cfg.mlp_act, cfg.gated_mlp, ctx)

    body = remat_wrap(body, cfg)
    for lp in unstack_layers(params["dec"], cfg.num_layers):
        x = body(x, lp)
    return x


def encdec_init_caches(cfg, batch: int, max_seq: int, device):
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    L, F = cfg.num_layers, cfg.encoder_frames
    dt = dict(dtype=getattr(torch, cfg.dtype), device=device)
    return {
        "self": {"k": torch.zeros((L, batch, max_seq, hk, dh), **dt),
                 "v": torch.zeros((L, batch, max_seq, hk, dh), **dt)},
        "cross": {"k": torch.zeros((L, batch, F, hk, dh), **dt),
                  "v": torch.zeros((L, batch, F, hk, dh), **dt)},
    }


def encdec_cache_axes(cfg):
    cx = axes("layers", "cache_batch", None, "cache_heads", None)
    return {"self": {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES},
            "cross": {"k": cx, "v": cx}}
