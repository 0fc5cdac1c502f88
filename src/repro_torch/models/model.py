"""Model bundle — the port of ``repro.models.model`` (dense family).

``build(cfg, device=...)`` returns a ``Model`` whose methods are plain
functions on tensors:

* ``init(seed) -> params`` (drawn on ``device`` from a ``torch.Generator``)
* ``prefill(params, batch, max_seq) -> (logits, caches)``
* ``decode_step(params, caches, tokens, positions) -> (logits, caches)``
  — the caches are updated IN PLACE and returned
* ``init_caches(batch, max_seq)``

``params_from_jax(np_tree, cfg, device)`` turns the reference's parameter
tree (``jax.tree.map(np.asarray, repro_model.init(key))``) into the port's
tensors: the layouts are the same, so it is a per-leaf copy. The training
loss waits for the training slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.persistent import check_device, tree_map
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (Init, embed_lookup, embed_params,
                                       rms_norm, unembed)


@dataclass
class Model:
    cfg: ModelConfig
    ctx: ShardCtx
    device: torch.device
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_caches: Callable


def params_from_jax(np_tree, cfg: ModelConfig, device) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's tensors
    on ``device``, in ``cfg.param_dtype`` — the layouts already agree."""
    dt = getattr(torch, cfg.param_dtype)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dt,
                               device=device), np_tree)


def build(cfg: ModelConfig, ctx: ShardCtx | None = None, *,
          device="cuda", plain_attention: bool = False) -> Model:
    """``device`` defaults to CUDA and raises when CUDA is absent.
    ``plain_attention=True`` runs attention through the kernels' plain
    PyTorch versions on any device (the reference path for checks)."""
    cfg.validate()
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (dense only)")
    device = check_device(device)
    ctx = ctx or ShardCtx.single()
    dtype = getattr(torch, cfg.dtype)

    def init(seed: int):
        b = Init(seed, getattr(torch, cfg.param_dtype), device)
        return {"embed": embed_params(b, cfg.padded_vocab, cfg.d_model,
                                      cfg.tie_embeddings),
                "final_norm": b.p((cfg.d_model,), init="ones"),
                "stack": tfm.stack_params(b, cfg)}

    def _embed(p, tokens):
        x = embed_lookup(p["embed"], tokens, cfg.d_model).to(dtype)
        if cfg.scale_embeddings:
            x = x * math.sqrt(cfg.d_model)
        return x

    def prefill(params, batch, max_seq: int):
        """Run the prompt; returns (last-position logits, caches padded to
        max_seq)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = _embed(params, tokens)
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, _, caches = tfm.forward_stack(params["stack"], x, cfg, ctx,
                                         mode="prefill", pos=pos,
                                         plain=plain_attention)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x[:, -1:, :], cfg.tie_embeddings,
                         cfg.logit_softcap, ctx)
        return logits, _pad_prefill_caches(caches, max_seq)

    def _pad_prefill_caches(caches, max_seq):
        # attn kv from prefill are (P,B,S,H,D): pad the seq dim to max_seq
        def pad(c):
            return F.pad(c, (0, 0, 0, 0, 0, max_seq - c.shape[2])) \
                if c.shape[2] < max_seq else c
        return tree_map(pad, caches)

    def decode_step(params, caches, tokens, positions):
        """tokens: (B,1) int32; positions: (B,) int32 write index of this
        token. Returns (logits (B,1,V), caches updated in place)."""
        x = _embed(params, tokens)
        valid_len = positions + 1
        x, _, caches = tfm.forward_stack(
            params["stack"], x, cfg, ctx, mode="decode",
            pos=positions[:, None], caches=caches, valid_len=valid_len,
            plain=plain_attention)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tie_embeddings,
                         cfg.logit_softcap, ctx)
        return logits, caches

    def init_caches(batch: int, max_seq: int):
        return tfm.init_caches(cfg, batch, max_seq, device)

    return Model(cfg=cfg, ctx=ctx, device=device, init=init, prefill=prefill,
                 decode_step=decode_step, init_caches=init_caches)
