"""Model bundle — the port of ``repro.models.model`` (all six families:
dense, ssm, hybrid, encdec, moe and vlm).

``build(cfg, device=...)`` returns a ``Model`` whose methods are plain
functions on tensors:

* ``init(seed) -> params`` (drawn on ``device`` from a ``torch.Generator``)
* ``loss(params, batch) -> (scalar, metrics)`` (the train step's body;
  differentiable: attention through K5 with its lse and K5-bwd on CUDA,
  their plain versions on the CPU, the SSD through its plain version)
* ``prefill(params, batch, max_seq) -> (logits, caches)``
* ``decode_step(params, caches, tokens, positions) -> (logits, caches)``
  — the caches are updated IN PLACE and returned
* ``init_caches(batch, max_seq)``

``params_from_jax(np_tree, cfg, device)`` turns the reference's parameter
tree (``jax.tree.map(np.asarray, repro_model.init(key))``) into the port's
tensors: the layouts are the same (the hybrid's lists of per-layer trees
included), so it is a per-leaf copy. An encdec ``batch`` carries
``frames`` (B, F, d_model) beside ``tokens`` for the prefill; a vlm
``batch`` carries ``vision_embeds`` (B, vision_tokens, d_model), the stub
patch embeddings prepended to the prompt's, so its caches hold
``vision_tokens + S`` rows and its first decode position is
``vision_tokens + S``. ``loss`` reads the same keys: next-token
cross-entropy on the text region (past a vlm's prefix), an encdec's frames
through the encoder, every aux scalar (``moe_lb``, ``moe_z``) added to the
total.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.persistent import check_device, tree_map
from repro_torch.distributed.sharding import (ShardCtx, _is_dtensor,
                                              as_replicated, axes,
                                              blocks_map, mesh_axis_names,
                                              mesh_coord, replicating,
                                              shard_axes, unshard_dim)
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (Init, embed_lookup, embed_params,
                                       rms_norm, sinusoidal_at,
                                       sinusoidal_positions, unembed)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (bounds logit materialization to (B, chunk, V))
# ---------------------------------------------------------------------------

def chunked_ce(hidden, targets, mask, embed_p, cfg, ctx):
    """hidden: (B,S,d) — predicts targets (B,S) at the same index.

    Returns (sum_ce, sum_mask, sum_correct) as f32 scalars. Each chunk's
    logits are recomputed in backward (``checkpoint``, the reference's
    ``jax.checkpoint``); padded-vocab columns stay in the log-sum-exp and
    the argmax, as in the reference. On a mesh each rank reduces its vocab
    shard of a chunk's logits (``_vocab_parallel``); no rank holds a whole
    chunk's logits."""
    B, S, d = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    # the reference pads S to a multiple of the chunk with masked rows; a
    # shorter last chunk sums the same terms (and DTensor's pad does not
    # redistribute in every torch release)

    def body(h, t, m):
        logits = unembed(embed_p, h, cfg.tie_embeddings, cfg.logit_softcap,
                         ctx).float()
        lse, true, pred = _vocab_parallel(logits, t, ctx)
        ce = (lse - true) * m
        acc = torch.sum((pred == t) * m)
        return torch.sum(ce), torch.sum(m), acc

    z = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ce_sum, n_sum, acc_sum = z, z, z
    for lo in range(0, S, chunk):
        c, n, a = checkpoint(body, hidden[:, lo:lo + chunk],
                             targets[:, lo:lo + chunk],
                             mask[:, lo:lo + chunk], use_reentrant=False)
        ce_sum, n_sum, acc_sum = ce_sum + c, n_sum + n, acc_sum + a
    return ce_sum, n_sum, acc_sum


def _vocab_parallel(logits, t, ctx):
    """(log-sum-exp over the vocab, the target's logit, the argmax) of f32
    logits (B,c,V) and targets (B,c). On a mesh whose logits are sharded
    over the vocab, each rank reduces its shard (``blocks_map``): the
    running max and the argmax by all-reduce (MAX; MIN of the global index
    among the ranks holding the max, the first as ``argmax`` takes it),
    the sum of exponentials and the target's logit (on the rank whose
    shard holds it) as partial sums that DTensor reduces, and whose
    backward is each rank's own."""
    vocab_axes = (shard_axes(logits.placements, ctx.mesh, 2)
                  if ctx.mesh is not None and _is_dtensor(logits) else [])
    if not vocab_axes:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, t[..., None].long())[..., 0],
                torch.argmax(logits, dim=-1))
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Partial
    mesh = ctx.mesh
    dims = [mesh_axis_names(mesh).index(a) for a in vocab_axes]
    l_pl = tuple(logits.placements)
    row_pl = unshard_dim(l_pl, 2)
    part_pl = tuple(Partial() if i in dims else p
                    for i, p in enumerate(row_pl))

    def reduce(x, op):
        for d in dims:
            x = fc.all_reduce(x, op, (mesh, d))
        return fc.wait_tensor(x)

    def body(ll, tl):
        V = ll.shape[-1]
        v0 = mesh_coord(mesh, vocab_axes) * V
        mx, am = ll.detach().max(dim=-1)
        gmax = reduce(mx, "max")
        se = torch.exp(ll - gmax[..., None]).sum(dim=-1)
        idx = tl.long() - v0
        inside = (idx >= 0) & (idx < V)
        true = torch.gather(ll, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
        true = torch.where(inside, true, torch.zeros_like(true))
        big = torch.full_like(am, torch.iinfo(am.dtype).max)
        pred = reduce(torch.where(mx == gmax, am + v0, big), "min")
        return se, true, gmax, pred
    se, true, gmax, pred = blocks_map(
        body, mesh, (l_pl, row_pl), (part_pl, part_pl, row_pl, row_pl))(
        logits, t)
    return gmax + torch.log(se), true, pred


# ---------------------------------------------------------------------------
# Model bundle
# ---------------------------------------------------------------------------

@dataclass
class Model:
    cfg: ModelConfig
    ctx: ShardCtx
    device: torch.device
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_caches: Callable
    param_axes: Callable
    cache_axes: Callable
    input_specs: Callable


def attention_layers(cfg: ModelConfig) -> int:
    """Attention calls in one forward of the model: one a layer (a dense,
    moe or vlm stack), one a shared-block invocation (hybrid), the
    encoder's self-attention and the decoder's self- and cross-attention
    (encdec), none (ssm). A train step launches K5 this many times a
    microbatch, twice under remat (the recompute), and K5-bwd once."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def params_from_jax(np_tree, cfg: ModelConfig, device) -> dict:
    """The reference's parameter tree (numpy leaves; dicts and lists) as
    the port's tensors on ``device``, in ``cfg.param_dtype`` — the layouts
    already agree."""
    dt = getattr(torch, cfg.param_dtype)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dt,
                               device=device), np_tree)


def build(cfg: ModelConfig, ctx: ShardCtx | None = None, *,
          device="cuda", plain_kernels: bool = False) -> Model:
    """``device`` defaults to CUDA and raises when CUDA is absent.
    ``plain_kernels=True`` runs attention (K4/K5, and K5/K5-bwd in
    ``loss``) and the SSD chunk (K6) through the kernels' plain PyTorch
    versions on any device (the reference path for checks)."""
    cfg.validate()
    tfm.period_spec(cfg)          # raises for a family not ported yet
    device = check_device(device)
    ctx = ctx or ShardCtx.single()
    dtype = getattr(torch, cfg.dtype)

    def build_params(b: Init):
        p = {"embed": embed_params(b, cfg.padded_vocab, cfg.d_model,
                                   cfg.tie_embeddings),
             "final_norm": b.p((cfg.d_model,), ("embed",), init="ones")}
        if cfg.family == "hybrid":
            p["stack"] = hybrid_mod.hybrid_params(b, cfg)
        elif cfg.family == "encdec":
            p["stack"] = encdec_mod.encdec_params(b, cfg)
        else:
            p["stack"] = tfm.stack_params(b, cfg)
        return p

    def init(seed: int):
        return build_params(Init(seed, getattr(torch, cfg.param_dtype),
                                 device))

    def param_axes():
        return build_params(Init.axes_mode())

    def _embed(p, tokens):
        x = embed_lookup(p["embed"], tokens, cfg.d_model)
        # on a mesh the vocab-sharded lookup is a masked partial sum: reduce
        x = ctx.constrain(x, "act_batch", "act_seq", "act_embed").to(dtype)
        if cfg.scale_embeddings:
            x = x * math.sqrt(cfg.d_model)
        return x

    def _prefix(p, batch):
        """VLM: prepend the precomputed patch embeddings."""
        x = _embed(p, batch["tokens"])
        if cfg.family == "vlm":
            x = torch.cat([batch["vision_embeds"].to(dtype), x], dim=1)
        return x

    def _backbone(p, x, *, mode, pos, caches=None, valid_len=None,
                  enc_out=None):
        """Train mode returns (x, aux), the others (x, aux, caches)."""
        kw = dict(mode=mode, pos=pos, caches=caches, valid_len=valid_len,
                  plain=plain_kernels)
        if cfg.family == "hybrid":
            return hybrid_mod.hybrid_forward(p["stack"], x, cfg, ctx, **kw)
        if cfg.family == "encdec":
            x, caches = encdec_mod.decoder_forward(p["stack"], x, enc_out,
                                                   cfg, ctx, **kw)
            return (x, {}) if mode == "train" else (x, {}, caches)
        return tfm.forward_stack(p["stack"], x, cfg, ctx, **kw)

    def _text_input(params, batch, mode):
        """(embedded input, encoder output or None): a vlm's prefix
        prepended, an encdec's frames encoded and sinusoidal positions
        added to its tokens."""
        x = _prefix(params, batch)
        if cfg.family != "encdec":
            return x, None
        enc_out = encdec_mod.encode(params["stack"], batch["frames"], cfg,
                                    ctx, plain=plain_kernels, mode=mode)
        pe = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
        return x + pe[None].to(dtype), enc_out

    def on_mesh(fn):
        """On a mesh, plain tensors the model makes (positions, masks,
        frequencies: the same on every rank) join DTensor ops as
        replicated values."""
        if ctx.mesh is None:
            return fn

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with replicating():
                return fn(*args, **kwargs)
        return run

    @on_mesh
    def loss(params, batch):
        """Mean next-token cross-entropy over the text region, plus every
        aux scalar. Returns (total, {"ce", "acc", aux..., "loss"}), f32.
        On a mesh each layer's parameters are gathered over their fsdp
        axes where the layer runs (inside its remat body: FSDP's gather at
        use, again in backward), the rest here; the loss is a replicated
        DTensor."""
        params = {k: v if k == "stack" else ctx.gather_fsdp(v)
                  for k, v in params.items()}
        tokens = ctx.constrain(batch["tokens"], "act_batch", "act_seq")
        batch = dict(batch, tokens=tokens)
        B, S = tokens.shape
        x, enc_out = _text_input(params, batch, "train")
        Sx = x.shape[1]
        pos = torch.arange(Sx, device=tokens.device)[None].expand(B, Sx)
        if ctx.mesh is not None:
            # tensors that backward multiplies with (the RoPE angles, the
            # mask) are DTensors too: backward mixes in no plain tensor
            pos = as_replicated(pos.contiguous(), ctx.mesh)
        x = ctx.constrain(x, "act_batch", "act_seq", "act_embed")
        x, aux = _backbone(params, x, mode="train", pos=pos, enc_out=enc_out)
        # the chunks slice the sequence: gathered, as the reference's
        # per-chunk constraint gathers it
        x = ctx.gather_seq(rms_norm(x, params["final_norm"], cfg.norm_eps))
        # next-token prediction on the text region
        off = Sx - S                                  # vision prefix length
        h = x[:, off:, :][:, :-1, :]
        targets = ctx.constrain(tokens, "act_batch", None)[:, 1:]
        mask = torch.ones_like(targets, dtype=torch.float32)
        ce_sum, n_sum, acc_sum = chunked_ce(h, targets, mask,
                                            params["embed"], cfg, ctx)
        n = torch.clamp(n_sum, min=1.0)
        ce = ce_sum / n
        total = ce
        metrics = {"ce": ce, "acc": acc_sum / n}
        for k, v in aux.items():
            total = total + v
            metrics[k] = v
        metrics["loss"] = total
        return total, metrics

    @on_mesh
    def prefill(params, batch, max_seq: int):
        """Run the prompt; returns (last-position logits, caches padded to
        max_seq)."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x, enc_out = _text_input(params, batch, "prefill")
        Sx = x.shape[1]
        pos = torch.arange(Sx, device=tokens.device)[None].expand(B, Sx)
        x, _, caches = _backbone(params, x, mode="prefill", pos=pos,
                                 enc_out=enc_out)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x[:, -1:, :], cfg.tie_embeddings,
                         cfg.logit_softcap, ctx)
        caches = _pad_prefill_caches(caches, max_seq)
        # on a mesh: each rank keeps its block of the decode placements
        return logits, ctx.constrain_tree(caches, cache_axes())

    def _pad_prefill_caches(caches, max_seq):
        # attention K/V from prefill are (P,B,S,H,D): pad the seq dim to
        # max_seq. SSM states are fixed-size and 'cross' caches (encdec)
        # full-length: neither is padded.
        def fix(tree):
            if isinstance(tree, dict) and set(tree) == {"k", "v"}:
                return {kk: F.pad(c, (0, 0, 0, 0, 0, max_seq - c.shape[2]))
                        if c.shape[2] < max_seq else c
                        for kk, c in tree.items()}
            if isinstance(tree, dict):
                return {kk: vv if kk == "cross" else fix(vv)
                        for kk, vv in tree.items()}
            return tree
        return fix(caches)

    @on_mesh
    def decode_step(params, caches, tokens, positions):
        """tokens: (B,1) int32; positions: (B,) int32 write index of this
        token. Returns (logits (B,1,V), caches updated in place)."""
        x = _embed(params, tokens)
        if cfg.family == "encdec":
            x = x + sinusoidal_at(positions, cfg.d_model).to(dtype)[:, None]
        x, _, caches = _backbone(params, x, mode="decode",
                                 pos=positions[:, None], caches=caches,
                                 valid_len=positions + 1)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x, cfg.tie_embeddings,
                         cfg.logit_softcap, ctx)
        return logits, caches

    def init_caches(batch: int, max_seq: int):
        if cfg.family == "hybrid":
            return hybrid_mod.hybrid_init_caches(cfg, batch, max_seq, device)
        if cfg.family == "encdec":
            return encdec_mod.encdec_init_caches(cfg, batch, max_seq, device)
        return tfm.init_caches(cfg, batch, max_seq, device)

    def cache_axes():
        if cfg.family == "hybrid":
            return hybrid_mod.hybrid_cache_axes(cfg)
        if cfg.family == "encdec":
            return encdec_mod.encdec_cache_axes(cfg)
        return tfm.cache_axes(cfg)

    def input_specs(shape: ShapeSpec, device="meta"):
        """(batch of empty tensors of the shape's global sizes on
        ``device`` — meta, or cuda under ``FakeTensorMode`` for the dry
        run — and their logical axes): the reference's ShapeDtypeStructs."""
        B, S = shape.global_batch, shape.seq_len

        def t(size, dtype=torch.int32):
            return torch.empty(size, dtype=dtype, device=device)
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": t((B, S))}
            ax = {"tokens": axes("act_batch", "act_seq")}
        else:  # decode: one new token
            batch = {"tokens": t((B, 1)), "positions": t((B,))}
            ax = {"tokens": axes("cache_batch", None),
                  "positions": axes("cache_batch")}
        if cfg.family == "vlm" and shape.kind != "decode":
            batch["vision_embeds"] = t((B, cfg.vision_tokens, cfg.d_model),
                                       dtype)
            ax["vision_embeds"] = axes("act_batch", None, "act_embed")
        if cfg.family == "encdec" and shape.kind != "decode":
            batch["frames"] = t((B, cfg.encoder_frames, cfg.d_model),
                                torch.float32)
            ax["frames"] = axes("act_batch", None, "act_embed")
        return batch, ax

    return Model(cfg=cfg, ctx=ctx, device=device, init=init, loss=loss,
                 prefill=prefill, decode_step=decode_step,
                 init_caches=init_caches, param_axes=param_axes,
                 cache_axes=cache_axes, input_specs=input_specs)
