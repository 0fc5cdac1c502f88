"""Attention: GQA projections, prefill attention and decode attention — the
port of ``repro.models.attention``.

The reference picks its prefill implementation from ``cfg.attn_backend``
and ``jax.default_backend()``; every backend computes the same function.
The port picks it from the tensor: a CUDA tensor goes through the
hand-written Hopper kernels (``kernels.flash_attention`` for prefill,
``kernels.decode_attention`` for decode), a CPU tensor through their plain
PyTorch versions. ``plain=True`` asks for the plain versions on any device
— the reference path that ``chip_smoke.py`` holds the kernel path against;
nothing falls back to it on its own.

Train mode (``train=True``) differentiates attention as the reference
does through ``flash_xla``'s custom VJP: ``flash_attention_grad`` runs K5
with its log-sum-exp forward and K5-bwd backward on CUDA tensors (their
plain, query-blockwise versions on the CPU or with ``plain``), saving only
q, k, v, out and lse. ``cfg.attn_backend == "masked"`` keeps train mode on
the full-score ``flash_attention_plain`` through autograd, as the
reference's ``masked_full_xla`` control arm.

On a mesh (``ShardCtx.for_mesh``, DTensor activations) the kernels run on
each rank's local blocks inside ``local_map``, the counterpart of the
reference's ``shard_map``:

* prefill: K5 on the rank's shard of query heads, with exactly the kv heads
  those heads read (``_local_kv``); ``pad_heads_for_tp`` pads each kv
  group's query heads so the heads divide the model axis;
* decode: the cache's sequence is sharded (``cache_seq``); each rank runs
  K4's shard mode on its block (``decode_attention_partial``) and the
  partials are merged over the sequence axes by all_reduce (MAX, then
  SUM): ``decode_attention_sharded``. ``cache_update_sharded`` writes the
  new token on the rank that owns its position, in place.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed.sharding import (_is_dtensor, as_replicated,
                                              blocks_map, mesh_coord,
                                              shard_axes, unshard_dim)
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_partial,
    decode_attention_partial_plain, decode_attention_plain,
    merge_decode_partials)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_grad,
                                                 flash_attention_plain)
from repro_torch.models.layers import Init


# ---------------------------------------------------------------------------
# Params / projections
# ---------------------------------------------------------------------------

def attn_params(b: Init, d_model: int, n_heads: int, n_kv: int,
                head_dim: int, qkv_bias: bool):
    p = {
        "wq": b.p((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": b.p((d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": b.p((d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": b.p((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if qkv_bias:
        p["bq"] = b.p((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        p["bk"] = b.p((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = b.p((n_kv, head_dim), ("kv_heads", "head_dim"), init="zeros")
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def qkv_project(p, x, ctx):
    x = ctx.gather_seq(x)
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
    # one 2-D product: a DTensor's 3-D @ 2-D becomes a bmm over a copy of
    # wo for every batch row
    y = o.reshape(-1, h * k) @ p["wo"].reshape(h * k, d)
    y = y.view(*o.shape[:-2], d)
    return ctx.constrain(y, "act_batch", "act_seq", "act_embed")


# ---------------------------------------------------------------------------
# Prefill attention
# ---------------------------------------------------------------------------

def pad_heads_for_tp(q, Hkv: int, ctx) -> tuple:
    """Pad q-heads so the model axis divides them: each kv group's G query
    heads become G' (the least G' >= G with Hkv G' a multiple of the model
    axis), so head h' = kv G' + g still reads kv head h' // G' = kv. Returns
    (q (B,S,Hkv G',D), Hq, G'); ``unpad_heads`` drops the padded heads'
    outputs (zeros). Without padding, a head count the model axis does not
    divide (llama4: 40 on 16) replicates attention over the axis.
    (The reference pads at the end of the head axis, which regroups the
    original heads when GQA is on: its reduced llama3-8b on a (1, 8) mesh
    moves the logits by 4.5 from its single-device model.)"""
    B, S, Hq, D = q.shape
    G = Hq // Hkv
    ms = ctx.model_axis_size if ctx is not None else 1
    if ms <= 1 or Hq % ms == 0:
        return q, Hq, G
    Gp = G
    while (Hkv * Gp) % ms:
        Gp += 1
    q = q.reshape(B, S, Hkv, G, D)
    q = torch.cat([q, q.new_zeros((B, S, Hkv, Gp - G, D))], dim=3)
    return q.reshape(B, S, Hkv * Gp, D), Hq, Gp


def unpad_heads(o, Hq: int, G_pad: int):
    B, S, Hp, D = o.shape
    if Hp == Hq:
        return o
    Hkv = Hp // G_pad
    return o.reshape(B, S, Hkv, G_pad, D)[:, :, :, :Hq // Hkv].reshape(
        B, S, Hq, D)


def _local_kv(k, v, h0: int, hq: int, G: int):
    """The kv heads that query heads [h0, h0 + hq) read (head h reads kv
    h // G), contiguous, and the group size among them."""
    if hq % G == 0:
        lo = h0 // G
        return k[:, :, lo:lo + hq // G], v[:, :, lo:lo + hq // G], G
    if G % hq == 0:
        lo = h0 // G
        return k[:, :, lo:lo + 1], v[:, :, lo:lo + 1], hq
    idx = torch.arange(h0, h0 + hq, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx), 1


def attention(q, k, v, cfg, ctx, *, causal: bool, window: int = 0,
              plain: bool = False, train: bool = False):
    """q: (B,S,Hq,D); k,v: (B,Skv,Hkv,D) -> (B,S,Hq,D). Every
    ``cfg.attn_backend`` value ('xla' | 'masked' | 'pallas' | 'auto')
    computes this function; on CUDA all of them run the flash kernel, and
    with ``train`` its differentiable form (K5 with lse, K5-bwd) but for
    'masked', the full-score plain version through autograd. On a mesh
    (DTensors) each rank runs it on its query-head shard."""
    if train and cfg.attn_backend == "masked":
        fn = flash_attention_plain
    elif train:
        fn = functools.partial(flash_attention_grad, block=cfg.attn_chunk,
                               plain=plain)
    else:
        fn = flash_attention_plain if plain else flash_attention
    kw = dict(causal=causal, window=window, attn_softcap=cfg.attn_softcap)
    if ctx.mesh is None or not _is_dtensor(q):
        return fn(q, k, v, **kw)
    mesh = ctx.mesh
    Hkv = k.shape[2]
    q, Hq, G = pad_heads_for_tp(q, Hkv, ctx)
    q = ctx.constrain(q, "act_batch", None, "act_heads", None)
    head_axes = shard_axes(q.placements, mesh, 2)
    kv_pl = unshard_dim(ctx.placements(k, "act_batch"), 2)

    def body(ql, kl, vl):
        hq = ql.shape[2]
        kl, vl, _ = _local_kv(kl, vl, mesh_coord(mesh, head_axes) * hq, hq,
                              G)
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous(), **kw)
    out = blocks_map(body, mesh, (q.placements, kv_pl, kv_pl),
                     (q.placements,))(q, k, v)
    if out.shape[2] != Hq:
        # the padded heads' outputs go; Hq itself does not divide the axis
        out = out.redistribute(mesh, unshard_dim(out.placements, 2))
    return unpad_heads(out, Hq, G)


# ---------------------------------------------------------------------------
# Decode attention (one new token vs cache)
# ---------------------------------------------------------------------------

def decode_attention_local(q, k_cache, v_cache, valid_len, *,
                           attn_softcap: float = 0.0, window: int = 0,
                           plain: bool = False, ctx=None):
    """q: (B,1,Hq,D); caches: (B,Smax,Hkv,D); valid_len: (B,) int32 —
    number of valid cache positions INCLUDING the just-written token. On a
    mesh (DTensor caches, sequence not sharded) each rank runs it on its
    batch block with every head."""
    fn = decode_attention_plain if plain else decode_attention
    kw = dict(attn_softcap=attn_softcap, window=window)
    if ctx is None or ctx.mesh is None or not _is_dtensor(k_cache):
        return fn(q, k_cache, v_cache, valid_len, **kw)
    from torch.distributed.tensor.experimental import local_map
    c_pl = k_cache.placements
    row_pl = unshard_dim(c_pl, 1)         # q and valid_len: the batch blocks

    def body(ql, kl, vl, ll):
        return fn(ql.contiguous(), kl, vl, ll, **kw)
    return local_map(body, out_placements=(row_pl,),
                     in_placements=(row_pl, c_pl, c_pl, row_pl),
                     device_mesh=ctx.mesh, redistribute_inputs=True)(
        as_replicated(q, ctx.mesh), k_cache, v_cache,
        as_replicated(valid_len, ctx.mesh))


def _cache_placements(ctx, cache):
    """(cache placements, the per-sequence tensors' placements (q, new
    tokens, positions), the sequence's mesh axes) of a (B,S,Hkv,D) cache
    under the decode rules; no mesh or a plain cache: no sequence axes."""
    if ctx.mesh is None or not _is_dtensor(cache):
        return None, None, []
    pl = ctx.placements(cache, "cache_batch", "cache_seq", "cache_heads")
    return pl, unshard_dim(pl, 1), shard_axes(pl, ctx.mesh, 1)


def decode_attention_sharded(q, k_cache, v_cache, valid_len, ctx, *,
                             attn_softcap: float = 0.0, window: int = 0,
                             plain: bool = False):
    """Flash-decoding over a KV cache whose sequence dim is sharded on mesh
    axes (decode: 'model'; long_decode: every axis). With no mesh, or no
    sequence sharding, it is ``decode_attention_local``. Otherwise each rank
    computes its shard's partial (K4's shard mode on CUDA, the plain partial
    on the CPU or with ``plain``), the partials are merged over the
    sequence axes by all_reduce, and the output is replicated over them;
    the batch stays sharded on the cache's batch axes."""
    c_pl, row_pl, seq_axes = _cache_placements(ctx, k_cache)
    if not seq_axes:
        return decode_attention_local(q, k_cache, v_cache, valid_len,
                                      attn_softcap=attn_softcap,
                                      window=window, plain=plain, ctx=ctx)
    from torch.distributed.tensor.experimental import local_map
    import torch.distributed._functional_collectives as funcol
    mesh = ctx.mesh
    S = k_cache.shape[1]
    part = decode_attention_partial_plain if plain else \
        decode_attention_partial
    dims = [mesh.mesh_dim_names.index(ax) for ax in seq_axes]

    def all_reduce(t, op):
        for d in dims:
            t = funcol.all_reduce(t, op, (mesh, d))
        return funcol.wait_tensor(t)

    def body(ql, kl, vl, ll):
        off = mesh_coord(mesh, seq_axes) * kl.shape[1]
        o, lse = part(ql.contiguous(), kl, vl, ll, off=off, seq_len=S,
                      attn_softcap=attn_softcap, window=window)
        return merge_decode_partials(o, lse, all_reduce)
    return local_map(body, out_placements=(row_pl,),
                     in_placements=(row_pl, c_pl, c_pl, row_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        as_replicated(q, mesh), k_cache, v_cache,
        as_replicated(valid_len, mesh))


def cache_update_sharded(k_cache, v_cache, k_new, v_new, positions, ctx):
    """Write (B,1,Hkv,D) new K/V at per-sequence ``positions`` (B,) into
    (B,Smax,Hkv,D) caches — IN PLACE (the reference returns updated
    copies). Positions are clamped to [0, Smax) as the reference's
    ``dynamic_update_slice`` clamps its start index. On a mesh whose cache
    sequence is sharded, each rank writes the rows whose position lies in
    its block, on its local block (the reference's predicated local
    update); the caches must already carry the decode placements."""
    c_pl, row_pl, seq_axes = _cache_placements(ctx, k_cache)
    if c_pl is None:
        _write_rows(k_cache, v_cache, k_new, v_new,
                    positions.long().clamp(0, k_cache.shape[1] - 1))
        return k_cache, v_cache
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.mesh
    if tuple(k_cache.placements) != c_pl or \
            tuple(v_cache.placements) != c_pl:
        raise ValueError(f"caches placed {k_cache.placements}, "
                         f"{v_cache.placements}; the decode rules place "
                         f"them {c_pl} (the update is in place)")

    def body(kl, vl, kn, vn, pos):
        # as the reference's shard_map body: a position past the cache is
        # owned by no shard (its single-device update clamps it instead)
        L = kl.shape[1]
        off = mesh_coord(mesh, seq_axes) * L
        pos = pos.long()
        _write_rows(kl, vl, kn, vn, (pos - off).clamp(0, L - 1),
                    owns=(pos >= off) & (pos < off + L))
        return pos
    local_map(body, out_placements=(row_pl,),
              in_placements=(c_pl, c_pl, row_pl, row_pl, row_pl),
              device_mesh=mesh, redistribute_inputs=True)(
        k_cache, v_cache, as_replicated(k_new, mesh),
        as_replicated(v_new, mesh), as_replicated(positions, mesh))
    return k_cache, v_cache


def _write_rows(kc, vc, kn, vn, rows_at, owns=None):
    """kc[b, rows_at[b]] = kn[b, 0] (and v), in place; with ``owns`` (B,)
    only where it holds, the other rows rewritten with what they held."""
    b = torch.arange(kc.shape[0], device=kc.device)
    for c, n in ((kc, kn), (vc, vn)):
        new = n[:, 0].to(c.dtype)
        if owns is not None:
            new = torch.where(owns[:, None, None], new, c[b, rows_at])
        c[b, rows_at] = new
