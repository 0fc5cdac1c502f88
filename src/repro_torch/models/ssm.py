"""Mamba2 (SSD — state-space duality) block: chunked prefill path and
O(1)-state decode recurrence — the port of ``repro.models.ssm``.

Chunked algorithm (Dao & Gu, arXiv:2405.21060 §6): the sequence is split
into chunks of length L; the intra-chunk term is a small quadratic
attention-like product with a decay mask, the inter-chunk term flows
through a recurrence over per-chunk states. All SSM math runs in float32.
The reference's model path computes the SSD through XLA (``ssd_chunked``);
the port runs it through the K6 kernel (``kernels.ssd_scan.ops.ssd``).

Decode updates the state IN PLACE (``copy_`` into the cache tensors it is
given): the serving engine's chunked prefill hands it views of a staging
row and keeps no returned value.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.distributed.sharding import (_is_dtensor, as_replicated,
                                              axes, blocks_map)
from repro_torch.models.layers import Init, rms_norm


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.state_dim


def ssm_params(b: Init, cfg):
    d = cfg.d_model
    d_inner, H, Pd, N = ssm_dims(cfg)
    W = cfg.ssm.conv_width
    return {
        "wz": b.p((d, H, Pd), ("embed", "ssm_heads", "head_dim")),
        "wx": b.p((d, H, Pd), ("embed", "ssm_heads", "head_dim")),
        "wB": b.p((d, N), ("embed", "ssm_state")),
        "wC": b.p((d, N), ("embed", "ssm_state")),
        "wdt": b.p((d, H), ("embed", "ssm_heads")),
        "conv_x": b.p((W, H, Pd), ("conv", "ssm_heads", "head_dim"),
                       init="uniform", scale=1.0 / math.sqrt(W)),
        "conv_B": b.p((W, N), ("conv", "ssm_state"), init="uniform",
                      scale=1.0 / math.sqrt(W)),
        "conv_C": b.p((W, N), ("conv", "ssm_state"), init="uniform",
                      scale=1.0 / math.sqrt(W)),
        "A_log": b.p((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": b.p((H,), ("ssm_heads",), init="zeros"),
        "D": b.p((H,), ("ssm_heads",), init="ones"),
        "gate_norm": b.p((H, Pd), ("ssm_heads", "head_dim"), init="ones"),
        "w_out": b.p((H, Pd, d), ("ssm_heads", "head_dim", "embed")),
    }


def _causal_conv(x, w):
    """x: (B,S,C...), w: (W,C...) depthwise causal conv along S, summed in
    f32 and rounded to x's dtype. On a mesh (x a DTensor, S unsharded)
    each rank convolves its block (channels are independent)."""
    if _is_dtensor(x):
        w = as_replicated(w, x.device_mesh)
        pl = tuple(x.placements)
        return blocks_map(_causal_conv, x.device_mesh,
                          (pl, tuple(w.placements)), (pl,))(x, w)
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0) * (x.dim() - 2) + (W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + pad[:, i:i + S].float() * w[i].float()
    return out.to(x.dtype)


def _project(p, u, ctx):
    """u: (B,S,d) -> z,x (B,S,H,P), Bm,Cm (B,S,N), dt (B,S,H)
    pre-activation."""
    u = ctx.gather_seq(u)
    z = torch.einsum("bsd,dhp->bshp", u, p["wz"])
    x = torch.einsum("bsd,dhp->bshp", u, p["wx"])
    Bm = u @ p["wB"]
    Cm = u @ p["wC"]
    dt = u @ p["wdt"]
    x = ctx.constrain(x, "act_batch", None, "act_heads", None)
    z = ctx.constrain(z, "act_batch", None, "act_heads", None)
    return z, x, Bm, Cm, dt


def _conv_tail(x_raw, width: int):
    """Last (width-1) pre-conv inputs along S, left-padded with zeros, f32."""
    S = x_raw.shape[1]
    W = width - 1
    tail = x_raw[:, max(0, S - W):]
    if W > S:
        tail = F.pad(tail, (0, 0) * (x_raw.dim() - 2) + (W - S, 0))
    return tail.float()


def _dt(p, dt_raw, s):
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return torch.clamp(dt, s.dt_min, s.dt_max)


def _ssd_on_heads(ctx, x, dt, A, Bm, Cm, *, chunk: int, plain: bool):
    """``ssd``; on a mesh (DTensors) each rank runs it, K6 included, on its
    shard of SSM heads (every head's scan is independent)."""
    if ctx.mesh is None or not _is_dtensor(x):
        return ssd(x, dt, A, Bm, Cm, chunk=chunk, plain=plain)
    pl = ctx.placements
    x_pl = pl(x, "act_batch", None, "act_heads", None)
    st_pl = pl(x.new_empty((x.shape[0], x.shape[2], 1, 1)), "act_batch",
               "act_heads")
    return blocks_map(
        lambda *a: ssd(*a, chunk=chunk, plain=plain), ctx.mesh,
        (x_pl, pl(dt, "act_batch", None, "act_heads"), pl(A, "act_heads"),
         pl(Bm, "act_batch"), pl(Cm, "act_batch")),
        (x_pl, st_pl))(x, dt, A, Bm, Cm)


def ssm_block(p, u, cfg, ctx, *, return_state: bool = False,
              plain: bool = False):
    """Full mamba2 block forward (prefill). u: (B,S,d) -> (B,S,d).

    With return_state=True also returns the decode state after the last
    position (SSD running state + causal-conv input tails). ``plain=True``
    runs the SSD chunk through K6's plain version."""
    s = cfg.ssm
    z, x, Bm, Cm, dt = _project(p, u, ctx)
    x_raw, B_raw, C_raw = x, Bm, Cm
    x = F.silu(_causal_conv(x, p["conv_x"]))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"]))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"]))
    A = -torch.exp(p["A_log"].float())
    y, st_final = _ssd_on_heads(ctx, x.float(), _dt(p, dt, s), A, Bm.float(),
                                Cm.float(), chunk=s.chunk_size, plain=plain)
    y = y + p["D"].float()[None, None, :, None] * x.float()
    y = y.to(u.dtype) * F.silu(z)
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bshp,hpd->bsd", y, p["w_out"])
    out = ctx.constrain(out, "act_batch", "act_seq", "act_embed")
    if not return_state:
        return out
    W = s.conv_width
    state = {"ssd": st_final,
             "conv_x": _conv_tail(x_raw, W),
             "conv_B": _conv_tail(B_raw, W),
             "conv_C": _conv_tail(C_raw, W)}
    return out, state


# ---------------------------------------------------------------------------
# Decode (single step): O(1) state recurrence
# ---------------------------------------------------------------------------

def ssm_init_state(cfg, batch, device):
    d_inner, H, Pd, N = ssm_dims(cfg)
    W = cfg.ssm.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ssd": torch.zeros((batch, H, Pd, N), **f32),
        "conv_x": torch.zeros((batch, W - 1, H, Pd), **f32),
        "conv_B": torch.zeros((batch, W - 1, N), **f32),
        "conv_C": torch.zeros((batch, W - 1, N), **f32),
    }


def ssm_state_axes(cfg):
    return {
        "ssd": axes("cache_batch", "ssm_heads", None, None),
        "conv_x": axes("cache_batch", None, "ssm_heads", None),
        "conv_B": axes("cache_batch", None, None),
        "conv_C": axes("cache_batch", None, None),
    }


def _conv_step(cache, xt, w):
    """cache: (B,W-1,C...), xt: (B,C...) -> out (B,C...) in f32; the cache
    shifts by one position IN PLACE."""
    hist = torch.cat([cache, xt[:, None].to(cache.dtype)], dim=1)
    out = torch.einsum("bw...,w...->b...", hist.float(), w.float())
    cache.copy_(hist[:, 1:])
    return out


def ssm_block_decode(p, u, state, cfg, ctx):
    """u: (B,1,d) single token; ``state`` is updated IN PLACE and returned.
    Returns (out (B,1,d), state)."""
    s = cfg.ssm
    z, x, Bm, Cm, dt = _project(p, u, ctx)
    x1 = F.silu(_conv_step(state["conv_x"], x[:, 0], p["conv_x"]))
    B1 = F.silu(_conv_step(state["conv_B"], Bm[:, 0], p["conv_B"]))
    C1 = F.silu(_conv_step(state["conv_C"], Cm[:, 0], p["conv_C"]))

    A = -torch.exp(p["A_log"].float())
    dt1 = _dt(p, dt[:, 0], s)                                 # (B,H)
    decay = torch.exp(dt1 * A)                                # (B,H)
    st = state["ssd"]
    st.copy_(st * decay[:, :, None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dt1, x1, B1))
    y = torch.einsum("bn,bhpn->bhp", C1, st)
    y = y + p["D"].float()[None, :, None] * x1
    y = y.to(u.dtype) * F.silu(z[:, 0])
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bhp,hpd->bd", y, p["w_out"])[:, None]
    return ctx.constrain(out, "act_batch", "act_seq", "act_embed"), state
