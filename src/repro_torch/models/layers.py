"""Shared building blocks: parameter init, norms, embeddings, RoPE, MLP —
the port of ``repro.models.layers``.

Parameters keep the reference's tree and axis layouts (``w_in (d, d_ff)``,
``table (V, d)``, ...), so converting a JAX parameter tree is a per-leaf
copy. ``Init`` replaces the reference's ``Builder`` with the same scales
(normal with 1/sqrt(fan_in), 0.02 for the embedding, ones for norms) but
draws from a ``torch.Generator`` on the target device, so full-width
weights are made where they live.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.persistent import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Param init (the reference's Builder in "init" mode)
# ---------------------------------------------------------------------------

class Init:
    def __init__(self, seed: int, dtype: torch.dtype, device):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def p(self, shape, init: str = "normal", scale: Optional[float] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init != "normal":
            raise ValueError(init)
        if scale is None:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (x * scale).to(dtype)

    def stack(self, n: int, fn: Callable) -> dict:
        """n stacked copies of a sub-tree (leading 'layers' axis), filled
        one layer at a time: the extra memory is one layer, not n."""
        first = fn(self)
        out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
        for i in range(n):
            sub = first if i == 0 else fn(self)
            for dst, src in zip(tree_leaves(out), tree_leaves(sub)):
                dst[i].copy_(src)
        return out


# ---------------------------------------------------------------------------
# Norms (f32 accumulation)
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., S, d//2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, d//2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(b: Init, d_model: int, d_ff: int, gated: bool):
    p = {
        "w_in": b.p((d_model, d_ff)),
        "w_out": b.p((d_ff, d_model)),
    }
    if gated:
        p["w_gate"] = b.p((d_model, d_ff))
    return p


def mlp_apply(p, x, act: str, gated: bool, ctx):
    h = x @ p["w_in"]
    if gated:
        g = _act(x @ p["w_gate"], act)
        h = g * h
    else:
        h = _act(h, act)
    h = ctx.constrain(h, "act_batch", None, "act_mlp")
    return h @ p["w_out"]


def _act(x, name: str):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def softcap(x, cap: float):
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_params(b: Init, vocab: int, d_model: int, tied: bool):
    p = {"table": b.p((vocab, d_model), scale=0.02)}
    if not tied:
        p["head"] = b.p((d_model, vocab))
    return p


def embed_lookup(p, tokens, d_model: int):
    return F.embedding(tokens.long(), p["table"])


def unembed(p, x, tied: bool, cap: float, ctx):
    if tied:
        logits = x @ p["table"].t()
    else:
        logits = x @ p["head"]
    logits = softcap(logits.float(), cap)
    return ctx.constrain(logits, "act_batch", None, "act_vocab")
