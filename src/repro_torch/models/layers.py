"""Shared building blocks: parameter init, norms, embeddings, RoPE,
sinusoidal positions, MLP — the port of ``repro.models.layers``.

Parameters keep the reference's tree and axis layouts (``w_in (d, d_ff)``,
``table (V, d)``, ...), so converting a JAX parameter tree is a per-leaf
copy. ``Init`` replaces the reference's ``Builder`` with the same scales
(normal with 1/sqrt(fan_in), 0.02 for the embedding, ones for norms,
uniform in [-scale, scale) for the SSM conv weights) but
draws from a ``torch.Generator`` on the target device, so full-width
weights are made where they live. A normal leaf whose f32 draw would pass
``BIG_DRAW_BYTES`` (an expert stack of llama4 or grok-1) is drawn one
leading-axis slice at a time straight into its storage dtype, so no f32
copy of it exists; ``stack(1, ...)`` adds the layers axis as a view.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.persistent import tree_leaves, tree_map
from repro_torch.distributed.sharding import axes
from repro_torch.kernels import shape_only


# ---------------------------------------------------------------------------
# Param init (the reference's Builder in "init" mode)
# ---------------------------------------------------------------------------

# Above this f32 draw a normal leaf is drawn slice by slice. It is above
# every leaf of the configs served at full width before the moe family
# (the largest, mistral-nemo-12b's embedding, is a 2.7 GB draw), so their
# seed-0 weights are the one-draw weights they always were.
BIG_DRAW_BYTES = 4 * 2**30


class Init:
    """``Init(seed, dtype, device)`` draws parameters; ``Init.axes_mode()``
    walks the same code and returns each parameter's logical axes instead
    (the reference's ``Builder("axes")``): one code path yields both trees,
    so they cannot disagree in structure."""

    def __init__(self, seed: int = 0, dtype: torch.dtype = torch.float32,
                 device="cpu", *, mode: str = "init"):
        assert mode in ("init", "axes")
        self.mode = mode
        self.device = torch.device(device)
        self.dtype = dtype
        # under FakeTensorMode (the dry run's abstract parameters, the
        # port's jax.eval_shape) only shapes are made: nothing is drawn
        self.fake = shape_only()
        if mode == "init" and not self.fake:
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    @staticmethod
    def axes_mode() -> "Init":
        return Init(mode="axes")

    def p(self, shape, logical_axes=None, init: str = "normal",
          scale: Optional[float] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.mode == "axes":
            assert logical_axes is not None and \
                len(shape) == len(logical_axes), (shape, logical_axes)
            return axes(*logical_axes)
        dtype = dtype or self.dtype
        if self.fake:
            return torch.empty(shape, dtype=dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "uniform":
            # [-scale, scale), scale 1 when not given
            s = scale if scale is not None else 1.0
            x = torch.rand(shape, generator=self.gen, dtype=torch.float32,
                           device=self.device)
            return (x * (2 * s) - s).to(dtype)
        if init != "normal":
            raise ValueError(init)
        if scale is None:
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        if len(shape) > 1 and 4 * math.prod(shape) > BIG_DRAW_BYTES:
            out = torch.empty(shape, dtype=dtype, device=self.device)
            for i in range(shape[0]):
                out[i] = torch.randn(shape[1:], generator=self.gen,
                                     dtype=torch.float32,
                                     device=self.device) * scale
            return out
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (x * scale).to(dtype)

    def stack(self, n: int, fn: Callable) -> dict:
        """n stacked copies of a sub-tree (leading 'layers' axis), filled
        one layer at a time: the extra memory is one layer, not n (none
        for n = 1, whose layers axis is a view). In axes mode: the
        sub-tree's axes under a leading "layers" axis."""
        sub = fn(self)
        if self.mode == "axes":
            return tree_map(lambda a: axes("layers", *a.names), sub)
        if self.fake:
            return tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), sub)
        if n == 1:
            return tree_map(lambda x: x[None], sub)
        out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), sub)
        for i in range(n):
            if i:
                sub = fn(self)
            for dst, src in zip(tree_leaves(out), tree_leaves(sub)):
                dst[i].copy_(src)
            del sub                 # freed before the next layer is drawn
        return out


# ---------------------------------------------------------------------------
# Norms (f32 accumulation)
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


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
# Sinusoidal positions (encdec)
# ---------------------------------------------------------------------------

def _sinusoid(pos, d_model: int):
    """pos: (n,) f32 -> (n, d_model) f32: sin at even, cos at odd columns."""
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=pos.device)
                    * (-math.log(10000.0) / d_model))
    half = pos[:, None] * div
    # interleaved (no in-place writes: pos may be a DTensor on a mesh)
    return torch.stack([torch.sin(half), torch.cos(half)], dim=-1).reshape(
        pos.shape[0], d_model)


def sinusoidal_at(positions, d_model: int):
    """Sinusoidal embedding at arbitrary integer positions. (B,) -> (B,d)."""
    return _sinusoid(positions.float(), d_model)


def sinusoidal_positions(num_pos: int, d_model: int, device="cpu"):
    return _sinusoid(torch.arange(num_pos, dtype=torch.float32,
                                  device=device), d_model)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(b: Init, d_model: int, d_ff: int, gated: bool):
    p = {
        "w_in": b.p((d_model, d_ff), ("embed", "mlp")),
        "w_out": b.p((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        p["w_gate"] = b.p((d_model, d_ff), ("embed", "mlp"))
    return p


def mlp_apply(p, x, act: str, gated: bool, ctx):
    x = ctx.gather_seq(x)
    h = x @ p["w_in"]
    if gated:
        g = _act(x @ p["w_gate"], act)
        h = g * h
    else:
        h = _act(h, act)
    h = ctx.constrain(h, "act_batch", None, "act_mlp")
    # on a mesh the row-parallel product is a partial sum: reduce it once
    # here, not at every later use of the residual stream
    return ctx.constrain(h @ p["w_out"], "act_batch", "act_seq", "act_embed")


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
    p = {"table": b.p((vocab, d_model), ("vocab", "embed"), scale=0.02)}
    if not tied:
        p["head"] = b.p((d_model, vocab), ("embed", "vocab"))
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
