"""Optimizers built from scratch — the port of ``repro.optim.optimizer``:
AdamW with fp32 moments, block-quantized 8-bit AdamW (the >=300B MoE
configs set it), a cosine LR schedule, global-norm clipping and int8
gradient compression.

Plain functions on tensor trees (nested dicts and lists, as the models'
parameters are). State trees mirror the parameter tree with the
reference's layout and dtypes: ``{"mv": {"m": tree, "v": tree}, "step":
int32 0-d}``, or with 8 bits ``{"mv": tree of {"m_q", "m_s", "v_q",
"v_s"}, "step"}``, so a checkpoint of either package restores in the other.
The arithmetic is the reference's, in f32 where it computes in f32
(``torch.round`` rounds half to even, as ``jnp.round`` does).

``adamw_update(..., donate=True)`` writes the new values into the given
parameter and state tensors, as the reference's launcher donates them to
its jitted step (``donate_argnums=(0, 1)``): the old state is then not
kept beside the new one. The values are the same either way.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.persistent import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


# ---------------------------------------------------------------------------
# Global-norm clipping
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# 8-bit block quantization (optimizer state / gradient compression)
# ---------------------------------------------------------------------------

QBLOCK = 256
QALIGN = 16     # production mesh axis size: keep (last/B) % QALIGN == 0 so
                # quantization blocks never cross shard boundaries


def qblock_for(last_dim: int, align: int = QALIGN) -> int:
    """Largest power-of-2 block <= QBLOCK that divides last_dim, preferring
    blocks whose count stays divisible by `align` (shard-aligned). Blocks
    below 8 give no compression win — fall back to the plain divisor."""
    best_plain = 1
    for b in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if last_dim % b:
            continue
        best_plain = max(best_plain, b)
        if b >= 8 and (last_dim // b) % align == 0:
            return b
    return best_plain


def quantize_8bit(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization blockwise along the LAST dim, keeping
    the shape: q has x's shape (int8), the scales x.shape[:-1] +
    (last/B,) (f32). A 0-d x is taken as shape (1,)."""
    x = x.float()
    if x.dim() == 0:
        x = x[None]
    last = x.shape[-1]
    B = qblock_for(last)
    blocks = x.reshape(tuple(x.shape[:-1]) + (last // B, B))
    absmax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def dequantize_8bit(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple) -> torch.Tensor:
    shape = tuple(shape) or (1,)
    last = shape[-1]
    B = last // scale.shape[-1]
    blocks = q.float().reshape(shape[:-1] + (last // B, B))
    return (blocks * scale[..., None]).reshape(shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

# An 8-bit leaf with more elements than this (and a leading axis > 1: a
# layer or expert stack) is updated one leading-axis slice at a time, so
# its dequantized f32 moments exist one slice at a time — the reference's
# ``lax.scan`` over such leaves. Tests lower it to reach the slice loop.
BIG_LEAF_ELEMS = 1 << 27


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    eightbit: bool = False


def _lr_at(cfg: AdamWConfig, step):
    if callable(cfg.lr):
        return cfg.lr(step)
    return torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)


def _zeros_8bit(p):
    shape = tuple(p.shape) or (1,)
    B = qblock_for(shape[-1])
    q = torch.zeros(shape, dtype=torch.int8, device=p.device)
    s = torch.zeros(shape[:-1] + (shape[-1] // B,), dtype=torch.float32,
                    device=p.device)
    return {"m_q": q, "m_s": s, "v_q": torch.zeros_like(q),
            "v_s": torch.zeros_like(s)}


def adamw_init(cfg: AdamWConfig, params):
    if cfg.eightbit:
        mv = tree_map(_zeros_8bit, params)
    else:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        mv = {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    device = tree_leaves(params)[0].device
    return {"mv": mv,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_state_axes(cfg: AdamWConfig, param_axes):
    """Optimizer-state logical axes mirroring the parameter axes: 8-bit
    state (and its scales) take its parameter's axes, the divisibility
    fallback trimming the shrunken last dim where needed."""
    from repro_torch.distributed.sharding import axes
    if cfg.eightbit:
        mv = tree_map(lambda a: {"m_q": a, "m_s": a, "v_q": a, "v_s": a},
                      param_axes)
    else:
        mv = {"m": param_axes, "v": param_axes}
    return {"mv": mv, "step": axes()}


def _adamw_update_leaf(cfg, p, g, m, v, step, lr):
    g32 = g.float()
    m = cfg.b1 * m + (1 - cfg.b1) * g32
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    mh = m / (1 - cfg.b1 ** step)
    vh = v / (1 - cfg.b2 ** step)
    upd = mh / (torch.sqrt(vh) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * p.float()
    new_p = (p.float() - lr * upd).to(p.dtype)
    return new_p, m, v


def _update_8bit_leaf(cfg, p, g, st, step, lr):
    m = dequantize_8bit(st["m_q"], st["m_s"], p.shape)
    v = dequantize_8bit(st["v_q"], st["v_s"], p.shape)
    new_p, m, v = _adamw_update_leaf(cfg, p, g, m, v, step, lr)
    m_q, m_s = quantize_8bit(m)
    v_q, v_s = quantize_8bit(v)
    return new_p, {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}


def _into(dst: dict, src: dict) -> dict:
    """``src``'s values copied into ``dst``'s tensors (same keys)."""
    for k, t in src.items():
        dst[k].copy_(t)
    return dst


def _update_8bit(cfg, p, g, st, step, lr, donate: bool):
    if p.dim() >= 2 and p.shape[0] > 1 and p.numel() > BIG_LEAF_ELEMS:
        out_p = p if donate else torch.empty_like(p)
        out_s = st if donate else {k: torch.empty_like(t)
                                   for k, t in st.items()}
        for i in range(p.shape[0]):
            new_p, new_s = _update_8bit_leaf(
                cfg, p[i], g[i], {k: t[i] for k, t in st.items()}, step, lr)
            out_p[i].copy_(new_p)
            _into({k: t[i] for k, t in out_s.items()}, new_s)
        return out_p, out_s
    new_p, new_s = _update_8bit_leaf(cfg, p, g, st, step, lr)
    if donate:
        return p.copy_(new_p), _into(st, new_s)
    return new_p, new_s


def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 donate: bool = False):
    """One AdamW step: clip by global norm, then update every leaf.
    Returns (params, state, {"grad_norm", "lr"}); ``donate=True`` writes
    the results into ``params``' and ``state``'s tensors. Leaves pair up by
    their keys, so the trees' key orders need not agree."""
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    stepf = step.to(torch.float32)
    if cfg.eightbit:
        outs = tree_map(
            lambda p, g, st: _update_8bit(cfg, p, g, st, stepf, lr, donate),
            params, grads, state["mv"])
        new_mv = _part(params, outs, 1)
    else:
        def upd(p, g, m, v):
            new = _adamw_update_leaf(cfg, p, g, m, v, stepf, lr)
            if donate:
                return p.copy_(new[0]), m.copy_(new[1]), v.copy_(new[2])
            return new
        outs = tree_map(upd, params, grads, state["mv"]["m"],
                        state["mv"]["v"])
        new_mv = {"m": _part(params, outs, 1), "v": _part(params, outs, 2)}
    return _part(params, outs, 0), {"mv": new_mv, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def _part(like, outs, i: int):
    """Item ``i`` of the tuple at each leaf of ``outs`` (``like``'s
    structure, whose leaves the tuples replaced)."""
    return tree_map(lambda _, o: o[i], like, outs)


# ---------------------------------------------------------------------------
# Gradient compression (int8 all-reduce payload)
# ---------------------------------------------------------------------------

def compress_grads(grads):
    """int8+scale representation for cross-pod transfer (4x traffic cut)."""
    def comp(g):
        q, s = quantize_8bit(g)
        return {"q": q, "s": s,
                "shape": torch.tensor(tuple(g.shape), dtype=torch.int32,
                                      device=g.device)}
    return tree_map(comp, grads)


def decompress_grads(comp, like):
    return tree_map(lambda l, c: dequantize_8bit(c["q"], c["s"], l.shape),
                    like, comp)


def make_optimizer(name: str, lr=3e-4, **kw) -> AdamWConfig:
    if name == "adamw":
        return AdamWConfig(lr=lr, **kw)
    if name == "adamw8bit":
        return AdamWConfig(lr=lr, eightbit=True, **kw)
    raise ValueError(name)
