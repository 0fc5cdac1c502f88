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

On a mesh every function takes DTensors as they come (the parameters and
state placed by the train rules): the global norm is one reduced scalar,
each leaf's update runs on its shards, an 8-bit block is quantized over
the global last dim's blocks (``qblock_for``'s shard alignment keeps a
block inside a shard where the mesh allows it; where it does not,
``_blockable`` gathers that dim for the reshape), and the results keep
their inputs' placements.
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


def _blockable(x, n_blocks: int):
    """``x`` as is, or, where it is a DTensor whose last-dim shards would
    split its ``n_blocks`` quantization blocks unevenly, with that dim
    gathered (DTensor refuses to unflatten an uneven shard)."""
    pl = getattr(x, "placements", None)
    if pl is None:
        return x
    from torch.distributed.tensor import Shard
    last = x.dim() - 1
    n = math.prod(x.device_mesh.size(i) for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == last)
    if n_blocks % n == 0:
        return x
    from repro_torch.distributed.sharding import unshard_dim
    return x.redistribute(x.device_mesh, unshard_dim(pl, last))


def quantize_8bit(x: torch.Tensor, block: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization blockwise along the LAST dim, keeping
    the shape: q has x's shape (int8), the scales x.shape[:-1] +
    (last/B,) (f32). A 0-d x is taken as shape (1,). ``block`` gives B
    (a rank's block of a sharded leaf keeps the whole leaf's B), else
    ``qblock_for(last)``."""
    x = x.float()
    if x.dim() == 0:
        x = x[None]
    last = x.shape[-1]
    B = block or qblock_for(last)
    x = _blockable(x, last // B)
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
    blocks = _blockable(q.float(), last // B).reshape(shape[:-1] + (last // B, B))
    return (blocks * scale[..., None]).reshape(shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

# An 8-bit leaf with more elements than this (and a leading axis > 1: a
# layer or expert stack, an embedding) is updated a run of leading rows at
# a time, each run under this many elements (one row at least), so its
# dequantized f32 moments exist a run at a time — the reference's
# ``lax.scan`` over such leaves, a row a step; rows are independent, so
# the values are the same. Tests lower it to reach the loop.
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


def _update_8bit_leaf(cfg, p, g, st, step, lr, block=None):
    m = dequantize_8bit(st["m_q"], st["m_s"], p.shape)
    v = dequantize_8bit(st["v_q"], st["v_s"], p.shape)
    new_p, m, v = _adamw_update_leaf(cfg, p, g, m, v, step, lr)
    m_q, m_s = quantize_8bit(m, block)
    v_q, v_s = quantize_8bit(v, block)
    return new_p, {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}


def _like(new, old):
    """``new`` on ``old``'s placements where both are DTensors (sharding
    propagation may place a reduced or reshaped result otherwise, e.g. an
    8-bit scale whose last dim the fallback left replicated), else
    ``new``."""
    pl = getattr(old, "placements", None)
    if pl is None or not hasattr(new, "placements") or \
            tuple(new.placements) == tuple(pl):
        return new
    return new.redistribute(old.device_mesh, pl)


def _copy(dst, src):
    return dst.copy_(_like(src, dst))


def _into(dst: dict, src: dict) -> dict:
    """``src``'s values copied into ``dst``'s tensors (same keys)."""
    for k, t in src.items():
        _copy(dst[k], t)
    return dst


def _update_8bit(cfg, p, g, st, step, lr, donate: bool, block=None):
    if p.dim() >= 2 and p.shape[0] > 1 and p.numel() > BIG_LEAF_ELEMS:
        out_p = p if donate else torch.empty_like(p)
        out_s = st if donate else {k: torch.empty_like(t)
                                   for k, t in st.items()}
        rows = max(1, BIG_LEAF_ELEMS // math.prod(p.shape[1:]))
        for i in range(0, p.shape[0], rows):
            cut = slice(i, i + rows)
            new_p, new_s = _update_8bit_leaf(
                cfg, p[cut], g[cut], {k: t[cut] for k, t in st.items()},
                step, lr, block)
            _copy(out_p[cut], new_p)
            _into({k: t[cut] for k, t in out_s.items()}, new_s)
        return out_p, out_s
    new_p, new_s = _update_8bit_leaf(cfg, p, g, st, step, lr, block)
    if donate:
        return _copy(p, new_p), _into(st, new_s)
    return _like(new_p, p), {k: _like(t, st[k]) for k, t in new_s.items()}


def _update_8bit_blocks(cfg, p, g, st, step, lr, donate: bool):
    """``_update_8bit`` of DTensor leaves on each rank's blocks
    (``local_map``), where every piece of the leaf's state is placed as
    the parameter is and each rank's last dim holds whole quantization
    blocks (``qblock_for``'s shard alignment); the big-leaf loop then runs
    over the rank's own rows. Returns None where that does not hold (the
    caller updates the DTensors as they are)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(p.placements)
    B = qblock_for(p.shape[-1]) if p.dim() else 1
    if p.dim() == 0 or tuple(g.placements) != pl or \
            any(tuple(t.placements) != pl for t in st.values()) or \
            p.to_local().shape[-1] % B:
        return None
    mesh = p.device_mesh
    rep = (Replicate(),) * mesh.ndim
    keys = tuple(st)

    def body(pl_, gl, sl, lr_, *sts):
        return _update_8bit(cfg, pl_, gl, dict(zip(keys, sts)), sl, lr_,
                            donate, B)

    def flat(pl_, gl, sl, lr_, *sts):
        new_p, new_s = body(pl_, gl, sl, lr_, *sts)
        return (new_p, *(new_s[k] for k in keys))
    outs = local_map(flat, out_placements=(pl,) * (1 + len(keys)),
                     in_placements=(pl, pl, rep, rep) + (pl,) * len(keys),
                     device_mesh=mesh)(p, g, step, lr,
                                       *(st[k] for k in keys))
    if donate:          # written into the given tensors' blocks
        return p, st
    return outs[0], dict(zip(keys, outs[1:]))


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
        def upd8(p, g, st):
            out = None
            if hasattr(p, "placements"):
                out = _update_8bit_blocks(cfg, p, g, st, stepf, lr, donate)
            return out if out is not None else \
                _update_8bit(cfg, p, g, st, stepf, lr, donate)
        outs = tree_map(upd8, params, grads, state["mv"])
        new_mv = _part(params, outs, 1)
    else:
        def upd(p, g, m, v):
            new = _adamw_update_leaf(cfg, p, g, m, v, stepf, lr)
            if donate:
                return _copy(p, new[0]), _copy(m, new[1]), _copy(v, new[2])
            return tuple(_like(t, o) for t, o in zip(new, (p, m, v)))
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
