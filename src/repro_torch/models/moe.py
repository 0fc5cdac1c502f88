"""Mixture-of-Experts layer: top-k router + group-capacity dispatch — the
port of ``repro.models.moe``.

Two grouping modes, as the reference's:
* ``local``  (prefill): fixed groups of ``group_size`` tokens of one
  sequence (the whole sequence when it is shorter or does not divide);
* ``global`` (decode): all tokens of the step form ONE group, the
  inactive slots' included, with capacity at least 4.

Routing is in f32 (``route``): softmax over the router logits, top-k,
gates normalised over the top-k, and each (token, choice) given a slot
in its expert's capacity in (token, choice) order — the reference's
``cumsum`` order, which decides the tokens that capacity drops. The expert
products are plain large products (the reference leaves them to XLA, no
Pallas kernel): ``torch.bmm`` over the expert axis on the stored
(E, d, f) / (E, f, d) stacks, so no copy of an expert stack is made.

On a mesh (DTensors) routing and the expert products run inside
``local_map`` on each rank's tokens (its batch block; every token for the
global group) and its experts (``expert`` on the model axis) or its slice
of each expert's hidden dim (``expert_mlp``), with the expert stacks
gathered over their fsdp axis (``expert_embed``); the rank's output is a
partial sum over the model axis, and the aux losses' sums are partial over
the batch axes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import (_is_dtensor, blocks_map,
                                              mesh_axis_names, mesh_coord,
                                              unshard_dim)
from repro_torch.models.layers import Init, _act, mlp_apply, mlp_params


def moe_params(b: Init, cfg):
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    p = {
        "router": b.p((d, E), ("embed", "expert"), scale=0.02),
        "w_in": b.p((E, d, f), ("expert", "expert_embed", "expert_mlp")),
        "w_gate": b.p((E, d, f), ("expert", "expert_embed", "expert_mlp")),
        "w_out": b.p((E, f, d), ("expert", "expert_mlp", "expert_embed")),
    }
    if m.shared_expert:
        p["shared"] = mlp_params(b, d, f, gated=True)
    return p


def _capacity(tokens_per_group: int, num_experts: int, top_k: int,
              cf: float) -> int:
    c = int(math.ceil(tokens_per_group * top_k * cf / num_experts))
    return max(c, 1)


def slots(idx, gates, num_experts: int, capacity: int):
    """(token, choice) -> expert slot tensors. idx, gates: (G,Sg,K) ->
    (dispatch (G,Sg,E,C), combine (G,Sg,E,C)) f32. Each expert's slots go
    to its choices in (token, choice) order; choices past ``capacity`` are
    dropped (all-zero rows)."""
    G, Sg, K = idx.shape
    onehot = torch.nn.functional.one_hot(idx.long(), num_experts).float()
    flat = onehot.reshape(G, Sg * K, num_experts)
    pos = torch.cumsum(flat, dim=1) * flat - 1.0           # (G,Sg*K,E)
    keep = (pos >= 0) & (pos < capacity)
    pos = pos.clamp(0, capacity - 1).long()
    slot = torch.nn.functional.one_hot(pos, capacity).float() \
        * keep[..., None] * flat[..., None]                 # (G,Sg*K,E,C)
    slot = slot.reshape(G, Sg, K, num_experts, capacity)
    dispatch = slot.sum(dim=2)
    combine = (slot * gates[..., None, None]).sum(dim=2)
    return dispatch, combine


def route(logits, top_k: int, capacity: int):
    """f32 router logits (G,Sg,E) -> (probs, idx, gates, dispatch,
    combine): softmax probabilities, the top-k experts of each token and
    their gates normalised over the top-k, then ``slots``. (The reference's
    ``jax.lax.top_k`` breaks a tie toward the lower index; ``torch.topk``
    promises no order for ties. Random f32 logits do not tie.)"""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)           # (G,Sg,K)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    dispatch, combine = slots(idx, gates, logits.shape[-1], capacity)
    return probs, idx, gates, dispatch, combine


def _experts(p, xin, act: str):
    """xin (E,T,d) -> (E,T,d): every expert's gated MLP on its T slots, one
    batched product over the expert axis per weight stack."""
    h = torch.bmm(xin, p["w_in"])
    g = torch.bmm(xin, p["w_gate"])
    return torch.bmm(_act(g, act) * h, p["w_out"])


def _groups(x, m, group_mode: str):
    """(B,S,D) -> (G,Sg,D): one group of every token (global), or fixed
    groups of ``group_size`` tokens of one sequence (the whole sequence
    when it is shorter or does not divide)."""
    B, S, D = x.shape
    if group_mode == "global":
        return x.reshape(1, B * S, D)
    g = min(m.group_size, S)
    return x.reshape(B * (S // g), g, D) if S % g == 0 and S > g else x


def _route_and_experts(xg, router, w, cfg, group_mode: str, e0: int = 0):
    """Routing of the (G,Sg,D) groups over all E experts, then the
    experts e0 ... e0 + E_loc of the stacks ``w`` (E_loc = the stacks'
    leading dim). Returns (y (G,Sg,D), probs, idx, logits)."""
    m = cfg.moe
    G, Sg, D = xg.shape
    E, K = m.num_experts, m.top_k
    C = _capacity(Sg, E, K, m.capacity_factor)
    if group_mode == "global":
        # decode: token counts are tiny — floor the capacity so collisions
        # (dropped tokens => wrong generations) are vanishingly rare
        C = max(C, 4)

    # ---- routing (f32) ----
    logits = torch.einsum("gsd,de->gse", xg.float(), router.float())
    probs, idx, _, dispatch, combine = route(logits, K, C)

    # ---- expert compute: (E, G*C, d) slots, one bmm per weight stack ----
    El = w["w_in"].shape[0]
    if El != E:
        dispatch = dispatch[:, :, e0:e0 + El]
        combine = combine[:, :, e0:e0 + El]
    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(xg.dtype), xg)
    out_e = _experts(w, xin.reshape(El, G * C, D), cfg.mlp_act)
    y = torch.einsum("egcd,gsec->gsd", out_e.reshape(El, G, C, D),
                     combine.to(out_e.dtype))
    return y, probs, idx, logits


def _aux_sums(probs, idx, logits, E: int):
    """Sums over the tokens of the router probabilities (E,), the routed
    counts times K (E,) and the squared log-sum-exps ()."""
    onehot = torch.nn.functional.one_hot(idx.long(), E).float()
    return (probs.sum(dim=(0, 1)), onehot.sum(dim=2).sum(dim=(0, 1)),
            torch.square(torch.logsumexp(logits, dim=-1)).sum())


def _aux(sums, n: int, m):
    """Switch load balance and router z from the sums over n tokens."""
    me, frac, z = (t / n for t in sums)
    lb = m.num_experts * torch.sum(me * frac) / m.top_k
    return {"moe_lb": lb * m.router_aux_weight,
            "moe_z": z * m.router_z_weight}


def moe_apply(p, x, cfg, ctx, group_mode: str = "local"):
    """x: (B,S,D) -> (y (B,S,D), aux_losses dict of scalars)."""
    m = cfg.moe
    B, S, D = x.shape
    x = ctx.gather_seq(x)
    w = {k: p[k] for k in ("w_in", "w_gate", "w_out")}
    if ctx.mesh is not None and _is_dtensor(x):
        y, sums = _moe_on_mesh(p["router"], w, x, cfg, ctx, group_mode)
    else:
        xg = _groups(x, m, group_mode)
        if group_mode != "global":
            xg = ctx.constrain(xg, "act_batch", None, "act_embed")
        y, probs, idx, logits = _route_and_experts(xg, p["router"], w, cfg,
                                                   group_mode)
        sums = _aux_sums(probs, idx, logits, m.num_experts)
    y = ctx.constrain(y.reshape(B, S, D), "act_batch", "act_seq", "act_embed")

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act, gated=True, ctx=ctx)
    return y, _aux(sums, B * S, m)


def _moe_on_mesh(router, w, x, cfg, ctx, group_mode: str):
    """Routing and experts on each rank's blocks (``local_map``): tokens
    batch-sharded as x is (all of them, replicated, for the global group);
    the router replicated; each stack's experts or hidden slice as placed,
    gathered over its fsdp dim. Returns (y (B,S,D), aux sums) as DTensors,
    y partial over the mesh dims that shard the experts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = ctx.mesh
    names = mesh_axis_names(mesh)
    m = cfg.moe
    rep = (Replicate(),) * mesh.ndim
    x_pl = rep if group_mode == "global" else \
        ctx.placements(x, "act_batch", None, "act_embed")
    w_pl = {"w_in": unshard_dim(w["w_in"].placements, 1),
            "w_gate": unshard_dim(w["w_gate"].placements, 1),
            "w_out": unshard_dim(w["w_out"].placements, 2)}
    expert_axes = [names[i] for i, pl in enumerate(w_pl["w_in"])
                   if isinstance(pl, Shard) and pl.dim == 0]
    split = {i for i, pl in enumerate(w_pl["w_in"]) if isinstance(pl, Shard)}
    y_pl = tuple(Partial() if i in split else pl for i, pl in
                 enumerate(x_pl))
    sum_pl = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                   for pl in x_pl)

    # every rank along an expert-split dim routes the same tokens: the aux
    # losses' gradient reaches the router and x once a rank there, and
    # ``blocks_map`` sums it over those dims, so each rank takes its share
    share = 1.0 / math.prod(mesh.size(i) for i in split
                            if not isinstance(x_pl[i], Shard))

    def body(xl, rl, wi, wg, wo):
        ws = {"w_in": wi, "w_gate": wg, "w_out": wo}
        e0 = mesh_coord(mesh, expert_axes) * wi.shape[0]
        xg = _groups(xl, m, group_mode)
        y, probs, idx, logits = _route_and_experts(xg, rl, ws, cfg,
                                                   group_mode, e0)
        if share != 1.0 and probs.requires_grad:
            probs, logits = (_GradScale.apply(t, share)
                             for t in (probs, logits))
        return (y.reshape(xl.shape), *_aux_sums(probs, idx, logits,
                                                m.num_experts))
    y, *sums = blocks_map(
        body, mesh, (x_pl, rep, w_pl["w_in"], w_pl["w_gate"], w_pl["w_out"]),
        (y_pl, sum_pl, sum_pl, sum_pl))(
        x, router, w["w_in"], w["w_gate"], w["w_out"])
    # replicated DTensors: the aux losses join the loss on the mesh
    return y, [t.redistribute(mesh, rep) for t in sums]


class _GradScale(torch.autograd.Function):
    """Identity forward; backward scales the gradient by ``c``."""

    @staticmethod
    def forward(ctx, t, c: float):
        ctx.c = c
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None
