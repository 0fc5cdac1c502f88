"""Mixture-of-Experts layer: top-k router + group-capacity dispatch — the
port of ``repro.models.moe`` (single device).

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
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Init, _act, mlp_apply, mlp_params


def moe_params(b: Init, cfg):
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    p = {
        "router": b.p((d, E), scale=0.02),
        "w_in": b.p((E, d, f)),
        "w_gate": b.p((E, d, f)),
        "w_out": b.p((E, f, d)),
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


def moe_apply(p, x, cfg, ctx, group_mode: str = "local"):
    """x: (B,S,D) -> (y (B,S,D), aux_losses dict of scalars)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k

    if group_mode == "global":
        xg = x.reshape(1, B * S, D)
    else:
        g = min(m.group_size, S)
        xg = x.reshape(B * (S // g), g, D) if S % g == 0 and S > g else x
        xg = ctx.constrain(xg, "act_batch", None, "act_embed")
    G, Sg, _ = xg.shape
    C = _capacity(Sg, E, K, m.capacity_factor)
    if group_mode == "global":
        # decode: token counts are tiny — floor the capacity so collisions
        # (dropped tokens => wrong generations) are vanishingly rare
        C = max(C, 4)

    # ---- routing (f32) ----
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"].float())
    probs, idx, _, dispatch, combine = route(logits, K, C)

    # ---- expert compute: (E, G*C, d) slots, one bmm per weight stack ----
    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(xg.dtype), xg)
    out_e = _experts(p, xin.reshape(E, G * C, D), cfg.mlp_act)
    y = torch.einsum("egcd,gsec->gsd", out_e.reshape(E, G, C, D),
                     combine.to(out_e.dtype))
    y = ctx.constrain(y.reshape(B, S, D), "act_batch", "act_seq", "act_embed")

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act, gated=True, ctx=ctx)

    # ---- aux losses (Switch LB + router z) ----
    onehot = torch.nn.functional.one_hot(idx.long(), E).float()
    me = probs.mean(dim=(0, 1))                             # (E,)
    frac = onehot.sum(dim=2).mean(dim=(0, 1))               # routed frac * K
    lb = E * torch.sum(me * frac) / K
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"moe_lb": lb * m.router_aux_weight,
           "moe_z": z * m.router_z_weight}
    return y, aux
