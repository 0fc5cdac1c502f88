"""Random weights from a seed, in the port's leaf layout.

Each leaf of each layer is drawn by its own ``torch.Generator`` on the
device, seeded from (seed, leaf, layer), straight in the type it is served
in: so the harness draws the whole tree in one pass and the reference
draws any one leaf again, alone and identically, when it needs it. The
scales are the port's (normal with ``1/sqrt(fan_in)``, ``fan_in`` the
product of all but the last axis; 0.02 for the embedding table; norms
one). Imports nothing of the port.
"""
from __future__ import annotations

import hashlib
import math

import torch


def dims(m: dict) -> dict:
    """The sizes of a configuration's ``model`` section."""
    d, H, Hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    D = m.get("head_dim") or d // H
    return dict(d=d, H=H, Hkv=Hkv, D=D, f=m["d_ff"],
                V=m["vocab_size"], Vp=((m["vocab_size"] + 255) // 256) * 256,
                n=m["num_layers"])


def layer_leaves(m: dict) -> dict:
    """{path: (shape, scale)} of one layer; scale None means ones."""
    z = dims(m)
    d, H, Hkv, D, f = z["d"], z["H"], z["Hkv"], z["D"], z["f"]
    if m["family"] != "dense":
        raise ValueError(f"no weights for family {m['family']!r}")
    return {
        "ln_attn": ((d,), None),
        "attn.wq": ((d, H, D), 1 / math.sqrt(d * H)),
        "attn.wk": ((d, Hkv, D), 1 / math.sqrt(d * Hkv)),
        "attn.wv": ((d, Hkv, D), 1 / math.sqrt(d * Hkv)),
        "attn.wo": ((H, D, d), 1 / math.sqrt(H * D)),
        "ln_mlp": ((d,), None),
        "mlp.w_in": ((d, f), 1 / math.sqrt(d)),
        "mlp.w_gate": ((d, f), 1 / math.sqrt(d)),
        "mlp.w_out": ((f, d), 1 / math.sqrt(f)),
    }


def top_leaves(m: dict) -> dict:
    z = dims(m)
    return {"embed.table": ((z["Vp"], z["d"]), 0.02),
            "embed.head": ((z["d"], z["Vp"]), 1 / math.sqrt(z["d"])),
            "final_norm": ((z["d"],), None)}


def _leaf_seed(seed: int, path: str, layer: int) -> int:
    h = hashlib.blake2b(f"{int(seed)}/{path}/{layer}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") & (2**63 - 1)


def leaf(m: dict, seed: int, path: str, layer: int = -1, *,
         device) -> torch.Tensor:
    """One leaf (of layer ``layer``; -1 for the top-level leaves), drawn
    anew in the configuration's parameter type."""
    shape, scale = (top_leaves(m) if layer < 0 else layer_leaves(m))[path]
    out = torch.empty(shape, dtype=getattr(torch, m["param_dtype"]),
                      device=device)
    if scale is None:
        return out.fill_(1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(_leaf_seed(seed, path, layer))
    return out.normal_(0.0, scale, generator=gen)


def _put(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def params(m: dict, seed: int, device) -> dict:
    """The whole parameter tree in the port's layout: ``embed``,
    ``final_norm`` and ``stack.blk0`` with a leading layers axis."""
    tree: dict = {}
    for path in top_leaves(m):
        _put(tree, path, leaf(m, seed, path, device=device))
    n = m["num_layers"]
    dt = getattr(torch, m["param_dtype"])
    blk: dict = {}
    for path, (shape, _) in layer_leaves(m).items():
        stacked = torch.empty((n, *shape), dtype=dt, device=device)
        for li in range(n):
            stacked[li].copy_(leaf(m, seed, path, li, device=device))
        _put(blk, path, stacked)
    tree["stack"] = {"blk0": blk}
    return tree
