"""Plain float32 reference of the served decoder stack (dense, SwiGLU).

Per layer, as published (Llama-style pre-norm blocks, as mistral-nemo
has them): RMSNorm; q, k, v projections; rotary embedding of q and k (the
halves rotated, angles in float64); causal softmax attention at
1/sqrt(head_dim), grouped query heads, scores capped by
``cap * tanh(s / cap)`` where the configuration states a cap; the output
projection and the residual; RMSNorm; the feed-forward
``(silu(h W_gate) * h W_in) W_out`` and the residual. After the last
layer RMSNorm and the untied head, the logits capped the same way.

``precision="fp8"`` is the control: each matrix product's operands rounded
to float8 e4m3 with a scale a tensor, the rest as above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench import weights as W

FP8_MAX = 448.0
NEG = -1e30
BLOCK = 1024        # queries a block of causal attention


def strict_f32() -> None:
    """Float32 products in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap and cap > 0 else x


def rope(x, pos, theta):
    """x: (S, h, D) rotated at integer positions ``pos`` (S,)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    """The reference of one configuration file with weights from
    ``seed``, on ``device``, in ``precision`` ("f32" or the control's
    "fp8")."""

    def __init__(self, config: dict, seed: int, device, *,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.m = config["model"]
        self.seed = seed
        self.device = torch.device(device)
        self.precision = precision
        z = W.dims(self.m)
        self.d, self.H, self.Hkv, self.D = z["d"], z["H"], z["Hkv"], z["D"]
        self.n, self.V = z["n"], z["V"]
        self.eps = self.m["norm_eps"]
        strict_f32()

    # -- pieces ----------------------------------------------------------
    def w(self, path: str, layer: int = -1) -> torch.Tensor:
        return W.leaf(self.m, self.seed, path, layer,
                      device=self.device).float()

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """A matrix product's operand in the working precision."""
        return fp8_round(x) if self.precision == "fp8" else x

    def mm(self, a, b):
        return self.op(a) @ self.op(b)

    def qkv(self, h, pos, wts):
        S = h.shape[0]
        q = self.mm(h, wts["wq"]).view(S, self.H, self.D)
        k = self.mm(h, wts["wk"]).view(S, self.Hkv, self.D)
        v = self.mm(h, wts["wv"]).view(S, self.Hkv, self.D)
        th = self.m["rope_theta"]
        return rope(q, pos, th), rope(k, pos, th), v

    def attn_weights(self, li):
        d, H, Hkv, D = self.d, self.H, self.Hkv, self.D
        return {"ln": self.w("ln_attn", li),
                "wq": self.w("attn.wq", li).reshape(d, H * D),
                "wk": self.w("attn.wk", li).reshape(d, Hkv * D),
                "wv": self.w("attn.wv", li).reshape(d, Hkv * D),
                "wo": self.w("attn.wo", li).reshape(H * D, d)}

    def scores_softmax_v(self, q, k, v, mask):
        """q (H, S, D) against k, v (H, T, D) with mask (S, T) or
        (H?, S, T) broadcastable; returns (S, H, D)."""
        s = self.op(q) @ self.op(k).transpose(-1, -2) / math.sqrt(self.D)
        s = softcap(s, self.m.get("attn_softcap", 0.0))
        s = torch.where(mask, s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1)
        return (self.op(p) @ self.op(v)).transpose(0, 1)

    def causal(self, q, k, v):
        """Causal attention of one sequence: q (S, H, D), k, v (S, Hkv, D),
        in blocks of queries."""
        S = q.shape[0]
        G = self.H // self.Hkv
        kf = k.repeat_interleave(G, dim=1).transpose(0, 1)    # (H, S, D)
        vf = v.repeat_interleave(G, dim=1).transpose(0, 1)
        qt = q.transpose(0, 1)
        out = torch.empty_like(q)
        for a in range(0, S, BLOCK):
            b = min(S, a + BLOCK)
            qp = torch.arange(a, b, device=q.device)[:, None]
            kp = torch.arange(0, b, device=q.device)[None, :]
            out[a:b] = self.scores_softmax_v(qt[:, a:b], kf[:, :b],
                                             vf[:, :b], kp <= qp)
        return out

    def swiglu(self, h, wi, wg, wo):
        return self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wi), wo)

    def ffn(self, hs: torch.Tensor, li: int) -> torch.Tensor:
        """The feed-forward of layer ``li`` over the rows ``hs`` (T, d)."""
        return self.swiglu(hs, self.w("mlp.w_in", li),
                           self.w("mlp.w_gate", li), self.w("mlp.w_out", li))

    def head(self, x):
        h = rms(x, self.w("final_norm"), self.eps)
        return softcap(self.mm(h, self.w("embed.head")[:, :self.V]),
                       self.m.get("logit_softcap", 0.0))

    # -- the whole pass ---------------------------------------------------
    def forward(self, seqs: list, want: list, kv: bool = False) -> dict:
        """Causal forward over each token sequence in ``seqs`` (1-D long
        tensors). Returns ``logits`` (a (len(want[i]), V) tensor a
        sequence, at the positions ``want[i]``) and with ``kv`` the keys
        and values a layer and sequence ((S, Hkv, D) each)."""
        dev = self.device
        seqs = [s.to(dev).long() for s in seqs]
        lens = [int(s.shape[0]) for s in seqs]
        offs = [0]
        for L in lens:
            offs.append(offs[-1] + L)
        table = self.w("embed.table")
        x = torch.cat([table[s] for s in seqs])               # (T, d)
        del table
        kvs = [[] for _ in seqs]
        for li in range(self.n):
            aw = self.attn_weights(li)
            att = torch.empty_like(x)
            for i, L in enumerate(lens):
                a, b = offs[i], offs[i + 1]
                h = rms(x[a:b], aw["ln"], self.eps)
                q, k, v = self.qkv(h, torch.arange(L, device=dev), aw)
                if kv:
                    kvs[i].append((k, v))
                o = self.causal(q, k, v).reshape(L, self.H * self.D)
                att[a:b] = self.mm(o, aw["wo"])
            x = x + att
            del aw, att
            x = x + self.ffn(rms(x, self.w("ln_mlp", li), self.eps), li)
        rows = [offs[i] + torch.as_tensor(pos, dtype=torch.long, device=dev)
                for i, pos in enumerate(want)]
        logits = self.head(x[torch.cat(rows)]).split(
            [len(r) for r in rows])
        out = {"logits": list(logits)}
        if kv:
            out["kv"] = kvs
        return out


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's logit lies below its row's best."""
    t = torch.as_tensor(tokens, dtype=torch.long, device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative error a row (all but the first axis flattened)."""
    g = got.float().reshape(got.shape[0], -1)
    w = want.float().reshape(want.shape[0], -1)
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-30)
