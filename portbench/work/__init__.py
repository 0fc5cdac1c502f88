"""The work that a step's inputs need, counted from shapes and the
traffic: floating-point operations and bytes moved, for the decode step,
the prefill, K4 (decode attention) and K5 (prefill attention) of a dense
decoder.

Counting rules, whatever implements the step:

* every weight a step uses is read once, every parameter element 2 bytes
  (bf16);
* keys and values are read and written at the valid lengths only, 2 bytes
  an element;
* a matrix product of (m, k) by (k, n) is 2 m k n operations; attention
  is 4 operations a (query, key, head dim) triple (scores and the
  weighted sum), over the keys a causal query sees.

``least_s`` is the least time the card could take: the larger of the
operations over the peak rate and the bytes over the peak bandwidth. A
share of it over a measured time cannot pass 100% unless the operations
or bytes are counted too high or the time leaves part of the work out.
Imports nothing of the port.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

B = 2          # bytes of a bf16 element

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.flops + o.flops, self.bytes + o.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


def peak(device_kind: str) -> dict:
    """``{"flops": ..., "bytes_s": ...}`` of a card by its name."""
    if device_kind not in PEAKS:
        raise KeyError(f"no peaks for {device_kind!r}; have {sorted(PEAKS)}")
    p = PEAKS[device_kind]
    return {"flops": p["bf16_dense_flops"], "bytes_s": p["hbm_bytes_s"]}


def least_s(w: Work, pk: dict) -> float:
    return max(w.flops / pk["flops"], w.bytes / pk["bytes_s"])


def _dims(m: dict):
    d, H, Hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    D = m.get("head_dim") or d // H
    return d, H, Hkv, D, m["d_ff"], m["vocab_size"]


def matmul(mm: int, k: int, n: int, weight_bytes: bool = True) -> Work:
    """(mm, k) @ (k, n) with the (k, n) operand a weight read once."""
    return Work(2.0 * mm * k * n, (k * n * B) if weight_bytes else 0.0)


def attn_proj(m: dict, tokens: int) -> Work:
    """q, k, v and output projections of one layer for ``tokens``."""
    d, H, Hkv, D, _, _ = _dims(m)
    w = matmul(tokens, d, H * D) + matmul(tokens, d, 2 * Hkv * D) \
        + matmul(tokens, H * D, d)
    return w + Work(0.0, tokens * (2 * d) * B)   # the layer's input, output


def k5(m: dict, L: int) -> Work:
    """Causal prefill attention of one layer over ``L`` tokens (K5)."""
    _, H, Hkv, D, _, _ = _dims(m)
    pairs = L * (L + 1) / 2                      # (query, key) a causal row
    return Work(4.0 * H * D * pairs,
                L * (2 * H * D + 2 * Hkv * D) * B)   # q, o; k, v


def k4(m: dict, valid: list) -> Work:
    """Decode attention of one layer: one query a row against ``valid``
    keys of that row (the new one included) (K4)."""
    _, H, Hkv, D, _, _ = _dims(m)
    keys = float(sum(valid))
    return Work(4.0 * H * D * keys,
                keys * 2 * Hkv * D * B + len(valid) * 2 * H * D * B)


def kv_write(m: dict, tokens: int) -> Work:
    _, _, Hkv, D, _, _ = _dims(m)
    return Work(0.0, tokens * 2 * Hkv * D * B)


def ffn(m: dict, tokens: int) -> Work:
    """The gated MLP of one layer."""
    d, _, _, _, f, _ = _dims(m)
    return matmul(tokens, d, f) * 3


def unembed(m: dict, rows: int) -> Work:
    d, _, _, _, _, V = _dims(m)
    return matmul(rows, d, V) + Work(0.0, rows * V * 4)   # f32 logits


def prefill(m: dict, L: int) -> Work:
    """One host prefill of an ``L``-token prompt: every layer, the
    unembedding of the last position."""
    per_layer = attn_proj(m, L) + k5(m, L) + kv_write(m, L) + ffn(m, L)
    d = m["d_model"]
    return per_layer * m["num_layers"] + unembed(m, 1) + Work(0, L * d * B)


def decode_step(m: dict, valid: list) -> Work:
    """One decode step over the rows whose valid lengths (the new key
    included) are ``valid``: the weights once, each row's keys and values
    at its length."""
    n = len(valid)
    per_layer = attn_proj(m, n) + k4(m, valid) + kv_write(m, n) + ffn(m, n)
    d = m["d_model"]
    return per_layer * m["num_layers"] + unembed(m, n) + Work(0, n * d * B)
