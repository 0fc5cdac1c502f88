"""Blockwise flash attention (prefill): the Hopper kernel's wrapper and its
plain PyTorch version.

Port of ``repro.kernels.flash_attention`` (``_flash_kernel`` /
``flash_attention_pallas``). ``flash_attention`` launches the CUDA kernel
in ``csrc/flash_attention.cu`` for CUDA tensors and uses
``flash_attention_plain`` for CPU tensors — the only case in which it does.
On a CUDA tensor it launches the kernel or raises; under ``FakeTensorMode``
or on meta tensors it returns an output of the right shape and launches
nothing (the dry run).

The query and key lengths may differ (whisper's cross-attention: a prompt
against 1500 encoder frames) where there is neither a causal mask nor a
window: that is ``repro.models.attention.flash_xla``'s function. (The
reference's Pallas kernel takes its key blocks from q's length, so there it
reads only the first Sq keys.)
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad, shape_only, tally

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 112, 128, 256)
NEG_INF = -1e30

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k5_flash_attention_fwd.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci, cf,
            vp]
        lib.k5_flash_attention_fwd.restype = ci
        lib.k5_error_string.argtypes = [ci]
        lib.k5_error_string.restype = ctypes.c_char_p
        lib.k5_request_smem.argtypes = [ci]
        lib.k5_request_smem.restype = None
        _lib = lib
    return _lib


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          attn_softcap: float = 0.0,
                          seq_len: Optional[int] = None):
    """Plain PyTorch version: full f32 scores, masked at -1e30, softmax.
    q: (B,S,Hq,D); k,v: (B,Skv,Hkv,D) -> (B,S,Hq,D) in q's dtype; Skv may
    differ from S only without a causal mask or a window."""
    _check_lengths(q, k, causal, window)
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
    G = Hq // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2) if G > 1 else k.float()
    vf = v.float().repeat_interleave(G, dim=2) if G > 1 else v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(D)
    if attn_softcap > 0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    if seq_len is not None:
        mask &= kpos < seq_len
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check_lengths(q, k, causal: bool, window: int) -> None:
    """Unequal query and key lengths only without a causal mask or a
    window (``flash_xla`` asserts the first; the kernel's window masks
    count query and key positions from one origin)."""
    if q.shape[1] != k.shape[1] and (causal or window):
        raise ValueError(f"q length {q.shape[1]} != k/v length {k.shape[1]}: "
                         f"only non-causal attention without a window takes "
                         f"unequal lengths")


def _check(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,Hq,D) and k, v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ops(q, k, causal: bool, window: int) -> float:
    """Q·Kᵀ and P·V over the (query, key) pairs the masks leave: 4 B Hq D
    pairs."""
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
    if not causal:
        pairs = S * Skv
    elif window and window < S:
        pairs = window * (window + 1) // 2 + (S - window) * window
    else:
        pairs = S * (S + 1) // 2
    return 4.0 * B * Hq * D * pairs


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0,
                    seq_len: Optional[int] = None):
    """q: (B,S,Hq,D); k,v: (B,Skv,Hkv,D) -> (B,S,Hq,D); Skv != S only
    without a causal mask or a window. CUDA tensors launch the Hopper kernel
    on the current stream (no synchronization); CPU tensors take the plain
    version. ``flash_attention.launches`` counts kernel launches."""
    refuse_grad("flash_attention", q, k, v)
    if shape_only(q, k, v):
        out = torch.empty_like(q)
        tally("K5", _ops(q, k, causal, window), (q, k, v), (out,))
        return out
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     attn_softcap=attn_softcap,
                                     seq_len=seq_len)
    _check(q, k, v)
    _check_lengths(q, k, causal, window)
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
    kv_len = Skv if seq_len is None else max(0, min(int(seq_len), Skv))
    out = torch.empty_like(q)
    lib = library()
    err = lib.k5_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Skv,
        Hq, k.shape[2], D, int(q.dtype == torch.bfloat16), int(bool(causal)),
        int(window or 0), float(attn_softcap or 0.0), kv_len,
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.k5_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
