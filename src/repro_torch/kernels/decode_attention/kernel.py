"""Flash-decoding (one new token vs a KV cache): the Hopper kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.decode_attention`` (``_decode_kernel`` /
``decode_attention_pallas``). ``decode_attention`` launches the CUDA
kernels in ``csrc/decode_attention.cu`` (split partials + merge) for CUDA
tensors and uses ``decode_attention_plain`` for CPU tensors — the only
case in which it does. On a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16        # query heads per kv head the kernel serves (one warp each)
KEY_TILE = 64         # keys per shared-memory tile; splits are multiples
TARGET_CTAS = 264     # two CTAs per SM of the H100's 132
NEG_INF = -1e30

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k4_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
            cf, ci, cf, vp]
        lib.k4_decode_attention.restype = ci
        lib.k4_error_string.argtypes = [ci]
        lib.k4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_attention_plain(q, k_cache, v_cache, valid_len, *,
                           attn_softcap: float = 0.0, window: int = 0):
    """Plain PyTorch version: full f32 scores over the cache, positions
    outside [valid_len - window, valid_len) masked at -1e30, softmax.
    q: (B,1,Hq,D); caches: (B,S,Hkv,D); valid_len: (B,) -> (B,1,Hq,D)."""
    B, S, Hkv, D = k_cache.shape
    G = q.shape[2] // Hkv
    kf = k_cache.float()
    vf = v_cache.float()
    if G > 1:
        kf = kf.repeat_interleave(G, dim=2)
        vf = vf.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(D)
    if attn_softcap > 0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    pos = torch.arange(S, device=q.device)[None, :]
    vl = valid_len.to(q.device)[:, None]
    mask = pos < vl
    if window > 0:
        mask &= pos >= (vl - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def split_plan(B: int, S: int, Hkv: int) -> tuple[int, int]:
    """(n_split, split_len): split the cache so B*Hkv*n_split CTAs come
    near ``TARGET_CTAS``, each split a whole number of key tiles."""
    tiles = -(-S // KEY_TILE)
    n_split = max(1, min(tiles, -(-TARGET_CTAS // (B * Hkv))))
    split_len = -(-tiles // n_split) * KEY_TILE
    return -(-S // split_len), split_len


def _check(q, k, v, valid_len) -> None:
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev
            and valid_len.device == dev):
        raise ValueError("q, caches and valid_len must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/caches "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if valid_len.dtype != torch.int32:
        raise TypeError(f"valid_len must be int32, got {valid_len.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,1,Hq,D) and caches (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hkv, D = k.shape
    if q.shape[0] != B or q.shape[1] != 1 or q.shape[3] != D or \
            tuple(valid_len.shape) != (B,):
        raise ValueError(f"q {tuple(q.shape)} / valid_len "
                         f"{tuple(valid_len.shape)} do not match caches "
                         f"{tuple(k.shape)}")
    Hq = q.shape[2]
    if Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"Hq/Hkv = {Hq}/{Hkv} must be an integer in "
                         f"[1, {MAX_GROUP}]")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (have {HEAD_DIMS})")
    for name, t in (("q", q), ("k_cache", k), ("v_cache", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not valid_len.is_contiguous():
        raise ValueError("valid_len must be contiguous")


def decode_attention(q, k_cache, v_cache, valid_len, *,
                     attn_softcap: float = 0.0, window: int = 0):
    """q: (B,1,Hq,D); caches: (B,S,Hkv,D); valid_len: (B,) int32, >= 1 ->
    (B,1,Hq,D). CUDA tensors launch the Hopper kernels on the current
    stream (no synchronization); CPU tensors take the plain version.
    ``decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid_len,
                                      attn_softcap=attn_softcap,
                                      window=window)
    _check(q, k_cache, v_cache, valid_len)
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    n_split, split_len = split_plan(B, S, Hkv)
    # scratch for the split partials; freeing it at return is safe while
    # the kernels still run: the caching allocator hands the memory only to
    # work ordered after them on this stream
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, Hq, n_split), **f32)
    part_l = torch.empty((B, Hq, n_split), **f32)
    part_acc = torch.empty((B, Hq, n_split, D), **f32)
    out = torch.empty_like(q)
    lib = library()
    err = lib.k4_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid_len.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D,
        int(q.dtype == torch.bfloat16), n_split, split_len,
        float(attn_softcap or 0.0), int(window or 0), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = {-1: "unsupported head dim", -2: "unsupported group size"}.get(
            err) or lib.k4_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
