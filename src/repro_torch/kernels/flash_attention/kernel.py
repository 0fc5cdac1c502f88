"""Blockwise flash attention: the Hopper kernels' wrappers (the forward,
K5, and its backward, K5-bwd) and their plain PyTorch versions.

Port of ``repro.kernels.flash_attention`` (``_flash_kernel`` /
``flash_attention_pallas``) and of the backward of the reference's
``flash_xla`` (``repro.models.attention``: ``_flash_fwd_impl``, which also
returns each row's log-sum-exp, ``_flash_bwd_impl`` and the
``jax.custom_vjp`` around them). ``flash_attention`` (serving) and
``flash_attention_fwd`` (the forward with its lse) launch the CUDA kernel
in ``csrc/flash_attention.cu``, ``flash_attention_bwd`` its backward, for
CUDA tensors; for CPU tensors they use the plain versions — the only case
in which they do. On a CUDA tensor each launches its kernel or raises;
under ``FakeTensorMode`` or on meta tensors each returns outputs of the
right shape and launches nothing (the dry run). ``flash_attention_grad``
is the differentiable entry (``FlashAttentionFn``), which train mode
takes; the forward-only ``flash_attention`` refuses a tensor that
requires grad.

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
            vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci,
            cf, vp]
        lib.k5_flash_attention_fwd.restype = ci
        lib.k5_flash_attention_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
            ci, ci, ci, cf, ci, cf, vp]
        lib.k5_flash_attention_bwd.restype = ci
        lib.k5_flash_attention_bwd_scratch.argtypes = [ci] * 7
        lib.k5_flash_attention_bwd_scratch.restype = ctypes.c_longlong
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


# ---------------------------------------------------------------------------
# Plain versions of the training pair (the reference's flash_xla schedule)
# ---------------------------------------------------------------------------

def _blocks(S: int, Skv: int, causal: bool, window: int, block: int):
    """The reference's schedule (``flash_xla`` with block_q = block_kv =
    ``block``, ``block_pairs``): for each query block its rows [r0, r1)
    and the key range [c0, c1) of its valid kv blocks, on keys padded to a
    whole number of kv blocks. Yields (r0, r1, c0, c1)."""
    bq, bk = min(block, S), min(block, Skv)
    n_kv = -(-Skv // bk)
    wb = max(1, math.ceil(window / bk)) if window > 0 else None
    for qi in range(-(-S // bq)):
        hi = min(qi, n_kv - 1) if causal else n_kv - 1
        lo = 0 if wb is None else max(0, qi - wb)
        yield qi * bq, min((qi + 1) * bq, S), lo * bk, (hi + 1) * bk


def _padded_kv(t, block: int):
    """k or v in f32 with zero keys up to a whole number of kv blocks."""
    Skv = t.shape[1]
    bk = min(block, Skv)
    pad = -Skv % bk
    t = t.float()
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def _pair_scores(qb, kb, r0: int, c0: int, causal: bool, window: int,
                 softcap: float, real_len: int, scale: float):
    """A query block against a key range: (s masked at -1e30, z, mask);
    qb (B, nq, Hkv, G, D), kb (B, nk, Hkv, D) f32; scores (B, Hkv, G, nq,
    nk)."""
    z = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
    s = torch.tanh(z / softcap) * softcap if softcap > 0 else z
    qpos = torch.arange(r0, r0 + qb.shape[1], device=qb.device)[:, None]
    kpos = torch.arange(c0, c0 + kb.shape[1], device=qb.device)[None, :]
    mask = kpos < real_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), z, mask


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, attn_softcap: float = 0.0,
                              seq_len: Optional[int] = None,
                              block: int = 512):
    """Plain PyTorch version of the forward with its log-sum-exp (the
    reference's ``_flash_fwd_impl``): (out (B,S,Hq,D) in q's dtype, lse
    (B,Hq,S) f32), one query block of ``block`` rows at a time against its
    valid kv blocks, so memory is O(S · block). A row with no live key
    keeps the reference's values: lse = -1e30 and the mean of v over the
    keys of its blocks (padding keys included)."""
    _check_lengths(q, k, causal, window)
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    real_len = Skv if seq_len is None else seq_len
    scale = 1.0 / math.sqrt(D)
    kp, vp = _padded_kv(k, block), _padded_kv(v, block)
    outs, lses = [], []
    for r0, r1, c0, c1 in _blocks(S, Skv, causal, window, block):
        qb = q[:, r0:r1].float().reshape(B, r1 - r0, Hkv, G, D)
        s, _, _ = _pair_scores(qb, kp[:, c0:c1], r0, c0, causal, window,
                               attn_softcap, real_len, scale)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vp[:, c0:c1])
        outs.append((o / l.permute(0, 3, 1, 2)[..., None]).reshape(
            B, r1 - r0, Hq, D))
        lses.append((m + torch.log(l)).reshape(B, Hq, r1 - r0))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=2)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, attn_softcap: float = 0.0,
                              seq_len: Optional[int] = None,
                              block: int = 512):
    """Plain PyTorch version of the backward (the reference's
    ``_flash_bwd_impl``), over the same query blocks: p recomputed from
    lse, delta = rowsum(dout · out), dS = p (dP - delta) with the
    softcap's chain rule, the masks and the scale; the G query heads of a
    kv head summed into its dk and dv. Returns (dq, dk, dv) in the inputs'
    dtypes; every sum in f32. p is 0 on every masked key, so a row with no
    live key gives no gradient; there the reference's p = exp(-1e30 -
    lse) is 1 (its lse is -1e30 too) and its dv takes that row's dout at
    every key of the blocks it visits, a value of its block schedule."""
    _check_lengths(q, k, causal, window)
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    real_len = Skv if seq_len is None else seq_len
    scale = 1.0 / math.sqrt(D)
    kp, vp = _padded_kv(k, block), _padded_kv(v, block)
    delta = (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1)
    dq = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros(kp.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vp.shape, dtype=torch.float32, device=q.device)
    for r0, r1, c0, c1 in _blocks(S, Skv, causal, window, block):
        n = r1 - r0
        qb = q[:, r0:r1].float().reshape(B, n, Hkv, G, D)
        do = dout[:, r0:r1].float().reshape(B, n, Hkv, G, D)
        kb, vb = kp[:, c0:c1], vp[:, c0:c1]
        s, z, mask = _pair_scores(qb, kb, r0, c0, causal, window,
                                  attn_softcap, real_len, scale)
        p = torch.exp(s - lse[:, :, r0:r1].reshape(B, Hkv, G, n)[..., None])
        p = torch.where(mask, p, torch.zeros_like(p))
        dv[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", p, do)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vb)
        ds = p * (dp - delta[:, :, r0:r1].reshape(B, Hkv, G, n)[..., None])
        if attn_softcap > 0:
            ds = ds * (1.0 - torch.square(torch.tanh(z / attn_softcap)))
        ds = torch.where(mask, ds, torch.zeros_like(ds)) * scale
        dq[:, r0:r1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb).reshape(
            B, n, Hq, D)
        dk[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
    return (dq.to(q.dtype), dk[:, :Skv].to(k.dtype),
            dv[:, :Skv].to(v.dtype))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

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


# the backward's five products (S and dP recomputed, dV, dQ, dK) against
# the forward's two
BWD_OPS_PER_FWD = 2.5


def _kv_len(k, seq_len) -> int:
    Skv = k.shape[1]
    return Skv if seq_len is None else max(0, min(int(seq_len), Skv))


def _launch_fwd(q, k, v, causal, window, attn_softcap, seq_len, lse):
    """K5 on CUDA tensors into a new output (and ``lse`` (B,Hq,S) f32 when
    given); counts the launch on ``flash_attention.launches``."""
    _check(q, k, v)
    _check_lengths(q, k, causal, window)
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
    out = torch.empty_like(q)
    lib = library()
    err = lib.k5_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, Skv, Hq, k.shape[2],
        D, int(q.dtype == torch.bfloat16), int(bool(causal)),
        int(window or 0), float(attn_softcap or 0.0), _kv_len(k, seq_len),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.k5_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0,
                    seq_len: Optional[int] = None):
    """q: (B,S,Hq,D); k,v: (B,Skv,Hkv,D) -> (B,S,Hq,D); Skv != S only
    without a causal mask or a window. CUDA tensors launch the Hopper kernel
    on the current stream (no synchronization); CPU tensors take the plain
    version. ``flash_attention.launches`` counts kernel launches (those of
    ``flash_attention_fwd`` too). Its output carries no gradient: it
    refuses an input that requires grad (train through
    ``flash_attention_grad``)."""
    refuse_grad("flash_attention", q, k, v)
    if shape_only(q, k, v):
        out = torch.empty_like(q)
        tally("K5", _ops(q, k, causal, window), (q, k, v), (out,))
        return out
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     attn_softcap=attn_softcap,
                                     seq_len=seq_len)
    return _launch_fwd(q, k, v, causal, window, attn_softcap, seq_len, None)


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        attn_softcap: float = 0.0,
                        seq_len: Optional[int] = None, block: int = 512):
    """The training forward: (out (B,S,Hq,D), lse (B,Hq,S) f32). CUDA
    tensors launch K5 with its lse output (counted on
    ``flash_attention.launches``); CPU tensors take
    ``flash_attention_lse_plain`` over query blocks of ``block``."""
    B, S, Hq, _ = q.shape
    if shape_only(q, k, v):
        out = torch.empty_like(q)
        lse = q.new_empty((B, Hq, S), dtype=torch.float32)
        tally("K5", _ops(q, k, causal, window), (q, k, v), (out, lse))
        return out, lse
    if q.device.type == "cpu":
        return flash_attention_lse_plain(
            q, k, v, causal=causal, window=window, attn_softcap=attn_softcap,
            seq_len=seq_len, block=block)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, causal, window, attn_softcap, seq_len, lse)
    return out, lse


def _check_bwd(q, k, v, out, lse, dout) -> None:
    _check(q, k, v)
    B, S, Hq, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError(f"lse must be (B,Hq,S) = {(B, Hq, S)} float32 on "
                         f"q's device, got {tuple(lse.shape)} {lse.dtype}")
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, attn_softcap: float = 0.0,
                        seq_len: Optional[int] = None, block: int = 512):
    """The backward of ``flash_attention_fwd``: (dq, dk, dv) in the inputs'
    dtypes from q, k, v, its out and lse and the output's gradient dout.
    CUDA tensors launch K5-bwd (on the current stream, one count on
    ``flash_attention_bwd.launches``: bf16 runs its wgmma kernels, prep,
    dk/dv, dq and, where Hq != Hkv or dq's keys are split, one
    fixed-order sum of their f32 partials; f32 its FFMA kernels, delta,
    dk/dv, dq); CPU tensors take ``flash_attention_bwd_plain`` over query
    blocks of ``block``."""
    if shape_only(q, k, v, out, lse, dout):
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
        tally("K5-bwd", BWD_OPS_PER_FWD * _ops(q, k, causal, window),
              (q, k, v, out, lse, dout), grads)
        return grads
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal=causal, window=window,
            attn_softcap=attn_softcap, seq_len=seq_len, block=block)
    _check_bwd(q, k, v, out, lse, dout)
    _check_lengths(q, k, causal, window)
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    is_bf16 = int(q.dtype == torch.bfloat16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = library()
    # delta (and for bf16 lse·log2(e) and the GQA partials): the kernel's
    # own count of floats
    scratch = torch.empty(
        lib.k5_flash_attention_bwd_scratch(B, S, Skv, Hq, Hkv, D, is_bf16),
        dtype=torch.float32, device=q.device)
    err = lib.k5_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, Skv, Hq, Hkv, D,
        is_bf16, int(bool(causal)), int(window or 0),
        float(attn_softcap or 0.0), _kv_len(k, seq_len), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"{lib.k5_error_string(err).decode()}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# The differentiable entry
# ---------------------------------------------------------------------------

class FlashAttentionFn(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP: the forward saves only
    q, k, v, out and lse (no score or probability matrix); the backward
    recomputes p from lse. CUDA tensors go through K5 and K5-bwd, CPU
    tensors (or ``plain``) through the plain versions. Every output is a
    new tensor, so a recomputation under activation checkpointing (either
    ``remat_wrap`` policy) runs the forward again into fresh memory."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, attn_softcap, seq_len, block,
                plain):
        kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
                  seq_len=seq_len, block=block)
        fwd = flash_attention_lse_plain if plain else flash_attention_fwd
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_grad(q, k, v, *, causal: bool = True, window: int = 0,
                         attn_softcap: float = 0.0,
                         seq_len: Optional[int] = None, block: int = 512,
                         plain: bool = False):
    """Differentiable attention (``flash_xla``'s function and its custom
    VJP): q: (B,S,Hq,D); k,v: (B,Skv,Hkv,D) -> (B,S,Hq,D), gradients for
    q, k and v. ``block`` is the plain versions' query and kv block (the
    reference's ``attn_chunk``); ``plain`` takes them on any device. A
    row with no live key (a window past ``seq_len``) gives no gradient,
    where the reference's dv takes its dout (``flash_attention_bwd_plain``)."""
    return FlashAttentionFn.apply(q, k, v, bool(causal), int(window or 0),
                                  float(attn_softcap or 0.0), seq_len,
                                  int(block), bool(plain))
