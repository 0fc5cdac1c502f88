"""Flash-decoding (one new token vs a KV cache): the Hopper kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.decode_attention`` (``_decode_kernel`` /
``decode_attention_pallas``). ``decode_attention`` launches the CUDA kernel
in ``csrc/decode_attention.cu`` for CUDA tensors — one launch a call:
``split_count`` CTAs a (sequence, kv head), each over the key range of the
live keys it derives from ``valid_len`` on the device (bf16 on the tensor
cores at every head dim, f32 in FFMA), merged through distributed shared
memory within one cluster or, past one cluster (bf16 at D = 256:
gemma2-2b's decode at a long cache), by the last CTA to arrive over the
splits' partials in scratch — and uses
``decode_attention_plain`` for CPU tensors, the only case in which it does.
On a CUDA tensor it launches the kernel or raises; under ``FakeTensorMode``
or on meta tensors it returns an output of the right shape and launches
nothing (the dry run).

``decode_attention_partial`` is the kernel's shard mode, the body of
``models.attention.decode_attention_sharded`` on a mesh whose cache is
sharded on its sequence: the caches hold positions [off, off + S_loc) of a
cache of ``seq_len``, and the kernel returns the shard's normalized output
and its log-sum-exp (f32, (B, Hq)); an empty shard gives 0 and -inf.
``merge_decode_partials`` joins the shards' partials, over a list or over
the mesh's all_reduce; ``decode_attention_partial_plain`` is the plain
version, the reference's shard_map body.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad, shape_only, tally

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (32, 64, 112, 128, 256)
MAX_GROUP = 16        # query heads per kv head the kernel serves (one m16 tile)
MAX_CLUSTER = 8       # CTAs a cluster: the portable limit
MAX_SPLITS = 128      # CTAs a (sequence, kv head), at most
SPLIT_MIN_KEYS = 64   # cache positions a split, at least
TARGET_CTAS = 264     # two CTAs per SM of the H100's 132
WIDE_TARGET_CTAS = 132   # bf16 at D = 256: one CTA an SM (~140 KB each)
# bf16 at D = 256: CTAs the card placed at once in clusters of 4 or 8, at
# one CTA an SM (scripts/exec_decode_turns.py's smid and timeline)
CLUSTER_WAVE_CTAS = 120
NEG_INF = -1e30

_lib: Optional[ctypes.CDLL] = None
# arrival counters of launches with more splits than one cluster holds,
# by (device, stream); replaced ones are kept, since a captured CUDA graph
# holds their address
_counters: dict = {}
_retired: list = []


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k4_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf,
            ci, cf, vp]
        lib.k4_decode_attention.restype = ci
        lib.k4_decode_attention_shard.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
            cf, ci, cf, ci, ci, vp]
        lib.k4_decode_attention_shard.restype = ci
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


def split_count(B: int, S: int, Hkv: int, window: int = 0, D: int = 128,
                bf16: bool = True) -> int:
    """Splits (CTAs) a (sequence, kv head), no more than the live keys a
    sequence can have (S, or the window when it is shorter) give
    ``SPLIT_MIN_KEYS`` each. bf16 at D = 256 (one CTA an SM): as many as
    keep the B*Hkv pairs' CTAs within ``WIDE_TARGET_CTAS`` (one wave),
    even past one cluster, at most ``MAX_SPLITS``. Else enough that the
    pairs come near ``TARGET_CTAS``, at most one cluster of
    ``MAX_CLUSTER``."""
    live = min(S, window) if window > 0 else S
    by_keys = -(-live // SPLIT_MIN_KEYS)
    if bf16 and D == 256:
        return max(1, min(by_keys, WIDE_TARGET_CTAS // (B * Hkv),
                          MAX_SPLITS))
    return max(1, min(MAX_CLUSTER, -(-TARGET_CTAS // (B * Hkv)), by_keys))


def cluster_size(n_split: int, B: int = 1, Hkv: int = 1, D: int = 128,
                 bf16: bool = True) -> int:
    """CTAs a cluster: all ``n_split`` up to ``MAX_CLUSTER`` (merged
    through distributed shared memory), else one (merged through
    scratch by the last CTA to arrive). bf16 at D = 256 also takes
    clusters of one where its B*Hkv*n_split CTAs outnumber
    ``CLUSTER_WAVE_CTAS``: in clusters the rest would wait for a second
    wave."""
    if n_split > MAX_CLUSTER or (bf16 and D == 256 and
                                 B * Hkv * n_split > CLUSTER_WAVE_CTAS):
        return 1
    return n_split


def _arrival_counters(device, stream, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters for launches on ``stream`` of
    ``device``, zero before a launch and left zero by it (the last CTA to
    arrive resets its own). One set a stream, so the launches that share
    them run one at a time, in stream order; a CUDA graph keeps the set
    of the stream it was captured on. A set is made and zeroed eagerly:
    under capture the zeroing would only be recorded, so a stream that
    has none yet (or too few) raises there; one eager call on it first
    makes them."""
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention: no arrival counters for this stream yet; "
                "call it once on the stream before capturing a CUDA graph")
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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
    (B,1,Hq,D). CUDA tensors launch the Hopper kernel on the current
    stream (one launch, no synchronization; f32 scratch for the splits'
    partials only past one cluster a (sequence, kv head)); CPU
    tensors take the plain version. ``decode_attention.launches`` counts
    launches."""
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if shape_only(q, k_cache, v_cache):
        out = torch.empty_like(q)
        tally("K4", _ops(q, k_cache), (q, k_cache, v_cache, valid_len),
              (out,))
        return out
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid_len,
                                      attn_softcap=attn_softcap,
                                      window=window)
    out, _ = _launch("decode_attention", q, k_cache, v_cache, valid_len,
                     attn_softcap, window)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _launch(name, q, k, v, valid_len, attn_softcap, window, shard=None):
    """One launch of K4 on the current stream: over the whole cache, or with
    ``shard = (off, seq_len)`` in its shard mode, which also writes the lse.
    Returns (out, lse or None)."""
    _check(q, k, v, valid_len)
    B, S, Hkv, D = k.shape
    Hq = q.shape[2]
    window = int(window or 0)
    if shard is not None:
        off, seq_len = shard
        if not (0 <= off and off + S <= seq_len):
            raise ValueError(f"shard [{off}, {off + S}) lies outside a "
                             f"cache of {seq_len}")
    bf16 = q.dtype == torch.bfloat16
    n_split = split_count(B, S, Hkv, window, D, bf16)
    cluster = cluster_size(n_split, B, Hkv, D, bf16)
    stream = torch.cuda.current_stream(q.device)
    out = torch.empty_like(q)
    work = (0, 0)                     # scratch and arrival counters
    if n_split > cluster:
        counters = _arrival_counters(q.device, stream, B * Hkv)
        scratch = torch.empty(B * Hkv * n_split * (Hq // Hkv) * (D + 4),
                              dtype=torch.float32, device=q.device)
        work = (scratch.data_ptr(), counters.data_ptr())
    common = (int(bf16), n_split, cluster, float(attn_softcap or 0.0),
              window, 1.0 / math.sqrt(D))
    stream = stream.cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr())
    lse = None
    if shard is None:
        err = library().k4_decode_attention(*ptrs, *work, B, S, Hq, Hkv, D,
                                            *common, stream)
    else:
        lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        err = library().k4_decode_attention_shard(
            *ptrs, lse.data_ptr(), *work, B, S, Hq, Hkv, D, *common,
            int(off), int(seq_len), stream)
    _raise_on(err, name)
    return out, lse


def _ops(q, k_cache) -> float:
    """Q·Kᵀ and P·V over every cache position (the live count is data the
    dry run does not have): 4 B Hq S D."""
    B, S, _, D = k_cache.shape
    return 4.0 * B * q.shape[2] * S * D


_ERRORS = {-1: "unsupported head dim", -2: "unsupported group size",
           -3: "split count or cluster size out of range, or no scratch"}


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _ERRORS.get(err) or library().k4_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


# ---------------------------------------------------------------------------
# Shard mode: one sequence shard's partial, and the merge
# ---------------------------------------------------------------------------

def decode_attention_partial_plain(q, k_shard, v_shard, valid_len, *,
                                   off: int, seq_len: int,
                                   attn_softcap: float = 0.0,
                                   window: int = 0):
    """Plain version of the shard mode, the reference's shard_map body
    (``src/repro/models/attention.py:479-514``) normalized: f32 scores over
    the shard's positions off + [0, S_loc), masked at -inf outside the live
    range [valid - window, valid) (valid = min(valid_len, seq_len)); m the
    max, l the sum of exp(s - m). Returns (o = P·V / l in q's dtype,
    lse = m + log l (B, Hq) f32); a shard without a live key gives 0 and
    -inf."""
    B, S_loc, Hkv, D = k_shard.shape
    G = q.shape[2] // Hkv
    kf = k_shard.float().repeat_interleave(G, dim=2)
    vf = v_shard.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kf) / math.sqrt(D)
    if attn_softcap > 0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    pos = off + torch.arange(S_loc, device=q.device)[None, :]
    vl = valid_len.to(q.device).long().clamp(max=seq_len)[:, None]
    mask = pos < vl
    if window > 0:
        mask &= pos >= (vl - window)
    s = torch.where(mask[:, None, :], s, -math.inf)
    m = s.amax(dim=-1)                                       # (B,Hq)
    live = torch.isfinite(m)
    m_safe = torch.where(live, m, torch.zeros_like(m))
    p = torch.where(mask[:, None, :], torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vf) / l.clamp(min=1e-30)[..., None]
    lse = torch.where(live, m_safe + torch.log(l.clamp(min=1e-30)),
                      torch.full_like(m, -math.inf))
    return o[:, None].to(q.dtype), lse


def merge_decode_partials(o, lse, all_reduce=None):
    """Join shards' partials: M = max of the lse values, corr_i =
    exp(lse_i - M) (0 where lse_i is -inf), out = sum corr_i o_i /
    max(sum corr_i, 1e-30), in f32, cast to o's dtype. Without
    ``all_reduce``, ``o`` and ``lse`` are sequences of the shards' (B,1,Hq,D)
    and (B,Hq) tensors (one card); with it, they are this rank's and
    ``all_reduce(t, op)`` (op "max" or "sum") returns a tensor reduced over
    the mesh's sequence axes."""
    if all_reduce is None:
        o, lse = torch.stack(list(o)), torch.stack(list(lse))

        def all_reduce(t, op):
            return t.amax(dim=0) if op == "max" else t.sum(dim=0)
    m = all_reduce(lse, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    corr = torch.where(torch.isfinite(lse), torch.exp(lse - m),
                       torch.zeros_like(lse))
    num = all_reduce(corr[..., None, :, None] * o.float(), "sum")
    den = all_reduce(corr, "sum")
    return (num / den.clamp(min=1e-30)[..., None, :, None]).to(o.dtype)


def decode_attention_partial(q, k_shard, v_shard, valid_len, *, off: int,
                             seq_len: int, attn_softcap: float = 0.0,
                             window: int = 0):
    """q: (B,1,Hq,D); caches: (B,S_loc,Hkv,D), positions [off, off + S_loc)
    of a cache of ``seq_len``; valid_len: (B,) int32 (0 allowed) -> (o
    (B,1,Hq,D), lse (B,Hq) f32). CUDA tensors launch K4's shard mode (one
    launch; the live range is cut to the shard on the device); CPU tensors
    take the plain version. ``decode_attention_partial.launches`` counts
    launches."""
    refuse_grad("decode_attention_partial", q, k_shard, v_shard)
    if shape_only(q, k_shard, v_shard):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[0], q.shape[2], dtype=torch.float32,
                          device=q.device)
        tally("K4", _ops(q, k_shard), (q, k_shard, v_shard, valid_len),
              (out, lse))
        return out, lse
    if q.device.type == "cpu":
        return decode_attention_partial_plain(
            q, k_shard, v_shard, valid_len, off=off, seq_len=seq_len,
            attn_softcap=attn_softcap, window=window)
    out, lse = _launch("decode_attention_partial", q, k_shard, v_shard,
                       valid_len, attn_softcap, window, shard=(off, seq_len))
    decode_attention_partial.launches += 1
    return out, lse


decode_attention_partial.launches = 0
