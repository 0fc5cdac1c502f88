"""Mamba2 SSD chunk kernel (K6): the Hopper kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.ssd_scan.kernel`` (``_ssd_chunk_kernel`` /
``ssd_chunk_pallas``): per (batch, chunk, head) the intra-chunk output and
the chunk-end state. ``ssd_chunk`` launches the CUDA kernel in
``csrc/ssd_scan.cu`` (one launch computes both outputs, in 3xTF32 on the
tensor cores) for CUDA tensors and uses ``ssd_chunk_plain`` for CPU tensors
— the only case in which it does. On a CUDA tensor it launches the kernel
or raises; under ``FakeTensorMode`` or on meta tensors it returns outputs of
the right shapes and launches nothing (the dry run).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad, shape_only, tally

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_HEAD_DIM = 64        # P: one 64-wide tensor-core tile of a head
MAX_STATE_DIM = 224      # N: a CTA keeps 128 rows of C (N wide) resident

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.k6_ssd_chunk_fwd.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.k6_ssd_chunk_fwd.restype = ci
        lib.k6_request_smem.argtypes = [ci]
        lib.k6_request_smem.restype = None
        lib.k6_force_heads.argtypes = [ci]
        lib.k6_force_heads.restype = None
        lib.k6_heads_for.argtypes = [ci] * 5
        lib.k6_heads_for.restype = ci
        lib.k6_error_string.argtypes = [ci]
        lib.k6_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssd_chunk_plain(x, dt, cum, Bm, Cm):
    """Plain PyTorch version, the Pallas kernel's arithmetic for every head
    at once. x: (B,C,L,H,P) f32; dt/cum: (B,C,L,H); Bm/Cm: (B,C,L,N).
    Returns (y_intra (B,C,L,H,P), states (B,C,H,P,N))."""
    L = x.shape[2]
    G = torch.einsum("bcin,bcjn->bcij", Cm, Bm)                   # (i,j)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (i,j,H)
    ii = torch.arange(L, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Wt = torch.where(causal, G[..., None] * torch.exp(
        torch.where(causal, dec, torch.zeros_like(dec)))
        * dt[:, :, None, :, :], torch.zeros_like(dec))
    y = torch.einsum("bcijh,bcjhp->bcihp", Wt, x)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)                  # (L,H)
    xw = x * (dt * dec_end)[..., None]
    states = torch.einsum("bclhp,bcln->bchpn", xw, Bm)
    return y, states


def _check(x, dt, cum, Bm, Cm) -> None:
    if not x.is_cuda or any(t.device != x.device for t in (dt, cum, Bm, Cm)):
        raise ValueError("x, dt, cum, Bm and Cm must lie on one CUDA device")
    for name, t in (("x", x), ("dt", dt), ("cum", cum), ("Bm", Bm),
                    ("Cm", Cm)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk takes float32 tensors, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 5:
        raise ValueError(f"expected x (B,C,L,H,P), got {tuple(x.shape)}")
    B, C, L, H, P = x.shape
    if tuple(dt.shape) != (B, C, L, H) or tuple(cum.shape) != (B, C, L, H):
        raise ValueError(f"dt {tuple(dt.shape)} / cum {tuple(cum.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if Bm.dim() != 4 or tuple(Bm.shape[:3]) != (B, C, L) or \
            Cm.shape != Bm.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} must "
                         f"be one (B,C,L,N) shape matching x {tuple(x.shape)}")
    if min(x.shape) < 1 or Bm.shape[-1] < 1:
        raise ValueError(f"empty input: x {tuple(x.shape)}, "
                         f"Bm {tuple(Bm.shape)}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"head dim P={P} not supported (at most "
                         f"{MAX_HEAD_DIM})")
    if Bm.shape[-1] > MAX_STATE_DIM:
        raise ValueError(f"state dim N={Bm.shape[-1]} not supported (at most "
                         f"{MAX_STATE_DIM})")


def ssd_chunk(x, dt, cum, Bm, Cm):
    """x: (B,C,L,H,P) f32; dt/cum: (B,C,L,H); Bm/Cm: (B,C,L,N) ->
    (y_intra (B,C,L,H,P), states (B,C,H,P,N)). CUDA tensors launch the
    Hopper kernel on the current stream (no synchronization); CPU tensors
    take the plain version. ``ssd_chunk.launches`` counts kernel launches
    (one a call, one device kernel computing both outputs)."""
    refuse_grad("ssd_chunk", x, dt, cum, Bm, Cm)
    if shape_only(x, dt, cum, Bm, Cm):
        B, C, L, H, P = x.shape
        N = Bm.shape[-1]
        y = torch.empty_like(x)
        states = x.new_empty((B, C, H, P, N))
        # C·Bᵀ, the masked product with x, and the chunk-end states
        ops = 2.0 * B * C * (L * L * N + H * (L * L * P + L * P * N))
        tally("K6", ops, (x, dt, cum, Bm, Cm), (y, states))
        return y, states
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, cum, Bm, Cm)
    _check(x, dt, cum, Bm, Cm)
    B, C, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    states = torch.empty((B, C, H, P, N), dtype=x.dtype, device=x.device)
    lib = library()
    err = lib.k6_ssd_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), states.data_ptr(), B, C, L, H, P, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = "unsupported shape" if err == -1 else \
            lib.k6_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk kernel launch failed: {msg}")
    ssd_chunk.launches += 1
    return y, states


ssd_chunk.launches = 0
