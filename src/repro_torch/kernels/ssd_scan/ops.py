"""Chunked SSD: the K6 chunk kernel plus the inter-chunk recurrence — the
port of ``repro.kernels.ssd_scan.ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_chunk, ssd_chunk_plain


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 64, plain: bool = False):
    """Chunked SSD with the K6 intra-chunk kernel (``plain=True``: its plain
    version, on any device).

    x: (B,S,H,P) f32; dt: (B,S,H) post-softplus; A: (H,) negative;
    Bm/Cm: (B,S,N). Returns (y (B,S,H,P), final state (B,H,P,N)).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {L}")
    C = S // L

    cum = torch.cumsum((dt * A).reshape(B, C, L, H), dim=2)
    total = cum[:, :, -1]                                     # (B,C,H)
    Cr = Cm.reshape(B, C, L, N)
    args = (x.reshape(B, C, L, H, P), dt.reshape(B, C, L, H), cum,
            Bm.reshape(B, C, L, N), Cr)
    y_intra, Sc = (ssd_chunk_plain if plain else ssd_chunk)(
        *(t.contiguous() for t in args))

    st_in, st = _chunk_states_in(Sc, total)
    y_inter = _y_inter(Cr, st_in, cum)
    return (y_intra + y_inter).reshape(B, S, H, P), st


def _chunk_states_in(Sc, total):
    """The inter-chunk recurrence: the state entering chunk c, for every c
    (B,C,H,P,N), and the final state (B,H,P,N). Sc: (B,C,H,P,N) chunk-end
    states; total: (B,C,H) each chunk's summed log-decay."""
    B, C = Sc.shape[:2]
    st = torch.zeros_like(Sc[:, 0])
    st_in = []
    for c in range(C):
        st_in.append(st)
        st = st * torch.exp(total[:, c])[:, :, None, None] + Sc[:, c]
    return torch.stack(st_in, dim=1), st


def _y_inter(Cr, st_in, cum):
    """Each position's read of the state entering its chunk, decayed to
    the position: (B,C,L,H,P)."""
    return torch.einsum("bcin,bchpn,bcih->bcihp", Cr, st_in, torch.exp(cum))
