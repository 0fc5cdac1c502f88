"""The definitional sequential SSD recurrence — a torch copy of the
reference's oracle (``repro.kernels.ssd_scan.ref.ssd_ref``), for checks."""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, Bm, Cm):
    """x: (B,S,H,P) f32; dt: (B,S,H) post-softplus; A: (H,) negative;
    Bm/Cm: (B,S,N). Returns (y (B,S,H,P), final state (B,H,P,N))."""
    B, S, H, P = x.shape
    st = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                     device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                       # (B,H)
        st = st * decay[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], st))
    return torch.stack(ys, dim=1), st
