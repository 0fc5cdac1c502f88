"""The port's differentiable attention against the reference's: the
output, the log-sum-exp and (dq, dk, dv) of ``flash_attention_grad``
(its plain blockwise forward and backward on the CPU) against
``jax.vjp`` of ``repro.models.attention.flash_xla`` and the lse of its
``_flash_fwd_impl``, on inputs and cotangents drawn with numpy from a
seed. Tolerance: f32, each tensor within 1e-5 x its largest |want| (the
two sum in other orders); a row with no live key has lse exactly -1e30 in
both and gives no gradient in the port, so the reference's gradients are
taken with that row's dout at 0 (its dv takes a dead row's dout at every
key of the blocks it visits). Also: what the autograd Function saves, the
dry run's shape-only tally, and the 'masked' backend's full-score train
path."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import (_FlashStatics, _flash_fwd_impl,
                                    _pad_to_block, flash_xla)
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.persistent import tree_leaves
from repro_torch.kernels.flash_attention import (flash_attention_grad,
                                                 flash_attention_lse_plain)
from repro_torch.models import attention as attn_mod
from repro_torch.models import build
from repro_torch.training.train_loop import _value_and_grad

RTOL = 1e-5           # of each tensor's largest |want|
NEG = -1e30
BLOCK = 16            # the reference's block_q = block_kv (attn_chunk)

# (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, seq_len)
CASES = {
    "G1_causal_D32": (2, 48, 48, 4, 4, 32, True, 0, 0.0, None),
    "G2_causal_softcap_ragged_D64": (1, 37, 37, 4, 2, 64, True, 0, 30.0,
                                     None),
    "G4_window_D32": (1, 64, 64, 8, 2, 32, True, 12, 0.0, None),
    "G4_window_softcap_ragged_D64": (1, 40, 40, 4, 1, 64, True, 8, 50.0,
                                     None),
    "noncausal_ragged_G2_D64": (2, 40, 40, 4, 2, 64, False, 0, 0.0, None),
    "cross_17x50_G2_D32": (2, 17, 50, 4, 2, 32, False, 0, 0.0, None),
    "cross_17x50_seq_len37_softcap_D64": (1, 17, 50, 4, 4, 64, False, 0,
                                          30.0, 37),
    "causal_seq_len20_G2_D32": (1, 48, 48, 4, 2, 32, True, 0, 0.0, 20),
    # rows 9..31 see keys 6.. only, all past seq_len 6: no live key
    "fully_masked_rows_D32": (1, 32, 32, 4, 2, 32, True, 4, 0.0, 6),
}


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, do, *, causal, window, softcap, seq_len):
    """``jax.vjp`` of ``flash_xla`` at (q, k, v) with cotangent ``do``, and
    ``_flash_fwd_impl``'s lse on ``flash_xla``'s block layout as
    (B, Hq, Sq): (out, (dq, dk, dv), lse), one jit."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    bq, bk = min(BLOCK, S), min(BLOCK, Skv)
    st = _FlashStatics(causal=causal, window=window, attn_softcap=softcap,
                       block_q=bq, block_kv=bk,
                       real_len=Skv if seq_len is None else seq_len,
                       groups=Hq // Hkv, scale=1.0 / math.sqrt(D))

    def blocks(x, b):
        xp = _pad_to_block(x, b, 1)
        T = xp.shape[1] // b
        return jnp.moveaxis(xp.reshape(B, T, b, x.shape[2], D), 1, 0)
    out, vjp = jax.vjp(functools.partial(
        flash_xla, causal=causal, window=window, attn_softcap=softcap,
        block_q=BLOCK, block_kv=BLOCK, seq_len=seq_len), q, k, v)
    _, lse = _flash_fwd_impl(blocks(q, bq), blocks(k, bk), blocks(v, bk), st)
    lse = jnp.transpose(lse, (1, 2, 0, 3)).reshape(B, Hq, -1)[:, :, :S]
    return out, vjp(do), lse


def _close(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{name}: {err:.3e} > {RTOL} x {scale:.3g}"


@pytest.mark.parametrize("case", list(CASES))
def test_flash_grad_matches_reference_vjp(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap, seq_len = CASES[case]
    q, k, v, do = _inputs(B, Sq, Skv, Hq, Hkv, D)
    ref = jax.jit(functools.partial(_reference, causal=causal, window=window,
                                    softcap=cap, seq_len=seq_len))
    want_lse = np.asarray(ref(q, k, v, do)[2])
    dead = want_lse <= NEG                                  # (B, Hq, Sq)
    do_ref = np.where(dead.transpose(0, 2, 1)[..., None], 0.0, do)
    out, grads, _ = ref(q, k, v, do_ref.astype(np.float32))
    want = [np.asarray(out)] + [np.asarray(g) for g in grads]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kw = dict(causal=causal, window=window, attn_softcap=cap,
              seq_len=seq_len, block=BLOCK)
    o = flash_attention_grad(tq, tk, tv, **kw)
    o.backward(torch.from_numpy(do))
    got = [o.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        _close(g, w, name)

    with torch.no_grad():
        _, lse = flash_attention_lse_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    lse = lse.numpy()
    assert lse.shape == want_lse.shape
    assert np.array_equal(lse <= NEG, dead)
    assert np.all(lse[dead] == np.float32(NEG))
    _close(lse[~dead], want_lse[~dead], "lse")
    if case == "fully_masked_rows_D32":
        assert dead[..., 9:].all() and not dead[..., :9].any()
        # the dead rows' dout reaches no gradient
        q2, k2, v2 = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        flash_attention_grad(q2, k2, v2, **kw).backward(
            torch.from_numpy(do_ref.astype(np.float32)))
        for a, b in zip((tq, tk, tv), (q2, k2, v2)):
            assert torch.equal(a.grad, b.grad)


def test_function_saves_only_q_k_v_out_and_lse():
    """As the reference's ``_flash_core_f``: the residuals are q, k, v, out
    and lse — nothing of size S x Skv."""
    B, S, Hq, Hkv, D = 1, 64, 4, 2, 32
    q, k, v, _ = _inputs(B, S, S, Hq, Hkv, D)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        flash_attention_grad(tq, tk, tv, causal=True, block=16)
    assert sorted(saved) == sorted([(B, S, Hq, D), (B, S, Hkv, D),
                                    (B, S, Hkv, D), (B, S, Hq, D),
                                    (B, Hq, S)])


def test_shape_only_calls_tally_k5_and_k5_bwd():
    """Under FakeTensorMode (the dry run) the forward and the backward
    launch nothing and tally K5 and K5-bwd: the backward's operations are
    2.5x the forward's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    kernels.SHAPE_ONLY_TALLY.clear()
    B, S, Hq, Hkv, D = 2, 256, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty((B, S, Hq, D), requires_grad=True)
        k = torch.empty((B, S, Hkv, D), requires_grad=True)
        v = torch.empty((B, S, Hkv, D), requires_grad=True)
        out = flash_attention_grad(q, k, v, causal=True)
        out.backward(torch.empty_like(out))
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
    tally = dict(kernels.SHAPE_ONLY_TALLY)
    fwd_ops = 4.0 * B * Hq * D * S * (S + 1) // 2
    assert tally["K5"][:2] == [1, fwd_ops]
    assert tally["K5-bwd"][:2] == [1, 2.5 * fwd_ops]
    kernels.SHAPE_ONLY_TALLY.clear()


def test_masked_backend_trains_through_full_scores(monkeypatch):
    """``attn_backend="masked"`` keeps train mode on the full-score plain
    attention (the reference's control arm); its loss and gradients agree
    with the flash path's."""
    calls = {"full": 0}
    full = attn_mod.flash_attention_plain

    def counting(*a, **kw):
        calls["full"] += 1
        return full(*a, **kw)
    monkeypatch.setattr(attn_mod, "flash_attention_plain", counting)
    cfg = get_config("llama3-8b").reduced()
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))}
    flash = build(cfg, device="cpu")
    params = flash.init(0)
    g0, m0 = _value_and_grad(flash.loss, params, batch)
    assert calls["full"] == 0
    masked = build(dataclasses.replace(cfg, attn_backend="masked"),
                   device="cpu")
    g1, m1 = _value_and_grad(masked.loss, params, batch)
    assert calls["full"] == cfg.num_layers
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        _close(b.numpy(), a.numpy(), "grad")
