"""The port's SSM path against the reference: K6's plain version against
interpret-mode Pallas, the chunked SSD against the sequential oracle, the
mamba2 block (prefill and decode) and reduced mamba2-780m (4 layers, d=128,
f32, the reference's parameters converted by ``params_from_jax``) against
the reference's ``ssd_chunked`` model path. Inputs are made by numpy from a
seed. Tolerance 1e-4 (f32; the two frameworks sum in different orders).
A numpy emulation of the Hopper K6 kernel's 3xTF32 arithmetic (its split,
its k-steps and fresh accumulators) holds the split to the same 1e-4
against the plain version at mamba2-780m's widths, before any card time."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.models import build as j_build
from repro.models import ssm as j_ssm
from repro_torch.configs import MoEConfig, get_config
from repro_torch.distributed import ShardCtx
from repro_torch.kernels.ssd_scan import kernel as K6
from repro_torch.kernels.ssd_scan import ssd, ssd_chunk_plain, ssd_ref
from repro_torch.models import build, params_from_jax
from repro_torch.models import ssm
from repro_torch.models.layers import Init
from test_torch_kernels_persistent import _split

TOL = 1e-4


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=msg)


def ssd_inputs(B, S, H, P, N, seed=0):
    """tests/test_kernels_ssd.py's inputs: dt in [1e-3, 0.1], A in
    [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(B, S, H, P)).astype(f32),
            rng.uniform(1e-3, 0.1, size=(B, S, H)).astype(f32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(f32),
            rng.normal(size=(B, S, N)).astype(f32),
            rng.normal(size=(B, S, N)).astype(f32))


def chunk_inputs(B, S, chunk, H, P, N, seed=0):
    """The K6 operands as ``ssd`` forms them: chunked x, dt, B, C and the
    in-chunk cumulative log-decay."""
    x, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, N, seed)
    C, L = S // chunk, chunk
    cum = np.cumsum((dt * A).reshape(B, C, L, H), axis=2, dtype=np.float32)
    return (x.reshape(B, C, L, H, P), dt.reshape(B, C, L, H), cum,
            Bm.reshape(B, C, L, N), Cm.reshape(B, C, L, N))


@pytest.mark.parametrize("B,S,chunk,H,P,N", [(2, 64, 16, 4, 16, 16),
                                             (2, 128, 32, 8, 16, 32),
                                             # zamba2-7b's 112 heads and
                                             # state 64 (P cut to 8)
                                             (1, 64, 32, 112, 8, 64)])
def test_chunk_plain_matches_pallas_interpret(B, S, chunk, H, P, N):
    args = chunk_inputs(B, S, chunk, H, P, N, seed=1)
    want_y, want_s = ssd_chunk_pallas(*map(jnp.asarray, args),
                                      interpret=True)
    got_y, got_s = ssd_chunk_plain(*map(torch.from_numpy, args))
    _close(got_y, want_y, "y_intra")
    _close(got_s, want_s, "states")


# ---------------------------------------------------------------------------
# 3xTF32, emulated: what the K6 kernel computes on the card
# ---------------------------------------------------------------------------

def _trunc32(v):
    """f64 to f32 rounded toward zero: how the tensor cores sum."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma(d, a, b):
    """``mma.sync`` m16n8k8 tf32: d + a @ b over 8-deep k, every product
    exact (tf32 x tf32 fits f32), the sum truncated to f32."""
    return _trunc32(d.astype(np.float64) + a.astype(np.float64) @
                    b.astype(np.float64))


def _product_3xtf32(A, B, kblock):
    """A @ B as the kernel forms it: every operand split into tf32 big and
    small halves; per ``kblock``-deep k-block a fresh accumulator takes,
    for each 8-deep step, a_small b_big, a_big b_small and a_big b_big in
    that order (a_small b_small dropped), then is added to the running sum
    in f32 (kblock = K: one accumulator, every sum truncated)."""
    ab, as_, _ = _split(A)
    bb, bs, _ = _split(B)
    acc = np.zeros((A.shape[0], B.shape[1]), np.float32)
    for k0 in range(0, A.shape[1], kblock):
        p = np.zeros_like(acc)
        for k in range(k0, min(k0 + kblock, A.shape[1]), 8):
            s = slice(k, k + 8)
            p = _mma(p, as_[:, s], bb[s])
            p = _mma(p, ab[:, s], bs[s])
            p = _mma(p, ab[:, s], bb[s])
        acc = acc + p
    return acc


def _ssd_chunk_3xtf32(x, dt, cum, Bm, Cm):
    """The K6 kernel's arithmetic in numpy (f32 where the kernel is f32):
    G = C B^T over N (mma.sync); W = G * exp(cum_i - cum_j) * dt_j (j > i
    zero) and y = W x, and the states' (B * w)^T x, w = dt * exp(cum_end -
    cum), over 32-column stages (wgmma); every product in 32-deep k-blocks
    with fresh accumulators."""
    Bsz, C, L, H, P = x.shape
    N = Bm.shape[-1]
    y = np.zeros_like(x)
    states = np.zeros((Bsz, C, H, P, N), np.float32)
    causal = np.tril(np.ones((L, L), bool))
    for b in range(Bsz):
        for c in range(C):
            G = _product_3xtf32(Cm[b, c], Bm[b, c].T, 32)
            for h in range(H):
                cu, d = cum[b, c, :, h], dt[b, c, :, h]
                dec = np.exp(np.where(causal, cu[:, None] - cu[None, :],
                                      np.float32(0)))
                W = np.where(causal, G * dec * d[None, :], np.float32(0))
                y[b, c, :, h] = _product_3xtf32(W.astype(np.float32),
                                                x[b, c, :, h], 32)
                w = d * np.exp(cu[-1] - cu)
                A = (Bm[b, c] * w[:, None]).T
                states[b, c, h] = _product_3xtf32(A, x[b, c, :, h], 32).T
    return y, states


@pytest.mark.parametrize("case", ["mamba2_width", "scaled100",
                                  "near_underflow", "zamba2_width"])
def test_chunk_3xtf32_emulation_meets_plain_contract(case):
    """The kernel's split, k-steps and fresh accumulators stay within 1e-4
    of ``ssd_chunk_plain`` at mamba2-780m's widths (L=256, N=128, P=64;
    two heads, two chunks) and at zamba2-7b's state width (N=64); with x,
    B and C times 100 (the split's accuracy is relative: the outputs, 100^3
    (y) and 100^2 (states) times larger, are compared in the inputs' units,
    divided by those factors); with decays near underflow (dt at dt_max
    0.1, A = -8)."""
    N = 64 if case == "zamba2_width" else 128
    B, C, L, H, P = 1, 2, 256, 2, 64
    x, dt, A, Bm, Cm = ssd_inputs(B, C * L, H, P, N, seed=5)
    unit_y = unit_s = np.float32(1)
    if case == "scaled100":
        x, Bm, Cm = (a * np.float32(100) for a in (x, Bm, Cm))
        unit_y, unit_s = np.float32(1e6), np.float32(1e4)
    if case == "near_underflow":
        dt = np.full_like(dt, 0.1)
        A = np.full_like(A, -8.0)
    cum = np.cumsum((dt * A).reshape(B, C, L, H), axis=2, dtype=np.float32)
    args = (x.reshape(B, C, L, H, P), dt.reshape(B, C, L, H), cum,
            Bm.reshape(B, C, L, N), Cm.reshape(B, C, L, N))
    got_y, got_s = _ssd_chunk_3xtf32(*args)
    want_y, want_s = ssd_chunk_plain(*map(torch.from_numpy, args))
    assert np.isfinite(got_y).all() and np.isfinite(got_s).all()
    _close(got_y / unit_y, want_y.numpy() / unit_y, "y_intra")
    _close(got_s / unit_s, want_s.numpy() / unit_s, "states")


def test_chunk_kernel_limits_equal_wrapper():
    """The shapes the wrapper lets through are the ones the CUDA launcher
    takes: its head-dim and state-width limits equal the source's."""
    src = K6.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["PMAX"]) == K6.MAX_HEAD_DIM
    assert int(consts["NMAX"]) == K6.MAX_STATE_DIM


@pytest.mark.parametrize("S,chunk", [(11, 32), (64, 16), (96, 32)])
def test_ssd_matches_sequential_oracle(S, chunk):
    """The port's chunked ``ssd`` (K6's plain version on the CPU plus the
    inter-chunk loop) and its torch oracle against the reference's
    oracle."""
    args = ssd_inputs(2, S, 4, 8, 16, seed=3)
    want_y, want_s = j_ssd_ref(*map(jnp.asarray, args))
    t = [torch.from_numpy(a) for a in args]
    got_y, got_s = ssd(*t, chunk=chunk)
    _close(got_y, want_y, "ssd y")
    _close(got_s, want_s, "ssd state")
    ref_y, ref_s = ssd_ref(*t)
    _close(ref_y, want_y, "ssd_ref y")
    _close(ref_s, want_s, "ssd_ref state")


def test_ssd_rejects_ragged_chunks():
    t = [torch.from_numpy(a) for a in ssd_inputs(1, 48, 2, 4, 8)]
    with pytest.raises(ValueError, match="multiple"):
        ssd(*t, chunk=32)


@pytest.fixture(scope="module")
def pair():
    j_cfg = j_get_config("mamba2-780m").reduced()
    j_model = j_build(j_cfg, JShardCtx.single(kind="decode"))
    j_params = j_model.init(jax.random.key(0))
    cfg = get_config("mamba2-780m").reduced()
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    return j_model, j_params, model, params


@pytest.fixture(scope="module")
def block(pair):
    """Layer 0's SSM parameters of the reduced model, reference and port,
    with a non-trivial A and dt bias (the init draws zeros)."""
    j_model, j_params, model, _ = pair
    j_p = jax.tree.map(lambda a: a[0], j_params["stack"]["blk0"]["ssm"])
    rng = np.random.default_rng(4)
    j_p["A_log"] = jnp.asarray(rng.uniform(-1, 1, j_p["A_log"].shape),
                               jnp.float32)
    j_p["dt_bias"] = jnp.asarray(rng.uniform(-3, 0, j_p["dt_bias"].shape),
                                 jnp.float32)
    p = params_from_jax(jax.tree.map(np.asarray, j_p), model.cfg, "cpu")
    return j_model.cfg, j_p, model.cfg, p


@pytest.mark.parametrize("S", [7, 64])
def test_ssm_block_and_decode_match_reference(block, S):
    j_cfg, j_p, cfg, p = block
    rng = np.random.default_rng(S)
    u = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    j_ctx, ctx = JShardCtx.single(), ShardCtx.single()
    j_block = jax.jit(lambda p_, u_: j_ssm.ssm_block(
        p_, u_, j_cfg, j_ctx, return_state=True))
    j_decode = jax.jit(lambda p_, u_, s_: j_ssm.ssm_block_decode(
        p_, u_, s_, j_cfg, j_ctx))
    want, j_state = j_block(j_p, jnp.asarray(u))
    got, state = ssm.ssm_block(p, torch.from_numpy(u), cfg, ctx,
                               return_state=True)
    _close(got, want, "ssm_block out")
    assert set(state) == set(j_state)
    for k in state:
        _close(state[k], j_state[k], f"state {k}")
    for step in range(3):
        ut = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, j_state = j_decode(j_p, jnp.asarray(ut), j_state)
        ids = {k: id(v) for k, v in state.items()}
        got, state2 = ssm.ssm_block_decode(p, torch.from_numpy(ut), state,
                                           cfg, ctx)
        assert state2 is state and ids == {k: id(v) for k, v in
                                           state.items()}
        _close(got, want, f"decode out, step {step}")
        for k in state:
            _close(state[k], j_state[k], f"decode state {k}, step {step}")


@pytest.mark.parametrize("S", [11, 64], ids=["one_chunk", "two_chunks"])
def test_model_prefill_and_decode_match_reference(pair, S):
    """Prefill logits and every state leaf (not padded to max_seq), then
    three decode steps whose states are updated in place."""
    j_model, j_params, model, params = pair
    rng = np.random.default_rng(S)
    B, max_seq = 2, 96
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_model.prefill(p, b, max_seq))(
            j_params, {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                   max_seq)
    _close(logits, j_logits, "prefill logits")
    assert set(caches["blk0"]) == {"ssd", "conv_x", "conv_B", "conv_C"}
    for k, leaf in caches["blk0"].items():
        assert leaf.shape == j_caches["blk0"][k].shape, k
        _close(leaf, j_caches["blk0"][k], f"prefill state {k}")
    j_dec = jax.jit(j_model.decode_step)
    pos = np.full((B,), S, np.int32)
    for step in range(3):
        nxt = rng.integers(0, 512, (B, 1)).astype(np.int32)
        j_logits, j_caches = j_dec(j_params, j_caches, jnp.asarray(nxt),
                                   jnp.asarray(pos))
        logits, out = model.decode_step(params, caches, torch.from_numpy(nxt),
                                        torch.from_numpy(pos))
        assert out is caches
        _close(logits, j_logits, f"decode logits, step {step}")
        for k, leaf in caches["blk0"].items():
            _close(leaf, j_caches["blk0"][k], f"decode state {k}, {step}")
        pos = pos + 1


def test_reduced_config_and_init_follow_reference():
    cfg = get_config("mamba2-780m").reduced()
    ref = j_get_config("mamba2-780m").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_config("mamba2-780m")) == \
        dataclasses.asdict(j_get_config("mamba2-780m"))
    model = build(cfg, device="cpu")
    p = model.init(0)
    blk = p["stack"]["blk0"]
    assert set(p["embed"]) == {"table"}                   # tied embeddings
    assert tuple(blk["ssm"]["wx"].shape) == (4, 128, 16, 16)
    for name in ("conv_x", "conv_B", "conv_C"):
        w = blk["ssm"][name]
        assert w.shape[1] == cfg.ssm.conv_width
        # uniform in [-1/sqrt(W), 1/sqrt(W)): std = scale / sqrt(3)
        s = cfg.ssm.conv_width ** -0.5
        assert float(w.abs().max()) <= s
        assert float(w.min()) < 0 < float(w.max())
        if w.numel() >= 1000:
            assert abs(float(w.std()) - s / 3 ** 0.5) < 0.02
    b = Init(0, torch.float32, "cpu")
    u = b.p((20000,), init="uniform")
    assert -1.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.02 and abs(float(u.std()) - 3 ** -0.5) < 0.01
    assert torch.equal(blk["ssm"]["D"], torch.ones_like(blk["ssm"]["D"]))
    assert torch.equal(blk["ssm"]["A_log"], torch.zeros_like(
        blk["ssm"]["A_log"]))


@pytest.mark.parametrize("family,extra", [
    ("moe", dict(moe=MoEConfig(num_experts=4, top_k=2))),
    ("vlm", dict(ssm=None))])
def test_unported_families_still_raise(family, extra):
    """Every family the reference assembles is ported now (moe and vlm
    last: tests/test_torch_moe.py, tests/test_torch_vlm.py), so these
    build; a family name outside the reference's six still raises."""
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(),
                              family=family, **extra)
    assert build(cfg, device="cpu").init(0)["stack"]
    with pytest.raises(NotImplementedError, match="not ported"):
        build(dataclasses.replace(cfg, family="diffusion"), device="cpu")


def test_dense_prefill_caches_still_padded():
    """``_pad_prefill_caches`` pads attention K/V to max_seq (and only
    them)."""
    cfg = get_config("llama3-8b").reduced()
    model = build(cfg, device="cpu")
    params = model.init(0)
    toks = torch.zeros((1, 5), dtype=torch.int32)
    _, caches = model.prefill(params, {"tokens": toks}, 16)
    assert tuple(caches["blk0"]["k"].shape) == (4, 1, 16, 2, 32)
