"""The port's optimizer (``repro_torch.optim``) against the reference
(``repro.optim``): the cases of ``tests/test_optimizer.py`` on the port,
then both packages from the same numpy parameters and gradients over three
steps. f32 parameters and moments agree within 1e-6 (the same f32
arithmetic, summed in another order); bf16 parameters equal or one bf16
rounding apart; the 8-bit states equal, or one quantization step apart
where the f32 moment sits on a rounding boundary (the count is printed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="dev extra: pip install -e .[dev]")
from hypothesis import given, settings, strategies as st

import repro.optim.optimizer as J
import repro_torch.optim.optimizer as T
from repro_torch.core.persistent import tree_map

ATOL = 1e-6


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# The reference's cases, on the port
# ---------------------------------------------------------------------------

def test_adamw_first_step_math():
    cfg = T.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                        weight_decay=0.0, max_grad_norm=1e9)
    p = {"w": torch.ones(4)}
    g = {"w": 2 * torch.ones(4)}
    st_ = T.adamw_init(cfg, p)
    p2, st2, info = T.adamw_update(cfg, p, g, st_)
    # bias-corrected first step: mh=g, vh=g^2 -> upd = g/(|g|+eps) = 1
    np.testing.assert_allclose(p2["w"].numpy(), 1.0 - 1e-2, rtol=1e-6)
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32
    assert float(info["grad_norm"]) == pytest.approx(4.0)


def test_weight_decay_applied():
    cfg = T.AdamWConfig(lr=1e-1, weight_decay=0.5, max_grad_norm=1e9)
    p = {"w": torch.ones(2)}
    g = {"w": torch.zeros(2)}
    p2, _, _ = T.adamw_update(cfg, p, g, T.adamw_init(cfg, p))
    np.testing.assert_allclose(p2["w"].numpy(), 1.0 - 0.1 * 0.5, rtol=1e-5)


def test_8bit_matches_fp32_closely():
    rng = np.random.default_rng(0)
    p = {"w": t(rng.normal(size=(512, 8)))}
    g = {"w": t(rng.normal(size=(512, 8)))}
    c32 = T.AdamWConfig(lr=1e-2, max_grad_norm=1e9)
    c8 = T.AdamWConfig(lr=1e-2, max_grad_norm=1e9, eightbit=True)
    p32, s32, _ = T.adamw_update(c32, p, g, T.adamw_init(c32, p))
    p8, s8, _ = T.adamw_update(c8, p, g, T.adamw_init(c8, p))
    np.testing.assert_allclose(p8["w"].numpy(), p32["w"].numpy(), atol=5e-4)
    p32b, _, _ = T.adamw_update(c32, p32, g, s32)
    p8b, _, _ = T.adamw_update(c8, p8, g, s8)
    np.testing.assert_allclose(p8b["w"].numpy(), p32b["w"].numpy(),
                               atol=2e-2)


@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=8,
                max_size=512))
@settings(max_examples=50, deadline=None)
def test_quantize_roundtrip_bound(vals):
    x = torch.tensor(np.asarray(vals, np.float32).reshape(1, -1))
    q, s = T.quantize_8bit(x)
    xr = T.dequantize_8bit(q, s, tuple(x.shape))
    err = (xr - x).abs().max().item()
    bound = x.abs().max().item() / 127.0 + 1e-6
    assert err <= bound + 1e-5


def test_qblock_alignment():
    assert T.qblock_for(8192) == 256
    assert 29568 % T.qblock_for(29568) == 0
    assert (29568 // T.qblock_for(29568)) % 16 == 0
    assert T.qblock_for(48) in (16, 48)
    for n in (1, 3, 8, 48, 96, 520, 4096, 29568, 128256):
        assert T.qblock_for(n) == J.qblock_for(n), n


def test_clip_by_global_norm():
    tree = {"a": 3 * torch.ones(4), "b": 4 * torch.ones(4)}
    clipped, norm = T.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(T.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    jc, jn = J.clip_by_global_norm({k: jnp.asarray(v.numpy())
                                    for k, v in tree.items()}, 1.0)
    assert float(norm) == float(jn)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jc[k]),
                                   atol=ATOL, rtol=0)


def test_cosine_schedule_shape_and_values():
    lr = T.cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(lr(100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(lr(55)) < float(lr(11))
    jlr = J.cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 37, 55, 99, 100, 140):
        assert float(lr(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(jlr(jnp.int32(s))), rel=1e-6, abs=1e-12), s


def test_gradient_compression_roundtrip():
    rng = np.random.default_rng(2)
    g = {"w": t(rng.normal(size=(256, 16)))}
    comp = T.compress_grads(g)
    assert comp["w"]["q"].dtype == torch.int8
    assert comp["w"]["shape"].tolist() == [256, 16]
    back = T.decompress_grads(comp, g)
    rel = float((back["w"] - g["w"]).abs().max() / g["w"].abs().max())
    assert rel < 0.01
    jcomp = J.compress_grads({"w": jnp.asarray(g["w"].numpy())})
    np.testing.assert_array_equal(comp["w"]["q"].numpy(),
                                  np.asarray(jcomp["w"]["q"]))
    np.testing.assert_array_equal(comp["w"]["s"].numpy(),
                                  np.asarray(jcomp["w"]["s"]))


def test_make_optimizer_and_defaults():
    assert T.make_optimizer("adamw", lr=1e-3) == T.AdamWConfig(lr=1e-3)
    assert T.make_optimizer("adamw8bit").eightbit
    with pytest.raises(ValueError):
        T.make_optimizer("sgd")


# ---------------------------------------------------------------------------
# Port against reference, three steps from the same numpy inputs
# ---------------------------------------------------------------------------

def _inputs(seed: int, bf16: bool):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 48), "b": {"c": (3, 16, 40), "d": (40,)},
              "e": [(8, 32), (2, 96)]}
    params = jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.3
                                     ).astype(np.float32), params)
             for _ in range(3)]
    dt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), params),
            [jax.tree.map(lambda a: jnp.asarray(a, jdt), g) for g in grads],
            tree_map(lambda a: torch.tensor(a, dtype=dt), params),
            [tree_map(lambda a: torch.tensor(a, dtype=dt), g)
             for g in grads])


def _run_both(kw, bf16=False, seed=0, donate=False):
    jp, jgs, tp, tgs = _inputs(seed, bf16)
    lr = kw.pop("schedule", None)
    jcfg = J.AdamWConfig(lr=J.cosine_schedule(*lr) if lr else 1e-2, **kw)
    tcfg = T.AdamWConfig(lr=T.cosine_schedule(*lr) if lr else 1e-2, **kw)
    jst, tst = J.adamw_init(jcfg, jp), T.adamw_init(tcfg, tp)
    jstep = jax.jit(lambda p, g, s: J.adamw_update(jcfg, p, g, s))
    for jg, tg in zip(jgs, tgs):
        jp, jst, jinfo = jstep(jp, jg, jst)
        tp, tst, tinfo = T.adamw_update(tcfg, tp, tg, tst, donate=donate)
        assert float(tinfo["grad_norm"]) == pytest.approx(
            float(jinfo["grad_norm"]), rel=1e-6)
        assert float(tinfo["lr"]) == pytest.approx(float(jinfo["lr"]),
                                                   rel=1e-6)
    return jp, jst, tp, tst


def _names(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.0, max_grad_norm=0.5),
    dict(schedule=(1e-2, 1, 3), b2=0.99),
], ids=["defaults", "clipped_no_decay", "cosine"])
def test_fp32_adamw_matches_reference_over_three_steps(kw):
    jp, jst, tp, tst = _run_both(dict(kw))
    assert int(tst["step"]) == int(jst["step"]) == 3
    assert tst["step"].dtype == torch.int32 and tst["step"].dim() == 0
    for name, want in _names(jp):
        np.testing.assert_allclose(_get(tp, name).numpy(), want, atol=ATOL,
                                   rtol=0, err_msg=name)
    for name, want in _names(jst["mv"]):
        got = _get(tst["mv"], name)
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_donated_update_gives_the_same_values():
    _, _, tp, tst = _run_both({})
    _, _, dp, dst = _run_both({}, donate=True)
    for a, b in zip(_names(tree_map(lambda x: x.numpy(), tp)),
                    _names(tree_map(lambda x: x.numpy(), dp))):
        np.testing.assert_array_equal(a[1], b[1])
    for m in ("m", "v"):
        for a, b in zip(_names(tree_map(lambda x: x.numpy(), tst["mv"][m])),
                        _names(tree_map(lambda x: x.numpy(), dst["mv"][m]))):
            np.testing.assert_array_equal(a[1], b[1])


def test_donated_update_writes_in_place():
    cfg = T.AdamWConfig(lr=1e-2)
    p = {"w": torch.ones(4, 8)}
    st_ = T.adamw_init(cfg, p)
    ptr_p, ptr_m = p["w"].data_ptr(), st_["mv"]["m"]["w"].data_ptr()
    p2, st2, _ = T.adamw_update(cfg, p, {"w": torch.ones(4, 8)}, st_,
                                donate=True)
    assert p2["w"].data_ptr() == ptr_p
    assert st2["mv"]["m"]["w"].data_ptr() == ptr_m
    assert not torch.equal(p["w"], torch.ones(4, 8))


def test_bf16_params_match_reference_within_one_rounding():
    jp, jst, tp, tst = _run_both({}, bf16=True)
    apart = 0
    for name, want in _names(jp):
        got = _get(tp, name)
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        # equal, or one bf16 rounding apart (2^-8 relative)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=0, err_msg=name)
        apart += int((got.float().numpy() != want).sum())
    print(f"bf16 parameters one rounding apart: {apart}")
    for name, want in _names(jst["mv"]):
        np.testing.assert_allclose(_get(tst["mv"], name).numpy(), want,
                                   atol=ATOL, rtol=0, err_msg=name)


def _compare_8bit(jp, jst, tp, tst, label):
    for name, want in _names(jp):
        np.testing.assert_allclose(_get(tp, name).numpy(), want, atol=ATOL,
                                   rtol=0, err_msg=name)
    off_by_one, total = 0, 0
    for name, want in _names(jst["mv"]):
        got = _get(tst["mv"], name)
        if name.endswith("_q"):
            assert got.dtype == torch.int8, name
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, name
            off_by_one += int((diff == 1).sum())
            total += diff.size
        else:
            assert got.dtype == torch.float32, name
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0,
                                       err_msg=name)
    print(f"{label}: int8 states one step apart: {off_by_one} of {total}")


def test_8bit_adamw_matches_reference_over_three_steps():
    jp, jst, tp, tst = _run_both(dict(eightbit=True))
    _compare_8bit(jp, jst, tp, tst, "8bit")


def test_8bit_slice_loop_matches_reference_whole_leaf(monkeypatch):
    """A leaf past ``BIG_LEAF_ELEMS`` is updated one leading slice at a
    time; with the threshold lowered, the small leaves here take that loop
    (both modes), and the reference updates them whole."""
    monkeypatch.setattr(T, "BIG_LEAF_ELEMS", 64)
    for donate in (False, True):
        jp, jst, tp, tst = _run_both(dict(eightbit=True), donate=donate)
        _compare_8bit(jp, jst, tp, tst, f"8bit slices donate={donate}")


def test_8bit_state_layout_is_the_reference():
    rng = np.random.default_rng(5)
    p = {"x": rng.normal(size=(6, 96)).astype(np.float32),
         "y": rng.normal(size=(29568,)).astype(np.float32)}
    cfg_j = J.AdamWConfig(eightbit=True)
    cfg_t = T.AdamWConfig(eightbit=True)
    js = J.adamw_init(cfg_j, jax.tree.map(jnp.asarray, p))
    ts = T.adamw_init(cfg_t, tree_map(torch.tensor, p))
    for name, want in _names(js):
        got = _get(ts, name)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
