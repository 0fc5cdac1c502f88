"""The port's training path against the reference: ``Model.loss`` and its
gradients for all six families at ``--reduced`` (the reference's
parameters through ``params_from_jax``; loss and metrics within 1e-5, each
leaf's gradient within 1e-4 x the leaf's largest |grad|), three train steps
(lr 1e-3) for dense, moe (8-bit AdamW) and ssm (loss within 1e-5,
parameters within 1e-4), microbatch accumulation, a bit-exact resume, the
remat policies, and train mode's paths on the CPU: attention through
``flash_attention_grad``'s plain blockwise forward and backward (the
full-score plain version only for the 'masked' backend), the plain SSD
(the forward-only kernel wrappers refuse a tensor that requires grad)."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed import ShardCtx as JShardCtx
from repro.models import build as j_build
from repro.training import make_train_step as j_make_train_step
from repro.training import opt_config_for as j_opt_config_for
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.persistent import tree_leaves, tree_map
from repro_torch.data import SyntheticLM
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import build, params_from_jax
from repro_torch.training import init_state, make_train_step, opt_config_for
from repro_torch.training.train_loop import _value_and_grad

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4        # of each leaf's largest |grad|
PARAM_ATOL = 1e-4
FAMILIES = ["llama3-8b", "mamba2-780m", "zamba2-7b", "whisper-tiny",
            "grok-1-314b", "internvl2-76b"]


def _cfgs(arch, **over):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return j_cfg, cfg


def _pair(arch, **over):
    j_cfg, cfg = _cfgs(arch, **over)
    j_model = j_build(j_cfg, JShardCtx.single())
    j_params = j_model.init(jax.random.key(0))
    model = build(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, "cpu")
    return j_model, j_params, model, params


def _batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _named(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _assert_grads_close(j_grads, grads, rtol=GRAD_RTOL):
    for name, want in _named(j_grads):
        got = _get(grads, name)
        assert got.dtype == torch.float32, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= rtol * scale, (name, err, scale)


@pytest.mark.parametrize("arch,over", [
    *[(a, {}) for a in FAMILIES],
    ("llama3-8b", {"loss_chunk": 8}),       # padded, four chunks
], ids=[*FAMILIES, "llama3-8b-loss_chunk8"])
def test_loss_and_grads_match_reference(arch, over):
    j_model, j_params, model, params = _pair(arch, **over)
    jb, tb = _batch(model.cfg)
    (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
        j_model.loss, has_aux=True))(j_params, jb)
    grads, met = _value_and_grad(model.loss, params, tb)
    assert set(met) == set(j_met)
    for k in j_met:
        assert met[k].dtype == torch.float32 and met[k].dim() == 0, k
        assert abs(float(met[k]) - float(j_met[k])) <= LOSS_ATOL, k
    if model.cfg.family == "moe":
        assert {"moe_lb", "moe_z"} <= set(met)
        assert float(met["loss"]) == pytest.approx(
            float(met["ce"] + met["moe_lb"] + met["moe_z"]), rel=1e-6)
    _assert_grads_close(j_grads, grads)


def _to_port(tree):
    """A reference tree (optimizer state) as port tensors, dtypes kept."""
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_metrics_close(met, j_met, where):
    for k in ("loss", "ce"):
        assert abs(float(met[k]) - float(j_met[k])) <= LOSS_ATOL, (where, k)
    # a sum of squares over every gradient element, in f32
    assert float(met["grad_norm"]) == pytest.approx(
        float(j_met["grad_norm"]), rel=1e-5), where


def _ill_conditioned(j_params, j_opt):
    """Per parameter, where the reference's incoming 8-bit state holds a
    first moment but a second moment that dequantizes to 0: there the
    update is m / (sqrt((1 - b2) g^2) + eps), which carries the relative
    error of one gradient element (up to 1 where it is near 0)."""
    from repro.optim.optimizer import dequantize_8bit
    out = {}
    for name, p in _named(j_params):
        st = _get(j_opt["mv"], name)
        m = np.asarray(dequantize_8bit(st["m_q"], st["m_s"], p.shape))
        v = np.asarray(dequantize_8bit(st["v_q"], st["v_s"], p.shape))
        out[name] = (v == 0) & (m != 0)
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "grok-1-314b", "mamba2-780m"])
def test_three_train_steps_match_reference(arch):
    """Three steps at lr 1e-3 from the same parameters and batches: loss
    and ce within 1e-5, parameters within 1e-4. The 8-bit state (grok-1)
    is held step by step, each port step from the reference's state: its
    int8 second moment rounds the small entries of a block to 0 (a
    property of the reference's algorithm), where the next update divides
    by one gradient element's magnitude, so 1e-6 apart in f32 becomes O(1)
    a step later in either package. Those elements are counted; at most
    0.1% of them may differ by more than 1e-4 (the rest of the parameters
    may not)."""
    from repro.optim.optimizer import adamw_init as j_adamw_init
    from repro_torch.optim.optimizer import adamw_init
    j_model, j_params, model, params = _pair(arch)
    cfg = model.cfg
    j_ocfg = j_opt_config_for(j_model.cfg, lr=1e-3)
    ocfg = opt_config_for(cfg, lr=1e-3)
    assert ocfg.eightbit == (cfg.optimizer == "adamw8bit")
    j_opt, opt = j_adamw_init(j_ocfg, j_params), adamw_init(ocfg, params)
    j_step = jax.jit(j_make_train_step(j_model, j_ocfg))
    step = make_train_step(model, ocfg)
    ds = SyntheticLM(cfg.vocab_size, seed=3)
    for s in range(3):
        toks = ds.batch(s, 2, 32)
        ill = {}
        if ocfg.eightbit:
            params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg,
                                     "cpu")
            opt = _to_port(j_opt)
            ill = _ill_conditioned(j_params, j_opt)
        j_params, j_opt, j_met = j_step(j_params, j_opt,
                                        {"tokens": jnp.asarray(toks)})
        params, opt, met = step(params, opt, {"tokens": torch.from_numpy(toks)})
        _assert_metrics_close(met, j_met, s)
        n_ill = n_ill_off = 0
        for name, want in _named(j_params):
            err = np.abs(_get(params, name).numpy() - want)
            mask = ill.get(name, np.zeros(err.shape, bool))
            assert not (err[~mask] > PARAM_ATOL).any(), (s, name)
            n_ill += int(mask.sum())
            n_ill_off += int((err[mask] > PARAM_ATOL).sum())
        if ocfg.eightbit:
            print(f"step {s}: {n_ill} elements with a zero second moment, "
                  f"{n_ill_off} of them more than {PARAM_ATOL} apart")
            assert n_ill_off <= 1e-3 * max(n_ill, 1)
            for name, want in _named(j_opt["mv"]):
                got = _get(opt["mv"], name).numpy()
                if name.endswith("_q"):
                    assert np.abs(got.astype(np.int32) - want).max() <= 1
                else:   # block absmax of a moment: the gradients' tolerance
                    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                               atol=0, err_msg=name)
    assert int(opt["step"]) == 3 and opt["step"].dtype == torch.int32


def _setup(arch="llama3-8b", lr=3e-3):
    cfg = get_config(arch).reduced()
    model = build(cfg, device="cpu")
    ocfg = opt_config_for(cfg, lr=lr)
    params, opt = init_state(model, ocfg, 0)
    return cfg, model, ocfg, params, opt


def test_overfit_loss_decreases():
    cfg, model, ocfg, params, opt = _setup()
    step = make_train_step(model, ocfg, donate=True)
    batch = {"tokens": torch.from_numpy(
        SyntheticLM(cfg.vocab_size, seed=1, noise=0.0).batch(0, 4, 64))}
    first = None
    for i in range(25):
        params, opt, m = step(params, opt, batch)
        if i == 0:
            first = float(m["loss"])
    assert float(m["loss"]) < 0.5 * first, (first, float(m["loss"]))


def test_accum_matches_single_shot():
    """accum=2 == accum=1 (metrics, parameters), and accum=2 matches the
    reference's accum=2."""
    cfg, model, ocfg, params, opt = _setup(lr=1e-3)
    toks = SyntheticLM(cfg.vocab_size, seed=2).batch(0, 4, 32)
    batch = {"tokens": torch.from_numpy(toks)}
    p1, _, m1 = make_train_step(model, ocfg, accum_steps=1)(params, opt, batch)
    p2, _, m2 = make_train_step(model, ocfg, accum_steps=2)(params, opt, batch)
    assert float(m1["ce"]) == pytest.approx(float(m2["ce"]), rel=1e-4)
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err < 1e-4
    j_model, j_params, model, params = _pair("llama3-8b")
    j_ocfg = j_opt_config_for(j_model.cfg, lr=1e-3)
    from repro.optim.optimizer import adamw_init as j_adamw_init
    jp, _, jm = jax.jit(j_make_train_step(j_model, j_ocfg, accum_steps=2))(
        j_params, j_adamw_init(j_ocfg, j_params), {"tokens": jnp.asarray(toks)})
    tp, _, tm = make_train_step(model, ocfg, accum_steps=2)(
        params, init_state(model, ocfg, 0)[1], batch)
    _assert_metrics_close(tm, jm, "accum 2")
    assert abs(float(tm["acc"]) - float(jm["acc"])) <= LOSS_ATOL
    for name, want in _named(jp):
        np.testing.assert_allclose(_get(tp, name).numpy(), want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_checkpoint_resume_bit_exact(tmp_path):
    """Train 4 steps == train 2, checkpoint, restore, train 2 more."""
    cfg, model, ocfg, params, opt = _setup(lr=1e-3)
    step = make_train_step(model, ocfg)
    ds = SyntheticLM(cfg.vocab_size, seed=3)

    def run(params, opt, lo, hi):
        for s in range(lo, hi):
            params, opt, m = step(params, opt, {
                "tokens": torch.from_numpy(ds.batch(s, 2, 32))})
        return params, opt, m

    pa, oa, ma = run(params, opt, 0, 4)
    pb, ob, _ = run(params, opt, 0, 2)
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, {"p": pb, "o": ob})
    back = cm.restore(2, tree_map(torch.zeros_like, {"p": pb, "o": ob}))
    pc, oc, mc = run(back["p"], back["o"], 2, 4)
    for a, b in zip(tree_leaves(pa), tree_leaves(pc)):
        assert torch.equal(a, b)
    assert float(ma["loss"]) == float(mc["loss"])


def test_moe_aux_losses_present():
    cfg, model, ocfg, params, opt = _setup("grok-1-314b")
    assert ocfg.eightbit
    _, opt2, m = make_train_step(model, ocfg)(params, opt, {
        "tokens": torch.from_numpy(
            SyntheticLM(cfg.vocab_size, seed=4).batch(0, 2, 32))})
    assert "moe_lb" in m and float(m["moe_lb"]) > 0
    assert float(m["loss"]) >= float(m["ce"])
    assert opt2["mv"]["embed"]["table"]["m_q"].dtype == torch.int8


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b", "whisper-tiny"])
def test_remat_policies_give_the_same_grads(arch, policy):
    cfg = get_config(arch).reduced()
    base = build(cfg, device="cpu")
    remat = build(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                  device="cpu")
    params = base.init(0)
    _, tb = _batch(cfg)
    g0, m0 = _value_and_grad(base.loss, params, tb)
    g1, m1 = _value_and_grad(remat.loss, params, tb)
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        scale = max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale


@pytest.fixture
def plain_counts(monkeypatch):
    """Counts of the plain attention and SSD calls the models make (the
    full-score attention, the training pair's blockwise forward with lse
    and backward, the SSD chunk), with the forward-only kernel wrappers
    replaced by functions that fail."""
    counts = {"flash_attention_plain": 0, "flash_attention_lse_plain": 0,
              "flash_attention_bwd_plain": 0, "ssd_chunk_plain": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called in train mode")

    monkeypatch.setattr(attn_mod, "flash_attention_plain",
                        counting("flash_attention_plain",
                                 flash_attention_plain))
    for name in ("flash_attention_lse_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(fa_kernel, name,
                            counting(name, getattr(fa_kernel, name)))
    monkeypatch.setattr(ssd_ops, "ssd_chunk_plain",
                        counting("ssd_chunk_plain", ssd_chunk_plain))
    monkeypatch.setattr(attn_mod, "flash_attention", refuse)
    monkeypatch.setattr(attn_mod, "decode_attention", refuse)
    monkeypatch.setattr(ssd_ops, "ssd_chunk", refuse)
    return counts


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m", "zamba2-7b",
                                  "whisper-tiny"])
def test_train_mode_takes_the_plain_paths(arch, plain_counts):
    """On the CPU train mode's attention is ``flash_attention_grad``'s
    plain pair (forward with lse, blockwise backward), never the
    full-score version nor a kernel wrapper; the SSD its plain chunk."""
    cfg = get_config(arch).reduced()
    model = build(cfg, device="cpu")
    _, tb = _batch(cfg)
    _value_and_grad(model.loss, model.init(0), tb)
    if cfg.family != "ssm":
        assert plain_counts["flash_attention_lse_plain"] > 0
        assert plain_counts["flash_attention_bwd_plain"] > 0
    assert plain_counts["flash_attention_plain"] == 0
    if cfg.family in ("ssm", "hybrid"):
        assert plain_counts["ssd_chunk_plain"] > 0


def _wrapper_args(name):
    g = torch.Generator().manual_seed(0)
    if name == "flash_attention":
        q, k, v = (torch.randn(1, 8, 4, 32, generator=g) for _ in range(3))
        return flash_attention, flash_attention_plain, (q, k, v), {}
    if name == "decode_attention":
        q = torch.randn(2, 1, 4, 32, generator=g)
        k, v = (torch.randn(2, 16, 2, 32, generator=g) for _ in range(2))
        vl = torch.tensor([5, 16], dtype=torch.int32)
        return decode_attention, decode_attention_plain, (q, k, v, vl), {}
    x = torch.randn(1, 2, 8, 2, 4, generator=g)
    dt = torch.rand(1, 2, 8, 2, generator=g)
    cum = torch.cumsum(-dt, dim=2)
    Bm, Cm = (torch.randn(1, 2, 8, 3, generator=g) for _ in range(2))
    return ssd_chunk, ssd_chunk_plain, (x, dt, cum, Bm, Cm), {}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_chunk"])
def test_kernel_wrapper_refuses_grad(name):
    """The forward-only wrappers (K5's serving ``flash_attention``, K4,
    K6) have no backward: a wrapper raises before anything else (the
    device check included) when grad mode is on and an input requires
    grad; under ``torch.no_grad()`` it runs."""
    fn, plain, args, kw = _wrapper_args(name)
    want = plain(*args, **kw)
    req = tuple(a.clone().requires_grad_(True) if a.is_floating_point()
                else a for a in args)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*req, **kw)
    with torch.no_grad():
        got = fn(*req, **kw)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(
        fn(*args, **kw) if isinstance(want, tuple) else (fn(*args, **kw),),
        want if isinstance(want, tuple) else (want,)))


LAUNCH = ["--arch", "llama3-8b", "--reduced", "--steps", "4", "--batch", "2",
          "--seq", "32", "--ckpt-every", "2", "--log-every", "1"]


def test_launcher_finishes_reference_run_from_its_checkpoint(tmp_path):
    """The reference launcher trains reduced llama3-8b for 4 steps with a
    checkpoint every 2; the port's launcher resumes from the reference's
    step_2 alone and ends on the reference's final metrics (1e-5
    relative)."""
    from repro.launch import train as j_train
    from repro_torch.launch import train
    j_dir, t_dir = tmp_path / "ref", tmp_path / "port"
    want = j_train.main(LAUNCH + ["--ckpt-dir", str(j_dir)])
    assert sorted(os.listdir(j_dir)) == ["step_0000000002",
                                         "step_0000000004"]
    shutil.copytree(j_dir / "step_0000000002", t_dir / "step_0000000002")
    got = train.main(LAUNCH + ["--ckpt-dir", str(t_dir), "--resume",
                               "--device", "cpu"])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    # the port's final checkpoint restores in the reference
    from repro.checkpoint import CheckpointManager as JCheckpointManager
    back = JCheckpointManager(str(t_dir)).restore(4, _j_template())
    assert int(back["opt"]["step"]) == 4


def _j_template():
    """The reference launcher's state tree, as ShapeDtypeStructs."""
    from repro.optim.optimizer import adamw_init as j_adamw_init
    j_cfg = j_get_config("llama3-8b").reduced()
    j_model = j_build(j_cfg, JShardCtx.single())
    params = jax.eval_shape(j_model.init, jax.random.key(0))
    ocfg = j_opt_config_for(j_cfg)
    return {"params": params,
            "opt": jax.eval_shape(lambda p: j_adamw_init(ocfg, p), params)}


def test_launcher_checkpoints_and_resumes_itself(tmp_path, capsys):
    from repro_torch.launch import train
    argv = LAUNCH + ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    full = train.main(argv)
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 4 and "step_ms=" in out
    assert "[train] wcet:" in out
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000004"]
    shutil.rmtree(tmp_path / "step_0000000004")
    resumed = train.main(argv + ["--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == full                      # bit exact on the CPU


@pytest.mark.parametrize("arch,key", [("whisper-tiny", "frames"),
                                      ("internvl2-76b", "vision_embeds")])
def test_launcher_refuses_families_the_loader_cannot_feed(arch, key):
    from repro_torch.launch import train
    with pytest.raises(ValueError, match=key):
        train.main(["--arch", arch, "--reduced", "--steps", "1",
                    "--device", "cpu"])
