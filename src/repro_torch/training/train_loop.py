"""Training step factory — the port of ``repro.training.train_loop``:
value and grad of ``Model.loss`` through autograd, microbatch gradient
accumulation, then AdamW (fp32 or 8-bit).

``make_train_step`` returns a (params, opt_state, batch) -> (params,
opt_state, metrics) function. With one microbatch the gradients keep the
parameters' dtype, as JAX's do; with ``accum_steps > 1`` they are summed
in ``cfg.accum_dtype`` and scaled by 1/accum, and the metrics averaged.
``donate=True`` lets the update write into the given state (the
reference's launcher donates it to its jitted step); the returned values
are the same. ``state_axes``, ``state_shardings`` and ``abstract_state``
give the state's logical axes, its Shardings on a mesh and, under
``FakeTensorMode``, its shapes as fake DTensors (the dry run's). On a mesh
the step runs on DTensors placed by ``state_shardings`` (``place_state``
puts a state there).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.persistent import tree_leaves, tree_map
from repro_torch.distributed.sharding import (ShardCtx, _is_dtensor,
                                              attach_shardings, full_value,
                                              replicating, unshard_dim)
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_state_axes, adamw_update,
                                         make_optimizer)


def _value_and_grad(loss_fn, params, batch):
    """(gradients shaped as ``params``, metrics detached). A parameter the
    loss does not reach gets zeros like it (a DTensor of its placements on
    a mesh)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(req)
        loss, metrics = loss_fn(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    return (tree_map(lambda _: next(it), params),
            {k: v.detach() for k, v in metrics.items()})


def _microbatch(x, i: int, n: int):
    """Rows [i B/n, (i+1) B/n) of a (B, ...) batch leaf. A DTensor is cut
    from its batch-gathered value and placed back as it was, so each
    microbatch holds the reference's rows (reshaping a batch-sharded
    DTensor to (n, B/n, ...) would hand each rank other rows)."""
    mb = x.shape[0] // n
    if not _is_dtensor(x):
        return x[i * mb:(i + 1) * mb]
    pl = tuple(x.placements)
    full = x.redistribute(x.device_mesh, unshard_dim(pl, 0))
    return full[i * mb:(i + 1) * mb].redistribute(x.device_mesh, pl)


def make_train_step(model, opt_cfg: AdamWConfig, accum_steps: int = 1, *,
                    donate: bool = False):
    """model: a ``repro_torch.models.Model``. Batch leaves are
    (global_batch, ...). On a mesh (DTensor parameters, optimizer state
    and batch) the step runs on DTensors: the state keeps its placements,
    the plain scalars the step makes join as replicated values, and the
    metrics come back as plain tensors, the same on every rank."""
    loss_fn = model.loss
    accum_dtype = getattr(torch, model.cfg.accum_dtype)

    def compute_grads(params, batch):
        if accum_steps <= 1:
            return _value_and_grad(loss_fn, params, batch)
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype),
                         params)
        m_acc = None
        for i in range(accum_steps):
            mb = {k: _microbatch(x, i, accum_steps) for k, x in batch.items()}
            g, metrics = _value_and_grad(loss_fn, params, mb)
            g_acc = tree_map(lambda a, b: a + b.to(a.dtype), g_acc, g)
            m_acc = metrics if m_acc is None else \
                {k: m_acc[k] + v for k, v in metrics.items()}
        inv = 1.0 / accum_steps
        return (tree_map(lambda g: g * inv, g_acc),
                {k: v * inv for k, v in m_acc.items()})

    def train_step(params, opt_state, batch):
        with _replicating(params):
            grads, metrics = compute_grads(params, batch)
            with torch.no_grad():
                params, opt_state, info = adamw_update(
                    opt_cfg, params, grads, opt_state, donate=donate)
        metrics = dict(metrics)
        metrics.update(info)
        return params, opt_state, {k: full_value(v) for k, v in metrics.items()}

    return train_step


def _replicating(params):
    """``replicating()`` where the parameters are DTensors (plain scalars
    and positions join DTensor ops as replicated values), else nothing."""
    if not any(_is_dtensor(p) for p in tree_leaves(params)):
        return contextlib.nullcontext()
    return replicating()


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------

def opt_config_for(cfg, lr=3e-4, **kw) -> AdamWConfig:
    return make_optimizer(cfg.optimizer, lr=lr, **kw)


def init_state(model, opt_cfg: AdamWConfig, seed: int):
    """(params drawn from ``seed`` on the model's device, optimizer
    state)."""
    params = model.init(seed)
    return params, adamw_init(opt_cfg, params)


def state_axes(model, opt_cfg: AdamWConfig):
    p_axes = model.param_axes()
    return p_axes, adamw_state_axes(opt_cfg, p_axes)


def place_state(model, opt_cfg: AdamWConfig, ctx: ShardCtx, params,
                opt_state):
    """(params, optimizer state) as DTensors placed by ``state_shardings``:
    every rank holds the full values (drawn from one seed) and keeps its
    block, with no collective (the reference's ``jax.device_put`` of the
    state onto its shardings)."""
    p_axes, o_axes = state_axes(model, opt_cfg)
    return ctx.distribute(params, p_axes), ctx.distribute(opt_state, o_axes)


def state_shardings(model, opt_cfg: AdamWConfig, ctx: ShardCtx,
                    params_shape=None, opt_shape=None):
    p_axes, o_axes = state_axes(model, opt_cfg)
    return (ctx.tree_shardings(p_axes, params_shape),
            ctx.tree_shardings(o_axes, opt_shape))


def abstract_state(model, opt_cfg: AdamWConfig, ctx: ShardCtx):
    """Params and optimizer state as fake tensors (DTensors of their
    Shardings on a mesh) on the model's device: the port's
    ``jax.eval_shape`` of the reference's ``abstract_state``. Nothing is
    drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode() or FakeTensorMode()
    with mode:
        params = model.init(0)
        opt = adamw_init(opt_cfg, params)
        p_sh, o_sh = state_shardings(model, opt_cfg, ctx, params, opt)
        return attach_shardings(params, p_sh), attach_shardings(opt, o_sh)
