"""Logical-axis sharding rules on a ``DeviceMesh`` — the port of
``repro.distributed.sharding``.

Parameters, activations and caches carry *logical* axis names; a rule table
maps each name to mesh axes per run kind (train / prefill / decode /
long_decode), exactly as the reference's table does. Where the reference
builds a ``NamedSharding`` from a ``PartitionSpec``, the port builds the
DTensor placements of a ``torch.distributed`` ``DeviceMesh``: one placement
per mesh dimension, ``Shard(d)`` on each mesh axis that a tensor dim ``d``
is split over, ``Replicate()`` on the others. A tensor dim split over
several mesh axes (``("pod", "data")``, long_decode's
``("pod", "data", "model")``) is ``Shard(d)`` on each of them; DTensor cuts
it over the mesh dims left to right, so the rank at mesh coordinate
(i, j) holds block ``i * n_j + j``, the block ``NamedSharding`` gives
that device (``tests/test_torch_mesh.py`` holds the offsets of every rank
to JAX's).

``ShardCtx.constrain`` is the counterpart of ``with_sharding_constraint``:
a DTensor is redistributed to the placements of its logical axes (a
collective where the placements differ); a plain tensor, or any tensor under
``ShardCtx.single()``, passes through. ``Sharding`` keeps the reference-style
spec (a tuple of mesh-axis names per tensor dim) beside the placements, so
tests compare specs directly.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.persistent import tree_map


# A leaf-safe wrapper for logical axis tuples (the tree helpers treat plain
# tuples as internal nodes).
@dataclass(frozen=True)
class Axes:
    names: tuple

    def __iter__(self):
        return iter(self.names)


def axes(*names) -> Axes:
    return Axes(tuple(names))


# ---------------------------------------------------------------------------
# Meshes: a DeviceMesh, or any object with ``axis_names`` and a ``shape``
# dict (the reference tests' stand-in)
# ---------------------------------------------------------------------------

def mesh_axis_names(mesh) -> tuple:
    if mesh is None:
        return ()
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size}."""
    if mesh is None:
        return {}
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# Rule tables: logical axis -> mesh axis (str | tuple | None)
# ---------------------------------------------------------------------------

def make_rules(mesh, kind: str, expert_on_model: bool = True) -> dict:
    """kind: train | prefill | decode | long_decode."""
    names = mesh_axis_names(mesh)
    has_pod = "pod" in names
    has_data = "data" in names
    has_model = "model" in names
    data = "data" if has_data else None
    model = "model" if has_model else None
    batch = (("pod", "data") if has_pod else (data,)) if has_data else None
    if isinstance(batch, tuple) and batch == (None,):
        batch = None

    rules = {
        # --- params ---
        "layers": None,
        "groups": None,
        "embed": data if kind == "train" else None,   # fsdp dim (train only)
        "heads": model,
        "kv_heads": None,          # kv heads too few (8) to shard over model=16
        "head_dim": None,
        "mlp": model,
        "vocab": model,
        "expert": model if expert_on_model else None,
        "expert_mlp": None if expert_on_model else model,
        "expert_embed": data,     # expert stacks stay fsdp-sharded always
        # flattened 8-bit optimizer blocks: over the whole 2-D mesh
        "qblocks": tuple(n for n in ("data", "model") if n in names) or None,
        "conv": None,
        "ssm_heads": model,
        "ssm_state": None,
        # --- activations ---
        "act_batch": batch,
        # sequence parallelism (train): the residual stream between blocks
        # is sharded on 'model' along seq
        "act_seq": model if kind == "train" else None,
        "act_embed": None,
        "act_heads": model,
        "act_mlp": model,
        "act_vocab": model,
        "act_expert": model if expert_on_model else None,
        # --- kv cache ---
        # decode: batch over (pod,)data, seq over model (flash-decode merge);
        # long_decode (B=1): seq over every axis
        "cache_batch": batch if kind != "long_decode" else None,
        "cache_seq": (model if kind == "decode" else
                      (tuple(n for n in ("pod", "data", "model") if n in names)
                       if kind == "long_decode" else None)),
        "cache_heads": None,
        # --- replicated scalars ---
        "null": None,
    }
    if kind in ("prefill", "decode", "long_decode"):
        # inference: no fsdp; params TP-sharded and replicated over data
        rules["embed"] = None
    return rules


def _fit_axes(dim_size: int, entry, mesh):
    """Greedy prefix of the rule's mesh axes whose cumulative product divides
    the dim: an uneven dim is replicated over the axes that do not fit
    (8 q-heads on a 16-way model axis; batch 1 in long decode)."""
    if entry is None or dim_size <= 0:
        return None
    if isinstance(entry, str):
        entry = (entry,)
    sizes = mesh_sizes(mesh)
    kept, prod = [], 1
    for ax in entry:
        size = sizes[ax]
        if dim_size % (prod * size) == 0:
            kept.append(ax)
            prod *= size
        else:
            break
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def logical_to_spec(ax: Axes, rules: dict, mesh=None,
                    shape: Optional[tuple] = None) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple: per tensor dim a mesh
    axis name, a tuple of them, or None; trailing Nones trimmed."""
    parts = []
    for i, name in enumerate(ax.names):
        if name is None:
            parts.append(None)
            continue
        if name not in rules:
            raise KeyError(f"unknown logical axis {name!r}")
        entry = rules[name]
        if mesh is not None and shape is not None:
            entry = _fit_axes(shape[i], entry, mesh)
        parts.append(entry)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec. A tensor dim over
    several mesh axes names them in mesh order (the rules always do), which
    is the order DTensor splits it in."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {group} of dim {dim} are not in "
                             f"mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """Each device's block of a global ``shape`` under ``spec`` (the specs
    here always divide: ``_fit_axes``)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            assert out[dim] % sizes[a] == 0, (shape, spec)
            out[dim] //= sizes[a]
    return tuple(out)


@dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh, the reference-style spec and
    the DTensor placements it maps to."""
    mesh: Any
    spec: tuple
    placements: tuple


# ---------------------------------------------------------------------------
# ShardCtx
# ---------------------------------------------------------------------------

@dataclass
class ShardCtx:
    mesh: Any
    rules: dict
    kind: str = "train"

    @staticmethod
    def single(kind: str = "train") -> "ShardCtx":
        """Single-device context: every constraint is a no-op."""
        return ShardCtx(mesh=None, rules=make_rules(None, kind), kind=kind)

    @staticmethod
    def for_mesh(mesh, kind: str, expert_on_model: bool = True) -> "ShardCtx":
        return ShardCtx(mesh=mesh, rules=make_rules(mesh, kind,
                                                    expert_on_model),
                        kind=kind)

    # -- activation constraint ------------------------------------------------
    def placements(self, x, *logical_names) -> tuple:
        """The placements of ``x`` under its logical axes (padded with
        None to x's rank; uneven dims fall back as ``_fit_axes`` says)."""
        names = tuple(logical_names)
        names = names + (None,) * (x.ndim - len(names))
        spec = logical_to_spec(Axes(names), self.rules, self.mesh,
                               tuple(x.shape))
        return spec_to_placements(spec, self.mesh)

    def constrain(self, x, *logical_names):
        if self.mesh is None or not _is_dtensor(x):
            return x
        pl = self.placements(x, *logical_names)
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(self.mesh, pl)

    def gather_seq(self, x):
        """Train mode on a mesh: the residual stream's sequence gathered
        (``act_seq`` -> replicated) before a block's projections, the
        entry of sequence parallelism; its backward reduce-scatters. Other
        kinds (whose residual stream is never sequence-sharded) and plain
        tensors pass through."""
        if self.kind != "train":
            return x
        return self.constrain(x, "act_batch", None, "act_embed")

    def gather_fsdp(self, tree):
        """On a mesh, each DTensor parameter of ``tree`` gathered over the
        fsdp axes ('pod', 'data'), keeping its tensor-parallel shards on
        'model' (FSDP's gather at use, which the train paths make; its
        backward reduce-scatters the gradient). Plain tensors pass
        through."""
        if self.mesh is None:
            return tree
        names = mesh_axis_names(self.mesh)
        fsdp = {i for i, n in enumerate(names) if n in ("pod", "data")}

        def gather(t):
            if not _is_dtensor(t):
                return t
            from torch.distributed.tensor import Replicate
            pl = tuple(Replicate() if i in fsdp else p
                       for i, p in enumerate(t.placements))
            return t if pl == tuple(t.placements) else \
                t.redistribute(self.mesh, pl)
        return tree_map(gather, tree)

    def replicate(self, x):
        """A DTensor redistributed to Replicate on every mesh dim."""
        if self.mesh is None or not _is_dtensor(x):
            return x
        from torch.distributed.tensor import Replicate
        return x.redistribute(self.mesh, (Replicate(),) * self.mesh.ndim)

    # -- param/tree shardings ------------------------------------------------
    def sharding_for(self, ax: Axes,
                     shape: Optional[tuple] = None) -> Optional[Sharding]:
        if self.mesh is None:
            return None
        spec = logical_to_spec(ax, self.rules, self.mesh, shape)
        return Sharding(self.mesh, spec, spec_to_placements(spec, self.mesh))

    def tree_shardings(self, axes_tree, shape_tree=None):
        """Map an Axes tree to Shardings; with ``shape_tree`` (tensors of
        the same structure) the per-dim divisibility fallback applies."""
        if self.mesh is None:
            return tree_map(lambda a: None, axes_tree)
        if shape_tree is None:
            return tree_map(self.sharding_for, axes_tree)
        return tree_map(lambda a, s: self.sharding_for(a, tuple(s.shape)),
                        axes_tree, shape_tree)

    def distribute(self, tree, axes_tree):
        """A tree of full tensors (the same on every rank) as DTensors
        placed by its logical axes: each rank keeps its block, no
        collective (``jax.device_put`` with ``tree_shardings``)."""
        if self.mesh is None:
            return tree
        from torch.distributed.tensor import distribute_tensor
        shardings = self.tree_shardings(axes_tree, tree)
        return tree_map(
            lambda sh, t: distribute_tensor(t, self.mesh, sh.placements,
                                            src_data_rank=None),
            shardings, tree)

    def constrain_tree(self, tree, axes_tree):
        """``constrain`` leaf by leaf, by an Axes tree."""
        if self.mesh is None:
            return tree
        return tree_map(lambda a, t: self.constrain(t, *a.names),
                        axes_tree, tree)

    @property
    def model_axis_size(self) -> int:
        return mesh_sizes(self.mesh).get("model", 1)

    @property
    def data_axis_size(self) -> int:
        return mesh_sizes(self.mesh).get("data", 1)


@contextlib.contextmanager
def replicating():
    """Plain tensors join DTensor ops as replicated values inside, as in
    ``implicit_replication``, and the setting is restored on exit (that
    context switches it off on exit, which ends an enclosing one: a
    model call inside a train step, a remat body inside a model call)."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def full_value(t):
    """A DTensor's full value (``full_tensor``: a collective of its mesh's
    ranks), or ``t`` as it is."""
    return t.full_tensor() if _is_dtensor(t) else t


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# A rank's blocks (the bodies that run inside local_map)
# ---------------------------------------------------------------------------

def mesh_coord(mesh, names) -> int:
    """This rank's block index along mesh axes ``names`` (in mesh order):
    the index of its block of a dim split over those axes."""
    idx = 0
    for ax in names:
        idx = idx * mesh.size(mesh_axis_names(mesh).index(ax)) + \
            mesh.get_local_rank(ax)
    return idx


def shard_axes(placements, mesh, dim: int) -> list:
    """The mesh axes a tensor dim is split over, in mesh order."""
    from torch.distributed.tensor import Shard
    names = mesh_axis_names(mesh)
    return [names[i] for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]


def unshard_dim(placements, dim: int) -> tuple:
    """``placements`` with tensor dim ``dim`` replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in placements)


def as_replicated(t, mesh):
    """A plain tensor (the same full value on every rank) as a replicated
    DTensor, so ``local_map`` hands each rank its block of it."""
    if _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def attach_shardings(shape_tree, sharding_tree):
    """Tensors of global shape (fake or meta: the dry run's inputs) as
    DTensors of their Shardings, each rank's block an empty tensor of the
    same dtype and device; a None sharding leaves the leaf as it is."""
    import torch
    from torch.distributed.tensor import DTensor

    def _attach(s, sh):
        if sh is None:
            return s
        loc = torch.empty(local_shape(tuple(s.shape), sh.spec, sh.mesh),
                          dtype=s.dtype, device=s.device)
        return DTensor.from_local(loc, sh.mesh, sh.placements,
                                  run_check=False, shape=tuple(s.shape),
                                  stride=s.stride())
    return tree_map(_attach, shape_tree, sharding_tree)


class _SumGrad:
    """Identity forward; backward sums the gradient over mesh dims
    (Megatron's "f" operator). Built on first use: ``torch.autograd``'s
    Function is only subclassed where a mesh trains."""
    fn = None

    @classmethod
    def apply(cls, x, dims: tuple):
        if cls.fn is None:
            import torch

            class SumGrad(torch.autograd.Function):
                @staticmethod
                def forward(ctx, t, dims):
                    ctx.dims = dims
                    return t.view_as(t)

                @staticmethod
                def backward(ctx, g):
                    import torch.distributed._functional_collectives as fc
                    from torch.distributed.tensor import DTensor
                    mesh = g.device_mesh
                    loc = g.to_local()
                    for d in ctx.dims:
                        loc = fc.all_reduce(loc, "sum", (mesh, d))
                    loc = fc.wait_tensor(loc)
                    return DTensor.from_local(
                        loc, mesh, g.placements, run_check=False,
                        shape=g.shape, stride=g.stride()), None
            cls.fn = SumGrad
        return cls.fn.apply(x, dims)


def blocks_map(body, mesh, in_placements, out_placements):
    """``local_map`` of ``body`` over DTensor arguments, right under
    autograd too. ``local_map`` hands an input's gradient back on the
    input's placements; where an input is replicated over a mesh dim that
    another input is sharded over, each rank's body reads it for its own
    block (its query heads' kv heads, its tokens' router rows, its SSM
    heads' B and C), so each rank's gradient is a partial sum: it is
    summed over those dims (the reference's ``shard_map`` transposes a
    replicated input's cotangent to a ``psum`` the same way). Forward it is
    ``local_map`` with the inputs redistributed to ``in_placements``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    split = sorted({i for pl in in_placements for i, p in enumerate(pl)
                    if isinstance(p, Shard)})
    fn = local_map(body, out_placements=out_placements,
                   in_placements=in_placements, device_mesh=mesh,
                   redistribute_inputs=True)

    def run(*args):
        placed = []
        for a, pl in zip(args, in_placements):
            if not _is_dtensor(a):          # passed whole, as local_map does
                placed.append(a)
                continue
            if tuple(a.placements) != tuple(pl):
                a = a.redistribute(mesh, pl)
            dims = tuple(i for i in split if not isinstance(pl[i], Shard))
            if dims and a.requires_grad:
                a = _SumGrad.apply(a, dims)
            placed.append(a)
        return fn(*placed)
    return run
