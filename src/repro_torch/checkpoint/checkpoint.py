"""Async checkpointing of tensor trees — the port of
``repro.checkpoint.checkpoint``, with the reference's on-disk layout, so
a checkpoint either package writes restores in the other.

Layout:  <dir>/step_<N>/
           manifest.json    step, time, metadata, shape/dtype/sha256 per entry
           arrays.npz       one entry per leaf (path-string keys)

* Names — the reference's ``tree_flatten_with_path`` names: dict keys in
  sorted order and list indices, joined by ``/`` (``params/stack/groups/
  0/ln``); ``None`` leaves hold nothing.
* bfloat16 — npz stores no bfloat16: the entry is its ``uint16`` view and
  the manifest says ``"bfloat16"`` (converted through ``torch`` views).
* Atomicity — written to ``step_<N>.tmp`` then renamed; ``keep`` newest
  steps survive.
* Integrity — per-entry SHA-256 verified on restore.
* Async — ``save_async`` copies to host memory at once (the caller may
  then update its tensors in place), writes on a daemon thread, and
  raises a write error at ``wait``.

``restore`` puts each leaf on its template leaf's device and dtype.

On a mesh (DTensor leaves) ``save`` / ``save_async`` gather each leaf
with ``full_tensor()`` in the synchronous snapshot, on every rank of the
leaves' mesh (a collective); the rank at the mesh's origin writes and the
ranks meet at a barrier over the mesh, so the files, names and sha256 are
those of a single-device save of the same values. ``restore(...,
shardings=)`` is the reference's elastic restart: each rank reads the
arrays and keeps its own block of each (``Sharding``'s placements, at the
offsets DTensor gives them; no collective), so a checkpoint saved on one
mesh (or by the reference, or on one device) restores onto another. A
DTensor template leaf restores onto its own placements.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch



def _flatten_with_names(tree, prefix: tuple = ()) -> list:
    """[(name, leaf)] in the reference's flatten order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_names(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_names(v, prefix + (i,))]
    if tree is None:
        return []
    return [("/".join(str(k) for k in prefix), tree)]


def _map_named(fn, tree, other=None, prefix: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(name, leaf, other's leaf
    at the same place)`` (``other`` None: None)."""
    def sub(key):
        return None if other is None else other[key]
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, sub(k), prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, sub(i), prefix + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(str(k) for k in prefix), tree, other)


def _mesh_of(leaves) -> Any:
    """The mesh of the DTensor leaves, or None (all on one mesh)."""
    from torch.distributed.tensor import DTensor
    meshes = {id(t.device_mesh): t.device_mesh for t in leaves
              if isinstance(t, DTensor)}
    if len(meshes) > 1:
        raise ValueError("a checkpoint's DTensors must share one mesh")
    return next(iter(meshes.values()), None)


def _is_writer(mesh) -> bool:
    """The rank at the mesh's origin writes (every rank without a mesh)."""
    return mesh is None or all(c == 0 for c in mesh.get_coordinate())


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others: an all-reduce over
    each mesh dim (a submesh has no process group of its own ranks)."""
    import torch.distributed._functional_collectives as fc
    t = torch.zeros(1, device=mesh.device_type)
    for d in range(mesh.ndim):
        t = fc.wait_tensor(fc.all_reduce(t, "sum", (mesh, d)))


def _block(arr: np.ndarray, sharding) -> tuple:
    """(this rank's block of the global ``arr`` under ``sharding``,
    the global shape)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        arr.shape, sharding.mesh, tuple(sharding.placements))
    idx = tuple(slice(o, o + n) for o, n in zip(off, shape))
    return np.ascontiguousarray(arr[idx]), arr.shape


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_storable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (bf16 as its uint16 view) and the
    logical dtype's name."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _dtype_name(t.dtype)


def _from_storable(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _placed(sh):
    """A Sharding, or a DTensor's (mesh, placements) as one."""
    if hasattr(sh, "device_mesh"):
        from repro_torch.distributed.sharding import Sharding
        return Sharding(sh.device_mesh, (), tuple(sh.placements))
    return sh


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None           # a meshed save_async's barrier is due

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    @staticmethod
    def _snapshot(tree) -> tuple[list, list, Any]:
        """(names, host copies, the leaves' mesh or None). A DTensor leaf
        is gathered on every rank of its mesh (a collective), one leaf at
        a time; only the writer copies it to the host, and the other ranks
        drop it at once (their host copies are empty)."""
        from repro_torch.distributed.sharding import full_value
        named = _flatten_with_names(tree)
        mesh = _mesh_of([t for _, t in named])
        writer = _is_writer(mesh)
        storable = []
        for _, t in named:
            full = full_value(t)
            if writer:
                storable.append(_to_storable(full))
            del full
        return [n for n, _ in named], storable, mesh

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None
             ) -> str:
        names, storable, mesh = self._snapshot(tree)
        final = self._step_dir(step)
        if _is_writer(mesh):
            final = self._write(step, names, storable, metadata or {})
        if mesh is not None:
            _mesh_barrier(mesh)
        return final

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None) -> None:
        """Snapshot now (device→host copy), write in background; on a
        mesh every rank calls it, and ``wait`` is the barrier."""
        self.wait()
        names, storable, mesh = self._snapshot(tree)  # synchronous snapshot
        meta = dict(metadata or {})
        self._mesh = mesh
        if not _is_writer(mesh):
            return

        def _bg():
            try:
                self._write(step, names, storable, meta)
            except BaseException as e:                  # surfaced at wait()
                self._error = e

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _mesh_barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _write(self, step: int, names, storable, metadata) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{n: a for n, (a, _) in zip(names, storable)})
        manifest = {
            "step": step,
            "time": time.time(),
            "metadata": metadata,
            "entries": {
                n: {"shape": list(a.shape), "dtype": dt,
                    "sha256": _sha256(a)}
                for n, (a, dt) in zip(names, storable)
            },
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, shardings: Any = None,
                verify: bool = True) -> Any:
        """template: a tree of tensors giving the structure, and each
        leaf's shape, dtype and device. shardings: None, or a tree of the
        template's structure whose leaves are ``Sharding``s (or None): a
        leaf with one comes back as a DTensor on its placements, each rank
        holding its block. A DTensor template leaf without one restores
        onto the template's own placements."""
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)

        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(name, leaf, sh):
                arr = data[name]
                ent = manifest["entries"][name]
                if verify and _sha256(arr) != ent["sha256"]:
                    raise IOError(f"checksum mismatch for {name}")
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch {name}: {arr.shape} "
                                     f"vs {tuple(leaf.shape)}")
                if sh is None and hasattr(leaf, "placements"):
                    sh = leaf
                if sh is None:
                    return _from_storable(arr, ent["dtype"]).to(
                        device=leaf.device, dtype=leaf.dtype)
                from torch.distributed.tensor import DTensor
                sh = _placed(sh)
                block, shape = _block(arr, sh)
                device = leaf.to_local().device if hasattr(
                    leaf, "to_local") else leaf.device
                loc = _from_storable(block, ent["dtype"]).to(
                    device=device, dtype=leaf.dtype)
                return DTensor.from_local(
                    loc, sh.mesh, tuple(sh.placements), run_check=False,
                    shape=shape, stride=_contiguous_stride(shape))
            return _map_named(load, template, shardings)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)
