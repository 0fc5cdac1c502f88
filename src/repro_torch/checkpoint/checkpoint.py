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

``restore`` puts each leaf on its template leaf's device and dtype. Its
``shardings`` argument (restore onto another mesh) comes with training on
a mesh (slice 13).
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


def _map_named(fn, tree, prefix: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(str(k) for k in prefix), tree)


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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    @staticmethod
    def _snapshot(tree) -> tuple[list, list]:
        named = _flatten_with_names(tree)
        return [n for n, _ in named], [_to_storable(t) for _, t in named]

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None
             ) -> str:
        names, storable = self._snapshot(tree)
        return self._write(step, names, storable, metadata or {})

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None) -> None:
        """Snapshot now (device→host copy), write in background."""
        self.wait()
        names, storable = self._snapshot(tree)       # synchronous snapshot
        meta = dict(metadata or {})

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
        leaf's shape, dtype and device."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto shardings comes with training on a mesh "
                "(slice 13)")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)

        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(name, leaf):
                arr = data[name]
                ent = manifest["entries"][name]
                if verify and _sha256(arr) != ent["sha256"]:
                    raise IOError(f"checksum mismatch for {name}")
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch {name}: {arr.shape} "
                                     f"vs {tuple(leaf.shape)}")
                return _from_storable(arr, ent["dtype"]).to(
                    device=leaf.device, dtype=leaf.dtype)
            return _map_named(load, template)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)
