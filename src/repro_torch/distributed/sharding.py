"""Single-device sharding context — the port's counterpart of
``repro.distributed.sharding``.

The reference threads a ``ShardCtx`` (mesh + logical-axis rules) through
model code. On one device every constraint is the identity, which is all
this slice needs; meshes, rule tables and DTensor placement come with the
distribution slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShardCtx:
    kind: str = "train"
    mesh: None = None

    @staticmethod
    def single(kind: str = "train") -> "ShardCtx":
        """Single-device context: every constraint is a no-op."""
        return ShardCtx(kind=kind)

    def constrain(self, x, *logical_names):
        return x

    def replicate(self, x):
        return x

    @property
    def model_axis_size(self) -> int:
        return 1
