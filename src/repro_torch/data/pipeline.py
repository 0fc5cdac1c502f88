"""Deterministic sharded data pipeline — the port of
``repro.data.pipeline``.

Sources: a synthetic affine-Markov LM stream (learnable — used by overfit
tests), and a binary token memmap. Batches are a pure function of
(seed, step), so any host/worker can reconstruct any step's batch after an
elastic restart — no data-loader state in checkpoints beyond the step id.
Each host materializes only its data-parallel slice. The sources are the
reference's numpy code, so the port draws the reference's batches bit for
bit; ``ShardedLoader.device_batch`` puts them on the loader's device.

Given a mesh and a batch spec (the reference-style spec: one mesh-axis
name, tuple of names or None per dim), ``device_batch`` returns the tokens
as a DTensor on the spec's placements: every rank draws the host batch
(a pure function of the step) and keeps its block, with no collective.
A deliberate difference from the reference: its launcher gives its loader
no mesh and lets ``jit`` reshard a plain array, while the port's
``ShardCtx.constrain`` lets a plain tensor through unchanged, so the port's
launcher hands the loader the mesh and the ``act_batch`` spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.persistent import check_device


class SyntheticLM:
    """tokens[t+1] = (a * tokens[t] + b) mod vocab, with per-sequence (a, b)
    drawn from a small pool and occasional noise — enough structure for a
    model to overfit, enough entropy to not be trivial."""

    def __init__(self, vocab_size: int, seed: int = 0, noise: float = 0.05,
                 n_rules: int = 8):
        self.vocab = vocab_size
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.rules = [(int(rng.integers(1, vocab_size)),
                       int(rng.integers(0, vocab_size)))
                      for _ in range(n_rules)]

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        out = np.empty((batch_size, seq_len), np.int32)
        rule_idx = rng.integers(0, len(self.rules), batch_size)
        tok = rng.integers(0, self.vocab, batch_size)
        noise = rng.random((batch_size, seq_len)) < self.noise
        rand = rng.integers(0, self.vocab, (batch_size, seq_len))
        a = np.array([self.rules[i][0] for i in rule_idx], np.int64)
        b = np.array([self.rules[i][1] for i in rule_idx], np.int64)
        cur = tok.astype(np.int64)
        for t in range(seq_len):
            cur = np.where(noise[:, t], rand[:, t], cur)
            out[:, t] = cur
            cur = (a * cur + b) % self.vocab
        return out


class MemmapDataset:
    """Flat binary token file (uint16/uint32). Windows are deterministic in
    (seed, step, slot)."""

    def __init__(self, path: str, vocab_size: int, dtype=np.uint16,
                 seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        n = self.data.shape[0] - seq_len - 1
        starts = rng.integers(0, n, batch_size)
        out = np.stack([self.data[s:s + seq_len] for s in starts])
        return out.astype(np.int32) % self.vocab


@dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    host_index: int = 0
    host_count: int = 1


class ShardedLoader:
    """Yields host-local batches as int32 tensors on ``device`` (default
    CUDA, which raises where CUDA is absent); with ``mesh`` and
    ``batch_spec``, as DTensors on the spec's placements."""

    def __init__(self, source, dcfg: DataConfig, mesh=None, batch_spec=None,
                 *, device="cuda"):
        self.source = source
        self.dcfg = dcfg
        self.mesh = mesh
        self.batch_spec = batch_spec
        self.device = check_device(device)
        if dcfg.global_batch % dcfg.host_count:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {dcfg.host_count} hosts")
        self.local_batch = dcfg.global_batch // dcfg.host_count

    def host_batch(self, step: int) -> np.ndarray:
        full = self.source.batch(step, self.dcfg.global_batch,
                                 self.dcfg.seq_len)
        lo = self.dcfg.host_index * self.local_batch
        return full[lo:lo + self.local_batch]

    def device_batch(self, step: int) -> dict:
        tokens = torch.from_numpy(np.ascontiguousarray(self.host_batch(step)))
        tokens = tokens.to(self.device)
        if self.mesh is not None and self.batch_spec is not None:
            from torch.distributed.tensor import distribute_tensor
            from repro_torch.distributed.sharding import spec_to_placements
            tokens = distribute_tensor(
                tokens, self.mesh,
                spec_to_placements(tuple(self.batch_spec), self.mesh),
                src_data_rank=None)
        return {"tokens": tokens}

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.device_batch(step)
            step += 1
