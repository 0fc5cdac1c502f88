"""Cells at a size a CPU test run holds: the benchmark's own files and
code, with a tiny model (float32, so that the program and the float32
reference agree to rounding) and a short traffic mix."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]

MODEL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 96, "vocab_size": 512,
         "rope_theta": 10000.0, "norm_eps": 1e-6, "mlp_act": "silu",
         "tie_embeddings": False, "dtype": "float32",
         "param_dtype": "float32"}

LIMITS = {"gap_max": {"limit": 1e-3}, "logit_err": {"limit": 1e-3}}


def config() -> dict:
    m = dict(MODEL, family="dense", attn_softcap=0.0, logit_softcap=0.0)
    return {"name": "tiny-dense", "source": "test", "reference": "dense",
            "model": m}


def traffic() -> dict:
    return {"rate_per_s": 6.0, "slots": 4, "max_seq": 96,
            "prompt_tokens": {"median": 24, "sigma": 0.5, "min": 8,
                              "max": 48},
            "output_tokens": {"median": 8, "sigma": 0.5, "min": 4,
                              "max": 16},
            "high_every": 4, "warm_prompts": [8, 48]}


def cell() -> spec.Cell:
    """A tiny cell with the benchmark's own metric lists."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    checks = {"served_tokens": 48, "max_requests": 6, "min_judged": 24,
              "limits": copy.deepcopy(LIMITS)}
    return spec.Cell(name="tiny-dense", config=config(), traffic=traffic(),
                     chips=1, end_to_end=bench["end_to_end"],
                     per_layer=bench["per_layer"], checks=checks)
