"""Model / run configuration system — the PyTorch port's copy of
``repro.configs.base``. The registry loads all ten configs the reference
registers: dense (llama3-8b, gemma2-2b, mistral-nemo-12b, qwen2-72b), ssm
(mamba2-780m), hybrid (zamba2-7b), encdec (whisper-tiny), moe
(llama4-maverick-400b-a17b, grok-1-314b) and vlm (internvl2-76b).

Every assigned architecture is a ``ModelConfig`` registered under its public id.
``ModelConfig.reduced()`` derives a small same-family config for CPU smoke tests;
the FULL configs are only ever lowered via the dry-run (ShapeDtypeStruct, no
allocation).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Shape sets (assigned): every LM-family arch pairs with these four shapes.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Families whose sequence mixing is sub-quadratic end-to-end (may run long_500k).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Apply MoE every `interleave` layers (1 = every layer, 2 = alternating).
    interleave: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # Dispatch group length: the one-hot dispatch/combine einsums cost
    # O(group_len * capacity) per token, and capacity ∝ group_len — fixed
    # groups keep dispatch LINEAR in sequence length (measured 0.073 →
    # ~0.4 useful-ratio on grok-1 prefill_32k in the reference).
    group_size: int = 512


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128       # N — SSM state size per head
    head_dim: int = 64         # P — channels per SSM head
    expand: int = 2            # d_inner = expand * d_model
    conv_width: int = 4        # depthwise causal conv width
    chunk_size: int = 256      # SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 1e-1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | ssm | hybrid | moe | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads
    # --- attention flavour ---
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    logit_softcap: float = 0.0         # gemma2 final-logit softcap
    attn_softcap: float = 0.0          # gemma2 attention-score softcap
    local_window: int = 0              # sliding-window size; 0 = none
    local_global_interleave: int = 0   # gemma2: alternate local/global every layer
    # --- norms / mlp ---
    norm_eps: float = 1e-6
    sandwich_norm: bool = False        # gemma2: post-norms after attn/mlp too
    mlp_act: str = "silu"              # silu (SwiGLU) | gelu (Gated GeLU / plain)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    scale_embeddings: bool = False     # gemma: multiply embeddings by sqrt(d)
    loss_chunk: int = 2048             # seq-chunked CE (bounds logit memory)
    # --- family-specific ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every `shared_attn_every`
    # ssm layers, on concat(hidden, embedding).
    shared_attn_every: int = 0
    # encdec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500          # stub frontend output length
    # vlm (internvl2)
    vision_tokens: int = 0              # stub patch-embedding prefix length
    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"      # storage dtype; master copy per optimizer
    remat: bool = True
    remat_policy: str = "full"         # full (nothing saveable) | dots | none
    scan_layers: bool = True
    scan_unroll: bool = False          # unroll layer scans (cost calibration)
    train_accum_steps: int = 1         # microbatch gradient accumulation
    accum_dtype: str = "float32"       # grad accumulator dtype
    optimizer: str = "adamw"           # adamw | adamw8bit
    # --- attention backend: every value computes the same function. In the
    # port the tensor's device picks the implementation (CUDA -> the hand
    # kernel, CPU -> its plain version); the field is kept for parity.
    attn_backend: str = "auto"
    attn_chunk: int = 512              # KV block of the reference's XLA path

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 so the vocab dim
        shards evenly on any production mesh axis (standard practice)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def validate(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, self.name
        if self.family in ("dense", "vlm"):
            assert self.ssm is None and self.moe is None
        if self.family == "moe":
            assert self.moe is not None
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None
        if self.family == "hybrid":
            assert self.shared_attn_every > 0
        if self.family == "encdec":
            assert self.encoder_layers > 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory napkin math)."""
        d, h = self.d_model, self.resolved_head_dim
        q_dim = self.num_heads * h
        kv_dim = self.num_kv_heads * h
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d  # wq, wk, wv, wo
        mlp_mats = 3 if self.gated_mlp else 2
        mlp = mlp_mats * d * self.d_ff
        norms = 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        if self.family == "ssm":
            total = self.num_layers * (self._ssm_block_params() + d) + embed + d
        elif self.family == "hybrid":
            n_shared = self.num_layers // self.shared_attn_every
            shared = attn + mlp + norms + 2 * d * d  # concat in-proj + out-proj
            total = (self.num_layers * (self._ssm_block_params() + d)
                     + shared + n_shared * 0 + embed + d)
        elif self.family == "moe":
            m = self.moe
            n_moe = self.num_layers // m.interleave
            n_dense = self.num_layers - n_moe
            expert_mlp = mlp_mats * d * self.d_ff
            moe_layer = m.num_experts * expert_mlp + d * m.num_experts
            if m.shared_expert:
                moe_layer += expert_mlp
            total = (self.num_layers * (attn + norms)
                     + n_dense * mlp + n_moe * moe_layer + embed + d)
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn + mlp + 2 * norms)
            dec = self.num_layers * (2 * attn + mlp + 3 * norms)  # self+cross
            total = enc + dec + embed + 2 * d
        else:  # dense / vlm backbone
            total = self.num_layers * (attn + mlp + norms) + embed + d
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared expert only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        mlp_mats = 3 if self.gated_mlp else 2
        expert_mlp = mlp_mats * d * self.d_ff
        n_moe = self.num_layers // m.interleave
        inactive = n_moe * (m.num_experts - m.top_k) * expert_mlp
        return self.param_count() - int(inactive)

    def _ssm_block_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_inner = s.expand * d
        n_heads = d_inner // s.head_dim
        in_proj = d * (2 * d_inner + 2 * s.state_dim + n_heads)  # z,x,B,C,dt
        conv = (d_inner + 2 * s.state_dim) * s.conv_width
        out = d_inner * d
        extras = 2 * n_heads + d_inner  # A_log, dt_bias, gate-norm
        return in_proj + conv + out + extras

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests (one fwd/train step)."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            scan_layers=self.scan_layers,
            remat=False,
            dtype="float32",
            param_dtype="float32",
            attn_backend="xla",
            attn_chunk=64,
        )
        if self.moe is not None:
            n_exp = min(self.moe.num_experts, 4)
            # cf = E makes capacity >= tokens*k: drop-free routing, so the
            # smoke tests' prefill<->decode equality is exact
            kw["moe"] = replace(self.moe, num_experts=n_exp,
                                top_k=min(self.moe.top_k, 2),
                                capacity_factor=float(n_exp))
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        if self.family == "hybrid":
            kw["shared_attn_every"] = 2
            kw["num_layers"] = 4
        if self.family == "encdec":
            kw["encoder_layers"] = 2
            kw["encoder_frames"] = 16
        if self.family == "vlm":
            kw["vision_tokens"] = 8
        if self.local_global_interleave:
            kw["local_window"] = 64
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    assert cfg.name not in _REGISTRY, f"duplicate config {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (  # noqa: F401
        gemma2_2b, grok1_314b, internvl2_76b, llama3_8b,
        llama4_maverick_400b_a17b, mamba2_780m, mistral_nemo_12b, qwen2_72b,
        whisper_tiny, zamba2_7b,
    )
    _LOADED = True


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and the reason if skipped."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("long_500k needs sub-quadratic sequence mixing; "
                       f"{cfg.name} is pure full-attention ({cfg.family})")
    return True, ""
