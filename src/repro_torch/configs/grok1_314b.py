"""grok-1-314b — MoE 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2 every layer.
Uses 8-bit AdamW so optimizer state fits 16GB/chip at 256 chips.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    moe=MoEConfig(num_experts=8, top_k=2, interleave=1, shared_expert=False,
                  capacity_factor=1.25),
    attn_softcap=30.0,          # grok uses attention logit softcap
    logit_softcap=30.0,
    rope_theta=10_000.0,
    optimizer="adamw8bit",
    train_accum_steps=8,
    accum_dtype="bfloat16",
))
