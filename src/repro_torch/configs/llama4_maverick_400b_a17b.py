"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.
Llama-4 interleaves MoE every other layer and adds a shared expert; with the
assigned dims that lands at ~400B total / ~17B active (see DESIGN §9).
Uses 8-bit AdamW so optimizer state fits 16GB/chip at 256 chips.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    moe=MoEConfig(num_experts=128, top_k=1, interleave=2, shared_expert=True,
                  capacity_factor=1.25),
    rope_theta=500_000.0,
    optimizer="adamw8bit",
    train_accum_steps=8,
    accum_dtype="bfloat16",
))
