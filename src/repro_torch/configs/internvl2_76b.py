"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Per assignment the modality frontend is a STUB: input_specs() provides
precomputed patch embeddings (vision_tokens, d_model) prepended to text.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    vision_tokens=256,
    train_accum_steps=4,
    rope_theta=1_000_000.0,
))
