"""gemma2-2b — local+global alternating attention, logit softcap [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    logit_softcap=30.0,
    attn_softcap=50.0,
    local_window=4096,
    local_global_interleave=2,   # alternate local / global
    sandwich_norm=True,
    scale_embeddings=True,
    mlp_act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
))
