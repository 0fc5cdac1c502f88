"""zamba2-7b — hybrid: Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
The shared attention+MLP block (one weight set) is applied every 6 mamba layers
on concat(hidden, embedding); per-invocation LoRA deltas omitted (see DESIGN §9).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    shared_attn_every=6,
    norm_eps=1e-5,
))
