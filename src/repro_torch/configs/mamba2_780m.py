"""mamba2-780m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=1536 (attn-free) vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=48,          # d_inner / ssm.head_dim = 2*1536/64
    num_kv_heads=48,       # unused (attn-free); kept for uniform plumbing
    d_ff=0,                # attn-free: the SSM block subsumes the MLP
    vocab_size=50_280,
    head_dim=64,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    tie_embeddings=True,
    norm_eps=1e-5,
))
