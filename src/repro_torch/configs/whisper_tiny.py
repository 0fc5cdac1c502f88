"""whisper-tiny — enc-dec, conv frontend (stub) [arXiv:2212.04356].

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. Encoder consumes precomputed
frame embeddings (stub frontend per assignment); decoder is causal + cross-attn.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    encoder_frames=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    mlp_act="gelu",
    gated_mlp=False,
    rope_theta=0.0,          # whisper uses learned/sinusoidal pos — we use sinusoidal
    norm_eps=1e-5,
))
