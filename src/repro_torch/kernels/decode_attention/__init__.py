from repro_torch.kernels.decode_attention.kernel import (
    decode_attention, decode_attention_plain)

__all__ = ["decode_attention", "decode_attention_plain"]
