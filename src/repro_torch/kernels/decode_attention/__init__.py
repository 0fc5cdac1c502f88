from repro_torch.kernels.decode_attention.kernel import (
    decode_attention, decode_attention_partial,
    decode_attention_partial_plain, decode_attention_plain,
    merge_decode_partials)

# the reference's name for its oracle; here it is the plain version
decode_attention_ref = decode_attention_plain

__all__ = ["decode_attention", "decode_attention_partial",
           "decode_attention_partial_plain", "decode_attention_plain",
           "decode_attention_ref", "merge_decode_partials"]
