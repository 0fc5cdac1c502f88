from repro_torch.kernels.flash_attention.kernel import (
    FlashAttentionFn, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_grad,
    flash_attention_lse_plain, flash_attention_plain)

# the reference's name for its oracle; here it is the plain version
attention_ref = flash_attention_plain

__all__ = ["FlashAttentionFn", "attention_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_grad",
           "flash_attention_lse_plain", "flash_attention_plain"]
