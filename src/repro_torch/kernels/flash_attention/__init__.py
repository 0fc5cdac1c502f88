from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_plain)

# the reference's name for its oracle; here it is the plain version
attention_ref = flash_attention_plain

__all__ = ["attention_ref", "flash_attention", "flash_attention_plain"]
