from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_plain"]
