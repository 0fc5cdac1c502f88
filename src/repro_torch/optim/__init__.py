from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_state_axes, adamw_update,
                                         clip_by_global_norm, compress_grads,
                                         cosine_schedule, decompress_grads,
                                         dequantize_8bit, global_norm,
                                         make_optimizer, quantize_8bit)
