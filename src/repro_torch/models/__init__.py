from repro_torch.models.model import (Model, attention_layers, build,
                                      params_from_jax)

__all__ = ["Model", "attention_layers", "build", "params_from_jax"]
