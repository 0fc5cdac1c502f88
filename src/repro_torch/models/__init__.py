from repro_torch.models.model import Model, build, params_from_jax

__all__ = ["Model", "build", "params_from_jax"]
