"""The plain reference: the served models' forward pass in float32 (and
the control's lower precision), in plain PyTorch, from the same seeded
weights, importing nothing of the port."""
from portbench.reference.model import Reference, strict_f32  # noqa: F401
