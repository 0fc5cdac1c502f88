"""PyTorch port of ``repro``: the persistent-worker dispatch stack and the
llama3 serving path on an NVIDIA H100, with hand-written Hopper kernels for
prefill and decode attention. Imports ``torch``, never ``jax`` or ``repro``.
"""
