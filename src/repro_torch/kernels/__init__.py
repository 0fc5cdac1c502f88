# Hand-written Hopper (sm_90a) kernels of the port. Each subpackage holds
# csrc/*.cu (CUDA C++ with a plain C interface, built by _build.py and
# bound with ctypes) and kernel.py (the wrapper, which launches the kernel
# for CUDA tensors and counts launches, plus the plain PyTorch version the
# wrapper uses for CPU tensors).
#
#   flash_attention/   blockwise causal/window/softcap GQA attention (K5) and
#                      its backward (K5-bwd), differentiable through
#                      flash_attention_grad (an autograd.Function)
#   decode_attention/  flash-decoding against a KV cache (split + merge)
#   ssd_scan/          Mamba2 SSD intra-chunk output and chunk-end states
#                      (K6); ops.ssd adds the inter-chunk recurrence
#   persistent/        the drain megakernel (K1/K2) and the legacy work-queue
#                      executor (K3) over 128x128 f32 tile workspaces

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a call of the forward-only kernel
    wrapper ``name`` (K4, K5's serving ``flash_attention``, K6): they write
    their outputs through raw pointers outside autograd, so their outputs
    would carry no gradient. Train mode takes ``flash_attention_grad`` for
    attention (K5 with its lse and K5-bwd inside an autograd.Function) and
    the plain SSD; call a forward-only wrapper under ``torch.no_grad()``,
    or with tensors that do not require grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad with grad mode "
            f"on, and the kernel's output would carry no gradient (train "
            f"through flash_attention_grad, or call it under "
            f"torch.no_grad())")


def shape_only(*tensors) -> bool:
    """Whether a call computes shapes only: under ``FakeTensorMode`` (the
    dry run traces the card's path on fake tensors), or for meta
    tensors. A wrapper then returns outputs of the right shape, dtype and
    device, and launches nothing."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor
    if detect_fake_mode() is not None:
        return True
    return any(isinstance(t, FakeTensor) or t.device.type == "meta"
               for t in tensors)


# What the shape-only branches would have computed: {kernel name: [calls,
# operations, bytes]} (each input read once, each output written once).
# The dry run reads it beside FlopCounterMode, which does not see a kernel
# launched through ctypes.
SHAPE_ONLY_TALLY: dict[str, list] = {}


def tally(name: str, ops: float, inputs, outputs) -> None:
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    row = SHAPE_ONLY_TALLY.setdefault(name, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += float(ops)
    row[2] += float(nbytes)
