# Hand-written Hopper (sm_90a) kernels of the port. Each subpackage holds
# csrc/*.cu (CUDA C++ with a plain C interface, built by _build.py and
# bound with ctypes) and kernel.py (the wrapper, which launches the kernel
# for CUDA tensors and counts launches, plus the plain PyTorch version the
# wrapper uses for CPU tensors).
#
#   flash_attention/   blockwise causal/window/softcap GQA prefill attention
#   decode_attention/  flash-decoding against a KV cache (split + merge)
#   persistent/        the drain megakernel (K1/K2) and the legacy work-queue
#                      executor (K3) over 128x128 f32 tile workspaces
